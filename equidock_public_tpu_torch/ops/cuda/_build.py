"""Build, load and call the port's CUDA kernels.

All `csrc/*.cu` files go through ONE plain `nvcc` call into one shared
library with an `extern "C"` interface, loaded with `ctypes`. The sources
include no PyTorch headers, so the build takes seconds and needs neither
`ninja` nor `torch.utils.cpp_extension`. The library lands in
`equidock_public_tpu_torch/_build/<hash of sources and flags>/`; a build
writes to a temporary name and renames it into place, so an interrupted
build leaves no lock and no half-written library behind.

Nothing here runs at import: the first launch of a kernel builds and loads.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Optional

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("edge_message.cu", "edge_message_bwd.cu", "cross_attention.cu",
           "cross_attention_bwd.cu", "softmin_field.cu", "halo_ring.cu")
HEADERS = ("attention_tiles.cuh", "edge_tiles.cuh")   # included by sources; part of the hash
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libequidock_kernels.so"
BUILD_TIMEOUT_S = 240


@dataclasses.dataclass
class BuildResult:
    path: str          # the shared library
    seconds: float     # compiler wall time (0 when the library was already built)
    log: str           # the compiler's output (nvcc: ptxas register / shared-memory lines)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                           "the CUDA kernels are built on the machine with the card")
    return nvcc


def _source_paths() -> List[str]:
    return [os.path.join(CSRC_DIR, s) for s in SOURCES]


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _source_paths() + [os.path.join(CSRC_DIR, s) for s in HEADERS]:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def compile_library(compiler: str, flags, sources, out_dir: str, lib_name: str,
                    timeout_s: float) -> BuildResult:
    """One compiler call `compiler flags -o <lib> sources` into
    `out_dir/lib_name`, unless that library exists. The call writes to a
    temporary name that is renamed into place, so processes that race to
    build the same library each finish with a whole one."""
    lib = os.path.join(out_dir, lib_name)
    if os.path.exists(lib):
        return BuildResult(lib, 0.0, "")
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, *sources]
    name = os.path.basename(compiler)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        os.unlink(tmp)
        raise RuntimeError(f"{name} timed out after {timeout_s} s: {' '.join(cmd)}\n"
                           f"{e.stdout or ''}{e.stderr or ''}") from e
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{name} failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, log)


def build(nvcc: Optional[str] = None) -> BuildResult:
    """Compile the sources unless a library for this exact source hash exists."""
    out_dir = os.path.join(BUILD_DIR, source_hash())
    if os.path.exists(os.path.join(out_dir, LIB_NAME)):
        return BuildResult(os.path.join(out_dir, LIB_NAME), 0.0, "")
    return compile_library(nvcc or find_nvcc(), NVCC_FLAGS, _source_paths(), out_dir,
                           LIB_NAME, BUILD_TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernels' library (once per process)."""
    return ctypes.CDLL(build().path)


def check_tensor(t, name: str, shape, dtype, device) -> None:
    """Raise unless `t` is a contiguous tensor of this shape, dtype and device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_launch(err: int, name: str) -> None:
    """A refused launch never runs and no later synchronize reports it."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def outputs(shapes, dev, out, what: str):
    """Fresh f32 outputs of `shapes`, or the caller's `out` after checking
    them (a kernel writes into preallocated outputs, e.g. inside guard
    regions)."""
    if out is None:
        return [torch.empty(s, dtype=torch.float32, device=dev) for s in shapes]
    if len(out) != len(shapes):
        raise ValueError(f"{what}: {len(out)} outputs given, {len(shapes)} expected")
    for i, (t, shape) in enumerate(zip(out, shapes)):
        check_tensor(t, f"{what} output {i}", shape, torch.float32, dev)
    return list(out)
