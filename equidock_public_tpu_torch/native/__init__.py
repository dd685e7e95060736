"""The host graph builder in C++ (`graph_builder.cc`): the mean all-atom
residue distance matrix and the kNN neighbour tables of
`data/featurize.py::build_protein_graph`, the port of
`equidock_public_tpu/native/__init__.py`.

The library is built at first use by one plain `g++` call into
`equidock_public_tpu_torch/_build/native-<hash of source and flags>/` and
bound with ctypes. There is no quiet fallback: a missing compiler or a
failed build raises with the compiler's output. The flags keep the result
independent of the host CPU (no `-march=native`, no floating-point
contraction), so the matrices are bit-equal to the numpy versions in
`data/featurize.py` (`residue_mean_distance_matrix`, `knn_tables`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
from typing import List, Tuple

import numpy as np

from ..ops.cuda._build import BUILD_DIR, BuildResult, compile_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "graph_builder.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread", "-ffp-contract=off")
LIB_NAME = "libgraph_builder.so"
BUILD_TIMEOUT_S = 120


def find_cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native graph builder is built "
                           "with it at first use")
    return cxx


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile `graph_builder.cc` unless the library for this source and
    these flags exists."""
    out_dir = os.path.join(BUILD_DIR, "native-" + source_hash())
    if os.path.exists(os.path.join(out_dir, LIB_NAME)):
        return BuildResult(os.path.join(out_dir, LIB_NAME), 0.0, "")
    return compile_library(find_cxx(), CXX_FLAGS, [SOURCE], out_dir, LIB_NAME,
                           BUILD_TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the library (once per process)."""
    lib = ctypes.CDLL(build().path)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.residue_mean_dist.argtypes = [f32p, i64p, ctypes.c_int64, f32p]
    lib.residue_mean_dist.restype = None
    lib.knn_edges.argtypes = [f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
                              i32p, u8p, f32p]
    lib.knn_edges.restype = None
    return lib


def residue_mean_dist(atoms: List[np.ndarray]) -> np.ndarray:
    """(N, N) float32 mean all-atom distance between residues, +inf on the
    diagonal; `atoms[i]` holds residue i's atoms (A_i, 3)."""
    if not atoms:
        raise ValueError("no residues")
    counts = np.array([a.shape[0] for a in atoms], dtype=np.int64)
    if (counts < 1).any() or any(a.ndim != 2 or a.shape[1] != 3 for a in atoms):
        raise ValueError("every residue needs at least one (x, y, z) atom")
    offsets = np.zeros(len(atoms) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    flat = np.ascontiguousarray(np.concatenate(atoms, axis=0), dtype=np.float32)
    out = np.empty((len(atoms), len(atoms)), dtype=np.float32)
    load_library().residue_mean_dist(flat, offsets, len(atoms), out)
    return out


def knn_edges(dist: np.ndarray, cutoff: float, max_neighbor: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(nbr int32, nbr_mask bool, nbr_dist float32), each (N, max_neighbor):
    per node all j with dist < cutoff in index order, or the max_neighbor
    nearest when there are more; unused slots self-loop with mask 0."""
    if dist.ndim != 2 or dist.shape[0] != dist.shape[1]:
        raise ValueError(f"expected a square distance matrix, got {dist.shape}")
    if max_neighbor < 1:
        raise ValueError(f"max_neighbor {max_neighbor} < 1")
    n = dist.shape[0]
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    nbr = np.empty((n, max_neighbor), dtype=np.int32)
    mask = np.empty((n, max_neighbor), dtype=np.uint8)
    nd = np.empty((n, max_neighbor), dtype=np.float32)
    load_library().knn_edges(dist, n, cutoff, max_neighbor, nbr, mask, nd)
    return nbr, mask.astype(bool), nd
