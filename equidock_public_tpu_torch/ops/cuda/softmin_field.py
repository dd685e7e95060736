"""Soft-min distance field sums, forward and backward: launch wrappers of
the CUDA kernels in `csrc/softmin_field.cu`, which replace `_fwd_kernel` and
`_bwd_kernel` of `equidock_public_tpu/ops/pallas/softmin_field.py`.

    S[b, m] = sum_n a_mask[b, n] exp(-|x[b, m] - a[b, n]|^2 / sigma)

The backward takes the cotangent c (B, M) of S and gives dx (B, M, 3) and
dA (B, N, 3) in one launch (query blocks and key blocks side by side, no
atomics). The plain versions, and the autograd Function that chooses
between them and these kernels, are in `ops/softmin_field.py`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, check_tensor, load_library

# Launches of each CUDA kernel in this process (plain-version calls excluded).
launches = 0        # forward
bwd_launches = 0    # backward (one launch computes dx and dA)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = load_library()
    fwd, bwd = lib.equidock_softmin_field_fwd, lib.equidock_softmin_field_bwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_inputs(x, a, a_mask):
    """(B, M, N) after checking the operands both kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"softmin_field: unsupported device {x.device}")
    B, M = x.shape[0], x.shape[1]
    N = a.shape[1]
    dev, f32 = x.device, torch.float32
    check_tensor(x, "x", (B, M, 3), f32, dev)
    check_tensor(a, "a", (B, N, 3), f32, dev)
    check_tensor(a_mask, "a_mask", (B, N), f32, dev)
    return B, M, N


def softmin_field_fwd(x, a, a_mask, sigma: float) -> torch.Tensor:
    """S (B, M) by the forward kernel, on CUDA operands."""
    B, M, N = _check_inputs(x, a, a_mask)
    s = torch.empty((B, M), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel_fns()[0](x.data_ptr(), a.data_ptr(), a_mask.data_ptr(), s.data_ptr(),
                               B, M, N, float(sigma),
                               torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "softmin_field")
    global launches
    launches += 1
    return s


def softmin_field_bwd(x, a, a_mask, c, sigma: float):
    """(dx (B, M, 3), dA (B, N, 3)) by the backward kernel for the cotangent
    c (B, M) of S, on CUDA operands; a_mask gets no gradient."""
    B, M, N = _check_inputs(x, a, a_mask)
    check_tensor(c, "c", (B, M), torch.float32, x.device)
    dx = torch.empty((B, M, 3), dtype=torch.float32, device=x.device)
    da = torch.empty((B, N, 3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel_fns()[1](x.data_ptr(), a.data_ptr(), a_mask.data_ptr(), c.data_ptr(),
                               dx.data_ptr(), da.data_ptr(), B, M, N, float(sigma),
                               torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "softmin_field bwd")
    global bwd_launches
    bwd_launches += 1
    return dx, da
