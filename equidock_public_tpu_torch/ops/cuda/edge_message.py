"""Fused IEGMN edge step, forward and backward: CUDA kernels
`csrc/edge_message.cu` and `csrc/edge_message_bwd.cu`, their plain PyTorch
versions, and the `torch.autograd.Function` that joins them.

Replaces `_kernel` and `_bwd_kernel` of
`equidock_public_tpu/ops/pallas/edge_message.py`. For
one protein side it computes, per destination node, the edge messages from
its K in-edges (RBFs of |x_rel|^2, the split first edge layer, LeakyReLU,
LayerNorm, lin2), the coors head's coefficient per edge, and the masked
means over K: `aggr` (B, N, D) and `x_upd` (B, N, 3). The backward
recomputes the forward from the saved inputs and gives every cotangent; a
second kernel sums the per-edge cotangents onto the src rows in a fixed
order (the transpose of the gather), and a sum reduces the per-block
parameter partials, as the JAX package's `_fused_bwd_call` does. Both are
bit-reproducible from run to run. See the kernels' sources for their design
and bound.

Inputs (the JAX package's fused-kernel layout):
    src (B, Nsrc, 3+D)  [x | h @ W_a] rows the neighbor table indexes
    dst (B, N, 3+D)     [x | h @ W_b + b1]
    he  (B, N, K, E)    static edge features (times the gmn gate)
    nbr (B, N, K) int32 source indices into src; msk (B, N, K) f32
    params: Wc (E, D), Wd (15, D), ln_g, ln_b, b2, b1c (D,), W2, W1c (D, D),
        W2c (D, 1), b2c (1,).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ...ops.segment import gather_neighbors
from ._build import check_launch, check_tensor, load_library

RBF_SIGMAS = tuple(1.5 ** x for x in range(15))
N_RBF = len(RBF_SIGMAS)
# The D the kernels are built for: the paper models' hidden width and the
# small DB5 models'
KERNEL_WIDTHS = (16, 64)
MAX_EDGE_FEATS = 32  # largest E the backward kernel takes (the models use 27)
BLOCK_THREADS = 256  # threads per block of both kernels: 256 / D nodes at a time
BWD_MAX_BLOCKS = 264  # two blocks per SM of an H100 (132 SMs)

# Launches of each CUDA kernel in this process (plain-version calls excluded).
launches = 0          # forward
bwd_launches = 0      # backward
scatter_launches = 0  # the backward's d_src sum, one per backward


def param_shapes(D: int, E: int) -> Dict[str, Tuple[int, ...]]:
    return {"Wc": (E, D), "Wd": (N_RBF, D), "ln_g": (D,), "ln_b": (D,),
            "W2": (D, D), "b2": (D,), "W1c": (D, D), "b1c": (D,),
            "W2c": (D, 1), "b2c": (1,)}


PARAM_NAMES = ("Wc", "Wd", "ln_g", "ln_b", "W2", "b2", "W1c", "b1c", "W2c", "b2c")


def edge_message_plain(src, dst, he, nbr, msk, params, slope: float = 0.01,
                       use_ln: bool = True, use_dist: bool = True):
    """Plain PyTorch version: the port of `edge_message._reference`."""
    gath = gather_neighbors(src, nbr)                         # (B, N, K, 3+D)
    dstr = dst[:, :, None, :]
    x_rel = gath[..., :3] - dstr[..., :3]
    d2 = (x_rel * x_rel).sum(dim=-1, keepdim=True)
    # 1.5^s built on the device (exact: every product is representable), so
    # no host copy: the plain version stays capturable in a CUDA graph
    sig = torch.full((N_RBF,), 1.5, dtype=d2.dtype, device=d2.device).cumprod(0) / 1.5
    rbf = torch.exp(-d2 / sig)
    if not use_dist:
        rbf = rbf * 0.0
    pre = (gath[..., 3:] + dstr[..., 3:]
           + torch.matmul(he, params["Wc"]) + torch.matmul(rbf, params["Wd"]))
    act = F.leaky_relu(pre, negative_slope=slope)
    if use_ln:
        mean = act.mean(dim=-1, keepdim=True)
        var = ((act - mean) ** 2).mean(dim=-1, keepdim=True)
        act = (act - mean) * torch.rsqrt(var + 1e-5) * params["ln_g"] + params["ln_b"]
    msg = torch.matmul(act, params["W2"]) + params["b2"]
    c1 = F.leaky_relu(torch.matmul(msg, params["W1c"]) + params["b1c"],
                      negative_slope=slope)
    coef = torch.matmul(c1, params["W2c"]) + params["b2c"]
    w = msk[..., None]
    cnt = torch.clamp(msk.sum(dim=-1), min=1.0)[..., None]
    aggr = (msg * w).sum(dim=2) / cnt
    xupd = (x_rel * coef * w).sum(dim=2) / cnt
    return aggr, xupd


def edge_message_bwd_plain(src, dst, he, nbr, msk, params, g_aggr, g_xupd,
                           slope: float = 0.01, use_ln: bool = True,
                           use_dist: bool = True):
    """Plain backward: (d_src, d_dst, d_he, d_params) by autograd through
    `edge_message_plain`; nbr and msk get no gradient, as in the kernel."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True)
                  for x in (src, dst, he, *(params[n] for n in PARAM_NAMES))]
        out = edge_message_plain(*leaves[:3], nbr, msk, dict(zip(PARAM_NAMES, leaves[3:])),
                                 slope, use_ln, use_dist)
        grads = torch.autograd.grad(out, leaves, (g_aggr, g_xupd), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    return grads[0], grads[1], grads[2], dict(zip(PARAM_NAMES, grads[3:]))


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = load_library()
    fwd, bwd = lib.equidock_edge_message_fwd, lib.equidock_edge_message_bwd
    scatter = lib.equidock_edge_scatter_src
    fwd.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 32 + [ctypes.c_int] * 6
                    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    scatter.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = scatter.restype = ctypes.c_int
    return fwd, bwd, scatter


def _check_inputs(src, dst, he, nbr, msk, params):
    """(B, Nsrc, N, K, D, E) after checking the operands the kernels take."""
    if src.device.type != "cuda":
        raise ValueError(f"edge_message: unsupported device {src.device}")
    B, N, K = nbr.shape
    Nsrc, C = src.shape[1], src.shape[2]
    D, E = C - 3, he.shape[-1]
    if D not in KERNEL_WIDTHS or K > D or E > MAX_EDGE_FEATS:
        raise ValueError(f"edge_message kernel: D={D} must be one of {KERNEL_WIDTHS}, "
                         f"K={K} <= D and E={E} <= {MAX_EDGE_FEATS}")
    dev, f32 = src.device, torch.float32
    check_tensor(src, "src", (B, Nsrc, 3 + D), f32, dev)
    check_tensor(dst, "dst", (B, N, 3 + D), f32, dev)
    check_tensor(he, "he", (B, N, K, E), f32, dev)
    check_tensor(nbr, "nbr", (B, N, K), torch.int32, dev)
    check_tensor(msk, "msk", (B, N, K), f32, dev)
    for name, shape in param_shapes(D, E).items():
        check_tensor(params[name], name, shape, f32, dev)
    return B, Nsrc, N, K, D, E


def _param_ptrs(params):
    return [params[n].data_ptr() for n in PARAM_NAMES]


def _launch_fwd(src, dst, he, nbr, msk, params, slope, use_ln, use_dist):
    B, Nsrc, N, K, D, E = _check_inputs(src, dst, he, nbr, msk, params)
    dev = src.device
    aggr = torch.empty((B, N, D), dtype=torch.float32, device=dev)
    xupd = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_fns()[0](
            src.data_ptr(), dst.data_ptr(), he.data_ptr(), nbr.data_ptr(),
            msk.data_ptr(), *_param_ptrs(params), aggr.data_ptr(), xupd.data_ptr(),
            B, Nsrc, N, K, D, E, float(slope), int(use_ln), int(use_dist),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "edge_message")
    global launches
    launches += 1
    return aggr, xupd


def bwd_blocks(B: int, N: int, D: int = 64) -> int:
    """Grid size of the backward kernel: one block per 256 / D nodes, at
    most BWD_MAX_BLOCKS (each block writes one set of partials)."""
    return min(-(-B * N // (BLOCK_THREADS // D)), BWD_MAX_BLOCKS)


def inverse_neighbors(nbr, Nsrc: int):
    """(order, offsets), int32: the flat edge indices (b, i, k) sorted
    stably by their src row b * Nsrc + nbr[b, i, k], and where each of the
    B * Nsrc rows starts in `order` (offsets[-1] = B * N * K). A stable sort
    and a binary search: both deterministic, no atomics."""
    B = nbr.shape[0]
    rows = (nbr.long() + Nsrc * torch.arange(B, device=nbr.device)[:, None, None]).reshape(-1)
    sorted_rows, order = torch.sort(rows, stable=True)
    offsets = torch.searchsorted(sorted_rows, torch.arange(B * Nsrc + 1, device=nbr.device))
    return order.to(torch.int32), offsets.to(torch.int32)


def scatter_src_plain(nbr, Nsrc: int, dgx, dgh):
    """Plain version of the scatter kernel: `index_add_`, the transpose of
    the gather (sequential on the CPU; on the card it adds with atomics in
    no fixed order)."""
    B, N, K = nbr.shape
    C = 3 + dgh.shape[-1]
    rows = (nbr.long() + Nsrc * torch.arange(B, device=nbr.device)[:, None, None]).reshape(-1)
    d_src = torch.zeros((B * Nsrc, C), dtype=dgh.dtype, device=dgh.device)
    d_src.index_add_(0, rows, torch.cat([dgx, dgh], dim=-1).reshape(B * N * K, C))
    return d_src.reshape(B, Nsrc, C)


def launch_scatter(nbr, Nsrc: int, dgx, dgh):
    """The scatter kernel on contiguous CUDA operands, not counted (each
    caller counts its own launches): d_src (B, Nsrc, 3 + D) with each row's
    edges summed in ascending edge order, the same bits from run to run."""
    B, D = nbr.shape[0], dgh.shape[-1]
    order, offsets = inverse_neighbors(nbr, Nsrc)
    d_src = torch.empty((B, Nsrc, 3 + D), dtype=torch.float32, device=dgh.device)
    with torch.cuda.device(dgh.device):
        err = _kernel_fns()[2](order.data_ptr(), offsets.data_ptr(), dgx.data_ptr(),
                               dgh.data_ptr(), d_src.data_ptr(), B * Nsrc, D,
                               torch.cuda.current_stream(dgh.device).cuda_stream)
    check_launch(err, "edge_message bwd scatter")
    return d_src


def scatter_src(nbr, Nsrc: int, dgx, dgh):
    """d_src (B, Nsrc, 3 + D): the per-edge cotangents [dgx | dgh] summed
    onto their src rows. CUDA tensors launch the scatter kernel, which sums
    each row's edges in ascending edge order, so the sums are the same from
    run to run; CPU tensors take the plain version."""
    if dgh.device.type == "cpu":
        return scatter_src_plain(nbr, Nsrc, dgx, dgh)
    d_src = launch_scatter(nbr, Nsrc, dgx, dgh)
    global scatter_launches
    scatter_launches += 1
    return d_src


def assemble_bwd(nbr, Nsrc: int, dgx, dgh, dhe, ddx, ddh, partials: Dict[str, torch.Tensor]):
    """The backward kernel's outputs -> (d_src, d_dst, d_he, d_params): the
    per-edge cotangents [dgx | dgh] go onto their src rows through
    `scatter_src` (the transpose of the gather), and the per-block parameter
    partials (blocks, *shape) are summed, as the JAX package does outside its
    kernel. Every sum runs in a fixed order, so all of it is bit-reproducible
    from run to run."""
    B, N, K = nbr.shape
    shapes = param_shapes(dgh.shape[-1], dhe.shape[-1])
    d_params = {n: partials[n].sum(dim=0).reshape(shapes[n]) for n in PARAM_NAMES}
    return (scatter_src(nbr, Nsrc, dgx, dgh), torch.cat([ddx, ddh], dim=-1),
            dhe.reshape(B, N, K, dhe.shape[-1]), d_params)


def edge_message_bwd_kernel(src, dst, he, nbr, msk, params, g_aggr, g_xupd,
                            slope: float = 0.01, use_ln: bool = True, use_dist: bool = True):
    """Launch the backward kernel on CUDA operands; its raw outputs
    (dgx, dgh, dhe, ddx, ddh, per-block partials by parameter name)."""
    B, Nsrc, N, K, D, E = _check_inputs(src, dst, he, nbr, msk, params)
    dev, f32 = src.device, torch.float32
    check_tensor(g_aggr, "g_aggr", (B, N, D), f32, dev)
    check_tensor(g_xupd, "g_xupd", (B, N, 3), f32, dev)
    blocks = bwd_blocks(B, N, D)
    new = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    dgx, dgh, dhe = new(B, N * K, 3), new(B, N * K, D), new(B, N * K, E)
    ddx, ddh = new(B, N, 3), new(B, N, D)
    partials = {n: new(blocks, *s) for n, s in param_shapes(D, E).items()}
    partials["W2c"] = new(blocks, D)
    partials["b2c"] = new(blocks)
    with torch.cuda.device(dev):
        err = _kernel_fns()[1](
            src.data_ptr(), dst.data_ptr(), he.data_ptr(), nbr.data_ptr(),
            msk.data_ptr(), *_param_ptrs(params), g_aggr.data_ptr(), g_xupd.data_ptr(),
            dgx.data_ptr(), dgh.data_ptr(), dhe.data_ptr(), ddx.data_ptr(), ddh.data_ptr(),
            *_param_ptrs(partials), B, Nsrc, N, K, D, E, float(slope), int(use_ln),
            int(use_dist), blocks, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "edge_message bwd")
    global bwd_launches
    bwd_launches += 1
    return dgx, dgh, dhe, ddx, ddh, partials


def edge_message_bwd(src, dst, he, nbr, msk, params, g_aggr, g_xupd,
                     slope: float = 0.01, use_ln: bool = True, use_dist: bool = True):
    """(d_src, d_dst, d_he, d_params) of the forward for the cotangents
    g_aggr (B, N, D) and g_xupd (B, N, 3). CPU tensors take the plain
    version; CUDA tensors launch the backward kernel or raise."""
    if src.device.type == "cpu":
        return edge_message_bwd_plain(src, dst, he, nbr, msk, params, g_aggr, g_xupd,
                                      slope, use_ln, use_dist)
    out = edge_message_bwd_kernel(src, dst, he, nbr, msk, params, g_aggr, g_xupd,
                                  slope, use_ln, use_dist)
    return assemble_bwd(nbr, src.shape[1], *out)


class _EdgeMessage(torch.autograd.Function):
    """Forward kernel; backward through the backward kernel, which recomputes
    the forward from the saved inputs (nothing per edge is kept)."""

    @staticmethod
    def forward(ctx, src, dst, he, nbr, msk, slope, use_ln, use_dist, *pvals):
        params = dict(zip(PARAM_NAMES, pvals))
        ctx.save_for_backward(src, dst, he, nbr, msk, *pvals)
        ctx.options = (slope, use_ln, use_dist)
        return _launch_fwd(src, dst, he, nbr, msk, params, slope, use_ln, use_dist)

    @staticmethod
    def backward(ctx, g_aggr, g_xupd):
        src, dst, he, nbr, msk, *pvals = ctx.saved_tensors
        d_src, d_dst, d_he, dp = edge_message_bwd(
            src, dst, he, nbr, msk, dict(zip(PARAM_NAMES, pvals)), g_aggr.contiguous(),
            g_xupd.contiguous(), *ctx.options)
        return (d_src, d_dst, d_he, None, None, None, None, None,
                *(dp[n] for n in PARAM_NAMES))


def edge_message_aggregate(src, dst, he, nbr, msk, params, slope: float = 0.01,
                           use_ln: bool = True, use_dist: bool = True):
    """(aggr (B, N, D), x_upd (B, N, 3)), differentiable in src, dst, he and
    the params. CPU tensors take the plain version; CUDA tensors launch the
    kernels or raise."""
    if src.device.type == "cpu":
        return edge_message_plain(src, dst, he, nbr, msk, params, slope,
                                  use_ln, use_dist)
    if src.device.type != "cuda":
        raise ValueError(f"edge_message: unsupported device {src.device}")
    return _EdgeMessage.apply(src, dst, he, nbr, msk, float(slope), bool(use_ln),
                              bool(use_dist), *(params[n] for n in PARAM_NAMES))
