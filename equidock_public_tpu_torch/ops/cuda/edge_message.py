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
bit-reproducible from run to run. Both kernels work on tiles of whole
destination nodes (`edge_tile_plan`); see `csrc/edge_tiles.cuh` and the
kernels' sources for their design and bound.

The scatter reads the inverse neighbour list (`inverse_neighbors`: a stable
sort of the flat src rows). `nbr` is the same for every layer of a side, so
the model builds the list once per side per forward that records gradients
and passes it to `edge_message_aggregate`, which keeps it for the backward;
a backward given none builds its own. A forward without gradients builds
none: nothing would read it.

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
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ...ops.segment import gather_neighbors
from ._build import check_launch, check_tensor, load_library, outputs

RBF_SIGMAS = tuple(1.5 ** x for x in range(15))
N_RBF = len(RBF_SIGMAS)
# The D the kernels are built for: the paper models' hidden width and the
# small DB5 models'
KERNEL_WIDTHS = (16, 64)
MAX_EDGE_FEATS = 32  # largest E the kernels take (the models use 27)
TILE_ROWS = 64       # edge rows of a kernel tile: the K in-edges of 64 // K nodes
SMS = 132            # streaming multiprocessors of an H100 SXM
FWD_MAX_BLOCKS = 1024
# One backward block an SM (184 KB of shared memory at D = 64; at D = 16 one
# an SM also beat two to four run in waves), each walking its share of the
# kept tiles and writing one set of parameter partials.
BWD_MAX_BLOCKS = SMS

# Launches of each CUDA kernel in this process (plain-version calls excluded).
launches = 0          # forward
bwd_launches = 0      # backward
scatter_launches = 0  # the backward's d_src sum, one per backward
inverse_builds = 0    # inverse neighbour lists built (`inverse_neighbors`), any device


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
    fwd.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 6
                    + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 6
                    + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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


def edge_tile_plan(B: int, N: int, D: int, K: int, backward: bool = True,
                   tile_nodes: int = 0) -> Tuple[int, int]:
    """(destination nodes a tile, grid blocks) of the edge kernels at hidden
    width D (the plan is the same at both widths): tiles of TILE_ROWS // K
    whole nodes of one graph (or `tile_nodes`), B * ceil(N / nodes) of them.
    The forward deals all tiles to at most FWD_MAX_BLOCKS blocks in turn
    (a block a tile at the models' shapes); the backward deals the tiles
    that keep an edge, and apart the others, to at most BWD_MAX_BLOCKS
    blocks in turn, each writing one set of parameter partials."""
    tn = tile_nodes or TILE_ROWS // K
    if not 0 < tn * K <= TILE_ROWS:
        raise ValueError(f"edge kernels: {tn} nodes of K={K} edges exceed a tile of "
                         f"{TILE_ROWS} rows")
    cap = BWD_MAX_BLOCKS if backward else FWD_MAX_BLOCKS
    return tn, min(n_tiles(B, N, tn), cap)


def n_tiles(B: int, N: int, tile_nodes: int) -> int:
    """Tiles of tile_nodes destination nodes over B graphs of N nodes."""
    return B * -(-N // tile_nodes)


def tile_keep(msk, tile_nodes: int):
    """(B * ceil(N / tile_nodes),) uint8: 1 for each tile of tile_nodes
    destination nodes with an edge of m != 0. Plain version of the flags the
    forward kernel writes, which the backward kernel deals its tiles by."""
    B, N, K = msk.shape
    tiles = n_tiles(B, N, tile_nodes)
    nz = F.pad((msk != 0).to(torch.uint8), (0, 0, 0, tiles // B * tile_nodes - N))
    return nz.reshape(tiles, tile_nodes * K).amax(dim=1).contiguous()


def _launch_fwd(src, dst, he, nbr, msk, params, slope, use_ln, use_dist, tile_nodes=0,
                out=None, kept=None):
    """The forward kernel; `out`: (aggr, xupd) to write into, else fresh;
    `kept`: a (tiles,) uint8 tensor the kernel fills with `tile_keep`'s
    flags, or None."""
    B, Nsrc, N, K, D, E = _check_inputs(src, dst, he, nbr, msk, params)
    tn, blocks = edge_tile_plan(B, N, D, K, backward=False, tile_nodes=tile_nodes)
    dev = src.device
    aggr, xupd = outputs(((B, N, D), (B, N, 3)), dev, out, "edge_message")
    if kept is not None:
        check_tensor(kept, "kept", (n_tiles(B, N, tn),), torch.uint8, dev)
    with torch.cuda.device(dev):
        err = _kernel_fns()[0](
            src.data_ptr(), dst.data_ptr(), he.data_ptr(), nbr.data_ptr(),
            msk.data_ptr(), *_param_ptrs(params), aggr.data_ptr(), xupd.data_ptr(),
            None if kept is None else kept.data_ptr(), B, Nsrc, N, K, D, E, float(slope),
            int(use_ln), int(use_dist), tn, blocks, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "edge_message")
    global launches
    launches += 1
    return aggr, xupd


def inverse_neighbors(nbr, Nsrc: int):
    """(order, offsets), int32: the flat edge indices (b, i, k) sorted
    stably by their src row b * Nsrc + nbr[b, i, k], and where each of the
    B * Nsrc rows starts in `order` (offsets[-1] = B * N * K). A stable sort
    and a binary search: both deterministic, no atomics. Counted in
    `inverse_builds` on every device."""
    global inverse_builds
    inverse_builds += 1
    B, dev = nbr.shape[0], nbr.device
    # 32-bit keys (B * Nsrc rows fit): half the radix passes of 64-bit ones
    rows = (nbr.to(torch.int32)
            + Nsrc * torch.arange(B, device=dev, dtype=torch.int32)[:, None, None]).reshape(-1)
    sorted_rows, order = torch.sort(rows, stable=True)
    offsets = torch.searchsorted(sorted_rows,
                                 torch.arange(B * Nsrc + 1, device=dev, dtype=torch.int32))
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


def _check_inverse(inverse, nbr, Nsrc: int):
    order, offsets = inverse
    dev = nbr.device
    check_tensor(order, "inverse order", (nbr.numel(),), torch.int32, dev)
    check_tensor(offsets, "inverse offsets", (nbr.shape[0] * Nsrc + 1,), torch.int32, dev)
    return order, offsets


def launch_scatter(nbr, Nsrc: int, dgx, dgh, inverse=None):
    """The scatter kernel on contiguous CUDA operands, not counted (each
    caller counts its own launches): d_src (B, Nsrc, 3 + D) with each row's
    edges summed in ascending edge order, the same bits from run to run.
    `inverse`: nbr's (order, offsets) from `inverse_neighbors`, built here
    when None."""
    B, D = nbr.shape[0], dgh.shape[-1]
    order, offsets = (inverse_neighbors(nbr, Nsrc) if inverse is None
                      else _check_inverse(inverse, nbr, Nsrc))
    d_src = torch.empty((B, Nsrc, 3 + D), dtype=torch.float32, device=dgh.device)
    with torch.cuda.device(dgh.device):
        err = _kernel_fns()[2](order.data_ptr(), offsets.data_ptr(), dgx.data_ptr(),
                               dgh.data_ptr(), d_src.data_ptr(), B * Nsrc, D,
                               torch.cuda.current_stream(dgh.device).cuda_stream)
    check_launch(err, "edge_message bwd scatter")
    return d_src


def scatter_src(nbr, Nsrc: int, dgx, dgh, inverse=None):
    """d_src (B, Nsrc, 3 + D): the per-edge cotangents [dgx | dgh] summed
    onto their src rows. CUDA tensors launch the scatter kernel, which sums
    each row's edges in ascending edge order (through `inverse`, or a list
    built here), so the sums are the same from run to run; CPU tensors take
    the plain version."""
    if dgh.device.type == "cpu":
        return scatter_src_plain(nbr, Nsrc, dgx, dgh)
    d_src = launch_scatter(nbr, Nsrc, dgx, dgh, inverse)
    global scatter_launches
    scatter_launches += 1
    return d_src


def partial_layout(D: int, E: int) -> Dict[str, Tuple[int, int]]:
    """(offset, size) of each parameter's flat gradient in a row of the
    backward kernel's partials, in PARAM_NAMES order (as the kernel writes
    them)."""
    out, o = {}, 0
    for n in PARAM_NAMES:
        size = math.prod(param_shapes(D, E)[n])
        out[n] = (o, size)
        o += size
    return out


def assemble_bwd(nbr, Nsrc: int, dgx, dgh, dhe, d_dst, part, inverse=None):
    """The backward kernel's outputs -> (d_src, d_dst, d_he, d_params): the
    per-edge cotangents [dgx | dgh] go onto their src rows through
    `scatter_src` (the transpose of the gather), and the per-block parameter
    partials (blocks, partial floats) are summed over the blocks in one
    reduction, as the JAX package sums its partials outside its kernel. Every
    sum runs in a fixed order, so all of it is bit-reproducible from run to
    run."""
    B, N, K = nbr.shape
    D, E = dgh.shape[-1], dhe.shape[-1]
    total = part.sum(dim=0)
    d_params = {n: total[o:o + size].reshape(param_shapes(D, E)[n])
                for n, (o, size) in partial_layout(D, E).items()}
    return (scatter_src(nbr, Nsrc, dgx, dgh, inverse), d_dst,
            dhe.reshape(B, N, K, E), d_params)


def bwd_output_shapes(B: int, N: int, K: int, D: int, E: int, blocks: int):
    """Shapes of the backward kernel's outputs: dgx, dgh, dhe, d_dst and the
    per-block partials (a row of `partial_layout` a block)."""
    floats = sum(size for _, size in partial_layout(D, E).values())
    return [(B, N * K, 3), (B, N * K, D), (B, N * K, E), (B, N, 3 + D), (blocks, floats)]


def edge_message_bwd_kernel(src, dst, he, nbr, msk, params, g_aggr, g_xupd,
                            slope: float = 0.01, use_ln: bool = True, use_dist: bool = True,
                            tile_nodes: int = 0, out=None, kept=None):
    """Launch the backward kernel on CUDA operands; its raw outputs
    (dgx, dgh, dhe, d_dst, per-block partials (blocks, floats)).
    `out`: tensors of `bwd_output_shapes` to write into, else fresh; `kept`:
    the forward's tile flags, else `tile_keep`'s."""
    B, Nsrc, N, K, D, E = _check_inputs(src, dst, he, nbr, msk, params)
    dev, f32 = src.device, torch.float32
    check_tensor(g_aggr, "g_aggr", (B, N, D), f32, dev)
    check_tensor(g_xupd, "g_xupd", (B, N, 3), f32, dev)
    tn, blocks = edge_tile_plan(B, N, D, K, tile_nodes=tile_nodes)
    if kept is None:
        kept = tile_keep(msk, tn)
    check_tensor(kept, "kept", (n_tiles(B, N, tn),), torch.uint8, dev)
    outs = outputs(bwd_output_shapes(B, N, K, D, E, blocks), dev, out, "edge_message bwd")
    with torch.cuda.device(dev):
        err = _kernel_fns()[1](
            src.data_ptr(), dst.data_ptr(), he.data_ptr(), nbr.data_ptr(),
            msk.data_ptr(), *_param_ptrs(params), g_aggr.data_ptr(), g_xupd.data_ptr(),
            kept.data_ptr(), *(t.data_ptr() for t in outs), B, Nsrc, N, K, D, E,
            float(slope), int(use_ln), int(use_dist), blocks, tn,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "edge_message bwd")
    global bwd_launches
    bwd_launches += 1
    return tuple(outs)


def edge_message_bwd(src, dst, he, nbr, msk, params, g_aggr, g_xupd,
                     slope: float = 0.01, use_ln: bool = True, use_dist: bool = True,
                     inverse=None, kept=None):
    """(d_src, d_dst, d_he, d_params) of the forward for the cotangents
    g_aggr (B, N, D) and g_xupd (B, N, 3). CPU tensors take the plain
    version (and ignore `inverse` and `kept`); CUDA tensors launch the
    backward kernel (its tiles dealt by `kept`, the forward's tile flags, or
    `tile_keep`'s) and the scatter, through `inverse` (nbr's inverse
    neighbour list) or one built here, or raise."""
    if src.device.type == "cpu":
        return edge_message_bwd_plain(src, dst, he, nbr, msk, params, g_aggr, g_xupd,
                                      slope, use_ln, use_dist)
    out = edge_message_bwd_kernel(src, dst, he, nbr, msk, params, g_aggr, g_xupd,
                                  slope, use_ln, use_dist, kept=kept)
    return assemble_bwd(nbr, src.shape[1], *out, inverse=inverse)


class _EdgeMessage(torch.autograd.Function):
    """Forward kernel; backward through the backward kernel, which recomputes
    the forward from the saved inputs (nothing per edge is kept) on the tiles
    the forward flagged, and the scatter through the inverse neighbour list
    given to the forward."""

    @staticmethod
    def forward(ctx, src, dst, he, nbr, msk, order, offsets, slope, use_ln, use_dist,
                *pvals):
        params = dict(zip(PARAM_NAMES, pvals))
        B, N, K = nbr.shape
        tn = edge_tile_plan(B, N, src.shape[-1] - 3, K)[0]
        kept = torch.empty(n_tiles(B, N, tn), dtype=torch.uint8, device=src.device)
        out = _launch_fwd(src, dst, he, nbr, msk, params, slope, use_ln, use_dist, kept=kept)
        ctx.save_for_backward(src, dst, he, nbr, msk, order, offsets, kept, *pvals)
        ctx.options = (slope, use_ln, use_dist)
        return out

    @staticmethod
    def backward(ctx, g_aggr, g_xupd):
        src, dst, he, nbr, msk, order, offsets, kept, *pvals = ctx.saved_tensors
        d_src, d_dst, d_he, dp = edge_message_bwd(
            src, dst, he, nbr, msk, dict(zip(PARAM_NAMES, pvals)), g_aggr.contiguous(),
            g_xupd.contiguous(), *ctx.options,
            inverse=None if order is None else (order, offsets), kept=kept)
        return (d_src, d_dst, d_he, None, None, None, None, None, None, None,
                *(dp[n] for n in PARAM_NAMES))


def edge_message_aggregate(src, dst, he, nbr, msk, params, slope: float = 0.01,
                           use_ln: bool = True, use_dist: bool = True, inverse=None):
    """(aggr (B, N, D), x_upd (B, N, 3)), differentiable in src, dst, he and
    the params. CPU tensors take the plain version (`inverse` unused); CUDA
    tensors launch the kernels or raise. `inverse`: (order, offsets) of nbr
    from `inverse_neighbors(nbr, src.shape[1])`, kept for the backward's
    scatter, which builds its own when it is None."""
    if src.device.type == "cpu":
        return edge_message_plain(src, dst, he, nbr, msk, params, slope,
                                  use_ln, use_dist)
    if src.device.type != "cuda":
        raise ValueError(f"edge_message: unsupported device {src.device}")
    order, offsets = (None, None) if inverse is None else _check_inverse(inverse, nbr,
                                                                        src.shape[1])
    return _EdgeMessage.apply(src, dst, he, nbr, msk, order, offsets, float(slope),
                              bool(use_ln), bool(use_dist),
                              *(params[n] for n in PARAM_NAMES))
