"""Masked cross-attention, forward and backward: CUDA kernels
`csrc/cross_attention.cu` (forward and its combine pass) and
`csrc/cross_attention_bwd.cu` (dQ and dK/dV, each with its combine pass),
their plain PyTorch versions, and the `torch.autograd.Function` that joins
them.

Replaces `_fwd_kernel`, `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
`equidock_public_tpu/ops/pallas/cross_attention.py`:
o = softmax(a) V and lse = logsumexp(a) with
a = mask * (Q K^T) - 1000 * (1 - mask), mask = (q_tag > 0) & (q_tag == k_tag).
Tags are the 0/1 node masks, or (segment id + 1) * mask for packed slots.
Keys run over exactly M, so every row, padded rows included, equals the
oracle `ops/attention.py::cross_attention`. The backward takes
delta = rowsum(dO * O) as a torch op, as the JAX package does outside its
kernels, then launches the dQ and dK/dV kernels; tags get no gradient.

All three kernels work on 64-row tiles and skip the dense work of the tile
pairs that keep no (query, key) pair: the forward and dK/dV take those in
closed form, and dQ, which gets exactly nothing from them, skips them. Each
splits the walked axis (keys for the forward and dQ, queries for dK/dV)
across blocks where the grid would leave the card under-filled; each split
writes partial results to scratch that a combine kernel merges in a fixed
order (no atomics, the same bits on every launch).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import check_launch, check_tensor, load_library

MAX_WIDTH = 96   # largest D / Dv the kernels are built for (layer 0 is 69 wide)
TILE = 64        # rows of a query tile and of a key tile (csrc/attention_tiles.cuh)
# Blocks a SM the splits aim at (each kernel holds one block a SM: about 200
# registers a thread for the forward, 141 KB of shared memory for dK/dV and
# 123 KB for dQ at D = 64). Tile pairs that keep nothing finish early, so
# the forward takes several waves and dK/dV and dQ two. On an H100
# (scripts/attention_tiles_check.py) these pick one key tile a block at
# 512x1024 and 512x512, 4 query-tile runs for dK/dV and 4 key-tile splits
# for dQ at B = 10, 512x512: near the fastest count swept at D 64 and 69.
FWD_SPLIT_TARGET = 8
DKV_SPLIT_TARGET = 2
DQ_SPLIT_TARGET = 2

# Launches of each CUDA kernel in this process (plain-version calls excluded).
launches = 0                # forward
combine_launches = 0        # forward, the merge of the key splits (one per forward)
dq_launches = 0             # backward, dQ
dq_combine_launches = 0     # backward, the sum of dQ's key splits (one per dQ)
dkv_launches = 0            # backward, dK and dV
dkv_combine_launches = 0    # backward, the sum of the query splits (one per dK/dV)


def cross_attention_plain(q, k, v, q_tag, k_tag) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (o (B, N, Dv), lse (B, N))."""
    qt = q_tag[:, :, None]
    mask = ((qt > 0) & (qt == k_tag[:, None, :])).to(q.dtype)
    a = mask * torch.matmul(q, k.transpose(1, 2)) - 1000.0 * (1.0 - mask)
    return torch.matmul(torch.softmax(a, dim=-1), v), torch.logsumexp(a, dim=-1)


def cross_attention_bwd_plain(q, k, v, q_tag, k_tag, dout):
    """Plain backward: (dq, dk, dv) by autograd through the plain forward."""
    with torch.enable_grad():
        qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o, _ = cross_attention_plain(*qkv, q_tag, k_tag)
        return torch.autograd.grad(o, qkv, dout)


def fwd_combine_plain(part_m, part_l, part_acc) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward's combine pass: (o, lse) from the key
    splits' running max, sum and accumulator (B, splits, N[, Dv])."""
    mx = part_m.max(dim=1).values
    w = torch.exp(part_m - mx[:, None])
    l = (part_l * w).sum(dim=1)
    return (part_acc * w[..., None]).sum(dim=1) / l[..., None], mx + torch.log(l)


def split_sum_plain(*parts) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward's combine passes: each (B, splits, rows,
    width) partial summed over its splits."""
    return tuple(p.sum(dim=1) for p in parts)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = load_library()
    fns = {name: getattr(lib, f"equidock_cross_attention_{name}")
           for name in ("fwd", "combine", "dq", "dq_combine", "dkv", "dkv_combine")}
    ptr, num = ctypes.c_void_p, ctypes.c_int
    fns["fwd"].argtypes = [ptr] * 8 + [num] * 6 + [ptr]
    fns["combine"].argtypes = [ptr] * 5 + [num] * 4 + [ptr]
    fns["dq"].argtypes = [ptr] * 9 + [num] * 6 + [ptr]
    fns["dq_combine"].argtypes = [ptr] * 2 + [num] * 4 + [ptr]
    fns["dkv"].argtypes = [ptr] * 10 + [num] * 6 + [ptr]
    fns["dkv_combine"].argtypes = [ptr] * 4 + [num] * 5 + [ptr]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_splits(blocks: int, tiles: int, target: int) -> int:
    """Runs of equal length, none empty, into which to cut `tiles` tiles so
    that `blocks` x runs reaches `target` blocks (one tile a run at most).
    dQ deals its key tiles to that many splits in turn instead."""
    want = min(tiles, max(1, -(-target // blocks)))
    per_run = -(-tiles // want)
    return -(-tiles // per_run)


def _tiles(n: int) -> int:
    return -(-n // TILE)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(name: str, err_name: str, dev, *args) -> None:
    with torch.cuda.device(dev):
        err = _kernel_fns()[name](*args, _stream(dev))
    check_launch(err, err_name)


def _ptrs(*ts):
    return [x.data_ptr() for x in ts]


def _check_inputs(q, k, v, q_tag, k_tag):
    """(B, N, M, D, Dv) after checking the operands the kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention: unsupported device {q.device}")
    B, N, D = q.shape
    M, Dv = k.shape[1], v.shape[2]
    if max(D, Dv) > MAX_WIDTH:
        raise ValueError(f"cross_attention kernel: D={D}, Dv={Dv} > {MAX_WIDTH}")
    dev, f32 = q.device, torch.float32
    check_tensor(q, "q", (B, N, D), f32, dev)
    check_tensor(k, "k", (B, M, D), f32, dev)
    check_tensor(v, "v", (B, M, Dv), f32, dev)
    check_tensor(q_tag, "q_tag", (B, N), f32, dev)
    check_tensor(k_tag, "k_tag", (B, M), f32, dev)
    return B, N, M, D, Dv


def _check_parts(*parts) -> None:
    """The partials a combine pass takes: contiguous f32 CUDA tensors of one
    (B, splits, rows) on one device."""
    for i, p in enumerate(parts):
        if p.device.type != "cuda" or p.shape[:3] != parts[0].shape[:3]:
            raise ValueError(f"combine: part {i} of shape {tuple(p.shape)} on {p.device}")
        check_tensor(p, f"part {i}", p.shape, torch.float32, parts[0].device)


def fwd_partials(q, k, v, q_tag, k_tag, splits: Optional[int] = None):
    """Launch the forward kernel on checked CUDA operands; each key split's
    running max and sum (B, splits, N) and accumulator (B, splits, N, Dv).
    `splits` (key-tile runs, one block each) defaults to what fills the card."""
    B, N, M, D, Dv = _check_inputs(q, k, v, q_tag, k_tag)
    dev, f32 = q.device, torch.float32
    if splits is None:
        splits = tile_splits(B * _tiles(N), _tiles(M), FWD_SPLIT_TARGET * _sm_count(dev.index))
    parts = (torch.empty((B, splits, N), dtype=f32, device=dev),
             torch.empty((B, splits, N), dtype=f32, device=dev),
             torch.empty((B, splits, N, Dv), dtype=f32, device=dev))
    _launch("fwd", "cross_attention", dev, *_ptrs(q, k, v, q_tag, k_tag, *parts),
            B, N, M, D, Dv, splits)
    global launches
    launches += 1
    return parts


def fwd_combine(part_m, part_l, part_acc):
    """Launch the forward's combine pass; (o (B, N, Dv), lse (B, N)). CPU
    tensors take the plain version."""
    if part_acc.device.type == "cpu":
        return fwd_combine_plain(part_m, part_l, part_acc)
    _check_parts(part_m, part_l, part_acc)
    B, splits, N, Dv = part_acc.shape
    o = torch.empty((B, N, Dv), dtype=torch.float32, device=part_acc.device)
    lse = torch.empty((B, N), dtype=torch.float32, device=part_acc.device)
    _launch("combine", "cross_attention combine", part_acc.device,
            *_ptrs(part_m, part_l, part_acc, o, lse), B, N, Dv, splits)
    global combine_launches
    combine_launches += 1
    return o, lse


def _launch_fwd(q, k, v, q_tag, k_tag, splits: Optional[int] = None):
    """The forward kernel and its combine pass on checked CUDA operands;
    (o, lse)."""
    return fwd_combine(*fwd_partials(q, k, v, q_tag, k_tag, splits))


def dq_partials(q, k, v, q_tag, k_tag, lse, dout, delta, splits: Optional[int] = None):
    """Launch the dQ kernel on checked CUDA operands; each key split's
    partial dQ (B, splits, N, D). `splits` (key-tile runs) defaults to what
    fills the card."""
    B, N, D = q.shape
    M, Dv = k.shape[1], v.shape[2]
    dev = q.device
    if splits is None:
        splits = tile_splits(B * _tiles(N), _tiles(M), DQ_SPLIT_TARGET * _sm_count(dev.index))
    part = torch.empty((B, splits, N, D), dtype=torch.float32, device=dev)
    _launch("dq", "cross_attention dq", dev,
            *_ptrs(q, k, v, q_tag, k_tag, lse, dout, delta, part), B, N, M, D, Dv, splits)
    global dq_launches
    dq_launches += 1
    return part


def dq_combine(part):
    """Launch dQ's combine pass: dq (B, N, D), the splits summed in order.
    CPU tensors take the plain version."""
    if part.device.type == "cpu":
        return split_sum_plain(part)[0]
    _check_parts(part)
    B, splits, N, D = part.shape
    dq = torch.empty((B, N, D), dtype=torch.float32, device=part.device)
    _launch("dq_combine", "cross_attention dq combine", part.device, *_ptrs(part, dq),
            B, N, D, splits)
    global dq_combine_launches
    dq_combine_launches += 1
    return dq


def cross_attention_dq(q, k, v, q_tag, k_tag, lse, dout, delta,
                       splits: Optional[int] = None):
    """The dQ kernel and its combine pass on checked CUDA operands; dq."""
    return dq_combine(dq_partials(q, k, v, q_tag, k_tag, lse, dout, delta, splits))


def dkv_partials(q, k, v, q_tag, k_tag, lse, dout, delta, splits: Optional[int] = None):
    """Launch the dK/dV kernel on checked CUDA operands; each query split's
    partial dK (B, splits, M, D) and dV (B, splits, M, Dv). `splits`
    (query-tile runs) defaults to what fills the card."""
    B, N, D = q.shape
    M, Dv = k.shape[1], v.shape[2]
    dev, f32 = q.device, torch.float32
    if splits is None:
        splits = tile_splits(B * _tiles(M), _tiles(N), DKV_SPLIT_TARGET * _sm_count(dev.index))
    parts = (torch.empty((B, splits, M, D), dtype=f32, device=dev),
             torch.empty((B, splits, M, Dv), dtype=f32, device=dev))
    _launch("dkv", "cross_attention dkv", dev,
            *_ptrs(q, k, v, q_tag, k_tag, lse, dout, delta, *parts), B, N, M, D, Dv, splits)
    global dkv_launches
    dkv_launches += 1
    return parts


def dkv_combine(part_k, part_v):
    """Launch dK/dV's combine pass: (dk, dv), the splits summed in order.
    CPU tensors take the plain version."""
    if part_k.device.type == "cpu":
        return split_sum_plain(part_k, part_v)
    _check_parts(part_k, part_v)
    B, splits, M, D = part_k.shape
    Dv = part_v.shape[3]
    dk = torch.empty((B, M, D), dtype=torch.float32, device=part_k.device)
    dv = torch.empty((B, M, Dv), dtype=torch.float32, device=part_k.device)
    _launch("dkv_combine", "cross_attention dkv combine", part_k.device,
            *_ptrs(part_k, part_v, dk, dv), B, M, D, Dv, splits)
    global dkv_combine_launches
    dkv_combine_launches += 1
    return dk, dv


def cross_attention_dkv(q, k, v, q_tag, k_tag, lse, dout, delta,
                        splits: Optional[int] = None):
    """The dK/dV kernel and its combine pass on checked CUDA operands;
    (dk, dv)."""
    return dkv_combine(*dkv_partials(q, k, v, q_tag, k_tag, lse, dout, delta, splits))


def cross_attention_bwd(q, k, v, q_tag, k_tag, o, lse, dout):
    """(dq, dk, dv) of the forward's o for the cotangent dout, from the
    forward's o and lse. CPU tensors take the plain version; CUDA tensors
    launch the dQ and dK/dV kernels or raise."""
    if q.device.type == "cpu":
        return cross_attention_bwd_plain(q, k, v, q_tag, k_tag, dout)
    B, N, M, D, Dv = _check_inputs(q, k, v, q_tag, k_tag)
    dev, f32 = q.device, torch.float32
    check_tensor(o, "o", (B, N, Dv), f32, dev)
    check_tensor(lse, "lse", (B, N), f32, dev)
    check_tensor(dout, "dout", (B, N, Dv), f32, dev)
    delta = (dout * o).sum(dim=-1).contiguous()
    args = (q, k, v, q_tag, k_tag, lse, dout, delta)
    return (cross_attention_dq(*args), *cross_attention_dkv(*args))


class _CrossAttention(torch.autograd.Function):
    """Forward kernel; backward through the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, q_tag, k_tag):
        o, lse = _launch_fwd(q, k, v, q_tag, k_tag)
        ctx.save_for_backward(q, k, v, q_tag, k_tag, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, q_tag, k_tag, o, lse = ctx.saved_tensors
        dq, dk, dv = cross_attention_bwd(q, k, v, q_tag, k_tag, o, lse, dout.contiguous())
        return dq, dk, dv, None, None


def cross_attention_fwd(q, k, v, q_tag, k_tag) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse), differentiable in q, k and v. CPU tensors take the plain
    version; CUDA tensors launch the kernels or raise."""
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v, q_tag, k_tag)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention: unsupported device {q.device}")
    return _CrossAttention.apply(q, k, v, q_tag, k_tag)


def cross_attention_fused(q, k, v, q_mask, k_mask,
                          q_seg: Optional[torch.Tensor] = None,
                          k_seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for `ops.attention.cross_attention` (cross_msgs on); packed
    segment ids ride the mask operands as tags."""
    if q_seg is not None:
        q_mask = (q_seg.to(torch.float32) + 1.0) * q_mask
        k_mask = (k_seg.to(torch.float32) + 1.0) * k_mask
    return cross_attention_fwd(q, k, v, q_mask, k_mask)[0]
