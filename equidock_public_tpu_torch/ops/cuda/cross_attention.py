"""Masked cross-attention, forward and backward: CUDA kernels
`csrc/cross_attention.cu` (forward and its combine pass) and
`csrc/cross_attention_bwd.cu` (dQ; dK/dV and its combine pass), their plain
PyTorch versions, and the `torch.autograd.Function` that joins them.

Replaces `_fwd_kernel`, `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
`equidock_public_tpu/ops/pallas/cross_attention.py`:
o = softmax(a) V and lse = logsumexp(a) with
a = mask * (Q K^T) - 1000 * (1 - mask), mask = (q_tag > 0) & (q_tag == k_tag).
Tags are the 0/1 node masks, or (segment id + 1) * mask for packed slots.
Keys run over exactly M, so every row, padded rows included, equals the
oracle `ops/attention.py::cross_attention`. The backward takes
delta = rowsum(dO * O) as a torch op, as the JAX package does outside its
kernels, then launches the dQ and dK/dV kernels; tags get no gradient.

The forward and dK/dV kernels work on 64-row tiles and split the walked
axis (keys, queries) across blocks where the grid would leave the card
under-filled; each split writes partial results to scratch that a combine
kernel merges in a fixed order (no atomics, the same bits on every launch).
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
# registers a thread for the forward, 141 KB of shared memory for dK/dV at
# D = 64). Tile pairs that keep nothing finish early, so the forward takes
# several waves and dK/dV two. On an H100 (scripts/attention_tiles_check.py)
# these pick one key tile a block at 512x1024 and 512x512, and 4 query-tile
# runs for dK/dV at B = 10, 512x512: within 3% of the fastest count swept.
FWD_SPLIT_TARGET = 8
DKV_SPLIT_TARGET = 2

# Launches of each CUDA kernel in this process (plain-version calls excluded).
launches = 0                # forward
combine_launches = 0        # forward, the merge of the key splits (one per forward)
dq_launches = 0             # backward, dQ
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


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = load_library()
    fns = {name: getattr(lib, f"equidock_cross_attention_{name}")
           for name in ("fwd", "combine", "dq", "dkv", "dkv_combine")}
    ptr, num = ctypes.c_void_p, ctypes.c_int
    fns["fwd"].argtypes = [ptr] * 8 + [num] * 6 + [ptr]
    fns["combine"].argtypes = [ptr] * 5 + [num] * 4 + [ptr]
    fns["dq"].argtypes = [ptr] * 9 + [num] * 5 + [ptr]
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
    that `blocks` x runs reaches `target` blocks (one tile a run at most)."""
    want = min(tiles, max(1, -(-target // blocks)))
    per_run = -(-tiles // want)
    return -(-tiles // per_run)


def _tiles(n: int) -> int:
    return -(-n // TILE)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


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


def _launch_fwd(q, k, v, q_tag, k_tag, splits: Optional[int] = None):
    """Launch the forward and its combine pass on checked CUDA operands;
    (o, lse). `splits` (key-tile runs, one block each) defaults to what
    fills the card."""
    B, N, M, D, Dv = _check_inputs(q, k, v, q_tag, k_tag)
    dev, f32 = q.device, torch.float32
    if splits is None:
        splits = tile_splits(B * _tiles(N), _tiles(M), FWD_SPLIT_TARGET * _sm_count(dev.index))
    # each split's (m, l, acc) for every row
    part_m = torch.empty((B, splits, N), dtype=f32, device=dev)
    part_l = torch.empty((B, splits, N), dtype=f32, device=dev)
    part_acc = torch.empty((B, splits, N, Dv), dtype=f32, device=dev)
    o = torch.empty((B, N, Dv), dtype=f32, device=dev)
    lse = torch.empty((B, N), dtype=f32, device=dev)
    fns = _kernel_fns()
    scratch = [x.data_ptr() for x in (part_m, part_l, part_acc)]
    with torch.cuda.device(dev):
        err = fns["fwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(), q_tag.data_ptr(),
                         k_tag.data_ptr(), *scratch, B, N, M, D, Dv, splits, _stream(dev))
    check_launch(err, "cross_attention")
    global launches, combine_launches
    launches += 1
    with torch.cuda.device(dev):
        err = fns["combine"](*scratch, o.data_ptr(), lse.data_ptr(), B, N, Dv, splits,
                             _stream(dev))
    check_launch(err, "cross_attention combine")
    combine_launches += 1
    return o, lse


def cross_attention_dq(q, k, v, q_tag, k_tag, lse, dout, delta):
    """Launch the dQ kernel on checked CUDA operands; dq (B, N, D)."""
    B, N, D = q.shape
    M, Dv = k.shape[1], v.shape[2]
    dq = torch.empty((B, N, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel_fns()["dq"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_tag.data_ptr(), k_tag.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, N, M, D, Dv,
            _stream(q.device))
    check_launch(err, "cross_attention dq")
    global dq_launches
    dq_launches += 1
    return dq


def cross_attention_dkv(q, k, v, q_tag, k_tag, lse, dout, delta,
                        splits: Optional[int] = None):
    """Launch the dK/dV kernel and its combine pass on checked CUDA
    operands; (dk, dv). `splits` (query-tile runs) defaults to what fills
    the card."""
    B, N, D = q.shape
    M, Dv = k.shape[1], v.shape[2]
    dev, f32 = q.device, torch.float32
    if splits is None:
        splits = tile_splits(B * _tiles(M), _tiles(N), DKV_SPLIT_TARGET * _sm_count(dev.index))
    # each split's dK and dV for every key
    part_k = torch.empty((B, splits, M, D), dtype=f32, device=dev)
    part_v = torch.empty((B, splits, M, Dv), dtype=f32, device=dev)
    dk = torch.empty((B, M, D), dtype=f32, device=dev)
    dv = torch.empty((B, M, Dv), dtype=f32, device=dev)
    fns = _kernel_fns()
    scratch = [x.data_ptr() for x in (part_k, part_v)]
    with torch.cuda.device(dev):
        err = fns["dkv"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_tag.data_ptr(), k_tag.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), *scratch, B, N, M, D, Dv,
            splits, _stream(dev))
    check_launch(err, "cross_attention dkv")
    global dkv_launches, dkv_combine_launches
    dkv_launches += 1
    with torch.cuda.device(dev):
        err = fns["dkv_combine"](*scratch, dk.data_ptr(), dv.data_ptr(), B, M, D, Dv,
                                 splits, _stream(dev))
    check_launch(err, "cross_attention dkv combine")
    dkv_combine_launches += 1
    return dk, dv


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
