"""Masked cross-attention, forward and backward: CUDA kernels
`csrc/cross_attention.cu` (forward) and `csrc/cross_attention_bwd.cu` (dQ,
dK/dV), their plain PyTorch versions, and the `torch.autograd.Function`
that joins them.

Replaces `_fwd_kernel`, `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
`equidock_public_tpu/ops/pallas/cross_attention.py`:
o = softmax(a) V and lse = logsumexp(a) with
a = mask * (Q K^T) - 1000 * (1 - mask), mask = (q_tag > 0) & (q_tag == k_tag).
Tags are the 0/1 node masks, or (segment id + 1) * mask for packed slots.
Keys run over exactly M, so every row, padded rows included, equals the
oracle `ops/attention.py::cross_attention`. The backward takes
delta = rowsum(dO * O) as a torch op, as the JAX package does outside its
kernels, then launches the dQ and dK/dV kernels; tags get no gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import check_launch, check_tensor, load_library

MAX_WIDTH = 96   # largest D / Dv the kernels are built for (layer 0 is 69 wide)

# Launches of each CUDA kernel in this process (plain-version calls excluded).
launches = 0        # forward
dq_launches = 0     # backward, dQ
dkv_launches = 0    # backward, dK and dV


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
    fwd, dq, dkv = (lib.equidock_cross_attention_fwd, lib.equidock_cross_attention_dq,
                    lib.equidock_cross_attention_dkv)
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    dq.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    dkv.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for fn in (fwd, dq, dkv):
        fn.restype = ctypes.c_int
    return fwd, dq, dkv


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


def _launch_fwd(q, k, v, q_tag, k_tag):
    B, N, M, D, Dv = _check_inputs(q, k, v, q_tag, k_tag)
    o = torch.empty((B, N, Dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, N), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel_fns()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_tag.data_ptr(),
            k_tag.data_ptr(), o.data_ptr(), lse.data_ptr(), B, N, M, D, Dv,
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "cross_attention")
    global launches
    launches += 1
    return o, lse


def cross_attention_dq(q, k, v, q_tag, k_tag, lse, dout, delta):
    """Launch the dQ kernel on checked CUDA operands; dq (B, N, D)."""
    B, N, D = q.shape
    M, Dv = k.shape[1], v.shape[2]
    dq = torch.empty((B, N, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel_fns()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_tag.data_ptr(), k_tag.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, N, M, D, Dv,
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "cross_attention dq")
    global dq_launches
    dq_launches += 1
    return dq


def cross_attention_dkv(q, k, v, q_tag, k_tag, lse, dout, delta):
    """Launch the dK/dV kernel on checked CUDA operands; (dk, dv)."""
    B, N, D = q.shape
    M, Dv = k.shape[1], v.shape[2]
    dk = torch.empty((B, M, D), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, M, Dv), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel_fns()[2](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_tag.data_ptr(), k_tag.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, N, M, D, Dv, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "cross_attention dkv")
    global dkv_launches
    dkv_launches += 1
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
