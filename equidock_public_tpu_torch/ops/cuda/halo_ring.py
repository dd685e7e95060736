"""The halo ring of the graph-parallel trunk: launch wrappers of the CUDA
kernels in `csrc/halo_ring.cu`, their plain PyTorch versions, and the
`torch.autograd.Function`s that join them; plus `take_rows`, the gather of
send rows whose transpose sums in a fixed order.

Replaces `_fwd_kernel` and `_ship2_kernel` of
`equidock_public_tpu/parallel/pallas_halo.py`. Every shard is a block of a
stacked tensor on one device (leading dims (G, P): data groups, graph
shards; see `parallel/mesh.py`):

    ring_exchange(local (G, P, Bl, S, F), snd_next, snd_prev (G, P, Bl, H, F))
        -> (G, P, Bl, S + 2H, F) = [local | snd_next of shard p - 1
                                          | snd_prev of shard p + 1]
    ring_ship(a (G, P, ...), b (G, P, ...))
        -> (a of shard p - 1, b of shard p + 1)

with zeros where no shard sends (p = 0 receives nothing from "prev",
p = P - 1 nothing from "next"), as `lax.ppermute` gives. The backward of
either is `ring_ship` in the other direction (`pallas_halo._bwd_rule`,
`_ship_bwd`). Both kernels move f32 rows without arithmetic, so on the card
each equals its plain version bit for bit.

On CUDA tensors the Functions always launch the kernels (a failed build or
launch raises); on CPU tensors they run the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import edge_message as em
from ._build import check_launch, check_tensor, load_library

# Launches of each CUDA kernel in this process (plain-version calls excluded).
launches = 0          # row 8, the ring exchange
ship_launches = 0     # row 9, the both-direction shipment
take_launches = 0     # the take's transpose (the d_src scatter kernel of row 2)


def _shift_from_prev(a: torch.Tensor) -> torch.Tensor:
    """a of shard p - 1 at shard p (dim 1), zeros at p = 0."""
    return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)


def _shift_from_next(b: torch.Tensor) -> torch.Tensor:
    """b of shard p + 1 at shard p (dim 1), zeros at p = P - 1."""
    return torch.cat([b[:, 1:], torch.zeros_like(b[:, :1])], dim=1)


def ring_exchange_plain(local, snd_next, snd_prev) -> torch.Tensor:
    """Plain PyTorch version of row 8: [local | from prev | from next] along
    the row axis (dim -2)."""
    return torch.cat([local, _shift_from_prev(snd_next), _shift_from_next(snd_prev)], dim=-2)


def ring_ship_plain(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of row 9: (a of shard p - 1, b of shard p + 1)."""
    return _shift_from_prev(a), _shift_from_next(b)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = load_library()
    ex, ship = lib.equidock_halo_ring_exchange, lib.equidock_halo_ring_ship2
    ex.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    ship.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
                     + [ctypes.c_void_p])
    ex.restype = ship.restype = ctypes.c_int
    return ex, ship


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ring_exchange_kernel(local, snd_next, snd_prev) -> torch.Tensor:
    """Row 8 by the CUDA kernel, on CUDA operands."""
    if local.device.type != "cuda":
        raise ValueError(f"ring_exchange: unsupported device {local.device}")
    G, P, Bl, S, F = local.shape
    H = snd_next.shape[3]
    dev, f32 = local.device, torch.float32
    check_tensor(local, "local", (G, P, Bl, S, F), f32, dev)
    check_tensor(snd_next, "snd_next", (G, P, Bl, H, F), f32, dev)
    check_tensor(snd_prev, "snd_prev", (G, P, Bl, H, F), f32, dev)
    out = torch.empty((G, P, Bl, S + 2 * H, F), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_fns()[0](local.data_ptr(), snd_next.data_ptr(), snd_prev.data_ptr(),
                               out.data_ptr(), G, P, Bl, S, H, F, _stream(dev))
    check_launch(err, "halo ring_exchange")
    global launches
    launches += 1
    return out


def ring_ship_kernel(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 9 by the CUDA kernel, on CUDA operands with the same (G, P)."""
    if a.device.type != "cuda":
        raise ValueError(f"ring_ship: unsupported device {a.device}")
    G, P = a.shape[:2]
    dev, f32 = a.device, torch.float32
    check_tensor(a, "a", a.shape, f32, dev)
    check_tensor(b, "b", (G, P) + tuple(b.shape[2:]), f32, dev)
    out_p, out_n = torch.empty_like(a), torch.empty_like(b)
    with torch.cuda.device(dev):
        err = _kernel_fns()[1](a.data_ptr(), b.data_ptr(), out_p.data_ptr(), out_n.data_ptr(),
                               G, P, a[0, 0].numel(), b[0, 0].numel(), _stream(dev))
    check_launch(err, "halo ring_ship")
    global ship_launches
    ship_launches += 1
    return out_p, out_n


def _exchange(local, snd_next, snd_prev):
    if local.device.type == "cpu":
        return ring_exchange_plain(local, snd_next, snd_prev)
    return ring_exchange_kernel(local, snd_next, snd_prev)


def _ship(a, b):
    if a.device.type == "cpu":
        return ring_ship_plain(a, b)
    return ring_ship_kernel(a.contiguous(), b.contiguous())


class _RingExchange(torch.autograd.Function):
    """Row 8; its backward is row 9 on the two halo slices of the
    cotangent (`pallas_halo._bwd_rule`): the "from next" slots go back to
    their owner p + 1's snd_prev, the "from prev" slots to p - 1's
    snd_next; chain-end slots were zeros and send nothing back."""

    @staticmethod
    def forward(ctx, local, snd_next, snd_prev):
        ctx.widths = (local.shape[-2], snd_next.shape[-2])
        return _exchange(local, snd_next, snd_prev)

    @staticmethod
    def backward(ctx, g):
        S, H = ctx.widths
        g_snd_prev, g_snd_next = _ship(g[..., S + H:, :], g[..., S:S + H, :])
        return g[..., :S, :], g_snd_next, g_snd_prev


class _RingShip(torch.autograd.Function):
    """Row 9; its backward is row 9 the other way (`pallas_halo._ship_bwd`)."""

    @staticmethod
    def forward(ctx, a, b):
        return _ship(a, b)

    @staticmethod
    def backward(ctx, g_from_prev, g_from_next):
        g_b, g_a = _ship(g_from_next, g_from_prev)
        return g_a, g_b


def ring_exchange(local, snd_next, snd_prev) -> torch.Tensor:
    """[local | from prev | from next] (G, P, Bl, S + 2H, F), differentiable.
    CUDA tensors launch row 8 (backward: row 9); CPU tensors take the plain
    versions."""
    return _RingExchange.apply(local, snd_next, snd_prev)


def ring_ship(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a of shard p - 1, b of shard p + 1), differentiable; widths may
    differ. CUDA tensors launch row 9 (backward: row 9); CPU tensors take
    the plain version."""
    return _RingShip.apply(a, b)


def take_rows_bwd_plain(idx, n_src: int, g) -> torch.Tensor:
    """Plain transpose of `take_rows`: `index_add_` (sequential on the CPU;
    on the card it adds with atomics in no fixed order)."""
    G, N = idx.shape
    rows = (idx.long() + n_src * torch.arange(G, device=idx.device)[:, None]).reshape(-1)
    out = torch.zeros((G * n_src, g.shape[-1]), dtype=g.dtype, device=g.device)
    out.index_add_(0, rows, g.reshape(G * N, -1))
    return out.reshape(G, n_src, -1)


def take_rows_bwd(idx, n_src: int, g) -> torch.Tensor:
    """(G, n_src, F): g (G, N, F) summed onto the rows idx (G, N) names.
    Several slots may name one row (padding slots all name row 0, a row can
    ship both ways, ragged unpack slots are clamped), so on the card the
    sum goes through row 2's d_src scatter kernel over the sorted inverse
    list: each row's slots in ascending order, the same bits every run. CPU
    tensors take the plain version."""
    if g.device.type == "cpu":
        return take_rows_bwd_plain(idx, n_src, g)
    if g.shape[-1] <= 3:
        raise ValueError(f"take_rows: rows of {g.shape[-1]} floats; the scatter kernel "
                         "takes 3 + D")
    out = em.launch_scatter(idx[..., None], n_src, g[..., :3].contiguous(),
                            g[..., 3:].contiguous())
    global take_launches
    take_launches += 1
    return out


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n_src = src.shape[1]
        return torch.gather(src, 1, idx.long()[..., None].expand(-1, -1, src.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return take_rows_bwd(idx, ctx.n_src, g.contiguous()), None


def take_rows(src, idx) -> torch.Tensor:
    """src (G, n_src, F), idx (G, N) int -> (G, N, F) = src[g, idx[g, i]],
    differentiable in src with a transpose that sums in a fixed order."""
    return _TakeRows.apply(src, idx)
