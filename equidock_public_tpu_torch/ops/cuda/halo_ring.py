"""The halo exchange of the graph-parallel trunk as a gather by a fixed
table: launch wrappers of the CUDA kernels in `csrc/halo_ring.cu` (rows 8
and 9), their plain PyTorch versions, the `torch.autograd.Function` that
joins them, a numpy emulation of the kernels' index arithmetic; and the
plain ring composition the table is pinned to.

Replaces `_fwd_kernel` and `_ship2_kernel` of
`equidock_public_tpu/parallel/pallas_halo.py` together with the takes, the
ragged unpack and the residual all_to_all around them
(`equidock_public_tpu/parallel/halo.py::_halo_exchange`). Every shard is a
block of a stacked tensor on one device, so a receiving shard reads the
owner's rows where they lie: one side's whole exchange is

    x_src[blk, s] = x of stacked row src_row[b, p, s]   (zeros where -1)

with `src_row` (B, gp, Ssrc) built once per batch by
`parallel/halo.py::exchange_table`, Ssrc = S + 2 Hr + gp Hres, laid out as
[local | from prev | from next | residual]. Rows live in the folded layout
of `parallel/mesh.py` (block (g gp + p) Bl + bl holds complex b = g Bl + bl,
shard p, nodes p S ... (p + 1) S - 1; stacked row b N + n). The backward
sums each stacked row's slots in ascending table order (b, p, s) from +0.0
through the inverse (order, offsets): no atomics, the same bits as a
sequential `index_add_` of the same table on the CPU.

On CUDA tensors the Function always launches the kernels, both sides of a
layer in one launch each way (a failed build or launch raises); on CPU
tensors it runs the plain versions.

Across ranks (the shards of a data group in processes of their own,
`parallel/mesh.py`) the same two gathers run in a peer form: a rank's
`PeerTable` names (rank, row) for each slot of its view and, for each of
its rows, the peers' cotangent slots that read it, in the stacked table's
order; the rows come from every rank's `PeerArena`, a buffer mapped into
its peers by CUDA IPC (handles swapped once a buffer over the group's host
object collectives), between two host barriers (rows written, rows read).
The plain form gathers the group's rows by an all_reduce and runs the
stacked plain versions. Either gives the stacked form's bits. `ring_exchange`, `ring_ship` and
`take_rows` are the plain ring composition (`parallel/halo.py::
ring_composition`): cat, zeros and gather, differentiable, launching no
kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._build import check_launch, check_tensor, load_library, outputs

# Launches of each CUDA kernel in this process (plain-version calls excluded).
launches = 0          # row 8, the exchange forward (all sides of a call in one launch)
bwd_launches = 0      # row 9, the exchange backward

THREADS = 256         # threads a block, both kernels
BATCH = 16            # slots a round trip of the backward (kBatch), at most lpr


# --------------------------------------------------------------------------- #
# The plain ring composition (the reference the tables are pinned to)
# --------------------------------------------------------------------------- #

def _shift_from_prev(a: torch.Tensor) -> torch.Tensor:
    """a of shard p - 1 at shard p (dim 1), zeros at p = 0."""
    return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)


def _shift_from_next(b: torch.Tensor) -> torch.Tensor:
    """b of shard p + 1 at shard p (dim 1), zeros at p = P - 1."""
    return torch.cat([b[:, 1:], torch.zeros_like(b[:, :1])], dim=1)


def ring_exchange_plain(local, snd_next, snd_prev) -> torch.Tensor:
    """`pallas_halo.ring_exchange`: [local | from prev | from next] along the
    row axis (dim -2) of (G, P, Bl, ., F) blocks, zeros at the chain ends."""
    return torch.cat([local, _shift_from_prev(snd_next), _shift_from_next(snd_prev)], dim=-2)


def ring_ship_plain(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """`pallas_halo.ring_ship`: (a of shard p - 1, b of shard p + 1)."""
    return _shift_from_prev(a), _shift_from_next(b)


# Differentiable through cat and zeros as they are; the JAX VJPs
# (`_bwd_rule`, `_ship_bwd`) are the transposes autograd takes.
ring_exchange = ring_exchange_plain
ring_ship = ring_ship_plain


def take_rows(src, idx) -> torch.Tensor:
    """src (G, n_src, F), idx (G, N) int -> (G, N, F) = src[g, idx[g, i]],
    differentiable in src (a gather; its transpose adds repeated rows)."""
    return torch.gather(src, 1, idx.long()[..., None].expand(-1, -1, src.shape[-1]))


def take_rows_bwd_plain(idx, n_src: int, g) -> torch.Tensor:
    """The transpose of `take_rows` as `index_add_` (sequential on the CPU)."""
    G, N = idx.shape
    rows = (idx.long() + n_src * torch.arange(G, device=idx.device)[:, None]).reshape(-1)
    out = torch.zeros((G * n_src, g.shape[-1]), dtype=g.dtype, device=g.device)
    out.index_add_(0, rows, g.reshape(G * N, -1))
    return out.reshape(G, n_src, -1)


# --------------------------------------------------------------------------- #
# The table of one side in the folded layout of a mesh
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class ExchangeTable:
    """One side's exchange on a mesh of dp data groups: `src_row` (B, gp,
    Ssrc) int32, the stacked row b N + n each slot reads or -1; its inverse
    in CSR form over the B N stacked rows, `order` (slots read,) int32 flat
    table slots (b gp + p) Ssrc + s ascending within a row, `offsets`
    (B N + 1,) int32. A padded plan's table holds for any dp dividing B; a
    ragged plan's (`ragged`) only for the dp it was packed for."""

    src_row: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor
    N: int
    dp: int
    ragged: bool = False

    @property
    def dims(self) -> Tuple[int, int, int, int, int, int]:
        """(B', S, N, Ssrc, gp, Bl) with B' = B gp folded blocks."""
        B, gp, Ssrc = self.src_row.shape
        return B * gp, self.N // gp, self.N, Ssrc, gp, B // self.dp

    def to(self, device) -> "ExchangeTable":
        return dataclasses.replace(self, src_row=self.src_row.to(device),
                                   order=self.order.to(device), offsets=self.offsets.to(device))


def _table_to_folded(t: torch.Tensor, tab: ExchangeTable) -> torch.Tensor:
    """(B, gp, W, ...) in table order -> folded (B', W, ...)."""
    B, gp = t.shape[:2]
    Bl = B // tab.dp
    return t.reshape(tab.dp, Bl, gp, *t.shape[2:]).transpose(1, 2).reshape(B * gp, *t.shape[2:])


def _folded_to_table(t: torch.Tensor, tab: ExchangeTable) -> torch.Tensor:
    """Folded (B', W, ...) -> (B, gp, W, ...) in table order."""
    _, _, _, _, gp, Bl = tab.dims
    return t.reshape(tab.dp, gp, Bl, *t.shape[1:]).transpose(1, 2).reshape(
        tab.dp * Bl, gp, *t.shape[1:])


def gather_index(tab: ExchangeTable) -> torch.Tensor:
    """(B gp Ssrc,) int64 in table order: the folded source row (blk S + r)
    of each slot, B' S for a zero slot."""
    Bp, S, N, _, gp, Bl = tab.dims
    v = tab.src_row.reshape(-1).long()
    b, n = v.div(N, rounding_mode="floor"), v.remainder(N)
    p, r = n.div(S, rounding_mode="floor"), n.remainder(S)
    blk = (b.div(Bl, rounding_mode="floor") * gp + p) * Bl + b.remainder(Bl)
    return torch.where(v >= 0, blk * S + r, torch.full_like(v, Bp * S))


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #

def exchange_plain(x, h, tab: ExchangeTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain row 8: `index_select` of the table over the folded rows with
    one zero row appended. x (B', S, 3), h (B', S, D) -> x_src (B', Ssrc,
    3), h_src (B', Ssrc, D)."""
    Bp, S, _, Ssrc, gp, _ = tab.dims
    idx = _table_to_folded(gather_index(tab).reshape(Bp // gp, gp, Ssrc), tab).reshape(-1)

    def one(a):
        flat = torch.cat([a.reshape(Bp * S, -1), a.new_zeros(1, a.shape[-1])])
        return flat.index_select(0, idx).reshape(Bp, Ssrc, -1)

    return one(x), one(h)


def exchange_bwd_plain(g_x, g_h, tab: ExchangeTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain row 9: the cotangents of x and h from those of x_src and h_src,
    a sequential `index_add_` over the slots in table order (on the card
    `index_add_` adds with atomics in no fixed order)."""
    Bp, S, _, Ssrc, _, _ = tab.dims
    idx = gather_index(tab)

    def one(g):
        C = g.shape[-1]
        out = g.new_zeros(Bp * S + 1, C)
        out.index_add_(0, idx, _folded_to_table(g, tab).reshape(-1, C))
        return out[:-1].reshape(Bp, S, C)

    return one(g_x), one(g_h)


# --------------------------------------------------------------------------- #
# The kernels
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = load_library()
    fwd, bwd = lib.equidock_halo_exchange, lib.equidock_halo_exchange_bwd
    for f in (fwd, bwd):
        f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return fwd, bwd


@dataclasses.dataclass(frozen=True)
class SidePlan:
    """How one side is laid over the grid: `lpr` lanes a row (a power of
    two, the same on every side of a launch), `vec` floats an h load (4:
    float4, else 1), `rows` and `blocks`."""

    lpr: int
    vec: int
    rows: int
    blocks: int


def exchange_launch_plan(dims: Sequence[Tuple[int, int, int, int, int, int]], Ds: Sequence[int],
                         vec: int, backward: bool) -> List[SidePlan]:
    """The grid of one launch: each side's rows (B' Ssrc output slots
    forward, B' S local rows backward) on groups of `lpr` lanes, THREADS /
    lpr rows a block, the sides' blocks one after the other. The kernel is
    built for three (lpr, vec): float4 loads on 4 lanes when every row
    holds at most 16 floats, else on 16 (D = 64; wider rows loop), and
    float loads on 32 lanes. x takes 3 lanes; the backward takes a row's
    slots min(lpr, BATCH) at a time."""
    if vec == 4:
        lpr = 4 if max(Ds) <= 16 else 16
    elif vec == 1:
        lpr = 32
    else:
        raise ValueError(f"halo_exchange: {vec} floats a load (4 or 1)")
    plans = []
    for Bp, S, _, Ssrc, _, _ in dims:
        rows = Bp * (S if backward else Ssrc)
        plans.append(SidePlan(lpr, vec, rows, -(-rows // (THREADS // lpr))))
    return plans


def fast_div(n, d: int):
    """n // d as the kernels compute it for 0 <= n < 2^31: one multiply-high
    by a magic number (`FastDiv` in `csrc/halo_ring.cu`)."""
    ell = max(d - 1, 0).bit_length()
    m = ((1 << 32) * ((1 << ell) - d)) // d + 1
    n = np.asarray(n, np.int64)
    return ((((n * m) >> 32) + n) >> ell).astype(np.int64)


def _vec_width(ts, Ds) -> int:
    """4 when every h row is whole float4s at 16-byte aligned addresses."""
    ok = all(D % 4 == 0 for D in Ds) and all(t.data_ptr() % 16 == 0 for t in ts)
    return 4 if ok else 1


def _launch(which: int, ptrs: List[int], dims, plans, dev) -> None:
    n = len(plans)
    ints = []
    for (Bp, S, N, Ssrc, gp, Bl, D), pl in zip(dims, plans):
        ints += [Bp, S, N, Ssrc, D, gp, Bl, pl.lpr, pl.vec, pl.rows, pl.blocks]
    p_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    i_arr = (ctypes.c_int * len(ints))(*ints)
    with torch.cuda.device(dev):
        err = _kernel_fns()[which](n, p_arr, i_arr, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "halo_exchange" + ("_bwd" if which else ""))


def _check_table(tab: ExchangeTable, D: int, dev) -> None:
    B, gp, Ssrc = tab.src_row.shape
    check_tensor(tab.src_row, "src_row", (B, gp, Ssrc), torch.int32, dev)
    check_tensor(tab.offsets, "inverse offsets", (B * tab.N + 1,), torch.int32, dev)
    check_tensor(tab.order, "inverse order", tuple(tab.order.shape), torch.int32, dev)
    if tab.N % gp or B % tab.dp or B * gp * Ssrc * max(D, 3) >= 2 ** 31:
        raise ValueError(f"exchange table {tuple(tab.src_row.shape)}, N={tab.N}, dp={tab.dp}, "
                         f"D={D}: outside the kernels' 32-bit offsets")


def exchange_kernel(sides, out=None):
    """Row 8 on CUDA operands: `sides` a list of one or two (x (B', S, 3),
    h (B', S, D), ExchangeTable), contiguous f32; one launch for all.
    `out`: [(x_src, h_src)] to write into, else fresh. Returns the list of
    (x_src, h_src)."""
    dev = sides[0][0].device
    if dev.type != "cuda" or not 1 <= len(sides) <= 2:
        raise ValueError(f"halo_exchange: {len(sides)} sides on {dev}")
    dims, ptrs, res = [], [], []
    for i, (x, h, tab) in enumerate(sides):
        Bp, S, N, Ssrc, gp, Bl = tab.dims
        D = h.shape[-1]
        check_tensor(x, "x", (Bp, S, 3), torch.float32, dev)
        check_tensor(h, "h", (Bp, S, D), torch.float32, dev)
        _check_table(tab, D, dev)
        xo, ho = outputs(((Bp, Ssrc, 3), (Bp, Ssrc, D)), dev,
                         None if out is None else out[i], "halo_exchange")
        res.append((xo, ho))
        dims.append((Bp, S, N, Ssrc, gp, Bl, D))
        ptrs += [x.data_ptr(), h.data_ptr(), xo.data_ptr(), ho.data_ptr(),
                 tab.src_row.data_ptr(), 0, 0]
    Ds = [d[6] for d in dims]
    vec = _vec_width([s[1] for s in sides] + [r[1] for r in res], Ds)
    plans = exchange_launch_plan([d[:6] for d in dims], Ds, vec, backward=False)
    _launch(0, ptrs, dims, plans, dev)
    global launches
    launches += 1
    return res


def exchange_bwd_kernel(sides, out=None):
    """Row 9 on CUDA operands: `sides` a list of one or two (g_x (B', Ssrc,
    3), g_h (B', Ssrc, D), ExchangeTable); one launch for all. Each local
    row's cotangent is the sum of its slots in ascending table order from
    +0.0. Returns the list of (d_x (B', S, 3), d_h (B', S, D))."""
    dev = sides[0][0].device
    if dev.type != "cuda" or not 1 <= len(sides) <= 2:
        raise ValueError(f"halo_exchange_bwd: {len(sides)} sides on {dev}")
    dims, ptrs, res = [], [], []
    for i, (gx, gh, tab) in enumerate(sides):
        Bp, S, N, Ssrc, gp, Bl = tab.dims
        D = gh.shape[-1]
        check_tensor(gx, "g_x", (Bp, Ssrc, 3), torch.float32, dev)
        check_tensor(gh, "g_h", (Bp, Ssrc, D), torch.float32, dev)
        _check_table(tab, D, dev)
        dx, dh = outputs(((Bp, S, 3), (Bp, S, D)), dev, None if out is None else out[i],
                         "halo_exchange_bwd")
        res.append((dx, dh))
        dims.append((Bp, S, N, Ssrc, gp, Bl, D))
        ptrs += [gx.data_ptr(), gh.data_ptr(), dx.data_ptr(), dh.data_ptr(), 0,
                 tab.order.data_ptr(), tab.offsets.data_ptr()]
    Ds = [d[6] for d in dims]
    vec = _vec_width([s[1] for s in sides] + [r[1] for r in res], Ds)
    plans = exchange_launch_plan([d[:6] for d in dims], Ds, vec, backward=True)
    _launch(1, ptrs, dims, plans, dev)
    global bwd_launches
    bwd_launches += 1
    return res


class _HaloExchange(torch.autograd.Function):
    """Rows 8 and 9 over one or two sides: inputs (x_1, h_1, x_2, h_2),
    outputs (x_src_1, h_src_1, ...)."""

    @staticmethod
    def forward(ctx, tabs, *xh):
        ctx.tabs = tabs
        pairs = [(xh[2 * i].contiguous(), xh[2 * i + 1].contiguous(), t)
                 for i, t in enumerate(tabs)]
        if xh[0].device.type == "cpu":
            res = [exchange_plain(x, h, t) for x, h, t in pairs]
        else:
            res = exchange_kernel(pairs)
        return tuple(a for r in res for a in r)

    @staticmethod
    def backward(ctx, *g):
        pairs = [(g[2 * i].contiguous(), g[2 * i + 1].contiguous(), t)
                 for i, t in enumerate(ctx.tabs)]
        if g[0].device.type == "cpu":
            res = [exchange_bwd_plain(gx, gh, t) for gx, gh, t in pairs]
        else:
            res = exchange_bwd_kernel(pairs)
        return (None,) + tuple(a for r in res for a in r)


def halo_exchange_sides(tabs: Sequence[ExchangeTable], xh: Sequence[torch.Tensor]):
    """(x_src_1, h_src_1, ...) of one or two sides, differentiable: on CUDA
    tensors one launch of row 8 (backward: one of row 9); on CPU tensors
    the plain versions."""
    return _HaloExchange.apply(tuple(tabs), *xh)


def halo_exchange_pair(x_l, h_l, x_r, h_r, tab_l: ExchangeTable, tab_r: ExchangeTable):
    """Both sides' exchange of one layer: (x_src_l, h_src_l, x_src_r,
    h_src_r)."""
    return halo_exchange_sides((tab_l, tab_r), (x_l, h_l, x_r, h_r))


# --------------------------------------------------------------------------- #
# CPU emulation of the kernels' index arithmetic (numpy, every thread)
# --------------------------------------------------------------------------- #

def _np_table(tab: ExchangeTable):
    return (tab.src_row.cpu().numpy().reshape(-1).astype(np.int64),
            tab.order.cpu().numpy().astype(np.int64), tab.offsets.cpu().numpy().astype(np.int64))


def _emulated_threads(plans: List[SidePlan]):
    """(side, row, lane) of every thread of the grid that owns a row, as the
    kernels compute them from blockIdx and threadIdx."""
    out = []
    first = 0
    for i, pl in enumerate(plans):
        blocks = np.arange(first, first + pl.blocks)
        first += pl.blocks
        t = np.arange(THREADS)
        shift = pl.lpr.bit_length() - 1
        bid = (blocks - (first - pl.blocks))[:, None]
        row = (bid * (THREADS >> shift) + (t[None, :] >> shift)).reshape(-1)
        lane = np.broadcast_to(t & (pl.lpr - 1), (pl.blocks, THREADS)).reshape(-1)
        keep = row < pl.rows
        out.append((i, row[keep], lane[keep]))
    return out


def _folded_block(blk, gp, Bl):
    """Folded block -> (b, p), the kernels' integer arithmetic."""
    g = fast_div(blk, gp * Bl)
    rem = blk - g * gp * Bl
    p = fast_div(rem, Bl)
    return g * Bl + rem - p * Bl, p


def _block_of(b, p, gp, Bl):
    """(b, p) -> folded block (g gp + p) Bl + bl."""
    g = fast_div(b, Bl)
    return (g * gp + p) * Bl + b - g * Bl


def _stacked_to_folded(v, S, N, gp, Bl):
    b = fast_div(v, N)
    n = v - b * N
    p = fast_div(n, S)
    return _block_of(b, p, gp, Bl), n - p * S


def exchange_tiles_fwd(sides, vec: int = 4):
    """Row 8's kernel emulated on the CPU: `sides` a list of (x, h, table);
    every thread of the grid computes its row, source and columns as the
    kernel does. Returns ([(x_src, h_src)], writes) with `writes` each
    output float's write count (1 everywhere when the grid covers each
    output once)."""
    dims = [t.dims for _, _, t in sides]
    Ds = [h.shape[-1] for _, h, _ in sides]
    plans = exchange_launch_plan(dims, Ds, vec, backward=False)
    res, writes = [], []
    for (i, row, lane), (x, h, tab) in zip(_emulated_threads(plans), sides):
        Bp, S, N, Ssrc, gp, Bl = tab.dims
        D, pl = Ds[i], plans[i]
        src_row, _, _ = _np_table(tab)
        xs, hs = x.numpy().reshape(-1, 3), h.numpy().reshape(Bp * S, D)
        xo, ho = np.full((Bp * Ssrc, 3), np.nan, np.float32), np.full((Bp * Ssrc, D), np.nan,
                                                                     np.float32)
        wx, wh = np.zeros(xo.shape, np.int64), np.zeros(ho.shape, np.int64)
        blk = fast_div(row, Ssrc)
        s = row - blk * Ssrc
        b, p = _folded_block(blk, gp, Bl)
        v = src_row[(b * gp + p) * Ssrc + s]
        fblk, r = _stacked_to_folded(np.maximum(v, 0), S, N, gp, Bl)
        src = fblk * S + r
        live = v >= 0
        xl = lane < 3
        xo[row[xl], lane[xl]] = np.where(live[xl], xs[src[xl], lane[xl]], 0.0)
        np.add.at(wx, (row[xl], lane[xl]), 1)
        for c0 in range(0, D // pl.vec, pl.lpr):     # the kernel's column loop
            c = c0 + lane
            ok = c < D // pl.vec
            for e in range(pl.vec):
                col = c[ok] * pl.vec + e
                ho[row[ok], col] = np.where(live[ok], hs[src[ok], col], 0.0)
                np.add.at(wh, (row[ok], col), 1)
        res.append((torch.from_numpy(xo.reshape(Bp, Ssrc, 3)),
                    torch.from_numpy(ho.reshape(Bp, Ssrc, D))))
        writes.append((wx, wh))
    return res, writes


def exchange_tiles_bwd(sides, vec: int = 4):
    """Row 9's kernel emulated on the CPU in float32: `sides` a list of
    (g_x_src, g_h_src, table); each group walks its row's slots `lpr` at a
    time in order, as the kernel does. Returns ([(d_x, d_h)], writes,
    longest slot list)."""
    dims = [t.dims for _, _, t in sides]
    Ds = [g.shape[-1] for _, g, _ in sides]
    plans = exchange_launch_plan(dims, Ds, vec, backward=True)
    res, writes, longest = [], [], 0
    for (i, row, lane), (gx, gh, tab) in zip(_emulated_threads(plans), sides):
        Bp, S, N, Ssrc, gp, Bl = tab.dims
        D, pl = Ds[i], plans[i]
        _, order, offsets = _np_table(tab)
        gxs, ghs = gx.numpy().reshape(-1, 3), gh.numpy().reshape(-1, D)
        dx, dh = np.full((Bp * S, 3), np.nan, np.float32), np.full((Bp * S, D), np.nan,
                                                                   np.float32)
        wx, wh = np.zeros(dx.shape, np.int64), np.zeros(dh.shape, np.int64)
        blk = fast_div(row, S)
        r = row - blk * S
        b, p = _folded_block(blk, gp, Bl)
        v = b * N + p * S + r
        beg, end = offsets[v], offsets[v + 1]
        longest = max(longest, int((end - beg).max(initial=0)))

        def slot_pos(k):
            q = order[np.minimum(k, len(order) - 1)]
            bq = fast_div(q, gp * Ssrc)
            rem = q - bq * gp * Ssrc
            pq = fast_div(rem, Ssrc)
            return _block_of(bq, pq, gp, Bl) * Ssrc + rem - pq * Ssrc

        cols = [(lane < 3, None)] + [(c0 + lane < D // pl.vec, c0 + lane)
                                     for c0 in range(0, D // pl.vec, pl.lpr)]
        for sel, c in cols:
            for e in range(1 if c is None else pl.vec):
                col = lane[sel] if c is None else c[sel] * pl.vec + e
                src = gxs if c is None else ghs
                acc = np.zeros(int(sel.sum()), np.float32)
                k0 = beg[sel].copy()
                while (k0 < end[sel]).any():
                    for u in range(min(BATCH, pl.lpr)):
                        k = k0 + u
                        live = k < end[sel]
                        val = src[slot_pos(k), col]
                        acc = np.where(live, acc + val, acc).astype(np.float32)
                    k0 += min(BATCH, pl.lpr)
                dst, w = (dx, wx) if c is None else (dh, wh)
                dst[row[sel], col] = acc
                np.add.at(w, (row[sel], col), 1)
        res.append((torch.from_numpy(dx.reshape(Bp, S, 3)), torch.from_numpy(dh.reshape(Bp, S, D))))
        writes.append((wx, wh))
    return res, writes, longest


# --------------------------------------------------------------------------- #
# The peer form: the shards of a complex as ranks (processes)
# --------------------------------------------------------------------------- #

# Launches of the peer form's kernels in this process (plain versions excluded).
peer_launches = 0       # row 8 across ranks
peer_bwd_launches = 0   # row 9 across ranks


@dataclasses.dataclass
class PeerTable:
    """One side's exchange on graph rank `rank` of a group of `gp` ranks
    that hold the `Bl` complexes of one data group, shard p of each on rank
    p. Forward: `peer_row` (Bl Ssrc,) int32, slot bl Ssrc + s of this rank's
    view reads row q (Bl S) + bl' S + r (row bl' S + r of rank q), or -1 for
    a zero. Backward: this rank's Bl S local rows, each summing the slots
    that read it in ascending table order (b, p, s): `order` p (Bl Ssrc) +
    pos (slot pos of rank p's cotangents), `offsets` (Bl S + 1,). `group`:
    the group's stacked table (dp 1), which the plain form reads."""

    peer_row: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor
    group: ExchangeTable
    rank: int
    gp: int
    Bl: int
    S: int
    Ssrc: int

    def to(self, device) -> "PeerTable":
        return dataclasses.replace(self, peer_row=self.peer_row.to(device),
                                   order=self.order.to(device),
                                   offsets=self.offsets.to(device),
                                   group=self.group.to(device))


def peer_table(tab: ExchangeTable, rank: int, device=None) -> PeerTable:
    """Rank `rank`'s peer table of a data group's stacked table (numpy, once
    a batch). Slot and row orders are the stacked table's, so the peer form
    moves and sums exactly what the stacked form does."""
    if tab.dp != 1:
        raise ValueError(f"peer tables come from a data group's own table (dp 1), got dp {tab.dp}")
    Bl, gp, Ssrc = tab.src_row.shape
    N = tab.N
    S = N // gp
    src = tab.src_row.cpu().numpy().astype(np.int64)
    v = src[:, rank, :]
    b, n = v // N, v % N
    q, r = n // S, n % S
    peer_row = np.where(v >= 0, q * (Bl * S) + b * S + r, -1).reshape(-1)
    flat = src.reshape(-1)                       # table order (b gp + p) Ssrc + s
    sel = np.flatnonzero((flat >= 0) & ((flat % N) // S == rank))
    local = (flat[sel] // N) * S + (flat[sel] % N) - rank * S
    o = np.argsort(local, kind="stable")
    sel, local = sel[o], local[o]
    bb, rem = sel // (gp * Ssrc), sel % (gp * Ssrc)
    order = (rem // Ssrc) * (Bl * Ssrc) + bb * Ssrc + rem % Ssrc
    offsets = np.searchsorted(local, np.arange(Bl * S + 1))
    dev = tab.src_row.device if device is None else device
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)
    return PeerTable(T(peer_row), T(order), T(offsets), tab.to(dev), rank, gp, Bl, S, Ssrc)


def _gather_group(a: torch.Tensor, group, rank: int, gp: int) -> torch.Tensor:
    """(gp Bl, ...): every rank's (Bl, ...) block, rank-major (an all_reduce
    of a buffer that is zero outside this rank's block: exact, every other
    term is +0.0)."""
    from ...parallel.dist import gather_slots

    return gather_slots(a, group, rank, gp).reshape((gp * a.shape[0],) + tuple(a.shape[1:]))


def peer_exchange_plain(x, h, tab: PeerTable, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain row 8 across ranks: the group's rows gathered by an all_reduce,
    the stacked plain gather, this rank's blocks. x (Bl, S, 3), h (Bl, S,
    D) -> (Bl, Ssrc, 3), (Bl, Ssrc, D)."""
    full = _gather_group(torch.cat([x, h], dim=-1), group, tab.rank, tab.gp)
    xs, hs = exchange_plain(full[..., :3].contiguous(), full[..., 3:].contiguous(), tab.group)
    own = slice(tab.rank * tab.Bl, (tab.rank + 1) * tab.Bl)
    return xs[own], hs[own]


def peer_exchange_bwd_plain(g_x, g_h, tab: PeerTable, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain row 9 across ranks: every rank's cotangent slots gathered by an
    all_reduce, the stacked plain backward (a sequential `index_add_` in
    table order on the CPU), this rank's rows."""
    full = _gather_group(torch.cat([g_x, g_h], dim=-1), group, tab.rank, tab.gp)
    dx, dh = exchange_bwd_plain(full[..., :3].contiguous(), full[..., 3:].contiguous(),
                                tab.group)
    own = slice(tab.rank * tab.Bl, (tab.rank + 1) * tab.Bl)
    return dx[own], dh[own]


def allocation_base(t: torch.Tensor) -> Tuple[int, int]:
    """(base, offset): the device allocation (the caching allocator's
    segment) that holds `t`, and `t`'s byte offset in it. A CUDA IPC handle
    names a whole allocation, so a peer adds the offset to the base it
    maps."""
    ptr = t.data_ptr()
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] == t.device.index and seg["address"] <= ptr < seg["address"] + \
                seg["total_size"]:
            return seg["address"], ptr - seg["address"]
    raise RuntimeError(f"no allocator segment holds the tensor at {ptr:#x}")


@functools.lru_cache(maxsize=None)
def _peer_fns():
    lib = load_library()
    fwd, bwd = lib.equidock_halo_peer_exchange, lib.equidock_halo_peer_exchange_bwd
    for f in (fwd, bwd):
        f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int
    get, open_, close = lib.equidock_ipc_handle, lib.equidock_ipc_open, lib.equidock_ipc_close
    get.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    open_.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    close.argtypes = [ctypes.c_void_p]
    for f in (get, open_, close):
        f.restype = ctypes.c_int
    return fwd, bwd, get, open_, close


class PeerArena:
    """This rank's exchange buffer and its graph-group peers' buffers,
    mapped by CUDA IPC. Handles are swapped once per buffer, over the
    group's host (gloo) object collectives; a larger buffer is agreed by
    all ranks of the group alike (the same shapes reach every rank). The
    exporting tensor stays alive while it is mapped; `close` unmaps the
    peers' buffers (a handle is never opened in the process that made it:
    a rank reads its own buffer by its own pointer)."""

    def __init__(self, cpu_group, rank: int, gp: int, device):
        self.cpu_group, self.rank, self.gp, self.device = cpu_group, rank, gp, device
        self.buf: Optional[torch.Tensor] = None
        self.bases: List[int] = []
        self._opened: List[int] = []
        self._ptr_arrays: dict = {}

    def ensure(self, floats: int) -> None:
        """A buffer of at least `floats` f32 on every rank (collective)."""
        import torch.distributed as dist

        if self.buf is not None and self.buf.numel() >= floats:
            return
        self.close()
        _, _, get, open_, _ = _peer_fns()
        self.buf = torch.zeros(max(floats, 1 << 16), dtype=torch.float32, device=self.device)
        torch.cuda.synchronize(self.device)
        base, off = allocation_base(self.buf)
        handle = ctypes.create_string_buffer(64)
        check_launch(get(ctypes.c_void_p(base), ctypes.cast(handle, ctypes.c_void_p)),
                     "cudaIpcGetMemHandle")
        mine = (bytes(handle.raw), off)
        everyone = [None] * self.gp
        dist.all_gather_object(everyone, mine, group=self.cpu_group)
        self.bases = []
        for q, (h, o) in enumerate(everyone):
            if q == self.rank:
                self.bases.append(self.buf.data_ptr())
                continue
            ptr = ctypes.c_void_p()
            raw = ctypes.create_string_buffer(h, 64)
            check_launch(open_(ctypes.cast(raw, ctypes.c_void_p), ctypes.byref(ptr)),
                         f"cudaIpcOpenMemHandle (rank {q}'s buffer)")
            self._opened.append(ptr.value)
            self.bases.append(ptr.value + o)
        dist.barrier(group=self.cpu_group)

    def pointers(self, offsets: Sequence[int]) -> torch.Tensor:
        """A device array of len(offsets) x gp pointers: region i of every
        rank's buffer (offsets in floats)."""
        key = tuple(offsets)
        if key not in self._ptr_arrays:
            ptrs = [b + 4 * o for o in offsets for b in self.bases]
            self._ptr_arrays[key] = torch.tensor(ptrs, dtype=torch.int64).to(self.device)
        return self._ptr_arrays[key]

    def close(self) -> None:
        """Unmap the peers' buffers, after every rank is done reading
        (collective when a buffer is mapped)."""
        import torch.distributed as dist

        if self.buf is None:
            return
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.cpu_group)
        _, _, _, _, close = _peer_fns()
        for ptr in self._opened:
            check_launch(close(ctypes.c_void_p(ptr)), "cudaIpcCloseMemHandle")
        dist.barrier(group=self.cpu_group)
        self._opened, self.bases, self._ptr_arrays, self.buf = [], [], {}, None


def _regions(shapes) -> Tuple[List[int], int]:
    """Float offsets of consecutive regions, each on a 16-byte boundary."""
    offs, at = [], 0
    for s in shapes:
        offs.append(at)
        at += -(-int(np.prod(s)) // 4) * 4
    return offs, at


def peer_launch(backward: bool, ptr_arr: torch.Tensor, sides, outs, vec: int) -> None:
    """One launch of the peer kernel: `sides` (D, PeerTable), `ptr_arr` the
    device array of x then h pointers of each side, `outs` [(out_x,
    out_h)]."""
    dev = ptr_arr.device
    dims, ptrs = [], []
    plans = exchange_launch_plan(
        [(t.Bl * t.gp, t.S, t.S * t.gp, t.Ssrc, t.gp, t.Bl) for _, t in sides],
        [D for D, _ in sides], vec, backward)
    base = ptr_arr.data_ptr()
    for i, ((D, t), (ox, oh), pl) in enumerate(zip(sides, outs, plans)):
        rows = t.Bl * (t.S if backward else t.Ssrc)
        blocks = -(-rows // (THREADS // pl.lpr))
        span = t.Bl * (t.Ssrc if backward else t.S)
        dims += [D, span, rows, blocks, pl.lpr, vec]
        ptrs += [base + 8 * t.gp * (2 * i), base + 8 * t.gp * (2 * i + 1), ox.data_ptr(),
                 oh.data_ptr(), t.peer_row.data_ptr(), t.order.data_ptr(), t.offsets.data_ptr()]
    p_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    i_arr = (ctypes.c_int * len(dims))(*dims)
    fwd, bwd, *_ = _peer_fns()
    with torch.cuda.device(dev):
        err = (bwd if backward else fwd)(len(sides), p_arr, i_arr,
                                         torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "halo_peer_exchange" + ("_bwd" if backward else ""))


def _peer_sides(pairs, backward: bool, out):
    """Checks of one launch's operands: ([(out_x, out_h)], [(D, PeerTable)],
    the operands' shapes)."""
    dev = pairs[0][0].device
    if dev.type != "cuda" or not 1 <= len(pairs) <= 2:
        raise ValueError(f"halo_peer_exchange: {len(pairs)} sides on {dev}")
    shapes, res, sides = [], [], []
    for i, (ax, ah, t) in enumerate(pairs):
        D = ah.shape[-1]
        rows_in, rows_out = (t.Ssrc, t.S) if backward else (t.S, t.Ssrc)
        check_tensor(ax, "x", (t.Bl, rows_in, 3), torch.float32, dev)
        check_tensor(ah, "h", (t.Bl, rows_in, D), torch.float32, dev)
        for name, tt in (("peer_row", t.peer_row), ("order", t.order), ("offsets", t.offsets)):
            check_tensor(tt, name, tuple(tt.shape), torch.int32, dev)
        if t.offsets.numel() != t.Bl * t.S + 1 or t.peer_row.numel() != t.Bl * t.Ssrc:
            raise ValueError(f"peer table of rank {t.rank} does not fit Bl={t.Bl}, S={t.S}")
        shapes += [ax.shape, ah.shape]
        res.append(outputs(((t.Bl, rows_out, 3), (t.Bl, rows_out, D)), dev,
                           None if out is None else out[i], "halo_peer_exchange"))
        sides.append((D, t))
    return res, sides, shapes


def peer_exchange_kernel(pairs, arena: PeerArena, backward: bool = False, out=None):
    """Row 8 (or 9, `backward`) across ranks on CUDA operands: `pairs` one or
    two (a_x, a_h, PeerTable) (forward: x (Bl, S, 3), h (Bl, S, D);
    backward: g_x (Bl, Ssrc, 3), g_h (Bl, Ssrc, D)). Writes them into this
    rank's arena, host barrier (rows written), one launch reading the
    peers' arenas, host barrier (read, reusable). Returns [(out_x, out_h)]."""
    from ...parallel.dist import host_barrier

    dev = pairs[0][0].device
    res, sides, shapes = _peer_sides(pairs, backward, out)
    offs, total = _regions(shapes)
    arena.ensure(total)
    for (ax, ah, _), i in zip(pairs, range(0, 2 * len(pairs), 2)):
        arena.buf[offs[i]:offs[i] + ax.numel()].copy_(ax.reshape(-1))
        arena.buf[offs[i + 1]:offs[i + 1] + ah.numel()].copy_(ah.reshape(-1))
    vec = _vec_width([r[1] for r in res], [D for D, _ in sides])
    ptr_arr = arena.pointers(offs)
    torch.cuda.current_stream(dev).synchronize()
    host_barrier(arena.cpu_group)                    # every rank's rows written
    peer_launch(backward, ptr_arr, sides, res, vec)
    torch.cuda.current_stream(dev).synchronize()
    host_barrier(arena.cpu_group)                    # read: the buffers are free again
    global peer_launches, peer_bwd_launches
    if backward:
        peer_bwd_launches += 1
    else:
        peer_launches += 1
    return res


def peer_kernel_only(pairs, arena: PeerArena, backward: bool = False):
    """A launcher of the peer kernel alone on what the arenas hold now (for
    timing the kernel apart from its copies and barriers; the caller keeps
    every rank from writing its arena meanwhile). Counts nothing."""
    res, sides, shapes = _peer_sides(pairs, backward, None)
    offs, _ = _regions(shapes)
    vec = _vec_width([r[1] for r in res], [D for D, _ in sides])
    ptr_arr = arena.pointers(offs)
    return lambda: peer_launch(backward, ptr_arr, sides, res, vec)


@dataclasses.dataclass
class PeerGroup:
    """The graph group a rank exchanges rows with: `group` (all_reduce, any
    device), `cpu_group` (host barriers, objects), this rank's place and the
    arena of the kernels (made at first use on the card)."""

    group: object
    cpu_group: object
    rank: int
    gp: int
    device: torch.device
    arena: Optional[PeerArena] = None

    def get_arena(self) -> PeerArena:
        if self.arena is None:
            self.arena = PeerArena(self.cpu_group, self.rank, self.gp, self.device)
        return self.arena

    def close(self) -> None:
        if self.arena is not None:
            self.arena.close()
            self.arena = None


class _PeerExchange(torch.autograd.Function):
    """Rows 8 and 9 across ranks over one or two sides: inputs (x_1, h_1,
    x_2, h_2), outputs (x_src_1, h_src_1, ...); the kernels on CUDA tensors,
    the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, pg: PeerGroup, tabs, *xh):
        ctx.pg, ctx.tabs = pg, tabs
        pairs = [(xh[2 * i].contiguous(), xh[2 * i + 1].contiguous(), t)
                 for i, t in enumerate(tabs)]
        if xh[0].device.type == "cpu":
            res = [peer_exchange_plain(x, h, t, pg.group) for x, h, t in pairs]
        else:
            res = peer_exchange_kernel(pairs, pg.get_arena())
        return tuple(a for r in res for a in r)

    @staticmethod
    def backward(ctx, *g):
        pg = ctx.pg
        pairs = [(g[2 * i].contiguous(), g[2 * i + 1].contiguous(), t)
                 for i, t in enumerate(ctx.tabs)]
        if g[0].device.type == "cpu":
            res = [peer_exchange_bwd_plain(gx, gh, t, pg.group) for gx, gh, t in pairs]
        else:
            res = peer_exchange_kernel(pairs, pg.get_arena(), backward=True)
        return (None, None) + tuple(a for r in res for a in r)


def peer_exchange_sides(pg: PeerGroup, tabs: Sequence[PeerTable], xh: Sequence[torch.Tensor]):
    """(x_src_1, h_src_1, ...) of one or two sides across the ranks of `pg`,
    differentiable: one launch of row 8's peer form on CUDA tensors
    (backward: one of row 9's), the plain versions on CPU tensors."""
    return _PeerExchange.apply(pg, tuple(tabs), *xh)
