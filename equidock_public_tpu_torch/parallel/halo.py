"""Boundary (halo) exchange graph parallelism: the port of
`equidock_public_tpu/parallel/halo.py`.

The padded node axis of each protein is cut into gp contiguous shards; each
shard owns one node block and every in-edge of those nodes (edges go with
their destination, the fixed-degree table layout). Per IEGMN layer each
shard receives only the boundary rows its in-edges read from other shards,
then runs the unchanged layer body (`models.iegmn.iegmn_layer_forward` with
src views) on its local block, with a ring cross-attention.

  host   `build_halo_batch`: reorder nodes (reverse Cuthill-McKee, so blocks
         are graph-compact and halos small), plan per (owner, dest) send
         lists in two tiers, remap the neighbour tables into each shard's
         [local | from prev | from next | residual] index space. Numpy, the
         JAX package's planner line for line: its arrays equal the JAX
         package's bit for bit; they stay on the host. Then, port only,
         each side's exchange table (`exchange_table`): the stacked row
         each slot of that space reads, and its inverse, once per batch,
         on the batch's device.
  device `make_halo_forward` / `make_halo_train_step`: the shards of a
         `ParallelMesh` are blocks of stacked tensors on one device
         (`parallel/mesh.py`), so a shard reads the rows it receives where
         their owner holds them. Per layer both sides' exchanges are one
         launch of row 8 (`ops/cuda/halo_ring.py::halo_exchange_pair`, a
         gather by the tables), whatever the tier: the composition of the
         takes, the ring (`pallas_halo.ring_exchange` / `ring_ship`), the
         ragged unpack and the residual all_to_all that the JAX package
         runs with `parallel.pallas_ring_halo` on; their backward is one
         launch of row 9. The trunk ends with the all-gather of x and h;
         the keypoint head and the Kabsch fit run densely.
         `ring_composition` keeps that composition in plain PyTorch, the
         reference the tables are pinned to.

Moving rows between cards (NCCL send/recv, peer stores) is not ported:
a mesh that names several devices raises (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config, ModelConfig
from ..graph import PairBatch, ProteinBatch
from ..models.iegmn import (check_supported, fused_edge_eligible, iegmn_layer_forward,
                            keypoint_head, layer_params, trunk_inputs, uses_batch_norm)
from ..ops.cuda.edge_message import inverse_neighbors
from ..ops.cuda.halo_ring import (ExchangeTable, halo_exchange_pair, halo_exchange_sides,
                                   ring_exchange, ring_ship, take_rows)
from ..ops.kabsch import apply_rigid
from ..params import flatten
from .mesh import ParallelMesh
from .ring_attention import ring_cross_attention_local

HALO_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


# --------------------------------------------------------------------------- #
# Host-side partition planning
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class HaloPlan:
    """Per-side exchange plan (int32 tensors), two tiers.

    Ring tier: `send_next` / `send_prev` (B, gp, Hr), local row indices each
    owner shard ships to shard + 1 / shard - 1. Residual tier: `send_res`
    (B, gp, gp * Hres) for the rare |i - j| >= 2 references (Hres usually 0).

    Ragged ring transport (`build_halo_batch(ragged=True, dp=...)`): each
    (element, owner) boundary at its exact width, packed into one flat buffer
    per direction: `send_next_flat` / `send_prev_flat` (dp, gp, R), indices
    into the owner's flattened (B/dp * S) rows (padding slots name row 0:
    shipped, never read); `unpack_prev` / `unpack_next` (dp, gp, B/dp, Hr),
    where each padded-view slot lives in the received flat buffer (clamped
    past the element's true width; the remapped tables never read those).
    The [local | from prev | from next | residual] view the layer body
    indexes is the same either way. The device path reads the side's
    `exchange_table` instead; `ring_composition` reads these."""

    send_next: torch.Tensor
    send_prev: torch.Tensor
    send_res: torch.Tensor
    send_next_flat: Optional[torch.Tensor] = None
    send_prev_flat: Optional[torch.Tensor] = None
    unpack_prev: Optional[torch.Tensor] = None
    unpack_next: Optional[torch.Tensor] = None

    @property
    def ragged(self) -> bool:
        return self.send_next_flat is not None


@dataclasses.dataclass
class HaloBatch:
    """A PairBatch whose node arrays are reordered and whose nbr tables are
    remapped to each shard's local + halo index space, plus the plans (on
    the host) and their exchange tables (on the pair's device). `pair` is
    self-consistent (gt and masks permuted alike), so the losses on it
    equal the dense ones up to the node order."""

    pair: PairBatch
    plan_lig: HaloPlan
    plan_rec: HaloPlan
    table_lig: ExchangeTable
    table_rec: ExchangeTable


@dataclasses.dataclass
class HaloStats:
    """Halo sizes before padding and the static tier widths, for traffic
    accounting."""

    sizes_lig: np.ndarray    # (B, gp, gp) unique remote rows dest i needs of owner j
    sizes_rec: np.ndarray
    hring_lig: int           # padded ring-tier width (rows per direction)
    hring_rec: int
    hres_lig: int            # padded residual-tier width (rows per pair)
    hres_rec: int
    # ragged transport: (R_next, R_prev) flat widths per side, else None;
    # dp is the ragged packing's group count (widths are per group)
    ring_flat_lig: Optional[Tuple[int, int]] = None
    ring_flat_rec: Optional[Tuple[int, int]] = None
    dp: int = 1

    def bytes_per_layer(self, feat_dim: int, padded: bool = True) -> int:
        """Bytes one shard RECEIVES per layer (x and h together: feat_dim + 3
        f32 a row). `padded` counts the buffers as shipped: the two flat
        totals of the ragged tier, else two B/dp x Hr ring chunks, plus gp
        residual chunks per side; otherwise the true demand."""
        gp = self.sizes_lig.shape[1]
        B = self.sizes_lig.shape[0]
        row = 4 * (feat_dim + 3)
        res = (B // max(self.dp, 1)) * gp * (self.hres_lig + self.hres_rec)
        if padded:
            if self.ring_flat_lig is not None:
                ring = sum(self.ring_flat_lig) + sum(self.ring_flat_rec)
            else:
                ring = (B // max(self.dp, 1)) * 2 * (self.hring_lig + self.hring_rec)
            per_shard = ring + res
        else:
            per_shard = int(self.sizes_lig.sum() + self.sizes_rec.sum()) // gp // max(self.dp, 1)
        return per_shard * row

    def full_gather_bytes_per_layer(self, feat_dim: int, n_l: int, n_r: int,
                                    batch: int) -> int:
        """What an all-gather of every remote node row would receive per
        shard, both sides."""
        row = 4 * (feat_dim + 3)
        gp = self.sizes_lig.shape[1]
        return batch * ((n_l - n_l // gp) + (n_r - n_r // gp)) * row


def spatial_permutation(x: np.ndarray, nbr: np.ndarray, nbr_mask: np.ndarray,
                        n_valid: int) -> np.ndarray:
    """Node order that makes contiguous blocks graph-compact: reverse
    Cuthill-McKee on the symmetrised kNN adjacency; a principal-axis sort of
    the coordinates without scipy. Padding rows stay at the end."""
    n_total = x.shape[0]
    if n_valid <= 1:
        return np.arange(n_total)
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        K = nbr.shape[1]
        dst = np.repeat(np.arange(n_total), K)
        src = np.asarray(nbr).reshape(-1)
        ok = (np.asarray(nbr_mask).reshape(-1) > 0) & (dst < n_valid) & (src < n_valid)
        A = sp.coo_matrix((np.ones(int(ok.sum())), (dst[ok], src[ok])),
                          shape=(n_valid, n_valid)).tocsr()
        A = (A + A.T).tocsr()
        order = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    except ImportError:
        order = principal_axis_order(x, n_valid)
    return np.concatenate([order, np.arange(n_valid, n_total)])


def principal_axis_order(x: np.ndarray, n_valid: int) -> np.ndarray:
    """The valid nodes sorted along the coordinates' principal axis."""
    xs = np.asarray(x[:n_valid], np.float64)
    c = xs - xs.mean(0)
    _, vecs = np.linalg.eigh(c.T @ c)
    return np.argsort(c @ vecs[:, -1], kind="stable")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def permute_protein(side: ProteinBatch, perms: np.ndarray) -> ProteinBatch:
    """Apply a per-complex node permutation (B, N) to every per-node array;
    nbr rows move with their destination and nbr values are renumbered."""
    B, N = perms.shape
    dev = side.x.device
    inv = np.zeros_like(perms)
    rows = np.arange(B)[:, None]
    inv[rows, perms] = np.arange(N)[None, :]

    def pnode(a):
        return torch.from_numpy(np.ascontiguousarray(_np(a)[rows, perms])).to(dev)

    nbr = _np(side.nbr)[rows, perms]                   # rows follow dst
    nbr = inv[rows[..., None], nbr]                    # values renumbered
    return ProteinBatch(res_id=pnode(side.res_id), x=pnode(side.x),
                        mu_r_norm=pnode(side.mu_r_norm),
                        nbr=torch.from_numpy(nbr.astype(np.int32)).to(dev),
                        nbr_mask=pnode(side.nbr_mask), edge_feat=pnode(side.edge_feat),
                        node_mask=pnode(side.node_mask))


def _bucketed(required: int, cap: int) -> int:
    h = next((h for h in HALO_BUCKETS if h >= required), required if required else 0)
    return min(h, cap)


def _plan_side(nbr: np.ndarray, nbr_mask: np.ndarray, gp: int, hmax: Optional[int] = None):
    """Two-tier send lists and remapped neighbour tables for one side.

    Returns (plan arrays dict, nbr_local (B, N, K) int32, sizes (B, gp, gp)
    int32, hr, hres). Gathered layout on destination shard i:
        [local S | from i-1 (Hr) | from i+1 (Hr) | residual gp * Hres]
    `hmax` forces both tier widths (tests)."""
    B, N, K = nbr.shape
    assert N % gp == 0, (N, gp)
    S = N // gp

    # pass 1: unique remote-source lists per (batch, dest, owner)
    sizes = np.zeros((B, gp, gp), np.int32)
    uniq: dict = {}
    for b in range(B):
        for i in range(gp):
            rows = nbr[b, i * S:(i + 1) * S]
            msk = nbr_mask[b, i * S:(i + 1) * S] > 0
            srcs = np.where(msk, rows, i * S)          # masked edges: local
            owners = srcs // S
            for j in range(gp):
                if j == i:
                    continue
                in_j = np.unique(srcs[owners == j])
                uniq[(b, i, j)] = in_j
                sizes[b, i, j] = len(in_j)

    ring_req = max([sizes[b, i, j] for b in range(B) for i in range(gp) for j in range(gp)
                    if abs(i - j) == 1] or [0])
    res_req = max([sizes[b, i, j] for b in range(B) for i in range(gp) for j in range(gp)
                   if abs(i - j) >= 2] or [0])
    hr = _bucketed(ring_req, S) if hmax is None else hmax
    hres = _bucketed(res_req, S) if hmax is None else hmax
    hr = max(hr, 1)                      # keep nonzero ring shapes
    assert ring_req <= hr and res_req <= hres, (ring_req, hr, res_req, hres)

    send_next = np.zeros((B, gp, hr), np.int32)        # shard j -> j+1
    send_prev = np.zeros((B, gp, hr), np.int32)        # shard j -> j-1
    send_res = np.zeros((B, gp, gp * hres), np.int32)
    nbr_local = np.zeros_like(nbr, dtype=np.int32)
    for b in range(B):
        for i in range(gp):
            rows = nbr[b, i * S:(i + 1) * S]
            msk = nbr_mask[b, i * S:(i + 1) * S] > 0
            srcs = np.where(msk, rows, i * S)
            maptab = np.zeros(N, np.int64)
            maptab[i * S:(i + 1) * S] = np.arange(S)
            for j in range(gp):
                if j == i:
                    continue
                in_j = uniq[(b, i, j)]
                t = np.arange(len(in_j))
                if j == i - 1:                         # ring: from prev
                    send_next[b, j, :len(in_j)] = in_j - j * S
                    maptab[in_j] = S + t
                elif j == i + 1:                       # ring: from next
                    send_prev[b, j, :len(in_j)] = in_j - j * S
                    maptab[in_j] = S + hr + t
                else:                                  # residual tier
                    send_res[b, j, i * hres:i * hres + len(in_j)] = in_j - j * S
                    maptab[in_j] = S + 2 * hr + j * hres + t
            nbr_local[b, i * S:(i + 1) * S] = maptab[srcs]
    plan = dict(send_next=send_next, send_prev=send_prev, send_res=send_res)
    return plan, nbr_local, sizes, hr, hres


def _pack_ring(plan: dict, sizes: np.ndarray, S: int, hr: int, dp: int):
    """Ragged ring tables (see HaloPlan): each (element, owner) boundary at
    its exact width in one flat buffer per direction, whose width is the
    max over (dp group, owner) of the summed demand, rounded up to 32."""
    B, gp, _ = sizes.shape
    assert B % dp == 0, (B, dp)
    Bl = B // dp
    # rows owner j ships toward j+1 (dest j+1's demand of j) / toward j-1
    w_next = np.zeros((B, gp), np.int64)
    w_prev = np.zeros((B, gp), np.int64)
    w_next[:, : gp - 1] = np.stack([sizes[:, j + 1, j] for j in range(gp - 1)], axis=1)
    w_prev[:, 1:] = np.stack([sizes[:, j - 1, j] for j in range(1, gp)], axis=1)

    def pack(w, send):
        group_sum = w.reshape(dp, Bl, gp).sum(axis=1)          # (dp, gp)
        req = int(group_sum.max())
        R = max(1, min(((req + 31) // 32) * 32, Bl * S)) if req else 1
        flat = np.zeros((dp, gp, R), np.int32)
        offs = np.zeros((dp, gp, Bl), np.int64)
        for d in range(dp):
            for j in range(gp):
                off = 0
                for bl in range(Bl):
                    b = d * Bl + bl
                    offs[d, j, bl] = off
                    k = int(w[b, j])
                    flat[d, j, off:off + k] = bl * S + send[b, j, :k]
                    off += k
        return flat, offs, R

    flat_next, offs_next, r_next = pack(w_next, plan["send_next"])
    flat_prev, offs_prev, r_prev = pack(w_prev, plan["send_prev"])

    # dest-side unpack: shard i reads owner i-1's next buffer (its from
    # prev) / owner i+1's prev buffer (its from next); slots past the
    # element's true width are clamped (never read through nbr_local)
    t = np.arange(hr)
    unpack_prev = np.zeros((dp, gp, Bl, hr), np.int32)
    unpack_next = np.zeros((dp, gp, Bl, hr), np.int32)
    for d in range(dp):
        for i in range(gp):
            if i > 0:
                unpack_prev[d, i] = np.minimum(offs_next[d, i - 1][:, None] + t[None, :],
                                               r_next - 1)
            if i < gp - 1:
                unpack_next[d, i] = np.minimum(offs_prev[d, i + 1][:, None] + t[None, :],
                                               r_prev - 1)
    plan["send_next_flat"] = flat_next
    plan["send_prev_flat"] = flat_prev
    plan["unpack_prev"] = unpack_prev
    plan["unpack_next"] = unpack_next
    return r_next, r_prev


table_builds = 0    # exchange tables built (`exchange_table`), one a side a batch


def exchange_table(plan: dict, N: int, device="cpu") -> ExchangeTable:
    """One side's exchange as a table (numpy, port only): `src_row` (B, gp,
    Ssrc) int32 with Ssrc = S + 2 Hr + gp Hres, the stacked row b N + n that
    slot s of shard p's [local | from prev | from next | residual] view
    holds for complex b, or -1 where the ring's chain ends hold zeros; and
    its inverse in CSR form over the B N stacked rows: `order`, the
    flat slots (b gp + p) Ssrc + s that read a row, ascending within each
    row (a stable argsort), and `offsets` (B N + 1,) (a searchsorted).
    Returned on `device`; `mesh_table` folds it for a mesh's dp (a ragged
    plan's table only for the dp it was packed for).

    It is the composition `ring_composition` runs (the takes, the ring or
    the ragged ship and unpack, the residual all_to_all), slot by slot:
    padding slots name row 0 of their owner shard, ragged unpack slots past
    an element's width may name another complex of its group, residual
    chunks of a shard's own or ring neighbours' name their row 0."""
    global table_builds
    table_builds += 1
    B, gp, hr = plan["send_next"].shape
    S = N // gp
    hres = plan["send_res"].shape[-1] // gp
    Ssrc = S + 2 * hr + gp * hres
    base = (np.arange(B) * N)[:, None]
    src = np.full((B, gp, Ssrc), -1, np.int64)
    ragged = plan.get("send_next_flat") is not None
    if ragged:
        dp = plan["send_next_flat"].shape[0]
        Bl = B // dp

        def unpacked(flat, unpack, owner):
            # received flat buffer entry -> owner's flattened (Bl S) row ->
            # stacked row; one (B, Hr) block of the destination
            v = np.take_along_axis(flat[:, owner], unpack.reshape(dp, Bl * hr), axis=1)
            bl, r = v // S, v % S
            b = np.arange(dp)[:, None] * Bl + bl
            return (b * N + owner * S + r).reshape(B, hr)

    for i in range(gp):
        src[:, i, :S] = base + i * S + np.arange(S)
        lo, hi = S, S + hr
        if i > 0:
            src[:, i, lo:hi] = (unpacked(plan["send_next_flat"], plan["unpack_prev"][:, i], i - 1)
                                if ragged else base + (i - 1) * S + plan["send_next"][:, i - 1])
        if i < gp - 1:
            src[:, i, hi:hi + hr] = (
                unpacked(plan["send_prev_flat"], plan["unpack_next"][:, i], i + 1)
                if ragged else base + (i + 1) * S + plan["send_prev"][:, i + 1])
        for j in range(gp):
            o = S + 2 * hr + j * hres
            src[:, i, o:o + hres] = base + j * S + plan["send_res"][:, j, i * hres:(i + 1) * hres]
    flat = src.reshape(-1)
    slots = np.flatnonzero(flat >= 0)
    order = slots[np.argsort(flat[slots], kind="stable")]
    offsets = np.searchsorted(flat[order], np.arange(B * N + 1))
    T = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
    return ExchangeTable(T(src), T(order), T(offsets), N=N, dp=dp if ragged else 1,
                         ragged=ragged)


def build_halo_batch(pair: PairBatch, gp: int, spatial: bool = True,
                     hmax: Optional[int] = None, ragged: bool = False, dp: int = 1
                     ) -> Tuple[HaloBatch, HaloStats, np.ndarray, np.ndarray]:
    """Host side: reorder, plan, remap. Returns (HaloBatch: pair and
    exchange tables on the pair's device, plans on the host; HaloStats,
    perm_lig, perm_rec); a perm maps new position ->
    original index, so `halo_out[b] == dense_out[b][perm[b]]`."""
    lig, rec = pair.lig, pair.rec
    B = lig.x.shape[0]
    dev = lig.x.device

    def side_perm(side: ProteinBatch) -> np.ndarray:
        N = side.x.shape[1]
        if not spatial:
            return np.tile(np.arange(N), (B, 1))
        x, nbr = _np(side.x), _np(side.nbr)
        nm, nbrm = _np(side.node_mask), _np(side.nbr_mask)
        return np.stack([spatial_permutation(x[b], nbr[b], nbrm[b], int(nm[b].sum()))
                         for b in range(B)])

    perm_l = side_perm(lig)
    perm_r = side_perm(rec)
    lig_p = permute_protein(lig, perm_l)
    rec_p = permute_protein(rec, perm_r)
    gt_p = _np(pair.gt_lig)[np.arange(B)[:, None], perm_l]

    plan_l, nbr_l, sz_l, hr_l, hres_l = _plan_side(_np(lig_p.nbr), _np(lig_p.nbr_mask), gp, hmax)
    plan_r, nbr_r, sz_r, hr_r, hres_r = _plan_side(_np(rec_p.nbr), _np(rec_p.nbr_mask), gp, hmax)
    rf_l = rf_r = None
    if ragged:
        rf_l = _pack_ring(plan_l, sz_l, lig_p.x.shape[1] // gp, hr_l, dp)
        rf_r = _pack_ring(plan_r, sz_r, rec_p.x.shape[1] // gp, hr_r, dp)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    host = lambda plan: HaloPlan(**{k: torch.from_numpy(np.ascontiguousarray(v))
                                    for k, v in plan.items()})
    pair_p = PairBatch(
        lig=dataclasses.replace(lig_p, nbr=T(nbr_l)),
        rec=dataclasses.replace(rec_p, nbr=T(nbr_r)),
        gt_lig=T(gt_p), pocket_lig=pair.pocket_lig, pocket_rec=pair.pocket_rec,
        pocket_mask=pair.pocket_mask, pair_mask=pair.pair_mask)
    hb = HaloBatch(pair=pair_p, plan_lig=host(plan_l), plan_rec=host(plan_r),
                   table_lig=exchange_table(plan_l, lig_p.x.shape[1], dev),
                   table_rec=exchange_table(plan_r, rec_p.x.shape[1], dev))
    stats = HaloStats(sizes_lig=sz_l, sizes_rec=sz_r, hring_lig=hr_l, hring_rec=hr_r,
                      hres_lig=hres_l, hres_rec=hres_r, ring_flat_lig=rf_l,
                      ring_flat_rec=rf_r, dp=dp if ragged else 1)
    return hb, stats, perm_l, perm_r


# --------------------------------------------------------------------------- #
# Device side: exchange + sharded trunk
# --------------------------------------------------------------------------- #

def mesh_table(table: ExchangeTable, mesh: ParallelMesh) -> ExchangeTable:
    """One side's exchange table on `mesh`: the same tensors, folded for
    the mesh's dp (no copy, no rebuild)."""
    B, gp = table.src_row.shape[:2]
    if gp != mesh.gp or B % mesh.dp:
        raise ValueError(f"table of {B} complexes x {gp} shards does not fit {mesh}")
    if table.ragged and table.dp != mesh.dp:
        raise ValueError(f"ragged plan packed for ({table.dp}, {gp}) (dp, gp) groups, "
                         f"mesh {mesh}")
    return dataclasses.replace(table, dp=mesh.dp)


def halo_exchange(x, h, table: ExchangeTable, mesh: ParallelMesh):
    """x (B', S, 3), h (B', S, D): every shard's local block, folded.
    Returns (x_src, h_src) (B', S + 2 Hr + gp Hres, .) laid out as [local |
    from prev | from next | residual], through the side's exchange table:
    row 8 on CUDA tensors (backward row 9), the plain versions on the CPU.
    `_trunk` exchanges both sides of a layer in one call
    (`halo_exchange_pair`)."""
    return halo_exchange_sides((mesh_table(table, mesh),), (x, h))


def ring_composition(x, h, plan: HaloPlan, mesh: ParallelMesh):
    """The exchange as the JAX package composes it (`_halo_exchange` with
    `pallas_ring_halo`), in plain PyTorch: x and h shipped in one buffer;
    ring tier: the takes of the padded send chunks and the ring exchange,
    or the ragged flat buffers, the both-way ship and the unpack; residual
    tier: the (owner, dest) block transpose. Launches no kernel; the
    reference `exchange_table` is pinned to. Copies the plan's arrays to
    x's device. Returns (x_src, h_src) as `halo_exchange`."""
    if plan.ragged and plan.send_next_flat.shape[:2] != (mesh.dp, mesh.gp):
        raise ValueError(f"ragged plan packed for {tuple(plan.send_next_flat.shape[:2])} "
                         f"(dp, gp) groups, mesh {mesh}")
    hp = HaloPlan(**{f.name: None if getattr(plan, f.name) is None
                     else getattr(plan, f.name).to(x.device)
                     for f in dataclasses.fields(HaloPlan)})
    xh = torch.cat([x, h], dim=-1)
    Bp, S, F = xh.shape
    G, P = mesh.dp, mesh.gp
    if hp.ragged:
        flat = xh.reshape(G * P, Bp // (G * P) * S, F)
        per_group = lambda a: a.reshape(G * P, -1)
        snd_n = take_rows(flat, per_group(hp.send_next_flat)).reshape(G, P, -1, F)
        snd_p = take_rows(flat, per_group(hp.send_prev_flat)).reshape(G, P, -1, F)
        from_prev, from_next = ring_ship(snd_n, snd_p)
        unpack = lambda buf, idx: take_rows(buf.reshape(G * P, -1, F),
                                            per_group(idx)).reshape(Bp, -1, F)
        parts = [xh, unpack(from_prev, hp.unpack_prev), unpack(from_next, hp.unpack_next)]
    else:
        snd_n = mesh.unfold(take_rows(xh, mesh.fold_plan(hp.send_next)))
        snd_p = mesh.unfold(take_rows(xh, mesh.fold_plan(hp.send_prev)))
        parts = [ring_exchange(mesh.unfold(xh), snd_n, snd_p).reshape(Bp, -1, F)]
    hres = hp.send_res.shape[-1] // P
    if hres > 0:
        snd = mesh.unfold(take_rows(xh, mesh.fold_plan(hp.send_res)))  # (G, P, Bl, P Hres, F)
        blocks = snd.reshape(G, P, snd.shape[2], P, hres, F)          # (G, owner, Bl, dest, ..)
        parts.append(blocks.transpose(1, 3).reshape(Bp, P * hres, F))
    full = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return full[..., :3], full[..., 3:]


def _ring_attend(mesh: ParallelMesh) -> Callable:
    """Cross-attention for the sharded layer body: queries stay local,
    K/V chunks rotate over the ring."""
    def attend(q, k, v, q_mask, k_mask, cross_msgs: bool = True):
        if not cross_msgs:
            return torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=q.dtype, device=q.device)
        out = ring_cross_attention_local(*(mesh.unfold(a) for a in (q, k, v, q_mask, k_mask)))
        return out.reshape(q.shape[:-1] + (v.shape[-1],))
    return attend


def _trunk(p, cfg: ModelConfig, mesh: ParallelMesh, n_lays: int, fine_tune: bool,
           lig: ProteinBatch, rec: ProteinBatch, x_l_in, tab_l: ExchangeTable,
           tab_r: ExchangeTable):
    """The IEGMN trunk on folded node shards. Per layer: the halo exchange
    of both sides in one call, then the unchanged layer body on the local
    blocks. Returns the final x and h of both sides gathered to (B, N, .)."""
    x_l, x_r = x_l_in, rec.x
    h_l, h_r, he_l, he_r = trunk_inputs(p, cfg, lig, rec)
    orig_h_l, orig_h_r = h_l, h_r
    attend = _ring_attend(mesh)
    inv_l = inv_r = None
    for i in range(n_lays):
        xs_l, hs_l, xs_r, hs_r = halo_exchange_pair(x_l, h_l, x_r, h_r, tab_l, tab_r)
        src_l, src_r = (xs_l, hs_l), (xs_r, hs_r)
        if i == 0 and torch.is_grad_enabled():   # the remapped nbr's inverse lists
            inv_l = inverse_neighbors(lig.nbr, src_l[0].shape[1])
            inv_r = inverse_neighbors(rec.nbr, src_r[0].shape[1])
        x_l, h_l, x_r, h_r = iegmn_layer_forward(
            layer_params(cfg, p, i), cfg, fine_tune, i > 0, lig, rec, x_l, h_l, x_r, h_r,
            orig_h_l, orig_h_r, he_l, he_r, x_l_in, rec.x, src_l=src_l, src_r=src_r,
            attend=attend, inv_l=inv_l, inv_r=inv_r)
    return tuple(mesh.gather(a) for a in (x_l, h_l, x_r, h_r))


def check_halo_supported(cfg: ModelConfig) -> None:
    """Raise for what the halo path does not compute (beyond the kernels'
    own limits, `check_supported`)."""
    check_supported(cfg)
    if cfg.dropout != 0.0:
        raise NotImplementedError(f"dropout={cfg.dropout}: the halo path runs dropout 0 only")
    if not fused_edge_eligible(cfg, train=True) or uses_batch_norm(cfg):
        raise NotImplementedError(
            f"the halo path runs the edge kernels without BatchNorm only: nonlin={cfg.nonlin!r}, "
            f"layer_norm={cfg.layer_norm!r}, layer_norm_coors={cfg.layer_norm_coors!r}, "
            f"final_h_layer_norm={cfg.final_h_layer_norm!r}")
    if cfg.final_h_layer_norm == "GN":
        raise NotImplementedError("final_h_layer_norm='GN' in the halo path: GraphNorm "
                                  "statistics summed across shards are not ported")


def make_halo_forward(cfg: Config, mesh: ParallelMesh):
    """Returns forward(params, hb, n_lays=None): `docking_forward` over a
    HaloBatch, the sharded trunk(s) plus the dense keypoint head and rigid
    fit, with the same output dict (coordinates in the HaloBatch's node
    order; with a fine-tune stage, (R, t) composed from the original input
    ligand, as the dense forward does)."""
    mc = cfg.model
    check_halo_supported(mc)

    def stage(params_stage, hb: HaloBatch, x_l_in, n_lays: int, fine_tune: bool):
        lig, rec = hb.pair.lig, hb.pair.rec
        for t in (lig.x, rec.x, x_l_in):
            if t.device != mesh.device:
                raise ValueError(f"halo batch on {t.device}, mesh on {mesh.device}")
        x_l_f, h_l_f, x_r_f, h_r_f = _trunk(
            params_stage, mc, mesh, n_lays, fine_tune, mesh.shard_protein(lig),
            mesh.shard_protein(rec), mesh.fold(x_l_in), mesh_table(hb.table_lig, mesh),
            mesh_table(hb.table_rec, mesh))
        return keypoint_head(params_stage, mc, h_l_f, x_l_f, h_r_f, x_r_f,
                             lig.node_mask, rec.node_mask)

    def forward(params, hb: HaloBatch, n_lays: Optional[int] = None) -> Dict[str, torch.Tensor]:
        n_lays = n_lays if n_lays is not None else mc.iegmn_n_lays
        x_l = hb.pair.lig.x
        if mc.fine_tune and "finetune" in params:
            R0, t0, _, _ = stage(params["original"], hb, x_l, n_lays, False)
            x_l = apply_rigid(x_l, R0, t0)
            R2, t2, kl, kr = stage(params["finetune"], hb, x_l, 2, True)
            lig_pred = apply_rigid(x_l, R2, t2)
            R = torch.einsum("bij,bjk->bik", R2, R0)
            t = torch.einsum("bij,bnj->bni", R2, t0) + t2
        else:
            R, t, kl, kr = stage(params["original"], hb, x_l, n_lays, False)
            lig_pred = apply_rigid(x_l, R, t)
        return {"ligand_coords": lig_pred, "keypts_lig": kl, "keypts_rec": kr, "R": R, "t": t}

    return forward


def make_halo_loss(cfg: Config, mesh: ParallelMesh):
    """The `loss_fn_` of `train/step.py` for a HaloBatch: the halo forward,
    then `total_loss` on the permuted pair (the JAX `halo_loss_fn`)."""
    from ..train.losses import total_loss

    fwd = make_halo_forward(cfg, mesh)

    def halo_loss_fn(params, cfg_: Config, hb: HaloBatch):
        out = fwd(params, hb)
        loss, metrics = total_loss(out, hb.pair, cfg_.train)
        return loss, (metrics, out)

    return halo_loss_fn


def make_halo_train_step(cfg: Config, mesh: ParallelMesh):
    """Returns step(state, hb, lr_scale=1.0) -> (state, metrics): the port's
    `train_step` with the halo loss swapped in, so the optimizer, the clip
    telemetry and the "no gradient reached" check are the dense step's. As
    in the JAX package, the metrics leave out ligand_coords."""
    from ..train.step import train_step

    halo_loss_fn = make_halo_loss(cfg, mesh)

    def step(state, hb: HaloBatch, lr_scale: float = 1.0):
        dev = next(iter(flatten(state.params).values())).device
        if dev != mesh.device:
            raise ValueError(f"train state on {dev}, mesh on {mesh.device}")
        state, metrics = train_step(state, hb, cfg, lr_scale, loss_fn_=halo_loss_fn)
        metrics.pop("ligand_coords", None)
        return state, metrics

    return step
