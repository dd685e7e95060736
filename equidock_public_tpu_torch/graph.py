"""Padded, fixed-shape batch schema: the port of `equidock_public_tpu/graph.py`,
unpacked (one complex per slot) and packed (several complexes a slot).

The layout is the JAX package's: node arrays (B, N, ...), neighbor tables
`nbr` (B, N, K) int32 and `nbr_mask` (B, N, K), padded to a node bucket.
Padded nodes self-loop with a zero mask, so message passing needs no
special case for them.

Packed batches (`collate_packed`) concatenate a slot's complexes along the
node axis, their neighbour indices offset so that the table stays
block-diagonal; `seg_id` names each node's complex, and the per-complex
labels grow a segment axis. The planner (`plan_packing`, `packed_shape`)
is the JAX package's, bit for bit.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import bucket_for
from .data.featurize import ProteinGraph


@dataclasses.dataclass
class ProteinBatch:
    """One side (ligand or receptor) of a batch of complexes, padded to N."""

    res_id: torch.Tensor      # (B, N) int64 residue-type index
    x: torch.Tensor           # (B, N, 3) f32 current coordinates
    mu_r_norm: torch.Tensor   # (B, N, 5) f32 (padded entries 1.0: log() = 0)
    nbr: torch.Tensor         # (B, N, K) int32 source-node index per in-edge
    nbr_mask: torch.Tensor    # (B, N, K) f32 {0, 1}
    edge_feat: torch.Tensor   # (B, N, K, 27) f32
    node_mask: torch.Tensor   # (B, N) f32 {0, 1}
    seg_id: Optional[torch.Tensor] = None   # (B, N) int32 in [0, C); packed only

    def seg_onehot(self, n_segs: int) -> torch.Tensor:
        """(B, N, C) f32: each node's complex, zero rows for padded nodes."""
        oh = (self.seg_id[..., None] == torch.arange(n_segs, device=self.seg_id.device,
                                                     dtype=self.seg_id.dtype))
        return oh.to(torch.float32) * self.node_mask[..., None]


@dataclasses.dataclass
class PairBatch:
    """A batch of ligand/receptor complexes plus the training-label slots
    (`gt_lig`, pockets) that serving fills with placeholders.

    Packed (`n_segs` C > 1): pockets (B, C, P, 3), pocket_mask (B, C, P),
    seg_mask (B, C); complexes are indexed m = b * C + c, and `pair_mask`
    stays (B,), 1 where the slot holds a complex."""

    lig: ProteinBatch
    rec: ProteinBatch
    gt_lig: torch.Tensor       # (B, N_l, 3)
    pocket_lig: torch.Tensor   # (B, [C,] P, 3)
    pocket_rec: torch.Tensor   # (B, [C,] P, 3)
    pocket_mask: torch.Tensor  # (B, [C,] P)
    pair_mask: torch.Tensor    # (B,) 0 for padding slots
    seg_mask: Optional[torch.Tensor] = None  # (B, C) f32 {0, 1}; packed only
    n_segs: int = 1

    @property
    def complex_mask(self) -> torch.Tensor:
        """(M,) validity over the complexes, M = B * n_segs."""
        return self.pair_mask if self.n_segs == 1 else self.seg_mask.reshape(-1)


def _pad_axis0(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, constant_values=fill)


class PadCache:
    """The padded static fields of each (graph, n_max), built once: the
    port of `equidock_public_tpu/graph.py::PadCache` (`-pad_cache_gb`).
    Augmentation moves only coordinates, so res_id, mu_r_norm, the
    neighbour tables and edge features pad alike every epoch. Keyed on the
    live graph object by weak reference (an entry dies with its graph),
    bounded by `max_bytes` of padded arrays, least recently used out first
    (an evicted entry is rebuilt at its next use). Callers copy an entry's
    dict before changing a field, so a batch is bit-equal with and without
    the cache."""

    def __init__(self, max_bytes: int = 4 << 30):
        self.max_bytes = int(max_bytes)
        self._cache: "weakref.WeakKeyDictionary[ProteinGraph, dict]" = weakref.WeakKeyDictionary()
        self._lru: "collections.OrderedDict[tuple, int]" = collections.OrderedDict()
        self._refs: dict = {}       # id(graph) -> weak reference
        self._gid_keys: dict = {}   # id(graph) -> its live LRU keys
        self._bytes = 0
        self.hits = self.misses = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._lru)

    def _drop_key(self, key: tuple) -> None:
        gid = key[0]
        keys = self._gid_keys.get(gid)
        if keys is not None:
            keys.discard(key)
            if not keys:
                self._gid_keys.pop(gid, None)
                self._refs.pop(gid, None)

    def _forget_graph(self, gid: int) -> None:
        for key in self._gid_keys.pop(gid, set()):
            self._bytes -= self._lru.pop(key, 0)
        self._refs.pop(gid, None)

    def get(self, g: ProteinGraph, n_max: int) -> dict:
        """`pad_protein(g, n_max)`, from the cache when held (do not change
        the dict or its arrays)."""
        per_graph = self._cache.get(g)
        if per_graph is None:
            per_graph = {}
            self._cache[g] = per_graph
            weakref.finalize(g, self._forget_graph, id(g))
        key = (id(g), n_max)
        hit = per_graph.get(n_max)
        if hit is not None:
            self.hits += 1
            self._lru.move_to_end(key)
            return hit
        self.misses += 1
        hit = pad_protein(g, n_max)
        nb = sum(a.nbytes for a in hit.values())
        if nb <= self.max_bytes:
            per_graph[n_max] = hit
            self._refs[id(g)] = weakref.ref(g)
            self._gid_keys.setdefault(id(g), set()).add(key)
            self._lru[key] = nb
            self._bytes += nb
            while self._bytes > self.max_bytes and self._lru:
                (ogid, on), onb = self._lru.popitem(last=False)
                self._bytes -= onb
                ref = self._refs.get(ogid)
                og = ref() if ref is not None else None
                if og is not None:
                    self._cache.get(og, {}).pop(on, None)
                self._drop_key((ogid, on))
        return hit


def _padded(g: ProteinGraph, n_max: int, pad_cache: Optional[PadCache]) -> dict:
    """A fresh dict of g's padded fields (its arrays shared with the cache)."""
    return dict(pad_cache.get(g, n_max)) if pad_cache is not None else pad_protein(g, n_max)


def pad_protein(g: ProteinGraph, n_max: int) -> dict:
    """Pad one ProteinGraph to n_max nodes. Padded nodes self-loop (masked)."""
    n = g.num_nodes
    if n > n_max:
        raise ValueError(f"{n} nodes do not fit a bucket of {n_max}")
    pad_nbr = np.tile(np.arange(n, n_max, dtype=np.int32)[:, None],
                      (1, g.nbr.shape[1]))
    node_mask = np.zeros(n_max, dtype=np.float32)
    node_mask[:n] = 1.0
    return dict(
        res_id=_pad_axis0(g.res_id.astype(np.int64), n_max),
        x=_pad_axis0(g.x.astype(np.float32), n_max),
        mu_r_norm=_pad_axis0(g.mu_r_norm.astype(np.float32), n_max, fill=1.0),
        nbr=np.concatenate([g.nbr.astype(np.int32), pad_nbr], axis=0),
        nbr_mask=_pad_axis0(g.nbr_mask.astype(np.float32), n_max),
        edge_feat=_pad_axis0(g.edge_feat.astype(np.float32), n_max),
        node_mask=node_mask)


def collate(
    ligs: Sequence[ProteinGraph],
    recs: Sequence[ProteinGraph],
    lig_new_x: Sequence[np.ndarray],
    gt_lig: Sequence[np.ndarray],
    pockets_lig: Sequence[np.ndarray],
    pockets_rec: Sequence[np.ndarray],
    node_buckets: Tuple[int, ...],
    pocket_buckets: Tuple[int, ...],
    device: torch.device,
    batch_size: Optional[int] = None,
    pin_memory: bool = False,
    pad_cache: Optional[PadCache] = None,
) -> PairBatch:
    """Collate complexes into one padded PairBatch on `device` (with
    `pin_memory`, on the CPU in page-locked memory instead; `pad_cache`
    serves the padded static fields).

    `lig_new_x` is the ligand's input coordinates; `gt_lig` the bound target.
    Slots past len(ligs) repeat the last complex with every mask zeroed."""
    b_actual = len(ligs)
    B = batch_size if batch_size is not None else b_actual
    if not 0 < b_actual <= B:
        raise ValueError(f"{b_actual} complexes for a batch of {B}")
    n_l = bucket_for(max(g.num_nodes for g in ligs), node_buckets)
    n_r = bucket_for(max(g.num_nodes for g in recs), node_buckets)
    P = bucket_for(max(p.shape[0] for p in pockets_lig), pocket_buckets)

    def to(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if pin_memory else t.to(device)

    def stack_side(graphs, n_max, coords_override) -> ProteinBatch:
        cols: List[dict] = []
        for i in range(B):
            j = min(i, b_actual - 1)
            d = _padded(graphs[j], n_max, pad_cache)
            if coords_override is not None:
                d["x"] = _pad_axis0(
                    np.asarray(coords_override[j], dtype=np.float32), n_max)
            if i >= b_actual:
                d["nbr_mask"] = np.zeros_like(d["nbr_mask"])
                d["node_mask"] = np.zeros_like(d["node_mask"])
            cols.append(d)
        return ProteinBatch(**{k: to(np.stack([c[k] for c in cols]))
                               for k in cols[0]})

    def stack_pad(arrs, n_max):
        return to(np.stack([
            _pad_axis0(np.asarray(arrs[min(i, b_actual - 1)], np.float32), n_max)
            for i in range(B)]))

    pocket_mask = np.zeros((B, P), dtype=np.float32)
    for i in range(b_actual):
        pocket_mask[i, : pockets_lig[i].shape[0]] = 1.0
    pair_mask = np.zeros(B, dtype=np.float32)
    pair_mask[:b_actual] = 1.0
    return PairBatch(
        lig=stack_side(ligs, n_l, lig_new_x),
        rec=stack_side(recs, n_r, None),
        gt_lig=stack_pad(gt_lig, n_l),
        pocket_lig=stack_pad(pockets_lig, P),
        pocket_rec=stack_pad(pockets_rec, P),
        pocket_mask=to(pocket_mask),
        pair_mask=to(pair_mask))


def batch_to(batch: PairBatch, device, non_blocking: bool = False) -> PairBatch:
    """Every tensor of the batch on `device` (asynchronous from pinned memory
    with `non_blocking`)."""
    move = lambda t: (t.to(device, non_blocking=non_blocking)
                      if isinstance(t, torch.Tensor) else t)
    side = lambda pb: ProteinBatch(**{f.name: move(getattr(pb, f.name))
                                      for f in dataclasses.fields(pb)})
    return PairBatch(lig=side(batch.lig), rec=side(batch.rec),
                     **{f.name: move(getattr(batch, f.name)) for f in dataclasses.fields(batch)
                        if f.name not in ("lig", "rec")})


def batch_digest(batch: PairBatch) -> dict:
    """A fingerprint of a batch that two featurizers which agree to f32
    rounding give alike: per field its shape, for integer and 0/1 fields a
    sha256 of the values, for float fields the sum and the sum of absolute
    values in float64 (compared with a relative tolerance)."""
    import hashlib

    def one(t: torch.Tensor) -> dict:
        a = t.detach().cpu().numpy()
        d = {"shape": list(a.shape)}
        if a.dtype.kind in "iub" or np.isin(a, (0.0, 1.0)).all():
            d["sha256"] = hashlib.sha256(np.ascontiguousarray(a.astype(np.int64))).hexdigest()
        else:
            d["sum"] = float(a.astype(np.float64).sum())
            d["abs_sum"] = float(np.abs(a.astype(np.float64)).sum())
        return d

    out = {}
    for name in ("lig", "rec"):
        side = getattr(batch, name)
        for f in dataclasses.fields(side):
            if getattr(side, f.name) is not None:
                out[f"{name}.{f.name}"] = one(getattr(side, f.name))
    for f in ("gt_lig", "pocket_lig", "pocket_rec", "pocket_mask", "pair_mask", "seg_mask"):
        if getattr(batch, f) is not None:
            out[f] = one(getattr(batch, f))
    if batch.n_segs != 1:
        out["n_segs"] = {"shape": [], "sha256": str(batch.n_segs)}
    return out


def digests_agree(got: dict, want: dict, rtol: float = 1e-5) -> list:
    """The fields where two `batch_digest`s differ (empty when they agree)."""
    bad = []
    for key in sorted(set(got) | set(want)):
        g, w = got.get(key), want.get(key)
        if g is None or w is None or g["shape"] != w["shape"] or set(g) != set(w):
            bad.append(key)
        elif "sha256" in w:
            if g["sha256"] != w["sha256"]:
                bad.append(key)
        elif any(abs(g[k] - w[k]) > rtol * max(abs(w[k]), 1.0) for k in ("sum", "abs_sum")):
            bad.append(key)
    return bad


# --------------------------------------------------------------------------- #
# Complex packing: the JAX package's planner and packed collate
# --------------------------------------------------------------------------- #

def _snake_partition(order: List[int], n_slots: int) -> List[List[int]]:
    """Deal size-ordered items into n_slots boustrophedon, so that slot sums
    stay balanced."""
    slots: List[List[int]] = [[] for _ in range(n_slots)]
    for i, idx in enumerate(order):
        row, col = divmod(i, n_slots)
        if row % 2:
            col = n_slots - 1 - col
        slots[col].append(idx)
    return slots


def packed_shape(slots, sizes_l, sizes_r, node_buckets, slot_count_buckets):
    """(B, b_l, b_r) of a plan's packed batch: every slot pads to the plan's
    largest packed (ligand, receptor) buckets, the slot count to its bucket."""
    B = bucket_for(len(slots), slot_count_buckets)
    b_l = bucket_for(max(sum(sizes_l[i] for i in s) for s in slots), node_buckets)
    b_r = bucket_for(max(sum(sizes_r[i] for i in s) for s in slots), node_buckets)
    return B, b_l, b_r


def _plan_cost(slots, sizes_l, sizes_r, node_buckets, slot_count_buckets):
    """Total padded node slots of a plan (`packed_shape`)."""
    B, b_l, b_r = packed_shape(slots, sizes_l, sizes_r, node_buckets, slot_count_buckets)
    return B * (b_l + b_r)


def plan_packing(sizes_l: Sequence[int], sizes_r: Sequence[int],
                 node_buckets: Tuple[int, ...], max_per_slot: int,
                 slot_count_buckets: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
                 ) -> List[List[int]]:
    """Slots of complex indices with the fewest padded node slots: the best,
    by `_plan_cost`, of the snake-balanced uniform-k plans (k = 1 ..
    max_per_slot) and a first-fit-decreasing plan (largest first, into the
    slot whose padded size grows least)."""
    n = len(sizes_l)
    order = sorted(range(n), key=lambda i: -(sizes_l[i] + sizes_r[i]))

    def cost(nl, nr):
        return bucket_for(nl, node_buckets) + bucket_for(nr, node_buckets)

    candidates: List[List[List[int]]] = [_snake_partition(order, -(-n // k))
                                         for k in range(1, max_per_slot + 1)]
    slots: List[List[int]] = []
    fill_l: List[int] = []
    fill_r: List[int] = []
    for i in order:
        nl, nr = sizes_l[i], sizes_r[i]
        best, best_delta = -1, cost(nl, nr)          # what a fresh slot costs
        for s in range(len(slots)):
            if len(slots[s]) >= max_per_slot:
                continue
            delta = cost(fill_l[s] + nl, fill_r[s] + nr) - cost(fill_l[s], fill_r[s])
            if delta < best_delta:
                best, best_delta = s, delta
        if best >= 0:
            slots[best].append(i)
            fill_l[best] += nl
            fill_r[best] += nr
        else:
            slots.append([i])
            fill_l.append(nl)
            fill_r.append(nr)
    candidates.append(slots)
    return min(candidates, key=lambda c: _plan_cost(c, sizes_l, sizes_r, node_buckets,
                                                    slot_count_buckets))


_PACK_FIELDS = ("res_id", "x", "mu_r_norm", "nbr", "nbr_mask", "edge_feat", "node_mask",
                "seg_id")


def _pack_side(graphs: Sequence[ProteinGraph], coords_override, slot_assign, n_max: int,
               n_segs: int, pad_cache: Optional[PadCache] = None):
    """(field dict of stacked numpy arrays with seg_id, per slot the (start,
    n) of each member): each slot's complexes concatenated along the node
    axis, neighbour indices offset, padded to n_max. The pad tail self-loops
    from the slot's last member node on, with seg id n_segs - 1 and node
    mask 0, so its attention tag (seg + 1) * mask is 0."""
    K = graphs[0].nbr.shape[1]
    fields = {k: [] for k in _PACK_FIELDS}
    offsets: List[List[Tuple[int, int]]] = []
    for members in slot_assign:
        segs, offs, base = [], [], 0
        for c, gi in enumerate(members):
            g = graphs[gi]
            d = _padded(g, g.num_nodes, pad_cache)
            if coords_override is not None:
                d["x"] = np.asarray(coords_override[gi], dtype=np.float32)
            d["nbr"] = d["nbr"] + base
            d["seg_id"] = np.full(g.num_nodes, c, np.int32)
            segs.append(d)
            offs.append((base, g.num_nodes))
            base += g.num_nodes
        if base > n_max:
            raise ValueError(f"{base} packed nodes do not fit a bucket of {n_max}")
        if segs:
            cat = {k: np.concatenate([s[k] for s in segs], axis=0) for k in segs[0]}
        else:                       # a padding slot of the slot-count bucket
            g0 = graphs[0]
            cat = dict(res_id=np.zeros(0, np.int64), x=np.zeros((0, 3), np.float32),
                       mu_r_norm=np.zeros((0, g0.mu_r_norm.shape[1]), np.float32),
                       nbr=np.zeros((0, K), np.int32), nbr_mask=np.zeros((0, K), np.float32),
                       edge_feat=np.zeros((0, K, g0.edge_feat.shape[2]), np.float32),
                       node_mask=np.zeros(0, np.float32), seg_id=np.zeros(0, np.int32))
        pad_nbr = np.tile(np.arange(base, n_max, dtype=np.int32)[:, None], (1, K))
        fields["res_id"].append(_pad_axis0(cat["res_id"], n_max))
        fields["x"].append(_pad_axis0(cat["x"], n_max))
        fields["mu_r_norm"].append(_pad_axis0(cat["mu_r_norm"], n_max, fill=1.0))
        fields["nbr"].append(np.concatenate([cat["nbr"], pad_nbr], axis=0))
        fields["nbr_mask"].append(_pad_axis0(cat["nbr_mask"], n_max))
        fields["edge_feat"].append(_pad_axis0(cat["edge_feat"], n_max))
        fields["node_mask"].append(_pad_axis0(cat["node_mask"], n_max))
        fields["seg_id"].append(np.concatenate(
            [cat["seg_id"], np.full(n_max - base, n_segs - 1, np.int32)]))
        offsets.append(offs)
    return {k: np.stack(v) for k, v in fields.items()}, offsets


def collate_packed(
    ligs: Sequence[ProteinGraph],
    recs: Sequence[ProteinGraph],
    lig_new_x: Sequence[np.ndarray],
    gt_lig: Sequence[np.ndarray],
    pockets_lig: Sequence[np.ndarray],
    pockets_rec: Sequence[np.ndarray],
    node_buckets: Tuple[int, ...],
    pocket_buckets: Tuple[int, ...],
    max_per_slot: int,
    slot_count_buckets: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
    device: Optional[torch.device] = None,
    pin_memory: bool = False,
    pad_cache: Optional[PadCache] = None,
) -> PairBatch:
    """Pack the complexes into slots (`plan_packing`) and collate one
    PairBatch whose slots each hold up to `max_per_slot` complexes, on
    `device` (with `pin_memory`, on the CPU in page-locked memory). The slot
    count pads to its bucket; padding slots carry zero masks."""
    if max_per_slot < 2:
        raise ValueError("packing with 1 complex a slot: use collate()")
    dev = torch.device("cpu") if device is None else device
    sizes_l, sizes_r = [g.num_nodes for g in ligs], [g.num_nodes for g in recs]
    slot_assign = plan_packing(sizes_l, sizes_r, node_buckets, max_per_slot,
                               slot_count_buckets)
    B, n_l, n_r = packed_shape(slot_assign, sizes_l, sizes_r, node_buckets,
                               slot_count_buckets)
    C = max_per_slot
    P = bucket_for(max(p.shape[0] for p in pockets_lig), pocket_buckets)
    slot_assign = list(slot_assign) + [[] for _ in range(B - len(slot_assign))]
    lig, lig_offs = _pack_side(ligs, lig_new_x, slot_assign, n_l, C, pad_cache)
    rec, _ = _pack_side(recs, None, slot_assign, n_r, C, pad_cache)

    gt = np.zeros((B, n_l, 3), np.float32)
    pl = np.zeros((B, C, P, 3), np.float32)
    pr = np.zeros((B, C, P, 3), np.float32)
    pmask = np.zeros((B, C, P), np.float32)
    seg_mask = np.zeros((B, C), np.float32)
    for b, members in enumerate(slot_assign):
        for c, gi in enumerate(members):
            start, n = lig_offs[b][c]
            gt[b, start:start + n] = np.asarray(gt_lig[gi], np.float32)
            k = pockets_lig[gi].shape[0]
            pl[b, c, :k] = np.asarray(pockets_lig[gi], np.float32)
            pr[b, c, :k] = np.asarray(pockets_rec[gi], np.float32)
            pmask[b, c, :k] = 1.0
            seg_mask[b, c] = 1.0

    def to(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if pin_memory else t.to(dev)

    def side(d: dict) -> ProteinBatch:
        d = dict(d, res_id=d["res_id"].astype(np.int64))
        return ProteinBatch(**{k: to(v) for k, v in d.items()})

    return PairBatch(lig=side(lig), rec=side(rec), gt_lig=to(gt), pocket_lig=to(pl),
                     pocket_rec=to(pr), pocket_mask=to(pmask),
                     pair_mask=to((seg_mask.sum(axis=1) > 0).astype(np.float32)),
                     seg_mask=to(seg_mask), n_segs=C)
