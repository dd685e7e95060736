"""Padded, fixed-shape batch schema: the port of `equidock_public_tpu/graph.py`
for unpacked batches (one complex per slot).

The layout is the JAX package's: node arrays (B, N, ...), neighbor tables
`nbr` (B, N, K) int32 and `nbr_mask` (B, N, K), padded to a node bucket.
Padded nodes self-loop with a zero mask, so message passing needs no
special case for them.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class PairBatch:
    """A batch of ligand/receptor complexes plus the training-label slots
    (`gt_lig`, pockets) that serving fills with placeholders."""

    lig: ProteinBatch
    rec: ProteinBatch
    gt_lig: torch.Tensor       # (B, N_l, 3)
    pocket_lig: torch.Tensor   # (B, P, 3)
    pocket_rec: torch.Tensor   # (B, P, 3)
    pocket_mask: torch.Tensor  # (B, P)
    pair_mask: torch.Tensor    # (B,) 0 for padding slots


def _pad_axis0(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, constant_values=fill)


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
) -> PairBatch:
    """Collate complexes into one padded PairBatch on `device` (with
    `pin_memory`, on the CPU in page-locked memory instead).

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
            d = pad_protein(graphs[j], n_max)
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
    move = lambda t: t.to(device, non_blocking=non_blocking)
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
            out[f"{name}.{f.name}"] = one(getattr(side, f.name))
    for f in ("gt_lig", "pocket_lig", "pocket_rec", "pocket_mask", "pair_mask"):
        out[f] = one(getattr(batch, f))
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
