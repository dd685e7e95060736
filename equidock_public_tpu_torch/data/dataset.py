"""Training samples and batches: the port of the unpacked part of
`equidock_public_tpu/data/dataset.py` (`ComplexSample`, `_process_one`, the
npz split cache, `DockingDataset.sample` and `batches`).

Augmentation is the JAX package's: a 50% ligand/receptor swap (train split),
then the ligand is centred and moved by a uniform random rotation and a
translation of length U(0, translation_interval); the ligand-frame pocket
cloud moves with it. One numpy seed gives both packages the same batches,
in training (shuffled) and in evaluation (not shuffled, but a fresh pose
per complex from the same generator).

The split cache is the JAX package's layout: one `<split>.npz` with, for
complex i, `c{i}/lig/<field>`, `c{i}/rec/<field>` (res_id, x, mu_r_norm,
nbr, nbr_mask, edge_feat), `c{i}/gt_lig`, `c{i}/gt_rec`, `c{i}/pocket`, and
`codes`. Either package reads what the other writes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config, GraphConfig
from ..device import resolve_device
from ..graph import PairBatch, collate
from .featurize import (ProteinGraph, alpha_carbon_array, build_protein_graph,
                        extract_pocket, uniform_rotation_translation)
from .pdb import GroupedResidue


@dataclasses.dataclass
class ComplexSample:
    lig: ProteinGraph
    rec: ProteinGraph
    gt_lig: np.ndarray       # (N_l, 3) bound ligand CA
    gt_rec: np.ndarray       # (N_r, 3) bound receptor CA (== rec.x)
    pocket: np.ndarray       # (P, 3) pocket midpoints


def complex_from_residues(lig_res: Sequence[GroupedResidue],
                          rec_res: Sequence[GroupedResidue],
                          gc: GraphConfig) -> Optional[ComplexSample]:
    """One bound complex from filtered residues; None when a side has at
    most one residue or the pocket has at most 3 pairs (the JAX package
    drops such complexes)."""
    if len(lig_res) <= 1 or len(rec_res) <= 1:
        return None
    lig_ca, rec_ca = alpha_carbon_array(lig_res), alpha_carbon_array(rec_res)
    pocket = extract_pocket(lig_ca, rec_ca, gc.pocket_cutoff)
    if pocket is None:
        return None
    return ComplexSample(
        lig=build_protein_graph(lig_res, gc.graph_cutoff, gc.graph_max_neighbor),
        rec=build_protein_graph(rec_res, gc.graph_cutoff, gc.graph_max_neighbor),
        gt_lig=lig_ca, gt_rec=rec_ca, pocket=pocket[0])


def split_chain_complex(residues: Sequence[GroupedResidue],
                        gc: GraphConfig) -> Optional[ComplexSample]:
    """A bound complex made from one chain: its residues cut at n // 2, the
    first half the ligand, the second the receptor. The halves touch
    natively, so the pocket is a real interface. None where
    `complex_from_residues` drops it."""
    n = len(residues)
    return complex_from_residues(residues[:n // 2], residues[n // 2:], gc)


_SIDE_KEYS = ("res_id", "x", "mu_r_norm", "nbr", "nbr_mask", "edge_feat")


def _graph_to_npz(prefix: str, g: ProteinGraph, out: dict) -> None:
    for key in _SIDE_KEYS:
        out[prefix + key] = getattr(g, key)


def _graph_from_npz(z, prefix: str) -> ProteinGraph:
    return ProteinGraph(**{key: z[prefix + key] for key in _SIDE_KEYS})


def write_cache(path: str, codes: Sequence[str], samples: Sequence[ComplexSample]) -> str:
    """Write complexes as one split cache in the JAX package's layout."""
    out: dict = {"codes": np.array(list(codes))}
    for i, s in enumerate(samples):
        _graph_to_npz(f"c{i}/lig/", s.lig, out)
        _graph_to_npz(f"c{i}/rec/", s.rec, out)
        out[f"c{i}/gt_lig"], out[f"c{i}/gt_rec"] = s.gt_lig, s.gt_rec
        out[f"c{i}/pocket"] = s.pocket
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **out)
    return path


def read_cache(path: str):
    """(codes, samples) of a split cache."""
    with np.load(path, allow_pickle=False) as z:
        codes = [str(c) for c in z["codes"]]
        samples = [ComplexSample(lig=_graph_from_npz(z, f"c{i}/lig/"),
                                 rec=_graph_from_npz(z, f"c{i}/rec/"),
                                 gt_lig=z[f"c{i}/gt_lig"], gt_rec=z[f"c{i}/gt_rec"],
                                 pocket=z[f"c{i}/pocket"])
                   for i in range(len(codes))]
    return codes, samples


class DockingDataset:
    """Complexes of one split, held in memory, that yield augmented, padded
    PairBatches. A sample swaps sides when `swap` is on: by default on the
    train split as `cfg.data.swap_train` says, off elsewhere."""

    def __init__(self, cfg: Config, samples: Sequence[ComplexSample],
                 codes: Optional[Sequence[str]] = None, split: str = "train",
                 swap: Optional[bool] = None):
        if cfg.data.pack:
            raise NotImplementedError("pack: packed batches are not ported")
        self.cfg = cfg
        self.samples: List[ComplexSample] = list(samples)
        self.codes = list(codes) if codes is not None else [str(i) for i in
                                                             range(len(self.samples))]
        self.swap = (split == "train" and cfg.data.swap_train) if swap is None else swap

    @classmethod
    def from_cache(cls, cfg: Config, split: str, swap: Optional[bool] = None,
                   cache_path: Optional[str] = None) -> "DockingDataset":
        """The split's npz cache, at `cache_path` or `cfg.cache_path()/<split>.npz`
        (the JAX `DockingDataset(cfg, split)`); the train split keeps its
        leading `data_fraction`."""
        dc = cfg.data
        if cache_path is None and dc.data == "dips":
            raise NotImplementedError("data='dips': DIPS shards and stream_dips are "
                                      "not ported (pass cache_path for an npz split)")
        if split == "train" and dc.distill_dir:
            raise NotImplementedError("distill_dir: pose distillation is not ported")
        codes, samples = read_cache(cache_path or os.path.join(cfg.cache_path(),
                                                               f"{split}.npz"))
        if dc.data_fraction < 1.0 and split == "train":
            n = max(1, int(dc.data_fraction * len(codes)))
            codes, samples = codes[:n], samples[:n]
        return cls(cfg, samples, codes, split, swap)

    def __len__(self) -> int:
        return len(self.samples)

    def pair_max_nodes(self, idx: int) -> int:
        s = self.samples[idx]
        return max(s.lig.num_nodes, s.rec.num_nodes)

    def sample(self, idx: int, rng: np.random.Generator):
        """One augmented complex: (lig_graph, rec_graph, lig_new_x, gt_lig,
        pocket_lig, pocket_rec)."""
        s = self.samples[idx]
        if self.swap and rng.uniform() > 0.5:
            lig, rec, gt_lig = s.rec, s.lig, s.gt_rec
        else:
            lig, rec, gt_lig = s.lig, s.rec, s.gt_lig
        rot, tr = uniform_rotation_translation(rng, self.cfg.graph.translation_interval)
        mean = lig.x.mean(axis=0, keepdims=True)
        pocket_lig = (rot @ (s.pocket - mean).T).T + tr
        lig_new_x = (rot @ (lig.x - mean).T).T + tr
        return (lig, rec, lig_new_x.astype(np.float32), gt_lig,
                pocket_lig.astype(np.float32), s.pocket.astype(np.float32))

    def batches(self, rng: np.random.Generator,
                device: Optional[Union[str, torch.device]] = None, shuffle: bool = True,
                pin_memory: bool = False) -> Iterator[PairBatch]:
        """Padded PairBatches of `cfg.train.bs` slots, the last one filled
        with masked copies, on the card unless `device` says otherwise
        (`pin_memory`: on the CPU, in page-locked memory for an asynchronous
        copy to the card). With `shuffle`: shuffle, sort by size
        (stable), cut into chunks, shuffle the chunks; without, the same in
        the split's order. Either way every complex draws its pose from
        `rng`, in the JAX package's order of draws."""
        dev = torch.device("cpu") if pin_memory else resolve_device(device)
        bs = self.cfg.train.bs
        order = np.arange(len(self.samples))
        if shuffle:
            rng.shuffle(order)
        sizes = np.array([self.pair_max_nodes(int(i)) for i in order])
        order = order[np.argsort(sizes, kind="stable")]
        chunks = [order[i:i + bs] for i in range(0, len(order), bs)]
        if shuffle:
            rng.shuffle(chunks)
        dc = self.cfg.data
        for chunk in chunks:
            items = [self.sample(int(i), rng) for i in chunk]
            ligs, recs, new_xs, gts, pls, prs = zip(*items)
            yield collate(ligs, recs, new_xs, gts, pls, prs, dc.node_buckets,
                          dc.pocket_buckets, dev, batch_size=bs, pin_memory=pin_memory)
