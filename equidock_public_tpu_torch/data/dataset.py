"""Training samples and batches: the port of the unpacked, in-memory part of
`equidock_public_tpu/data/dataset.py` (`ComplexSample`, `_process_one`,
`DockingDataset.sample` and `batches`).

Augmentation is the JAX package's: a 50% ligand/receptor swap, then the
ligand is centred and moved by a uniform random rotation and a translation
of length U(0, translation_interval); the ligand-frame pocket cloud moves
with it. One numpy seed gives both packages the same batches.
"""

from __future__ import annotations

import dataclasses
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


class DockingDataset:
    """In-memory complexes of a training split that yield augmented, padded
    PairBatches; a sample swaps sides as `cfg.data.swap_train` says."""

    def __init__(self, cfg: Config, samples: Sequence[ComplexSample]):
        if cfg.data.pack:
            raise NotImplementedError("pack: packed batches are not ported")
        self.cfg = cfg
        self.samples: List[ComplexSample] = list(samples)

    def __len__(self) -> int:
        return len(self.samples)

    def pair_max_nodes(self, idx: int) -> int:
        s = self.samples[idx]
        return max(s.lig.num_nodes, s.rec.num_nodes)

    def sample(self, idx: int, rng: np.random.Generator):
        """One augmented complex: (lig_graph, rec_graph, lig_new_x, gt_lig,
        pocket_lig, pocket_rec)."""
        s = self.samples[idx]
        if self.cfg.data.swap_train and rng.uniform() > 0.5:
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
                device: Optional[Union[str, torch.device]] = None) -> Iterator[PairBatch]:
        """Padded PairBatches of `cfg.train.bs` slots (the last one filled with
        masked copies), on the card unless `device` says otherwise: shuffle,
        sort by size (stable), cut into chunks, shuffle the chunks, collate."""
        dev = resolve_device(device)
        bs = self.cfg.train.bs
        order = np.arange(len(self.samples))
        rng.shuffle(order)
        sizes = np.array([self.pair_max_nodes(int(i)) for i in order])
        order = order[np.argsort(sizes, kind="stable")]
        chunks = [order[i:i + bs] for i in range(0, len(order), bs)]
        rng.shuffle(chunks)
        dc = self.cfg.data
        for chunk in chunks:
            items = [self.sample(int(i), rng) for i in chunk]
            ligs, recs, new_xs, gts, pls, prs = zip(*items)
            yield collate(ligs, recs, new_xs, gts, pls, prs, dc.node_buckets,
                          dc.pocket_buckets, dev, batch_size=bs)
