"""Training samples and batches: the port of
`equidock_public_tpu/data/dataset.py` (`ComplexSample`; `_process_one` and
`build_cache`, which featurize a split of PDB files into the npz split
cache; DIPS shards whole or streamed; `DockingDataset.sample` and
`batches`, unpacked or packed with `cfg.data.pack`).

Augmentation is the JAX package's: a 50% ligand/receptor swap (train split),
then the ligand is centred and moved by a uniform random rotation and a
translation of length U(0, translation_interval); the ligand-frame pocket
cloud moves with it. One numpy seed gives both packages the same batches,
in training (shuffled) and in evaluation (not shuffled, but a fresh pose
per complex from the same generator).

The split cache is the JAX package's layout: one `<split>.npz` with, for
complex i, `c{i}/lig/<field>`, `c{i}/rec/<field>` (res_id, x, mu_r_norm,
nbr, nbr_mask, edge_feat), `c{i}/gt_lig`, `c{i}/gt_rec`, `c{i}/pocket`, and
`codes`. Either package reads what the other writes. A DIPS split is the
same layout cut into shards (`data/dips.py`); with `stream_dips` only a
window of shards is held at a time (`DockingDataset._stream_batches`).
With `distill_dir`, the train split's targets are blended with teacher
poses as it is read (`blend_teacher_poses`).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config, GraphConfig
from ..device import resolve_device
from ..graph import PairBatch, collate, collate_packed
from .featurize import (ProteinGraph, alpha_carbon_array, build_protein_graph,
                        extract_pocket, filter_residues, uniform_rotation_translation)
from .pdb import GroupedResidue, ca_coords, group_residues, read_pdb


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


def _process_one(task) -> Optional[ComplexSample]:
    """One complex of (ligand PDB, receptor PDB, GraphConfig), or None where
    `complex_from_residues` drops it. Runs in the pool's workers: numpy and
    the native builder only."""
    lig_path, rec_path, gc = task
    return complex_from_residues(filter_residues(group_residues(read_pdb(lig_path))),
                                 filter_residues(group_residues(read_pdb(rec_path))), gc)


def process_map(fn: Callable, tasks: Sequence, n_jobs: int) -> list:
    """`fn` over `tasks` in order: in a pool of `n_jobs` processes when
    `n_jobs > 1`, else here. The native graph builder is built and loaded
    first, so the workers find it built and run no compiler of their own."""
    if n_jobs <= 1:
        return [fn(t) for t in tasks]
    from .. import native

    native.load_library()
    with ProcessPoolExecutor(max_workers=n_jobs) as ex:
        return list(ex.map(fn, tasks))


def split_codes(raw_data_path: str, split_file: str) -> List[str]:
    """The sorted distinct codes of a split file that have both
    `<code>_l_b.pdb` and `<code>_r_b.pdb` in `raw_data_path`."""
    with open(split_file) as f:
        codes = sorted({line.strip() for line in f if line.strip()})
    files = set(os.listdir(raw_data_path))
    return [c for c in codes if f"{c}_l_b.pdb" in files and f"{c}_r_b.pdb" in files]


def build_cache(cfg: Config, split: str, log=print) -> str:
    """Featurize one DB5 split into `cfg.cache_path()/<split>.npz`: the
    codes of `<split_files_path>/<split>.txt` with both `<code>_l_b.pdb` and
    `<code>_r_b.pdb` in `raw_data_path`, in sorted order, on `n_jobs`
    processes; complexes with too few residues or a pocket of at most 3
    pairs are dropped (and logged), and the seconds from reading to the
    written file are logged. An existing cache is kept as it is."""
    dc = cfg.data
    out_path = os.path.join(cfg.cache_path(), f"{split}.npz")
    if os.path.exists(out_path):
        log(f"cache exists: {out_path}")
        return out_path
    codes = split_codes(dc.raw_data_path, os.path.join(dc.split_files_path, split + ".txt"))
    log(f"{split}: {len(codes)} complexes")
    t0 = time.perf_counter()
    tasks = [(os.path.join(dc.raw_data_path, f"{c}_l_b.pdb"),
              os.path.join(dc.raw_data_path, f"{c}_r_b.pdb"), cfg.graph) for c in codes]
    kept, samples = [], []
    for code, sample in zip(codes, process_map(_process_one, tasks, dc.n_jobs)):
        if sample is None:
            log(f"  dropped {code} (pocket <= 3 pairs or too few residues)")
            continue
        kept.append(code)
        samples.append(sample)
    write_cache(out_path, kept, samples)
    log(f"wrote {out_path}: {len(kept)} complexes in {time.perf_counter() - t0:.3f} s")
    return out_path


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


def blend_teacher_poses(samples: Sequence[ComplexSample], codes: Sequence[str],
                        teacher_dir: str, alpha: float, log=print) -> List[ComplexSample]:
    """Pose distillation, the JAX package's `_blend_teacher_poses`: each
    complex whose code has a teacher file `<code>_l_b_*.pdb` in
    `teacher_dir` (the first match) with as many CA atoms as its target
    gets the bound-ligand target (1 - alpha) gt + alpha teacher, in f32;
    the others keep theirs. The MSE to the blended target has the gradient
    of the blend of the two MSEs, so the loss needs no change. Returns new
    samples and prints how many were blended."""
    out, n_blend = [], 0
    for s, code in zip(samples, codes):
        hits = glob.glob(os.path.join(teacher_dir, f"{str(code)}_l_b_*.pdb"))
        t = ca_coords(read_pdb(hits[0])) if hits else None
        if t is None or t.shape != s.gt_lig.shape:
            out.append(s)
            continue
        out.append(dataclasses.replace(
            s, gt_lig=((1.0 - alpha) * s.gt_lig + alpha * t).astype(np.float32)))
        n_blend += 1
    log(f"distill: blended teacher poses into {n_blend}/{len(codes)} train targets "
        f"(alpha={alpha})")
    return out


class DockingDataset:
    """Complexes of one split that yield augmented, padded PairBatches. A
    sample swaps sides when `swap` is on: by default on the train split as
    `cfg.data.swap_train` says, off elsewhere. The complexes are held in
    memory (`samples`), or, for a streamed DIPS split, read through a shard
    LRU by the shard index (`index`); `pair_max_nodes`, `pocket_size` and
    `get_sample` serve both."""

    def __init__(self, cfg: Config, samples: Optional[Sequence[ComplexSample]],
                 codes: Optional[Sequence[str]] = None, split: str = "train",
                 swap: Optional[bool] = None, index=None, lru=None):
        self.cfg = cfg
        self.index, self._lru = index, lru
        self.samples: Optional[List[ComplexSample]] = (
            None if samples is None else list(samples))
        if codes is not None:
            self.codes = list(codes)
        elif index is not None:
            self.codes = list(index.codes)
        else:
            self.codes = [str(i) for i in range(len(self.samples))]
        self.swap = (split == "train" and cfg.data.swap_train) if swap is None else swap

    @classmethod
    def from_cache(cls, cfg: Config, split: str, swap: Optional[bool] = None,
                   cache_path: Optional[str] = None) -> "DockingDataset":
        """The split's cache (the JAX `DockingDataset(cfg, split)`): the npz
        at `cache_path` or `cfg.cache_path()/<split>.npz`; for `data='dips'`
        without `cache_path`, the split's shards, streamed through a shard
        LRU of `stream_window` shards with `stream_dips`, else loaded whole
        (a split without shards raises, naming the builders). The
        train split keeps its leading `data_fraction`, its targets blended
        with the teacher poses of `distill_dir` when one is set (a streamed
        split raises: it holds no samples to blend)."""
        dc = cfg.data
        distill = split == "train" and bool(dc.distill_dir)
        if distill and dc.data == "dips" and dc.stream_dips and cache_path is None:
            raise ValueError("distill_dir requires a materialized dataset (not stream_dips)")
        index = lru = samples = None
        if dc.data == "dips" and cache_path is None:
            from .dips import DipsShardIndex, ShardLRU, load_dips_shards, shard_files

            if not shard_files(cfg.cache_path(), split):
                raise NotImplementedError(
                    f"data='dips': no DIPS shards of split {split!r} under {cfg.cache_path()} "
                    "(the curriculum's DIPS stage reads them); build them from DIPS pair "
                    "files (data/dips.py::build_dips_cache), from bound complexes "
                    "(python -m equidock_public_tpu_torch.cli.preprocess "
                    "-dips_frozen_complexes DIR) or as interface crops "
                    "(python -m equidock_public_tpu_torch.cli.crop_corpus)")
            if dc.stream_dips:
                index = DipsShardIndex(cfg.cache_path(), split)
                lru = ShardLRU(index.shard_paths, capacity=max(1, dc.stream_window))
                codes = list(index.codes)
            else:
                samples, codes = load_dips_shards(cfg, split)
        else:
            codes, samples = read_cache(cache_path or os.path.join(cfg.cache_path(),
                                                                   f"{split}.npz"))
        if dc.data_fraction < 1.0 and split == "train":
            n = max(1, int(dc.data_fraction * len(codes)))
            codes = codes[:n]
            samples = samples[:n] if samples is not None else None
        if distill:
            samples = blend_teacher_poses(samples, codes, dc.distill_dir, dc.distill_alpha)
        return cls(cfg, samples, codes, split, swap, index=index, lru=lru)

    def __len__(self) -> int:
        return len(self.codes)

    def pair_max_nodes(self, idx: int) -> int:
        if self.index is not None:
            return max(self.index.n_lig[idx], self.index.n_rec[idx])
        s = self.samples[idx]
        return max(s.lig.num_nodes, s.rec.num_nodes)

    def pocket_size(self, idx: int) -> int:
        if self.index is not None:
            return self.index.n_pocket[idx]
        return self.samples[idx].pocket.shape[0]

    def get_sample(self, idx: int) -> ComplexSample:
        if self.index is not None:
            shard = self._lru.get(self.index.shard_of[idx])
            return shard[self.index.index_in_shard[idx]]
        return self.samples[idx]

    def sample(self, idx: int, rng: np.random.Generator):
        """One augmented complex: (lig_graph, rec_graph, lig_new_x, gt_lig,
        pocket_lig, pocket_rec)."""
        s = self.get_sample(idx)
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
        with masked copies (with `cfg.data.pack`, the chunk of bs complexes
        packed by `collate_packed` instead), on the card unless `device`
        says otherwise
        (`pin_memory`: on the CPU, in page-locked memory for an asynchronous
        copy to the card). With `shuffle`: shuffle, sort by size
        (stable), cut into chunks, shuffle the chunks;
        without, the same in the split's order. Either way every complex
        draws its pose from `rng`, in the JAX package's order of draws. A
        streamed split does this within each window of shards."""
        dev = torch.device("cpu") if pin_memory else resolve_device(device)
        if self.index is not None:
            yield from self._stream_batches(rng, dev, shuffle, pin_memory)
            return
        order = np.arange(len(self.codes))
        if shuffle:
            rng.shuffle(order)
        yield from self._chunked(order, rng, dev, shuffle, pin_memory)

    def _chunked(self, order: np.ndarray, rng: np.random.Generator, dev, shuffle: bool,
                 pin_memory: bool) -> Iterator[PairBatch]:
        bs = self.cfg.train.bs
        sizes = np.array([self.pair_max_nodes(int(i)) for i in order])
        order = order[np.argsort(sizes, kind="stable")]
        chunks = [order[i:i + bs] for i in range(0, len(order), bs)]
        if shuffle:
            rng.shuffle(chunks)
        dc = self.cfg.data
        for chunk in chunks:
            items = [self.sample(int(i), rng) for i in chunk]
            ligs, recs, new_xs, gts, pls, prs = zip(*items)
            if dc.pack and dc.pack_max_per_slot > 1:
                yield collate_packed(ligs, recs, new_xs, gts, pls, prs, dc.node_buckets,
                                     dc.pocket_buckets, dc.pack_max_per_slot,
                                     dc.slot_count_buckets, dev, pin_memory=pin_memory)
            else:
                yield collate(ligs, recs, new_xs, gts, pls, prs, dc.node_buckets,
                              dc.pocket_buckets, dev, batch_size=bs, pin_memory=pin_memory)

    def _stream_batches(self, rng: np.random.Generator, dev, shuffle: bool,
                        pin_memory: bool) -> Iterator[PairBatch]:
        """A streamed epoch: the shard order shuffled, then the schedule of
        `_chunked` within each window of `stream_window` shards, the next
        window prefetched while this one collates. At most 2 x window
        shards are held; shuffling mixes complexes within a window only."""
        n = len(self.codes)
        shard_of = self.index.shard_of
        n_shards = (max(shard_of[:n]) + 1) if n else 0
        by_shard: List[List[int]] = [[] for _ in range(n_shards)]
        for i in range(n):
            by_shard[shard_of[i]].append(i)
        shard_order = np.arange(n_shards)
        if shuffle:
            rng.shuffle(shard_order)
        W = max(1, self.cfg.data.stream_window)
        windows = [shard_order[w:w + W] for w in range(0, n_shards, W)]
        for wi, window in enumerate(windows):
            for si in window:
                self._lru.get(int(si))              # held for the whole window
            if wi + 1 < len(windows):
                for si in windows[wi + 1]:
                    self._lru.prefetch(int(si))
            order = np.concatenate([np.array(by_shard[int(si)], np.int64) for si in window])
            if shuffle:
                rng.shuffle(order)
            yield from self._chunked(order, rng, dev, shuffle, pin_memory)
