"""Interface-crop pseudo-pairs: a DIPS-sized pretraining corpus cut from
bound DB5 complexes, the port of `equidock_public_tpu/data/crops.py`.

A crop picks a random interface residue pair (CA-CA below the pocket
cutoff) as its anchor, keeps the n_l / n_r residues nearest to each side's
anchor (sizes drawn jointly from a size sample, e.g. the frozen DIPS test
set's, `data/synth.py::dips_testset_sizes`), and featurizes the cropped
residues like any complex (`featurize.build_protein_graph`), pocket again
included; a crop whose pocket has at most 3 pairs is drawn again. Train
crops come from train parents only and val crops from val parents, so the
test split stays untouched. The shards are written in the DIPS layout
(`data/dips.py`), so `-data dips [-stream_dips]` trains on them.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from .dataset import ComplexSample, process_map, write_cache
from .dips import SHARD_SIZE, shard_files
from .featurize import alpha_carbon_array, build_protein_graph, extract_pocket, filter_residues
from .pdb import group_residues, read_pdb


@dataclasses.dataclass
class Parent:
    """One source complex, read and interface-indexed once."""

    code: str
    lig_res: list
    rec_res: list
    lig_ca: np.ndarray
    rec_ca: np.ndarray
    iface: np.ndarray        # (P, 2) int32 interface (lig_idx, rec_idx) pairs


def load_parent(code: str, lig_path: str, rec_path: str,
                pocket_cutoff: float = 8.0) -> Optional[Parent]:
    """The parent of (ligand, receptor) PDBs; None where a side keeps at
    most 8 residues or the interface has at most 3 pairs."""
    lig_res = filter_residues(group_residues(read_pdb(lig_path)))
    rec_res = filter_residues(group_residues(read_pdb(rec_path)))
    if len(lig_res) <= 8 or len(rec_res) <= 8:
        return None
    lig_ca, rec_ca = alpha_carbon_array(lig_res), alpha_carbon_array(rec_res)
    d = np.linalg.norm(lig_ca[:, None, :] - rec_ca[None, :, :], axis=-1)
    ai, aj = np.where(d < pocket_cutoff)
    if ai.size <= 3:
        return None
    return Parent(code=code, lig_res=lig_res, rec_res=rec_res, lig_ca=lig_ca, rec_ca=rec_ca,
                  iface=np.stack([ai, aj], axis=1).astype(np.int32))


def _crop_side(ca: np.ndarray, anchor: int, n_keep: int) -> np.ndarray:
    """The indices (sorted) of the n_keep residues nearest to the anchor's CA."""
    d = np.linalg.norm(ca - ca[anchor], axis=-1)
    return np.sort(np.argpartition(d, min(n_keep, d.size) - 1)[:n_keep])


def sample_crop(parent: Parent, rng: np.random.Generator, sizes: Sequence[Tuple[int, int]],
                max_side: int, min_side: int = 24, pocket_cutoff: float = 8.0,
                graph_cutoff: float = 30.0, max_neighbor: int = 10) -> Optional[ComplexSample]:
    """One interface-anchored crop of `parent`: an anchor pair, then a size
    pair from `sizes`, each side clipped to [min_side, min(max_side, its
    residues)]. None when the crop keeps a pocket of at most 3 pairs."""
    ai, aj = parent.iface[rng.integers(parent.iface.shape[0])]
    n_l, n_r = sizes[rng.integers(len(sizes))]
    n_l = int(np.clip(n_l, min_side, min(max_side, len(parent.lig_res))))
    n_r = int(np.clip(n_r, min_side, min(max_side, len(parent.rec_res))))
    li = _crop_side(parent.lig_ca, int(ai), n_l)
    ri = _crop_side(parent.rec_ca, int(aj), n_r)
    lig_ca, rec_ca = parent.lig_ca[li], parent.rec_ca[ri]
    pocket = extract_pocket(lig_ca, rec_ca, pocket_cutoff)
    if pocket is None:
        return None
    return ComplexSample(
        lig=build_protein_graph([parent.lig_res[i] for i in li], graph_cutoff, max_neighbor),
        rec=build_protein_graph([parent.rec_res[i] for i in ri], graph_cutoff, max_neighbor),
        gt_lig=lig_ca, gt_rec=rec_ca, pocket=pocket[0])


def _gen_for_parent(task) -> List[Tuple[str, ComplexSample]]:
    """(worker) Up to n_crops crops of one parent in at most 4 n_crops
    draws, named `<code>_crop<i>`; none for a parent `load_parent` drops."""
    (code, lig_path, rec_path, n_crops, seed, sizes, max_side,
     pocket_cutoff, graph_cutoff, max_neighbor) = task
    parent = load_parent(code, lig_path, rec_path, pocket_cutoff)
    if parent is None:
        return []
    rng = np.random.default_rng(seed)
    out, attempts = [], 0
    while len(out) < n_crops and attempts < 4 * n_crops:
        attempts += 1
        s = sample_crop(parent, rng, sizes, max_side, pocket_cutoff=pocket_cutoff,
                        graph_cutoff=graph_cutoff, max_neighbor=max_neighbor)
        if s is not None:
            out.append((f"{code}_crop{len(out)}", s))
    return out


def generate_crop_shards(cfg: Config, split: str, codes: List[str], raw_db5_path: str,
                         n_pairs: int, seed: int, sizes: Sequence[Tuple[int, int]],
                         max_side: int = 256, n_jobs: int = 4, log=print) -> List[str]:
    """`n_pairs` crops over the parents `codes` (`<code>_{l,r}_b.pdb` in
    `raw_db5_path`; ceil(n_pairs / parents) each, parent i seeded with
    seed + 7919 i), shuffled with `seed`, cut to n_pairs and written as DIPS
    shards of `split` in `cfg.cache_path()` (a `data='dips'` config); logs
    the seconds it took. A split that has shards already is kept as it is."""
    if cfg.data.data != "dips":
        raise ValueError("the crop corpus is written as a DIPS cache: use data='dips'")
    cache_dir = cfg.cache_path()
    existing = shard_files(cache_dir, split)
    if existing:
        log(f"crop cache exists: {len(existing)} shards in {cache_dir}")
        return existing
    t0 = time.perf_counter()
    per_parent = -(-n_pairs // max(len(codes), 1))
    gc = cfg.graph
    tasks = [(c, os.path.join(raw_db5_path, f"{c}_l_b.pdb"),
              os.path.join(raw_db5_path, f"{c}_r_b.pdb"), per_parent, seed + 7919 * i,
              list(sizes), max_side, gc.pocket_cutoff, gc.graph_cutoff, gc.graph_max_neighbor)
             for i, c in enumerate(codes)]
    results = [crop for crops in process_map(_gen_for_parent, tasks, n_jobs) for crop in crops]
    rng = np.random.default_rng(seed)
    rng.shuffle(results)
    results = results[:n_pairs]
    shard_paths = []
    for shard_idx, start in enumerate(range(0, len(results), SHARD_SIZE)):
        out_path = os.path.join(cache_dir, f"{split}_shard{shard_idx:04d}.npz")
        chunk = results[start:start + SHARD_SIZE]
        write_cache(out_path, [n for n, _ in chunk], [s for _, s in chunk])
        shard_paths.append(out_path)
        log(f"  wrote shard {shard_idx}: {len(chunk)} pairs")
    log(f"crop corpus {split}: {len(results)} pairs from {len(codes)} parents in "
        f"{time.perf_counter() - t0:.3f} s")
    return shard_paths
