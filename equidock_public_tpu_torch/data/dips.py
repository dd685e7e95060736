"""Sharded DIPS caches: the port's own copy of
`equidock_public_tpu/data/dips.py`, its builders (`build_dips_cache` from
DIPS pair pickles, `build_dips_frozen_cache` from bound complex PDBs) and its
readers (`shard_files`, `load_shard_samples`, `load_dips_shards`,
`DipsShardIndex`, `ShardLRU`).

A DIPS split is cached as `<split>_shard0000.npz`, `<split>_shard0001.npz`,
... in the split-cache layout of `data/dataset.py` (one shard holds up to
`SHARD_SIZE` complexes), each with a `<shard>.index.json` sidecar of the
sizes (derived at the first read when a builder did not write it). Either
package reads what the other writes. The pair pickles are read with
pandas, imported inside the readers only: the machine with the card has
none, and everything else here runs without it.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from .dataset import (ComplexSample, _process_one, complex_from_residues, process_map,
                      read_cache, write_cache)
from .featurize import filter_residues
from .pdb import GroupedResidue, build_atom_table

SHARD_SIZE = 512


def residues_from_dataframe(df) -> List[GroupedResidue]:
    """A pandas frame of atoms (atom3 columns chain, residue, resname,
    atom_name, x, y, z, element) as residues grouped by (chain, residue,
    resname), sorted by that key, as `pdb.group_residues` groups a PDB."""
    order = {}
    chains, resnums, resnames = (df["chain"].to_numpy(), df["residue"].to_numpy(),
                                 df["resname"].to_numpy())
    for i in range(len(df)):
        order.setdefault((str(chains[i]), int(resnums[i]), str(resnames[i])), []).append(i)
    names = df["atom_name"].to_numpy()
    coords = df[["x", "y", "z"]].to_numpy().astype(np.float32)
    elements = (df["element"].to_numpy() if "element" in df.columns
                else np.array([""] * len(df)))
    out = []
    for key in sorted(order.keys()):
        idx = np.array(order[key], dtype=np.int64)
        out.append((key, {"atom_name": names[idx].astype(object), "coords": coords[idx],
                          "element": elements[idx].astype(object), "resname": key[2]}))
    return out


def _normalize_dips_df(df):
    """atom3 column names from biopandas ones (absent columns are left)."""
    return df.rename(columns={
        "chain_id": "chain", "residue_number": "residue", "residue_name": "resname",
        "x_coord": "x", "y_coord": "y", "z_coord": "z", "element_symbol": "element"})


def read_dips_pair_tables(dill_path: str):
    """(ligand df0, receptor df1) of a DIPS pair pickle as full-atom
    AtomTables: every atom, as the test-set generator writes them."""
    import pandas as pd

    x = pd.read_pickle(dill_path)

    def table(df):
        df = _normalize_dips_df(df)
        coords = np.stack([df["x"].to_numpy(), df["y"].to_numpy(), df["z"].to_numpy()],
                          axis=1).astype(np.float32)
        return build_atom_table(df["atom_name"].to_numpy(), df["resname"].to_numpy(),
                                df["chain"].to_numpy(), df["residue"].to_numpy().astype(np.int64),
                                coords, df["element"].to_numpy())

    return table(x.df0), table(x.df1)


def read_dips_pair(dill_path: str) -> Tuple[List[GroupedResidue], List[GroupedResidue]]:
    """(ligand residues of df0, receptor residues of df1) of a pair pickle."""
    import pandas as pd

    x = pd.read_pickle(dill_path)
    return (residues_from_dataframe(_normalize_dips_df(x.df0)),
            residues_from_dataframe(_normalize_dips_df(x.df1)))


def _process_dips_one(task) -> Optional[ComplexSample]:
    """One pair pickle of (path, GraphConfig) as a complex; None where it
    cannot be read or `complex_from_residues` drops it."""
    dill_path, gc = task
    try:
        lig_res, rec_res = read_dips_pair(dill_path)
    except Exception:
        return None
    return complex_from_residues(filter_residues(lig_res), filter_residues(rec_res), gc)


def build_dips_cache(cfg: Config, split: str, raw_data_path: str, split_files_path: str,
                     log=print) -> List[str]:
    """Featurize the pairs of `<split_files_path>/pairs-postprocessed-<split>.txt`
    (pickles under `raw_data_path`) into shards of `SHARD_SIZE` pairs in
    `cfg.cache_path()`, on `n_jobs` processes. The train split with
    `data_fraction < 1` keeps that share of its names after a shuffle seeded
    with `random_seed`. Unreadable or dropped pairs are left out; an
    existing shard is kept as it is."""
    with open(os.path.join(split_files_path, f"pairs-postprocessed-{split}.txt")) as f:
        names = [line.strip() for line in f if line.strip()]
    if split == "train" and cfg.data.data_fraction < 1.0:
        rng = np.random.default_rng(cfg.train.random_seed)
        rng.shuffle(names)
        names = names[:int(cfg.data.data_fraction * len(names))]
    log(f"dips {split}: {len(names)} pairs")
    shard_paths = []
    for shard_idx, start in enumerate(range(0, len(names), SHARD_SIZE)):
        out_path = os.path.join(cfg.cache_path(), f"{split}_shard{shard_idx:04d}.npz")
        shard_paths.append(out_path)
        if os.path.exists(out_path):
            continue
        chunk = names[start:start + SHARD_SIZE]
        tasks = [(os.path.join(raw_data_path, n), cfg.graph) for n in chunk]
        results = process_map(_process_dips_one, tasks, cfg.data.n_jobs)
        kept = [(n, s) for n, s in zip(chunk, results) if s is not None]
        write_cache(out_path, [n for n, _ in kept], [s for _, s in kept])
        log(f"  shard {shard_idx}: kept {len(kept)}/{len(chunk)}")
    return shard_paths


def build_dips_frozen_cache(cfg: Config, complexes_dir: str, log=print) -> List[str]:
    """DIPS shards of real bound pairs: every `<name>_l_b_COMPLEX.pdb` of
    `complexes_dir` with its `<name>_r_b_COMPLEX.pdb`, in sorted order, cut
    into train / val / test by index mod 10 (8 : 1 : 1), one shard a split
    (`<split>_shard0000.npz`), the codes the names. Pairs made from a test
    set (the frozen DIPS test complexes) must not be scored on that test set
    after training on them. An existing shard is kept as it is."""
    lig_files = sorted(glob.glob(os.path.join(complexes_dir, "*_l_b_COMPLEX.pdb")))
    pairs = [(f, f.replace("_l_b_COMPLEX.pdb", "_r_b_COMPLEX.pdb")) for f in lig_files]
    pairs = [(l, r) for l, r in pairs if os.path.exists(r)]
    log(f"dips-frozen: {len(pairs)} bound complex pairs in {complexes_dir}")
    by_split: dict = {"train": [], "val": [], "test": []}
    for i, pair in enumerate(pairs):
        by_split["val" if i % 10 == 8 else "test" if i % 10 == 9 else "train"].append(pair)
    shard_paths = []
    for split, items in by_split.items():
        out_path = os.path.join(cfg.cache_path(), f"{split}_shard0000.npz")
        shard_paths.append(out_path)
        if os.path.exists(out_path):
            log(f"  {split}: cache exists")
            continue
        results = process_map(_process_one, [(l, r, cfg.graph) for l, r in items],
                              cfg.data.n_jobs)
        kept = [(os.path.basename(l).replace("_l_b_COMPLEX.pdb", ""), s)
                for (l, _), s in zip(items, results) if s is not None]
        write_cache(out_path, [c for c, _ in kept], [s for _, s in kept])
        log(f"  {split}: kept {len(kept)}/{len(items)}")
    return shard_paths


def shard_files(cache_dir: str, split: str) -> List[str]:
    """The split's shard paths in order, up to the first missing index."""
    paths = []
    while True:
        path = os.path.join(cache_dir, f"{split}_shard{len(paths):04d}.npz")
        if not os.path.exists(path):
            return paths
        paths.append(path)


def load_shard_samples(path: str) -> Tuple[List[ComplexSample], List[str]]:
    """One shard's complexes and codes."""
    codes, samples = read_cache(path)
    return samples, codes


def load_dips_shards(cfg: Config, split: str) -> Tuple[List[ComplexSample], List[str]]:
    """Every shard of the split, in memory (the materialized DIPS dataset)."""
    samples: List[ComplexSample] = []
    codes: List[str] = []
    for path in shard_files(cfg.cache_path(), split):
        s, c = load_shard_samples(path)
        samples.extend(s)
        codes.extend(c)
    return samples, codes


class DipsShardIndex:
    """Codes and sizes of every complex of a sharded split without its
    arrays: per complex its shard, its place in the shard, n_lig, n_rec and
    the pocket size. Each shard's sizes come from its `.index.json`
    sidecar; a missing or truncated sidecar is derived by loading the shard
    once and written back atomically (a temporary file renamed into place),
    or not at all in a read-only directory."""

    def __init__(self, cache_dir: str, split: str):
        self.shard_paths = shard_files(cache_dir, split)
        self.codes: List[str] = []
        self.shard_of: List[int] = []
        self.index_in_shard: List[int] = []
        self.n_lig: List[int] = []
        self.n_rec: List[int] = []
        self.n_pocket: List[int] = []
        for si, path in enumerate(self.shard_paths):
            meta = self._read_sidecar(path + ".index.json")
            if meta is None:
                samples, codes = load_shard_samples(path)
                meta = {"codes": [str(c) for c in codes],
                        "n_lig": [s.lig.num_nodes for s in samples],
                        "n_rec": [s.rec.num_nodes for s in samples],
                        "n_pocket": [int(s.pocket.shape[0]) for s in samples]}
                write_sidecar(path, meta)
            k = len(meta["codes"])
            self.codes.extend(meta["codes"])
            self.shard_of.extend([si] * k)
            self.index_in_shard.extend(range(k))
            self.n_lig.extend(meta["n_lig"])
            self.n_rec.extend(meta["n_rec"])
            self.n_pocket.extend(meta["n_pocket"])

    @staticmethod
    def _read_sidecar(path: str):
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except ValueError:          # truncated by a killed writer: derive again
            return None

    def __len__(self) -> int:
        return len(self.codes)


def write_sidecar(shard_path: str, meta: dict) -> None:
    """Write `<shard>.index.json` through a temporary file renamed into
    place, so a writer killed mid-way leaves no truncated sidecar; skipped
    where the directory is read-only."""
    sidecar = shard_path + ".index.json"
    try:
        tmp = sidecar + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, sidecar)
    except OSError:
        pass


class ShardLRU:
    """At most `capacity` shards in memory, least recently used evicted
    first. `get(i)` returns shard i's complexes, loading it on a miss;
    `prefetch(i)` loads it on one background thread. `loads` counts the
    shards loaded, `resident()` those held."""

    def __init__(self, shard_paths: List[str], capacity: int = 4):
        self.shard_paths = shard_paths
        self.capacity = max(1, capacity)
        self._cache: "collections.OrderedDict[int, List[ComplexSample]]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: dict = {}
        self.loads = 0

    def _load(self, idx: int) -> List[ComplexSample]:
        return load_shard_samples(self.shard_paths[idx])[0]

    def _put(self, idx: int, samples: List[ComplexSample]) -> None:
        self._cache[idx] = samples
        self._cache.move_to_end(idx)
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)

    def prefetch(self, idx: int) -> None:
        with self._lock:
            if idx in self._cache or idx in self._pending:
                return
            self.loads += 1
            self._pending[idx] = self._pool.submit(self._load, idx)

    def get(self, idx: int) -> List[ComplexSample]:
        with self._lock:
            if idx in self._cache:
                self._cache.move_to_end(idx)
                return self._cache[idx]
            fut = self._pending.pop(idx, None)
            if fut is None:
                self.loads += 1
        samples = fut.result() if fut is not None else self._load(idx)
        with self._lock:
            self._put(idx, samples)
        return samples

    def resident(self) -> int:
        with self._lock:
            return len(self._cache)
