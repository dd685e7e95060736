"""Sharded DIPS caches: the port's own copy of `shard_files`,
`load_shard_samples`, `load_dips_shards`, `DipsShardIndex` and `ShardLRU` of
`equidock_public_tpu/data/dips.py`.

A DIPS split is cached as `<split>_shard0000.npz`, `<split>_shard0001.npz`,
... in the split-cache layout of `data/dataset.py` (one shard holds up to
`SHARD_SIZE` complexes), each with a `<shard>.index.json` sidecar of the
sizes. Either package reads what the other writes. Building shards from the
raw DIPS pair files is a host tool that the port does not have.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

from ..config import Config
from .dataset import ComplexSample, read_cache

SHARD_SIZE = 512


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
