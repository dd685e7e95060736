"""Synthetic protein graphs with real-kNN topology, synthetic split caches
and synthetic DIPS shards: the port's copy of `synth_graph` and
`write_synth_split` from `equidock_public_tpu/data/synth.py`, and of the
shard recipe of the JAX package's streaming tests (`_synth_graph`,
`_write_shards` in `tests/test_dips_stream.py`). Under one seed both
packages write the same arrays, so the card's machine can make the caches
the JAX package's tests use without importing it."""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def synth_graph(rng: np.random.Generator, n: int, k: int = 10) -> dict:
    """One protein's fields (random features; coordinates at protein-like
    density; the neighbor table is the kNN graph of those coordinates)."""
    x = (rng.standard_normal((n, 3)) * (2.0 * n ** (1 / 3))).astype(np.float32)
    kk = min(k, n)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, axis=1)[:, :kk].astype(np.int32)
    return {
        "res_id": rng.integers(0, 21, (n,)).astype(np.int32),
        "x": x,
        "mu_r_norm": (np.abs(rng.standard_normal((n, 5))) + 0.5
                      ).astype(np.float32),
        "nbr": nbr,
        "nbr_mask": np.ones((n, kk), np.float32),
        "edge_feat": rng.standard_normal((n, kk, 27)).astype(np.float32),
    }


def write_synth_split(path: str, sizes: Sequence[Tuple[int, int]],
                      seed: int = 0, k: int = 10) -> str:
    """Write a synthetic split cache in the npz layout of `data/dataset.py`,
    one complex per (n_lig, n_rec): random features, the ground truth at the
    input coordinates, and a random pocket cloud of max(4, min(n) // 8)
    points."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for i, (n_l, n_r) in enumerate(sizes):
        p = f"c{i}/"
        for prefix, g in (("lig/", synth_graph(rng, n_l, k)),
                          ("rec/", synth_graph(rng, n_r, k))):
            for key, val in g.items():
                out[p + prefix + key] = val
        out[p + "gt_lig"] = out[p + "lig/x"]
        out[p + "gt_rec"] = out[p + "rec/x"]
        n_p = max(4, min(n_l, n_r) // 8)
        out[p + "pocket"] = (rng.standard_normal((n_p, 3)) * 4).astype(np.float32)
    out["codes"] = np.array([f"synth{i}" for i in range(len(sizes))])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **out)
    return path


def random_table_graph(rng: np.random.Generator, n: int, k: int = 4) -> dict:
    """One protein's fields with a random neighbor table (not kNN): the
    streaming tests' recipe."""
    return {
        "res_id": rng.integers(0, 21, (n,)).astype(np.int32),
        "x": (rng.standard_normal((n, 3)) * 8).astype(np.float32),
        "mu_r_norm": (np.abs(rng.standard_normal((n, 5))) + 0.5).astype(np.float32),
        "nbr": rng.integers(0, n, (n, k)).astype(np.int32),
        "nbr_mask": np.ones((n, k), np.float32),
        "edge_feat": rng.standard_normal((n, k, 27)).astype(np.float32),
    }


def write_synth_shards(cache_dir: str, split: str = "train", n_shards: int = 12,
                       per_shard: int = 24, seed: int = 0, k: int = 4,
                       sizes: Optional[Sequence[Tuple[int, int]]] = None) -> list:
    """Write `n_shards` DIPS shards of `per_shard` complexes each
    (`<split>_shard0000.npz`, ...) with their `.index.json` sidecars; returns
    the shard paths. Without `sizes`: the streaming tests' recipe, n_lig in
    [8, 14), n_rec in [10, 18), random tables, a 5-point pocket. With
    `sizes` (n_shards x per_shard pairs): kNN graphs of those sizes
    (`synth_graph`) and the pocket of `write_synth_split`."""
    from .dips import write_sidecar

    rng = np.random.default_rng(seed)
    os.makedirs(cache_dir, exist_ok=True)
    paths = []
    for s in range(n_shards):
        out: dict = {}
        meta = {"codes": [], "n_lig": [], "n_rec": [], "n_pocket": []}
        for i in range(per_shard):
            p = f"c{i}/"
            if sizes is None:
                n_l, n_r = int(rng.integers(8, 14)), int(rng.integers(10, 18))
                sides = (("lig/", random_table_graph(rng, n_l, k)),
                         ("rec/", random_table_graph(rng, n_r, k)))
            else:
                n_l, n_r = sizes[s * per_shard + i]
                sides = (("lig/", synth_graph(rng, n_l, k)), ("rec/", synth_graph(rng, n_r, k)))
            for prefix, g in sides:
                for key, val in g.items():
                    out[p + prefix + key] = val
            out[p + "gt_lig"] = out[p + "lig/x"]
            out[p + "gt_rec"] = out[p + "rec/x"]
            n_p = 5 if sizes is None else max(4, min(n_l, n_r) // 8)
            out[p + "pocket"] = (rng.standard_normal((n_p, 3)) * 4).astype(np.float32)
            meta["codes"].append(f"s{s}c{i}")
            meta["n_lig"].append(int(out[p + "lig/x"].shape[0]))
            meta["n_rec"].append(int(out[p + "rec/x"].shape[0]))
            meta["n_pocket"].append(n_p)
        out["codes"] = np.array(meta["codes"])
        path = os.path.join(cache_dir, f"{split}_shard{s:04d}.npz")
        np.savez(path, **out)
        write_sidecar(path, meta)
        paths.append(path)
    return paths
