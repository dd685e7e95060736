"""Synthetic protein graphs with real-kNN topology and synthetic split
caches: the port's copy of `synth_graph` and `write_synth_split` from
`equidock_public_tpu/data/synth.py`. Under one seed both packages write the
same arrays, so the card's machine can make the caches the JAX package's
tests use without importing it."""

from __future__ import annotations

import os
from typing import Sequence, Tuple

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
