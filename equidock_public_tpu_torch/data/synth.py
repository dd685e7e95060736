"""Synthetic protein graphs with real-kNN topology, synthetic split caches
and synthetic DIPS shards: the port's copy of `synth_graph`,
`write_synth_split` and `dips_testset_sizes` from
`equidock_public_tpu/data/synth.py`, and of the shard recipe of the JAX
package's streaming tests (`_synth_graph`, `_write_shards` in
`tests/test_dips_stream.py`). Under one seed both packages write the same
arrays, so the card's machine can make the caches the JAX package's tests
use without importing it. `write_db5_raw_tree` writes PDB files and split
files in the layout of the DB5.5 checkout from single chains cut in two,
the raw input of the cache builders."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

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


def dips_testset_sizes(dips_dir: str) -> List[Tuple[int, int]]:
    """(n_lig, n_rec) filtered-residue counts of the pairs
    `random_transformed/*_{l,r}_b.pdb` under `dips_dir` (the frozen DIPS
    test set: the sample of DIPS sizes the crop corpus draws from)."""
    import glob

    from .featurize import filter_residues
    from .pdb import group_residues, read_pdb

    sizes = []
    for lig in sorted(glob.glob(os.path.join(dips_dir, "random_transformed", "*_l_b.pdb"))):
        rec = lig.replace("_l_b.pdb", "_r_b.pdb")
        if not os.path.exists(rec):
            continue
        n = [len(filter_residues(group_residues(read_pdb(f)))) for f in (lig, rec)]
        sizes.append((n[0], n[1]))
    return sizes


def write_chain_halves(chain_pdb: str, lig_path: str, rec_path: str) -> None:
    """The ATOM lines of one chain cut in two at half its residues (file
    order): the first half as the ligand, the rest as the receptor. The
    halves touch natively, so the pair has a real interface."""
    with open(chain_pdb) as f:
        lines = [ln for ln in f if ln.startswith("ATOM")]
    keys = list(dict.fromkeys(ln[21:27] for ln in lines))
    first = set(keys[:len(keys) // 2])
    for path, keep in ((lig_path, True), (rec_path, False)):
        with open(path, "w") as f:
            f.writelines(ln for ln in lines if (ln[21:27] in first) == keep)


def write_db5_raw_tree(root: str, chains: Dict[str, str],
                       splits: Sequence[Tuple[str, int]] = (("train", 10), ("val", 3),
                                                            ("test", 3))) -> Tuple[str, str]:
    """A raw tree in the DB5.5 checkout's layout under `root`: for each code
    of `chains` (code -> a single-chain PDB), in order,
    `data/benchmark5.5/structures/<code>_{l,r}_b.pdb` (`write_chain_halves`),
    and `data/benchmark5.5/cv/cv_0/<split>.txt` with the next `n` codes per
    (split, n). Returns (structures dir, split-files dir): the defaults of
    `raw_data_path` and `split_files_path` with EQUIDOCK_REFERENCE_ROOT=root."""
    structures = os.path.join(root, "data", "benchmark5.5", "structures")
    cv = os.path.join(root, "data", "benchmark5.5", "cv", "cv_0")
    os.makedirs(structures, exist_ok=True)
    os.makedirs(cv, exist_ok=True)
    codes = list(chains)
    if sum(n for _, n in splits) > len(codes):
        raise ValueError(f"{len(codes)} chains for splits {list(splits)}")
    for code in codes:
        write_chain_halves(chains[code], os.path.join(structures, f"{code}_l_b.pdb"),
                           os.path.join(structures, f"{code}_r_b.pdb"))
    start = 0
    for split, n in splits:
        with open(os.path.join(cv, f"{split}.txt"), "w") as f:
            f.write("".join(c + "\n" for c in codes[start:start + n]))
        start += n
    return structures, cv
