"""Frozen test-set generator, the port of
`equidock_public_tpu/cli/testset_gen.py`: for each test complex, the ground
truth `<code>_{l,r}_b_COMPLEX.pdb` and the inputs `<code>_{l,r}_b.pdb`,
centred and moved by a random rotation and a translation of length
U(0, 20), residue and atom numbers renumbered from 1. One `-seed` gives the
JAX package's files byte for byte (the same draws in the same order).

    python -m equidock_public_tpu_torch.cli.testset_gen -dataset db5 -out_dir DIR \
        [-raw_data_path DIR] [-split_file FILE] [-seed 0]
    python -m equidock_public_tpu_torch.cli.testset_gen -dataset dips -out_dir DIR \
        -raw_data_path PAIRS_DIR -split_file pairs-postprocessed-test.txt

The defaults lie under $EQUIDOCK_REFERENCE_ROOT. `-dataset dips` reads DIPS
pair pickles (pandas).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from ..config import reference_root
from ..data.featurize import uniform_rotation_translation
from ..data.pdb import read_pdb, write_pdb_renumbered


def write_table_variant(table, out_path: str, rng, unchanged: bool = False,
                        translation_interval: float = 20.0) -> None:
    """Write one AtomTable renumbered: as it is (a ground truth), or centred
    and moved by a pose drawn from `rng`."""
    coords = table.coords
    if not unchanged:
        rot, tr = uniform_rotation_translation(rng, translation_interval)
        coords = (rot @ (coords - coords.mean(axis=0, keepdims=True)).T).T + tr
    write_pdb_renumbered(out_path, table, coords.astype(np.float32))


def random_transf_pdb(in_path: str, out_path: str, rng, unchanged: bool = False,
                      translation_interval: float = 20.0) -> None:
    write_table_variant(read_pdb(in_path), out_path, rng, unchanged, translation_interval)


def main_db5(raw_data_path: str, split_file: str, out_dir: str, rng) -> None:
    """Each code of the split file (sorted) with a `<code>_l_b.pdb`: for the
    ligand, then the receptor, its ground truth, then its moved input."""
    os.makedirs(out_dir, exist_ok=True)
    files = set(os.listdir(raw_data_path))
    with open(split_file) as f:
        codes = sorted({line.strip() for line in f if line.strip()})
    for code in [c for c in codes if f"{c}_l_b.pdb" in files]:
        for side in ("l", "r"):
            src = os.path.join(raw_data_path, f"{code}_{side}_b.pdb")
            random_transf_pdb(src, os.path.join(out_dir, f"{code}_{side}_b_COMPLEX.pdb"), rng,
                              unchanged=True)
            random_transf_pdb(src, os.path.join(out_dir, f"{code}_{side}_b.pdb"), rng)
        print("wrote", code)


def sample_dips_round_robin(split_file: str, num_complexes: int, shuffler) -> list:
    """Visit the family directories in turn, each visit drawing one pair not
    drawn before (the family's list shuffled by `shuffler` first), until
    `num_complexes` pairs are drawn or the split has none left."""
    by_cat = {}
    with open(split_file) as f:
        for line in f:
            name = line.strip()
            if name:
                by_cat.setdefault(name.split("/")[0], []).append(name)
    cats = list(by_cat.keys())
    total = sum(map(len, by_cat.values()))
    selected, seen, idx = [], set(), -1
    while len(selected) < num_complexes and len(seen) < total:
        idx = (idx + 1) % len(cats)
        choices = by_cat[cats[idx]]
        shuffler(choices)
        for name in choices:
            if name not in seen:
                seen.add(name)
                selected.append(name)
                break
    return selected


def main_dips(raw_data_path: str, split_file: str, out_dir: str, rng,
              num_complexes: int = 100, seed: int = 0) -> None:
    """`num_complexes` pairs drawn round robin over the families (the
    shuffles seeded with `seed`), each written full-atom as ground truth and
    moved input, named `<family>_<pair>_{l,r}_b[_COMPLEX].pdb`."""
    import random

    from ..data.dips import read_dips_pair_tables

    os.makedirs(out_dir, exist_ok=True)
    selected = sample_dips_round_robin(split_file, num_complexes, random.Random(seed).shuffle)
    for name in selected:
        lig_t, rec_t = read_dips_pair_tables(os.path.join(raw_data_path, name))
        base = name.replace("/", "_")
        for side, table in (("l", lig_t), ("r", rec_t)):
            write_table_variant(table, os.path.join(out_dir, f"{base}_{side}_b_COMPLEX.pdb"),
                                rng, unchanged=True)
            write_table_variant(table, os.path.join(out_dir, f"{base}_{side}_b.pdb"), rng)
        print("wrote", base)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-dataset", default="db5", choices=["db5", "dips"])
    p.add_argument("-raw_data_path", default=reference_root("data/benchmark5.5/structures"))
    p.add_argument("-split_file", default=reference_root("data/benchmark5.5/cv/cv_0/test.txt"))
    p.add_argument("-out_dir", required=True)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-num_complexes", type=int, default=100,
                   help="dips only: number of pairs to sample")
    a = p.parse_args(argv)
    rng = np.random.default_rng(a.seed)
    if a.dataset == "db5":
        main_db5(a.raw_data_path, a.split_file, a.out_dir, rng)
    else:
        main_dips(a.raw_data_path, a.split_file, a.out_dir, rng,
                  num_complexes=a.num_complexes, seed=a.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
