"""DIPS partitioner, the port of `equidock_public_tpu/cli/partition_dips.py`:
scan a tree `<family>/<pair>.dill`, keep the pairs whose two proteins each
have fewer than `-max_atom_count` atoms, and split train / val / test by
family directory (the last 40 of the shuffled families: 20 val, 20 test),
so that homologous structures never straddle splits.

    python -m equidock_public_tpu_torch.cli.partition_dips -data_dir DIR [-out_dir DIR]

Writes `pairs-postprocessed.txt` (kept as it is when it exists) and
`pairs-postprocessed-{train,val,test}.txt`, the lists
`data/dips.py::build_dips_cache` reads. Needs pandas (for the pickles).
"""

from __future__ import annotations

import argparse
import os
import random
from pathlib import Path
from typing import List, Optional


def count_atoms_ok(dill_path: str, max_atom_count: int) -> bool:
    """Both proteins of the pair have fewer than `max_atom_count` atoms
    (False for an unreadable pickle)."""
    import pandas as pd

    try:
        pair = pd.read_pickle(dill_path)
        return len(pair.df0) < max_atom_count and len(pair.df1) < max_atom_count
    except Exception:
        return False


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-data_dir", required=True, help="root dir with <family>/<pair>.dill files")
    p.add_argument("-out_dir", default=None)
    p.add_argument("-max_atom_count", type=int, default=10000)
    p.add_argument("-no_filter", action="store_true")
    p.add_argument("-seed", type=int, default=0)
    a = p.parse_args(argv)
    out_dir = a.out_dir or a.data_dir
    os.makedirs(out_dir, exist_ok=True)

    all_path = os.path.join(out_dir, "pairs-postprocessed.txt")
    if os.path.exists(all_path):
        print("pairs-postprocessed.txt exists, skipping scan")
        with open(all_path) as f:
            kept = [line.strip() for line in f if line.strip()]
    else:
        kept = []
        for dill in sorted(Path(a.data_dir).rglob("*.dill")):
            if a.no_filter or count_atoms_ok(str(dill), a.max_atom_count):
                kept.append(os.path.join(dill.parent.name, dill.name))
        with open(all_path, "w") as f:
            f.write("\n".join(kept) + "\n")
    print(f"{len(kept)} pairs pass the atom-count filter")

    families = sorted({name.split(os.sep)[0] for name in kept})
    random.Random(a.seed).shuffle(families)
    splits = {"train": set(families[:-40]), "val": set(families[-40:-20]),
              "test": set(families[-20:])}
    for split, fams in splits.items():
        names = [n for n in kept if n.split(os.sep)[0] in fams]
        path = os.path.join(out_dir, f"pairs-postprocessed-{split}.txt")
        with open(path, "w") as f:
            f.write("\n".join(names) + "\n")
        print(f"{split}: {len(names)} pairs ({len(fams)} families) -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
