"""Crop-corpus CLI: a DIPS-sized pretraining corpus of interface crops of
the DB5 train complexes (`data/crops.py`), the port of
`equidock_public_tpu/cli/crop_corpus.py`.

    python -m equidock_public_tpu_torch.cli.crop_corpus -n_pairs 16384 \
        -cache_dir ./cache -n_jobs 8

The parents are the DB5 checkout's (`DataConfig`'s default `raw_data_path`
and `split_files_path` under $EQUIDOCK_REFERENCE_ROOT, or `-db5_raw`), the
size sample the frozen DIPS test set's (`-dips_sizes_dir`). Writes DIPS
shards into the DIPS cache path of `-cache_dir`: train from the train
parents, val from the val parents, and a crop test split from the val
parents again (a seed apart: it gives `-data dips` runs a final test, not
an independent evaluation). Test parents are never cropped.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

from ..config import DataConfig, reference_root
from ..data.crops import generate_crop_shards
from ..data.dataset import split_codes
from ..data.synth import dips_testset_sizes
from ._common import add_config_args, config_from_args, refuse_unported


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Build interface-crop corpus")
    add_config_args(p)
    p.add_argument("-n_pairs", type=int, default=16384)
    p.add_argument("-n_val_pairs", type=int, default=512)
    p.add_argument("-max_side", type=int, default=256)
    p.add_argument("-crop_seed", type=int, default=0)
    p.add_argument("-db5_raw", default=None,
                   help="DB5 structures dir (default: the DB5 checkout's raw_data_path)")
    p.add_argument("-dips_sizes_dir",
                   default=reference_root("test_sets_pdb/dips_test_random_transformed"),
                   help="frozen DIPS test dir for the size sample")
    a = p.parse_args(argv)
    refuse_unported(a)
    db5 = DataConfig()
    raw = a.db5_raw or db5.raw_data_path
    cfg = config_from_args(a)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data="dips"))

    def codes(split):
        return split_codes(raw, os.path.join(db5.split_files_path, f"{split}.txt"))

    sizes = dips_testset_sizes(a.dips_sizes_dir)
    print(f"size distribution: {len(sizes)} (n_l, n_r) draws, "
          f"median {sorted(nl for nl, _ in sizes)[len(sizes) // 2]} residues")
    n_jobs = cfg.data.n_jobs
    generate_crop_shards(cfg, "train", codes("train"), raw, a.n_pairs, a.crop_seed, sizes,
                         a.max_side, n_jobs)
    generate_crop_shards(cfg, "val", codes("val"), raw, a.n_val_pairs, a.crop_seed + 1, sizes,
                         a.max_side, n_jobs)
    generate_crop_shards(cfg, "test", codes("val"), raw, max(64, a.n_val_pairs // 4),
                         a.crop_seed + 2, sizes, a.max_side, n_jobs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
