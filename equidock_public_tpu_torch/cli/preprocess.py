"""Preprocess CLI: featurize PDB files into the split caches the training
CLI reads, the port of `equidock_public_tpu/cli/preprocess.py`.

    python -m equidock_public_tpu_torch.cli.preprocess [-n_jobs 4] \
        [-raw_data_path DIR] [-split_files_path DIR] [-cache_dir DIR] [splits...]

Each split (default val, test, train) becomes `<cache_path>/<split>.npz`
(`data/dataset.py::build_cache`). With `-dips_frozen_complexes DIR`, the
bound pairs `*_{l,r}_b_COMPLEX.pdb` of DIR become DIPS shards instead
(`data/dips.py::build_dips_frozen_cache`). Host work only: numpy and the
native graph builder, no device.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..data.dataset import build_cache
from ._common import add_config_args, config_from_args, refuse_unported


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Build graph caches")
    add_config_args(p)
    p.add_argument("-dips_frozen_complexes", default=None,
                   help="a directory of *_{l,r}_b_COMPLEX.pdb bound pairs: build DIPS shards "
                        "of them (8 train : 1 val : 1 test by sorted index)")
    p.add_argument("splits", nargs="*", default=["val", "test", "train"])
    a = p.parse_args(argv)
    refuse_unported(a)
    cfg = config_from_args(a)
    if a.dips_frozen_complexes:
        from ..data.dips import build_dips_frozen_cache

        build_dips_frozen_cache(cfg, a.dips_frozen_complexes)
        return 0
    for split in a.splits or ["val", "test", "train"]:
        build_cache(cfg, split)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
