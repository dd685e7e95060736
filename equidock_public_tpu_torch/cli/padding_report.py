"""Padding-waste report of the bucketed batching policy, the port of
`equidock_public_tpu/cli/padding_report.py`: on real size lists, how many
padded node slots the configured `-node_buckets` waste beside the shapes
they cost, candidate ladders side by side, and packed batches at 2, 4 and 6
complexes a slot (`utils/padding.py`).

    python -m equidock_public_tpu_torch.cli.padding_report [-cache_dir DIR] [-dips_dir DIR]

Sizes: the DB5 train split cache under `-cache_dir` (when it exists) and
the pairs `<dips_dir>/random_transformed/*_{l,r}_b.pdb` (default: the frozen
DIPS test set under $EQUIDOCK_REFERENCE_ROOT). Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from ..config import reference_root
from ..data.synth import dips_testset_sizes
from ..utils.padding import compare_policies, waste_report_packed
from ._common import add_config_args, config_from_args, refuse_unported

CANDIDATES = {
    "configured": None,  # the config's node_buckets
    "coarse_pow2": (128, 256, 512, 1024, 2048),
    "fine": (64, 96, 128, 160, 192, 224, 256, 320, 384, 448, 512, 640, 768, 1024, 1536),
    "single_max": (1536,),
}


def db5_sizes(cfg):
    """(n_lig, n_rec) of every complex of the cached DB5 train split, or
    None without a cache."""
    import numpy as np

    path = os.path.join(cfg.cache_path(), "train.npz")
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        sizes, i = [], 0
        while f"c{i}/lig/x" in z:
            sizes.append((z[f"c{i}/lig/x"].shape[0], z[f"c{i}/rec/x"].shape[0]))
            i += 1
    return sizes


def report(cfg, dips_dir: str) -> dict:
    """The report's dict: bs, then db5_train and dips_test where they have
    sizes, each with its complexes, the policies and the packed rows."""
    policies = dict(CANDIDATES, configured=cfg.data.node_buckets)
    out = {"bs": cfg.train.bs}

    def rows(sizes):
        return {"n_complexes": len(sizes),
                "policies": compare_policies(sizes, cfg.train.bs, policies),
                **{f"packed_c{c}": waste_report_packed(sizes, cfg.data.node_buckets,
                                                       cfg.train.bs, c,
                                                       cfg.data.slot_count_buckets)
                   for c in (2, 4, 6)}}

    db5 = db5_sizes(cfg)
    if db5:
        out["db5_train"] = rows(db5)
    if os.path.isdir(dips_dir):
        out["dips_test"] = rows(dips_testset_sizes(dips_dir))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    add_config_args(p)
    p.add_argument("-dips_dir",
                   default=reference_root("test_sets_pdb/dips_test_random_transformed"))
    a = p.parse_args(argv)
    refuse_unported(a)
    print(json.dumps(report(config_from_args(a), a.dips_dir), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
