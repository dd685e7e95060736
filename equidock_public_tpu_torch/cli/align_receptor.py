"""Baseline-output aligner, the port of
`equidock_public_tpu/cli/align_receptor.py`: Kabsch-align a method's
predicted receptor onto the ground-truth receptor and move the predicted
ligand by the same transform (for docking outputs whose receptor frame
differs from the ground truth's).

    python -m equidock_public_tpu_torch.cli.align_receptor \
        -ligand L.pdb -receptor R.pdb -receptor_gt R_COMPLEX.pdb -out OUT.pdb

Raises when the receptor does not align rigidly (residual 0.1 or more).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ..data.featurize import rigid_transform_kabsch
from ..data.pdb import read_pdb, write_pdb


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-ligand", required=True)
    p.add_argument("-receptor", required=True)
    p.add_argument("-receptor_gt", required=True)
    p.add_argument("-out", required=True)
    a = p.parse_args(argv)

    lig_table = read_pdb(a.ligand)
    rec = read_pdb(a.receptor).coords
    rec_gt = read_pdb(a.receptor_gt).coords
    R, b = rigid_transform_kabsch(rec.T, rec_gt.T)
    err = np.linalg.norm(((R @ rec.T) + b).T - rec_gt)
    if not err < 1e-1:
        raise ValueError(f"receptor alignment residual {err}")
    moved = ((R @ lig_table.coords.T) + b).T
    write_pdb(a.out, lig_table, moved.astype(np.float32))
    print(f"wrote {a.out} (receptor alignment residual {err:.2e})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
