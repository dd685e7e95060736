"""Offline evaluator, CRMSD and IRMSD over a directory of predicted ligand
PDBs: the port of `equidock_public_tpu/eval/rmsd.py` (numpy on the host).

- CA atoms only;
- CRMSD: the RMSD after the Kabsch fit of the predicted complex
  [ligand ++ receptor] onto the ground truth;
- IRMSD: the same over the interface (ground-truth CA pairs closer than
  8 A);
- single-ligand methods take the ground-truth receptor as the predicted
  one; `attract` and `hdock` read their own predicted receptors.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..data.pdb import ca_coords, read_pdb
from ..train.meter import RmsdMeter


def evaluate_output_dir(input_dir: str, ground_truth_dir: str,
                        method: str = "equidock") -> Dict[str, float]:
    """Median, mean and standard deviation of the CRMSD and IRMSD of every
    `X_l_b_<METHOD>.pdb` in `input_dir` against `ground_truth_dir/
    X_l_b_COMPLEX.pdb` and `X_r_b_COMPLEX.pdb`."""
    meter, imeter = RmsdMeter(), RmsdMeter()
    suffix = method.upper()
    tail = f"_l_b_{suffix}.pdb"
    num_files = 0
    for file in sorted(os.listdir(input_dir)):
        if not file.endswith(tail):
            continue
        stem = file[:-len(tail)]
        rec_gt_file = os.path.join(ground_truth_dir, f"{stem}_r_b_COMPLEX.pdb")
        rec_model_file = (os.path.join(input_dir, f"{stem}_r_b_{suffix}.pdb")
                          if method in ("attract", "hdock") else rec_gt_file)
        num_files += 1
        lig_model = ca_coords(read_pdb(os.path.join(input_dir, file)))
        rec_model = ca_coords(read_pdb(rec_model_file))
        lig_gt = ca_coords(read_pdb(os.path.join(ground_truth_dir, f"{stem}_l_b_COMPLEX.pdb")))
        rec_gt = ca_coords(read_pdb(rec_gt_file))
        if lig_model.shape != lig_gt.shape or rec_model.shape != rec_gt.shape:
            raise ValueError(f"{stem}: predicted CA shapes {lig_model.shape}, "
                             f"{rec_model.shape} against ground truth {lig_gt.shape}, "
                             f"{rec_gt.shape}")
        d = np.linalg.norm(lig_gt[:, None, :] - rec_gt[None, :, :], axis=-1)
        ai, aj = np.where(d < 8.0)
        meter.update(lig_model, rec_model, lig_gt, rec_gt)
        imeter.update(lig_model[ai], rec_model[aj], lig_gt[ai], rec_gt[aj])
    if num_files == 0:
        raise FileNotFoundError(f"no '*{tail}' files found in {input_dir}: check the "
                                "-method name (it must match the output suffix)")
    crmsd_median, _ = meter.summarize_with_std("median")
    crmsd_mean, crmsd_std = meter.summarize_with_std("mean")
    irmsd_median, _ = imeter.summarize_with_std("median")
    irmsd_mean, irmsd_std = imeter.summarize_with_std("mean")
    return {"num_files": num_files,
            "crmsd_median": crmsd_median, "crmsd_mean": crmsd_mean, "crmsd_std": crmsd_std,
            "irmsd_median": irmsd_median, "irmsd_mean": irmsd_mean, "irmsd_std": irmsd_std}
