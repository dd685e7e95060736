"""RMSD metering on the host (numpy): the port's copy of
`equidock_public_tpu/train/meter.py`, unpacked and packed batches.

- ligand / receptor RMSD: unaligned RMSD of CA coordinates;
- complex RMSD: RMSD after the Kabsch fit of the whole predicted complex
  (ligand ++ receptor) onto the ground truth;
- interface RMSD (`update_batch(meter_interface=True)`): the complex RMSD
  restricted to the ground-truth CA pairs closer than 8 A.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..data.featurize import rigid_transform_kabsch


def complex_rmsd(lig_pred: np.ndarray, rec_pred: np.ndarray,
                 lig_true: np.ndarray, rec_true: np.ndarray) -> Tuple[float, float, float]:
    """(ligand_rmsd, receptor_rmsd, complex_rmsd)."""
    lig_rmsd = float(np.sqrt(np.mean(np.sum((lig_pred - lig_true) ** 2, axis=1))))
    rec_rmsd = float(np.sqrt(np.mean(np.sum((rec_pred - rec_true) ** 2, axis=1))))
    pred = np.concatenate([lig_pred, rec_pred], axis=0)
    true = np.concatenate([lig_true, rec_true], axis=0)
    R, b = rigid_transform_kabsch(pred.T, true.T)
    aligned = ((R @ pred.T) + b).T
    crmsd = float(np.sqrt(np.mean(np.sum((aligned - true) ** 2, axis=1))))
    return lig_rmsd, rec_rmsd, crmsd


class RmsdMeter:
    """Per-complex RMSDs and their mean / median summaries."""

    def __init__(self):
        self.ligand, self.receptor, self.complex = [], [], []
        self.interface = []       # filled by update_batch(meter_interface=True) only

    def update(self, lig_pred, rec_pred, lig_true, rec_true) -> float:
        lig, rec, cplx = complex_rmsd(np.asarray(lig_pred), np.asarray(rec_pred),
                                      np.asarray(lig_true), np.asarray(rec_true))
        self.ligand.append(lig)
        self.receptor.append(rec)
        self.complex.append(cplx)
        return cplx

    def update_batch(self, batch, lig_pred_padded: np.ndarray,
                     meter_interface: bool = False) -> None:
        """Meter every valid complex of a padded PairBatch (tensors on any
        device) from the predicted ligand coordinates (B, N_l, 3); a packed
        batch's complexes are found by their segment ids."""
        host = lambda t: t.detach().cpu().numpy()
        lig_mask, rec_mask = host(batch.lig.node_mask), host(batch.rec.node_mask)
        gt_lig, rec_x = host(batch.gt_lig), host(batch.rec.x)
        pred = np.asarray(lig_pred_padded)

        def meter_one(lp, lt, rt):
            self.update(lp, rt, lt, rt)
            if meter_interface:
                d = np.linalg.norm(lt[:, None, :] - rt[None, :, :], axis=-1)
                ai, aj = np.where(d < 8.0)
                if ai.size:
                    self.interface.append(complex_rmsd(lp[ai], rt[aj], lt[ai], rt[aj])[2])

        if batch.n_segs > 1:
            seg_l, seg_r = host(batch.lig.seg_id), host(batch.rec.seg_id)
            seg_mask = host(batch.seg_mask)
            for b in range(lig_mask.shape[0]):
                for c in range(batch.n_segs):
                    if seg_mask[b, c] == 0:
                        continue
                    il = np.where((lig_mask[b] > 0) & (seg_l[b] == c))[0]
                    ir = np.where((rec_mask[b] > 0) & (seg_r[b] == c))[0]
                    meter_one(pred[b, il], gt_lig[b, il], rec_x[b, ir])
            return
        pair_mask = host(batch.pair_mask)
        for b in range(lig_mask.shape[0]):
            if pair_mask[b] == 0:
                continue
            nl, nr = int(lig_mask[b].sum()), int(rec_mask[b].sum())
            meter_one(pred[b, :nl], gt_lig[b, :nl], rec_x[b, :nr])

    def summarize_interface(self, reduction: str = "median") -> float:
        red = np.median if reduction == "median" else np.mean
        return float(red(self.interface)) if self.interface else float("nan")

    def summarize(self, reduction: str = "median"):
        red = np.median if reduction == "median" else np.mean
        if not self.complex:
            return float("nan"), float("nan"), float("nan")
        return (float(red(self.ligand)), float(red(self.receptor)),
                float(red(self.complex)))

    def summarize_with_std(self, reduction: str = "median"):
        red = np.median if reduction == "median" else np.mean
        arr = np.array(self.complex)
        return float(red(arr)), float(np.std(arr))
