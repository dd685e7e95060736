"""Training losses, batched and mask-aware: the port of `masked_mse` and
`total_loss` of `equidock_public_tpu/train/losses.py` for unpacked
batches (one complex per slot)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import TrainConfig
from ..graph import PairBatch
from ..ops.intersection import body_intersection_loss
from ..ops.sinkhorn import pocket_ot_loss, sq_dist_mat
from ..ops.softmin_field import body_intersection_loss_fused


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-complex mean squared error over the valid nodes x 3 coordinates:
    pred/target (B, N, 3), mask (B, N) -> (B,)."""
    se = (((pred - target) ** 2) * mask[..., None]).sum(dim=(1, 2))
    return se / torch.clamp(3.0 * mask.sum(dim=1), min=1.0)


def total_loss(outputs: Dict[str, torch.Tensor], batch: PairBatch,
               tc: TrainConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar training loss and its terms, averaged over the valid complexes:
    coordinate MSE + w_ot * Sinkhorn pocket OT + w_int * body intersection
    (through the soft-min field sums when `tc.use_fused_intersection`)."""
    if tc.ot_solver != "sinkhorn":
        raise NotImplementedError(f"ot_solver={tc.ot_solver!r}: only 'sinkhorn' is ported")
    lig_pred = outputs["ligand_coords"]
    pm = batch.pair_mask
    denom = torch.clamp(pm.sum(), min=1.0)

    lig_coors = masked_mse(lig_pred, batch.gt_lig, batch.lig.node_mask)
    cost = (sq_dist_mat(batch.pocket_lig, outputs["keypts_lig"])
            + sq_dist_mat(batch.pocket_rec, outputs["keypts_rec"]))
    ot = pocket_ot_loss(cost, batch.pocket_mask, epsilon=tc.sinkhorn_epsilon,
                        iters=tc.sinkhorn_iters)
    # the same function either way; the fused one runs the soft-min field
    # kernels on the card instead of the (B, N_l, N_r) distance tensor
    intersection_fn = (body_intersection_loss_fused if tc.use_fused_intersection
                       else body_intersection_loss)
    intersection = intersection_fn(
        lig_pred, batch.lig.node_mask, batch.rec.x, batch.rec.node_mask,
        tc.intersection_sigma, tc.intersection_surface_ct)

    lig_loss = (lig_coors * pm).sum() / denom
    ot_loss = (ot * pm).sum() / denom
    int_loss = (intersection * pm).sum() / denom
    loss = (lig_loss + tc.pocket_ot_loss_weight * ot_loss
            + tc.intersection_loss_weight * int_loss)
    metrics = {"loss": loss, "ligand_coors_loss": lig_loss,
               # the receptor never moves
               "receptor_coors_loss": torch.zeros((), dtype=loss.dtype, device=loss.device),
               "ot_loss": ot_loss, "intersection_loss": int_loss}
    return loss, metrics
