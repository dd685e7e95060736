"""Training losses, batched and mask-aware: the port of `masked_mse`,
`masked_mse_packed` and `total_loss` of `equidock_public_tpu/train/losses.py`,
unpacked (one complex per slot) and packed (several a slot)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import TrainConfig
from ..graph import PairBatch
from ..ops.intersection import body_intersection_loss, body_intersection_loss_packed
from ..ops.sinkhorn import pocket_ot_loss, pocket_ot_loss_exact, sq_dist_mat
from ..ops.softmin_field import body_intersection_loss_fused


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-complex mean squared error over the valid nodes x 3 coordinates:
    pred/target (B, N, 3), mask (B, N) -> (B,)."""
    se = (((pred - target) ** 2) * mask[..., None]).sum(dim=(1, 2))
    return se / torch.clamp(3.0 * mask.sum(dim=1), min=1.0)


def masked_mse_packed(pred: torch.Tensor, target: torch.Tensor,
                      oh: torch.Tensor) -> torch.Tensor:
    """Per packed complex: pred/target (B, N, 3), oh (B, N, C) segment
    one-hot times node mask -> (B, C), normalised as `masked_mse`."""
    se = ((pred - target) ** 2).sum(dim=-1)                        # (B, N)
    return torch.einsum("bn,bnc->bc", se, oh) / torch.clamp(3.0 * oh.sum(dim=1), min=1.0)


def total_loss(outputs: Dict[str, torch.Tensor], batch: PairBatch,
               tc: TrainConfig, denom: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar training loss and its terms, averaged over the valid complexes:
    coordinate MSE + w_ot * pocket OT (Sinkhorn, or the exact host LP with
    `ot_solver='exact'`) + w_int * body intersection (through the soft-min
    field sums when `tc.use_fused_intersection`). Packed batches (C > 1)
    take every term per packed complex, with the unpacked normalisations;
    their intersection term is the plain packed one, as in the JAX package,
    whatever `use_fused_intersection` says. `denom` replaces the count of
    valid complexes (a rank's share of a batch is normalised by the whole
    batch's count, as the JAX package's SPMD step computes it)."""
    if tc.ot_solver not in ("sinkhorn", "exact"):
        raise ValueError(f"unknown ot_solver {tc.ot_solver!r}")
    lig_pred = outputs["ligand_coords"]
    C = batch.n_segs
    pm = batch.complex_mask
    denom = torch.clamp(pm.sum(), min=1.0) if denom is None else denom

    if C == 1:
        lig_coors = masked_mse(lig_pred, batch.gt_lig, batch.lig.node_mask)
        keypts_l, keypts_r = outputs["keypts_lig"], outputs["keypts_rec"]
        pocket_l, pocket_r, pocket_mask = batch.pocket_lig, batch.pocket_rec, batch.pocket_mask
    else:
        lig_oh, rec_oh = batch.lig.seg_onehot(C), batch.rec.seg_onehot(C)
        lig_coors = masked_mse_packed(lig_pred, batch.gt_lig, lig_oh).reshape(-1)
        B, H, P = lig_pred.shape[0], outputs["keypts_lig"].shape[2], batch.pocket_lig.shape[2]
        keypts_l = outputs["keypts_lig"].reshape(B * C, H, 3)
        keypts_r = outputs["keypts_rec"].reshape(B * C, H, 3)
        pocket_l = batch.pocket_lig.reshape(B * C, P, 3)
        pocket_r = batch.pocket_rec.reshape(B * C, P, 3)
        pocket_mask = batch.pocket_mask.reshape(B * C, P)

    cost = sq_dist_mat(pocket_l, keypts_l) + sq_dist_mat(pocket_r, keypts_r)
    if tc.ot_solver == "exact":
        ot = pocket_ot_loss_exact(cost, pocket_mask)
    else:
        ot = pocket_ot_loss(cost, pocket_mask, epsilon=tc.sinkhorn_epsilon,
                            iters=tc.sinkhorn_iters)
    if C > 1:
        intersection = body_intersection_loss_packed(
            lig_pred, lig_oh, batch.rec.x, rec_oh, tc.intersection_sigma,
            tc.intersection_surface_ct).reshape(-1)
    else:
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
