"""Soft body-intersection penalty, batched and mask-aware: the port of
`equidock_public_tpu/ops/intersection.py`, plain PyTorch, unpacked and
packed (per packed complex, same-complex pairs only).

    G(x) = -sigma * log(1e-3 + sum_i exp(-||x - a_i||^2 / sigma))
    IL   = mean_j relu(ct - G_rec(lig_j)) + mean_i relu(ct - G_lig(rec_i))

Masked points contribute exp(...) * 0 = 0, matching the unpadded sum.
"""

from __future__ import annotations

import torch


def g_fn(protein: torch.Tensor, protein_mask: torch.Tensor, x: torch.Tensor,
         sigma: float) -> torch.Tensor:
    """(B, M): soft-min distance field of `protein` (B, N, 3) with mask
    (B, N), evaluated at the points x (B, M, 3)."""
    d2 = ((x[:, :, None, :] - protein[:, None, :, :]) ** 2).sum(dim=-1)
    e = torch.exp(-d2 / float(sigma)) * protein_mask[:, None, :]
    return -sigma * torch.log(1e-3 + e.sum(dim=-1))


def body_intersection_loss(lig: torch.Tensor, lig_mask: torch.Tensor,
                           rec: torch.Tensor, rec_mask: torch.Tensor,
                           sigma: float, surface_ct: float) -> torch.Tensor:
    """(B,) per-complex intersection loss of predicted ligand coordinates
    (B, N_l, 3) against the receptor (B, N_r, 3)."""
    pen_l = torch.clamp(surface_ct - g_fn(rec, rec_mask, lig, sigma), min=0.0)
    pen_r = torch.clamp(surface_ct - g_fn(lig, lig_mask, rec, sigma), min=0.0)
    mean_l = (pen_l * lig_mask).sum(dim=1) / torch.clamp(lig_mask.sum(dim=1), min=1.0)
    mean_r = (pen_r * rec_mask).sum(dim=1) / torch.clamp(rec_mask.sum(dim=1), min=1.0)
    return mean_l + mean_r


def _g_fn_seg(protein: torch.Tensor, protein_oh: torch.Tensor, x: torch.Tensor,
              sigma: float) -> torch.Tensor:
    """(B, M, C): for each packed complex c, the soft-min field of
    `protein`'s complex-c points (one-hot `protein_oh` (B, N, C)) at every x."""
    d2 = ((x[:, :, None, :] - protein[:, None, :, :]) ** 2).sum(dim=-1)
    s = torch.einsum("bmn,bnc->bmc", torch.exp(-d2 / float(sigma)), protein_oh)
    return -sigma * torch.log(1e-3 + s)


def body_intersection_loss_packed(lig: torch.Tensor, lig_oh: torch.Tensor,
                                  rec: torch.Tensor, rec_oh: torch.Tensor,
                                  sigma: float, surface_ct: float) -> torch.Tensor:
    """(B, C) per packed complex: `body_intersection_loss` with the field and
    the means restricted to each complex's own points (one-hots (B, N, C)
    that are zero on padded nodes)."""
    pen_l = torch.clamp(surface_ct - _g_fn_seg(rec, rec_oh, lig, sigma), min=0.0)
    pen_r = torch.clamp(surface_ct - _g_fn_seg(lig, lig_oh, rec, sigma), min=0.0)
    mean_l = (torch.einsum("blc,blc->bc", pen_l, lig_oh)
              / torch.clamp(lig_oh.sum(dim=1), min=1.0))
    mean_r = (torch.einsum("brc,brc->bc", pen_r, rec_oh)
              / torch.clamp(rec_oh.sum(dim=1), min=1.0))
    return mean_l + mean_r
