"""Batched Kabsch/SVD rigid fit: the port of `equidock_public_tpu/ops/kabsch.py`.

The whole batch of 3x3 covariances goes through one batched SVD. Degenerate
matrices (a tiny singular value, or two nearly equal squared ones) get a
fixed asymmetric diagonal jitter and are decomposed again, with no
data-dependent control flow.
"""

from __future__ import annotations

from typing import Tuple

import torch

_JITTER = (0.31, 0.47, 0.59)


def _is_degenerate(S: torch.Tensor, tol_small: float,
                   tol_gap: float) -> torch.Tensor:
    """S (B, 3) -> (B,) bool: min singular value < tol_small, or two squared
    singular values within tol_gap of each other."""
    small = S.amin(dim=-1) < tol_small
    s2 = S ** 2
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    diff = (s2[:, :, None] - s2[:, None, :]).abs() + eye[None]
    close = diff.reshape(S.shape[0], -1).amin(dim=-1) < tol_gap
    return small | close


def kabsch_from_covariance(A: torch.Tensor, tol_small: float = 1e-3,
                           tol_gap: float = 1e-2) -> torch.Tensor:
    """A (B, 3, 3) covariance -> R (B, 3, 3) = U diag(1, 1, sign det A) Vt,
    at f32 (or f64 for f64 input)."""
    A = A.to(torch.promote_types(A.dtype, torch.float32))
    S_probe = torch.linalg.svdvals(A.detach())
    bad = _is_degenerate(S_probe, tol_small, tol_gap)
    jitter = torch.diag(torch.tensor(_JITTER, dtype=A.dtype, device=A.device))
    A_safe = A + bad[:, None, None].to(A.dtype) * jitter[None]
    U, _, Vt = torch.linalg.svd(A_safe, full_matrices=False)
    sign = torch.sign(torch.linalg.det(A_safe))
    corr = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign], dim=-1)
    return torch.einsum("bij,bj,bjk->bik", U, corr, Vt)


def rigid_fit(keypts_src: torch.Tensor,
              keypts_dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R (B, 3, 3), t (B, 1, 3)) mapping src keypoints (B, K, 3) onto dst:
    A = (Y_dst - mean)^T (Y_src - mean), t = mean_dst - R mean_src."""
    mean_src = keypts_src.mean(dim=1, keepdim=True)
    mean_dst = keypts_dst.mean(dim=1, keepdim=True)
    A = torch.einsum("bki,bkj->bij", keypts_dst - mean_dst, keypts_src - mean_src)
    R = kabsch_from_covariance(A)
    t = mean_dst - torch.einsum("bij,bkj->bki", R, mean_src)
    return R, t


def apply_rigid(x: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x (B, N, 3), R (B, 3, 3), t (B, 1, 3) -> R x + t."""
    return torch.einsum("bij,bnj->bni", R, x) + t


def apply_rigid_packed(x: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                       seg_id: torch.Tensor, n_segs: int) -> torch.Tensor:
    """Packed slots: node n of slot b moved by its own complex's (R, t).
    x (B, N, 3), R (B, C, 3, 3), t (B, C, 1, 3), seg_id (B, N) -> (B, N, 3),
    through the segment one-hot as in the JAX package."""
    oh = (seg_id[..., None] == torch.arange(n_segs, device=seg_id.device,
                                            dtype=seg_id.dtype)).to(x.dtype)
    Rx = torch.einsum("bcij,bnj->bnci", R, x)
    return torch.einsum("bnci,bnc->bni", Rx, oh) + torch.einsum("bckj,bnc->bnj", t, oh)
