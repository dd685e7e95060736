"""Fused soft-min distance field for the body-intersection loss: the port of
`equidock_public_tpu/ops/pallas/softmin_field.py` (`softmin_field_sums`
with its custom VJP, `body_intersection_loss_fused`).

For every query point x_m the Gaussian mass of the other protein,
    S_m = sum_n a_mask_n exp(-|x_m - a_n|^2 / sigma),
without the (B, M, N) distance tensor in device memory on the card: CUDA
tensors go through the kernels of `csrc/softmin_field.cu`, CPU tensors
through the plain versions below. `G = -sigma log(1e-3 + S)` and the relu
and mean reductions stay in PyTorch.
"""

from __future__ import annotations

import torch

from .cuda import softmin_field as kernels


def softmin_field_sums_plain(x: torch.Tensor, a: torch.Tensor, a_mask: torch.Tensor,
                             sigma: float) -> torch.Tensor:
    """S (B, M) through the (B, M, N) distance tensor."""
    d2 = ((x[:, :, None, :] - a[:, None, :, :]) ** 2).sum(dim=-1)
    return (torch.exp(-d2 / float(sigma)) * a_mask[:, None, :]).sum(dim=-1)


def softmin_field_bwd_plain(x, a, a_mask, c, sigma: float):
    """(dx, dA) for the cotangent c (B, M) of S, the JAX custom VJP's
    formulas: with w_mn = a_mask_n exp(-|x_m - a_n|^2 / sigma),
    dx = (-2/sigma) c (S x - w a) and dA = (2/sigma) ((c w)^T x - (c w)^T 1 a)."""
    d2 = ((x[:, :, None, :] - a[:, None, :, :]) ** 2).sum(dim=-1)
    w = torch.exp(-d2 / float(sigma)) * a_mask[:, None, :]          # (B, M, N)
    s = w.sum(dim=-1, keepdim=True)
    dx = (-2.0 / sigma) * c[..., None] * (s * x - torch.matmul(w, a))
    cw = w * c[..., None]
    da = (2.0 / sigma) * (torch.matmul(cw.transpose(1, 2), x) - cw.sum(dim=1)[..., None] * a)
    return dx, da


class SoftminFieldSums(torch.autograd.Function):
    """S with the kernels on CUDA tensors and the plain formulas on CPU
    tensors, both ways; no gradient for a_mask or sigma. Any other device
    raises: on the card it never gives way to the plain version."""

    @staticmethod
    def forward(ctx, x, a, a_mask, sigma):
        ctx.save_for_backward(x, a, a_mask)
        ctx.sigma = float(sigma)
        if x.device.type == "cpu":
            return softmin_field_sums_plain(x, a, a_mask, sigma)
        return kernels.softmin_field_fwd(x.contiguous(), a.contiguous(), a_mask.contiguous(),
                                         sigma)

    @staticmethod
    def backward(ctx, g):
        x, a, a_mask = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, da = softmin_field_bwd_plain(x, a, a_mask, g, ctx.sigma)
        else:
            dx, da = kernels.softmin_field_bwd(x.contiguous(), a.contiguous(),
                                               a_mask.contiguous(), g.contiguous(), ctx.sigma)
        return dx, da, None, None


def softmin_field_sums(x, a, a_mask, sigma: float) -> torch.Tensor:
    """S (B, M) = sum_n a_mask_n exp(-|x_m - a_n|^2 / sigma), differentiable
    in x and a."""
    return SoftminFieldSums.apply(x, a, a_mask, float(sigma))


def body_intersection_loss_fused(lig, lig_mask, rec, rec_mask, sigma: float,
                                 surface_ct: float) -> torch.Tensor:
    """(B,) per-complex intersection loss, the same function as
    `ops/intersection.py::body_intersection_loss` through the soft-min field
    sums: mean_j relu(ct - G_rec(lig_j)) + mean_i relu(ct - G_lig(rec_i))."""
    def one_direction(queries, q_mask, prot, p_mask):
        s = softmin_field_sums(queries, prot, p_mask, sigma)
        g = -sigma * torch.log(1e-3 + s)
        pen = torch.clamp(surface_ct - g, min=0.0)
        return (pen * q_mask).sum(dim=1) / torch.clamp(q_mask.sum(dim=1), min=1.0)

    return (one_direction(lig, lig_mask, rec, rec_mask)
            + one_direction(rec, rec_mask, lig, lig_mask))
