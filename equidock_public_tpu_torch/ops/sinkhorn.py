"""Entropic optimal transport for the pocket OT loss: the port of
`sq_dist_mat`, `sinkhorn_log` and `pocket_ot_loss` of
`equidock_public_tpu/ops/sinkhorn.py`, plain PyTorch.

The reference detaches the transport plan, so gradients flow through the
cost only. The solver runs under `torch.no_grad()` on a detached cost, and
the plan is detached, as the JAX package's stop_gradient does. The
annealed epsilon `eps_start * decay**i` is computed in f32, as JAX does.
"""

from __future__ import annotations

import torch

_NEG = -1.0e9


def sq_dist_mat(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched squared-distance cost: x (B, N, 3), y (B, M, 3) -> (B, N, M)."""
    d = x[:, :, None, :] - y[:, None, :, :]
    return (d * d).sum(dim=-1)


@torch.no_grad()
def sinkhorn_log(cost: torch.Tensor, row_mask: torch.Tensor, epsilon: float = 0.01,
                 iters: int = 200, anneal_from_scale: float = 1.0) -> torch.Tensor:
    """Log-domain Sinkhorn with geometric epsilon annealing; the plan
    (B, N, M). Marginals a_i = row_mask_i / n_valid, b_j = 1 / M; padded rows
    get zero mass. The final epsilon is `epsilon * mean(cost)` over the
    valid rows, so the blur is scale-invariant."""
    cost = cost.detach()
    B, N, M = cost.shape
    dt, dev = cost.dtype, cost.device
    valid = row_mask > 0
    n_valid = torch.clamp(row_mask.sum(dim=1), min=1.0)                 # (B,)
    log_a = torch.where(valid, -torch.log(n_valid)[:, None].expand(B, N),
                        torch.full((B, N), _NEG, dtype=dt, device=dev))
    log_b = -torch.log(torch.full((), float(M), dtype=dt, device=dev))

    cost_safe = torch.where(valid[:, :, None], cost, torch.zeros((), dtype=dt, device=dev))
    scale = torch.clamp(cost_safe.mean(dim=(1, 2)) * (N * M) / (n_valid * M), min=1e-6)
    eps_final = epsilon * scale                                          # (B,)
    eps_start = anneal_from_scale * scale

    f = torch.zeros((B, N), dtype=dt, device=dev)
    g = torch.zeros((B, M), dtype=dt, device=dev)
    decay = torch.full((), (epsilon / anneal_from_scale) ** (1.0 / max(iters - 1, 1)),
                       dtype=dt, device=dev)
    steps = torch.arange(iters, dtype=dt, device=dev)
    eps_all = torch.maximum(eps_start[:, None] * decay ** steps, eps_final[:, None])
    neg = torch.full((), _NEG, dtype=dt, device=dev)
    for i in range(iters):
        eps = eps_all[:, i:i + 1]                                        # (B, 1)
        z = (g[:, None, :] - cost_safe) / eps[..., None]
        f = eps * log_a - eps * torch.logsumexp(z, dim=2)
        f = torch.where(valid, f, neg)
        z = (f[:, :, None] - cost_safe) / eps[..., None]
        g = eps * log_b - eps * torch.logsumexp(z, dim=1)

    log_plan = (f[:, :, None] + g[:, None, :] - cost_safe) / eps_final[:, None, None]
    plan = torch.exp(torch.clamp(log_plan, -60.0, 30.0))
    return torch.where(valid[:, :, None], plan, torch.zeros((), dtype=dt, device=dev))


def pocket_ot_loss(cost: torch.Tensor, pocket_mask: torch.Tensor, epsilon: float = 0.01,
                   iters: int = 200) -> torch.Tensor:
    """Per-complex OT distance (B,): <plan, cost> with the plan detached."""
    plan = sinkhorn_log(cost, pocket_mask, epsilon=epsilon, iters=iters)
    return (plan * cost).sum(dim=(1, 2))
