"""Entropic optimal transport for the pocket OT loss: the port of
`sq_dist_mat`, `sinkhorn_log`, `pocket_ot_loss`, `exact_emd_plan_host` and
`pocket_ot_loss_exact` of `equidock_public_tpu/ops/sinkhorn.py`: the
Sinkhorn solver in plain PyTorch, the exact one as scipy's HiGHS LP on the
host.

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


def exact_emd_plan_host(cost, row_mask):
    """Exact EMD transport plans on the host (numpy in, float32 numpy out):
    per complex the linear program of the reference's `ot.emd`, rows
    summing to 1 / n_valid and columns to 1 / K, through scipy's HiGHS.
    Padded rows carry no mass. The constraint matrix is dense, so pockets
    past P * K = 1e6 are refused."""
    import numpy as np
    from scipy.optimize import linprog

    cost = np.asarray(cost, np.float64)
    row_mask = np.asarray(row_mask)
    B, P, K = cost.shape
    assert P * K <= 1_000_000, (
        f"exact_emd_plan_host builds a dense ({P}+{K}-1, {P}*{K}) LP "
        f"(~{(P + K) * P * K * 8 / 1e9:.1f} GB); use the Sinkhorn solver for pockets this large")
    plans = np.zeros((B, P, K), np.float32)
    for b in range(B):
        valid = np.flatnonzero(row_mask[b] > 0)
        n = valid.size
        if n == 0:
            continue
        # marginals: rows 1 / n, columns 1 / K; one redundant constraint dropped
        A_eq = np.zeros((n + K - 1, n * K))
        b_eq = np.empty(n + K - 1)
        for i in range(n):
            A_eq[i, i * K:(i + 1) * K] = 1.0
            b_eq[i] = 1.0 / n
        for j in range(K - 1):
            A_eq[n + j, j::K] = 1.0
            b_eq[n + j] = 1.0 / K
        res = linprog(cost[b, valid].ravel(), A_eq=A_eq, b_eq=b_eq, bounds=(0, None),
                      method="highs")
        assert res.status == 0, f"exact EMD LP failed: {res.message}"
        plans[b, valid] = res.x.reshape(n, K).astype(np.float32)
    return plans


def pocket_ot_loss_exact(cost: torch.Tensor, pocket_mask: torch.Tensor) -> torch.Tensor:
    """Per-complex exact OT distance (B,): the plan solved on the host from
    the detached cost (one copy each way a call), the gradient through the
    cost only."""
    plan = exact_emd_plan_host(cost.detach().cpu().numpy(), pocket_mask.detach().cpu().numpy())
    plan = torch.from_numpy(plan).to(cost.device)
    return (plan * cost).sum(dim=(1, 2))
