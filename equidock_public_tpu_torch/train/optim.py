"""The optimizer of `equidock_public_tpu/train/optim.py` as plain tensor ops.

`make_optimizer` there is the optax chain
    clip_by_global_norm(clip) -> add_decayed_weights(w_decay)
    -> scale_by_adam(0.9, 0.999, 1e-8) -> scale_by_learning_rate(schedule),
and the train step multiplies the update by the epoch factor `lr_scale`.
`adam_update` below runs the same steps in the same order: clipping scales
by clip / ||g|| only when ||g|| >= clip (optax's rule, no +1e-6 as in
`torch.nn.utils.clip_grad_norm_`), the L2 term is added to the gradient
before the moments (torch Adam's `weight_decay`, not decoupled AdamW), the
moments are bias-corrected, and the learning rate follows the schedule at
optax's step count. `cyclic_epoch_factor`, `ReduceOnPlateau` and
`epoch_lr_factor` are copies of the JAX package's host-side schedulers.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import TrainConfig

B1, B2, EPS = 0.9, 0.999, 1e-8


def warmup_lr(base_lr: float, warmup: float, step: int) -> float:
    """Cubic ramp lr * min(1, ((step + 1) / warmup)^3); constant at warmup 1."""
    return base_lr * min(1.0, ((step + 1.0) / warmup) ** 3)


def learning_rate(tc: TrainConfig, step: int) -> float:
    """The schedule's learning rate at optimizer step `step` (0-based)."""
    if tc.scheduler == "cyclic":
        return tc.lr          # the triangular epoch factor arrives via lr_scale
    return warmup_lr(tc.lr, tc.warmup, step)


def cyclic_epoch_factor(epoch: int, step_size_up: float) -> float:
    """Triangular factor in [1, 10] with half-period `step_size_up` epochs."""
    s = max(step_size_up, 1.0)
    cycle = math.floor(1.0 + epoch / (2.0 * s))
    x = abs(epoch / s - 2.0 * cycle + 1.0)
    return 1.0 + 9.0 * max(0.0, 1.0 - x)


class ReduceOnPlateau:
    """Epoch-driven ReduceLROnPlateau (mode=min, rel threshold).
    `step(val_loss)` returns the cumulative LR factor for the next epoch."""

    def __init__(self, factor: float = 0.5, patience: int = 100,
                 threshold: float = 1e-4, min_scale: float = 0.0):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_scale = min_scale
        self.best = float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def step(self, value: float) -> float:
        if value < self.best * (1.0 - self.threshold):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.num_bad = 0
        return self.scale


def epoch_lr_factor(tc: TrainConfig, epoch: int, plateau: "ReduceOnPlateau | None") -> float:
    """The LR factor the loop passes to the train step for this epoch."""
    if tc.scheduler == "cyclic":
        return cyclic_epoch_factor(epoch, tc.warmup)
    if tc.scheduler == "ROP" and plateau is not None:
        return plateau.scale
    return 1.0


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (optax.global_norm)."""
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


def adam_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor], step: int,
                tc: TrainConfig, lr_scale: float = 1.0
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor],
                           Dict[str, torch.Tensor], torch.Tensor]:
    """One optimizer step on flat {key: tensor} dicts; `step` counts the
    steps taken before this one. Returns (new params, new mu, new nu,
    global gradient norm before clipping). Pure: nothing is updated in place."""
    gnorm = global_norm(grads)
    keep = gnorm < tc.clip                     # optax: g, else g / ||g|| * clip
    count = np.int32(step + 1)
    bc1 = float(np.float32(1.0) - np.float32(B1) ** count)   # bias corrections, in f32
    bc2 = float(np.float32(1.0) - np.float32(B2) ** count)
    lr = learning_rate(tc, step)
    new_p, new_mu, new_nu = {}, {}, {}
    for key, p in params.items():
        g = torch.where(keep, grads[key], grads[key] / gnorm * tc.clip)
        g = g + tc.w_decay * p
        m = (1.0 - B1) * g + B1 * mu[key]
        v = (1.0 - B2) * (g * g) + B2 * nu[key]
        upd = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        new_p[key] = p + (-lr * upd) * lr_scale
        new_mu[key], new_nu[key] = m, v
    return new_p, new_mu, new_nu, gnorm
