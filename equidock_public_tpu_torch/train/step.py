"""One training step and one evaluation step: the port of `TrainState`,
`create_train_state`, `loss_fn`, `step_body` / `train_step` and
`eval_step` of `equidock_public_tpu/train/step.py` for unpacked batches.

A step runs the forward (both forward kernels on CUDA tensors), the loss
(coordinate MSE + Sinkhorn pocket OT + body intersection, the last through
the soft-min field kernels with `use_fused_intersection`), the backward
through torch autograd and the backward kernels, then the optimizer of
`optim.py`. It raises if any parameter gets no gradient: on the card a
backward that stopped at a kernel would otherwise leave parameters
silently untrained. The state is pure data and each step returns a new
one, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..config import Config
from ..device import resolve_device
from ..graph import PairBatch
from ..models.iegmn import check_supported, docking_forward
from ..params import flatten, unflatten
from .losses import total_loss
from .optim import adam_update

Tensors = Dict[str, torch.Tensor]
# (params, cfg, batch) -> (loss, (metrics, forward outputs))
LossFn = Callable[..., Tuple[torch.Tensor, Tuple[Tensors, Tensors]]]


@dataclasses.dataclass
class TrainState:
    params: Dict[str, object]   # nested dicts of f32 tensors, the JAX package's keys
    mu: Tensors                 # Adam first moments, by flat key ("original/layer0/...")
    nu: Tensors                 # Adam second moments
    step: int = 0               # optimizer steps taken


def check_train_supported(cfg: Config) -> None:
    """Raise NotImplementedError naming every option outside what the
    port's training step computes."""
    check_supported(cfg.model, training=True)
    problems = []
    tc = cfg.train
    if tc.ot_solver != "sinkhorn":
        problems.append(f"ot_solver={tc.ot_solver!r} (a host LP)")
    if tc.freeze_original:
        problems.append("freeze_original (fine-tuning)")
    if cfg.data.pack:
        problems.append("pack (packed batches)")
    if problems:
        raise NotImplementedError("training option not ported: " + ", ".join(problems))


def create_train_state(params, cfg: Config,
                       device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """Fresh optimizer state for `params`, on the card unless `device` says
    otherwise."""
    check_train_supported(cfg)
    dev = resolve_device(device)
    flat = {k: v.detach().to(dev) for k, v in flatten(params).items()}
    return TrainState(params=unflatten(flat),
                      mu={k: torch.zeros_like(v) for k, v in flat.items()},
                      nu={k: torch.zeros_like(v) for k, v in flat.items()})


def loss_fn(params, cfg: Config, batch: PairBatch):
    """(loss, (metrics, forward outputs))."""
    out = docking_forward(params, cfg.model, batch)
    loss, metrics = total_loss(out, batch, cfg.train)
    return loss, (metrics, out)


def loss_and_grads(params, cfg: Config, batch: PairBatch, loss_fn_: Optional[LossFn] = None
                   ) -> Tuple[Tensors, Tensors, Dict[str, torch.Tensor]]:
    """(gradients by flat key, detached metrics, forward outputs) of the
    training loss at `params`. Raises if a parameter gets no gradient.
    `loss_fn_` swaps the loss (the halo path's forward) for `loss_fn`."""
    flat = flatten(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    with torch.enable_grad():
        loss, (metrics, out) = (loss_fn_ or loss_fn)(unflatten(leaves), cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    missing = [k for k, g in zip(leaves, grads) if g is None]
    if missing:
        raise RuntimeError(f"no gradient reached {missing}: the backward stopped "
                           "before these parameters")
    return (dict(zip(leaves, grads)), {k: v.detach() for k, v in metrics.items()},
            {k: v.detach() for k, v in out.items()})


def apply_gradients(state: TrainState, grads: Tensors, cfg: Config,
                    lr_scale: float = 1.0) -> Tuple[TrainState, torch.Tensor]:
    """(new state, global gradient norm before clipping)."""
    new_p, mu, nu, gnorm = adam_update(flatten(state.params), grads, state.mu, state.nu,
                                       state.step, cfg.train, lr_scale)
    return TrainState(unflatten(new_p), mu, nu, state.step + 1), gnorm


def train_step(state: TrainState, batch, cfg: Config, lr_scale: float = 1.0,
               loss_fn_: Optional[LossFn] = None) -> Tuple[TrainState, Tensors]:
    """One optimizer step. Returns the new state and the metrics of
    `step_body`: loss, ligand_coors_loss, receptor_coors_loss, ot_loss,
    intersection_loss, grad_norm, clipped and ligand_coords. `loss_fn_`
    swaps the forward and loss (`parallel/halo.py` passes its HaloBatch
    loss) and keeps the optimizer and the metrics; the batch's device is
    then that loss's to check."""
    check_train_supported(cfg)
    if loss_fn_ is None:
        dev = next(iter(flatten(state.params).values())).device
        if batch.lig.x.device != dev:
            raise ValueError(f"batch on {batch.lig.x.device}, train state on {dev}")
    grads, metrics, out = loss_and_grads(state.params, cfg, batch, loss_fn_)
    state, gnorm = apply_gradients(state, grads, cfg, lr_scale)
    metrics["grad_norm"] = gnorm
    metrics["clipped"] = (gnorm > cfg.train.clip).to(torch.float32)
    metrics["ligand_coords"] = out["ligand_coords"]
    return state, metrics


@torch.no_grad()
def eval_step(params, batch: PairBatch, cfg: Config) -> Tensors:
    """The loss terms and ligand_coords of a forward, without a gradient."""
    out = docking_forward(params, cfg.model, batch)
    _, metrics = total_loss(out, batch, cfg.train)
    metrics = dict(metrics)
    metrics["ligand_coords"] = out["ligand_coords"]
    return metrics
