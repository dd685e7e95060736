"""One training step and one evaluation step: the port of `TrainState`,
`create_train_state`, `loss_fn`, `step_body` / `train_step` and
`eval_step` of `equidock_public_tpu/train/step.py`.

A step runs the forward (the kernels on CUDA tensors, `models/iegmn.py`
says which), the loss (coordinate MSE + pocket OT, Sinkhorn or the exact
host LP, + body intersection, the last through the soft-min field kernels
with `use_fused_intersection` on unpacked batches), the backward through
torch autograd and the backward kernels, then the optimizer of `optim.py`.
It raises if any parameter gets no gradient: on the card a backward that
stopped at a kernel would otherwise leave parameters silently untrained.
The state is pure data and each step returns a new one, as in the JAX
package: parameters, Adam moments, the step count and the BatchNorm
running statistics (`bn_state`, empty unless an option is 'BN'). Dropout
above 0 draws its masks from the `Dropout` passed as `drop` (a generator,
or recorded masks). With `freeze_original` (two-stage fine-tuning) the
original stage's gradients are zeroed before the optimizer and its updates
after it, as in the JAX package (so weight decay still reaches its Adam
moments, but never its weights).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..config import Config
from ..device import resolve_device
from ..graph import PairBatch
from ..models.iegmn import check_supported, docking_forward, init_bn_state, uses_batch_norm
from ..models.layers import Dropout
from ..params import flatten, unflatten
from .losses import total_loss
from .optim import adam_update, global_norm

Tensors = Dict[str, torch.Tensor]
# (params, cfg, batch) -> (loss, (metrics, forward outputs))
LossFn = Callable[..., Tuple[torch.Tensor, Tuple[Tensors, Tensors]]]


@dataclasses.dataclass
class TrainState:
    params: Dict[str, object]   # nested dicts of f32 tensors, the JAX package's keys
    mu: Tensors                 # Adam first moments, by flat key ("original/layer0/...")
    nu: Tensors                 # Adam second moments
    step: int = 0               # optimizer steps taken
    # BatchNorm running statistics by site ("original/layer0/edge_mlp":
    # {"mean", "var"}); empty unless an option is 'BN'
    bn_state: Dict[str, Tensors] = dataclasses.field(default_factory=dict)


def create_train_state(params, cfg: Config,
                       device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """Fresh optimizer state for `params`, on the card unless `device` says
    otherwise."""
    check_supported(cfg.model)
    dev = resolve_device(device)
    flat = {k: v.detach().to(dev) for k, v in flatten(params).items()}
    return TrainState(params=unflatten(flat),
                      mu={k: torch.zeros_like(v) for k, v in flat.items()},
                      nu={k: torch.zeros_like(v) for k, v in flat.items()},
                      bn_state=(init_bn_state(cfg.model, device=dev)
                                if uses_batch_norm(cfg.model) else {}))


def make_dropout(cfg: Config, device, epoch: int = 0) -> Optional[Dropout]:
    """The dropout masks of an epoch's training steps: a generator on
    `device` seeded from `random_seed` and `epoch`; None for dropout 0."""
    if cfg.model.dropout == 0.0:
        return None
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.random_seed * 1_000_003 + epoch)
    return Dropout(cfg.model.dropout, gen)


def loss_fn(params, cfg: Config, batch: PairBatch, train: bool = True, drop=None,
            bn_state: Optional[dict] = None):
    """(loss, (metrics, forward outputs)); a training forward's outputs carry
    "bn_updates" when `bn_state` is given."""
    out = docking_forward(params, cfg.model, batch, train=train, drop=drop,
                          bn_state=bn_state or None)
    loss, metrics = total_loss(out, batch, cfg.train)
    return loss, (metrics, out)


def _detach(v):
    return {k: _detach(x) for k, x in v.items()} if isinstance(v, dict) else v.detach()


def loss_and_grads(params, cfg: Config, batch: PairBatch, loss_fn_: Optional[LossFn] = None,
                   drop=None, bn_state: Optional[dict] = None
                   ) -> Tuple[Tensors, Tensors, Dict[str, torch.Tensor]]:
    """(gradients by flat key, detached metrics, forward outputs) of the
    training loss at `params`. Raises if a parameter gets no gradient.
    `loss_fn_` swaps the loss (the halo path's forward) for `loss_fn`;
    `drop` and `bn_state` go to the training forward."""
    flat = flatten(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    with torch.enable_grad():
        if loss_fn_ is not None:
            loss, (metrics, out) = loss_fn_(unflatten(leaves), cfg, batch)
        else:
            loss, (metrics, out) = loss_fn(unflatten(leaves), cfg, batch, True, drop, bn_state)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    missing = [k for k, g in zip(leaves, grads) if g is None]
    if missing:
        raise RuntimeError(f"no gradient reached {missing}: the backward stopped "
                           "before these parameters")
    return dict(zip(leaves, grads)), _detach(metrics), _detach(out)


def _frozen(key: str, cfg: Config, params) -> bool:
    return (cfg.train.freeze_original and "finetune" in params
            and key.startswith("original/"))


def apply_gradients(state: TrainState, grads: Tensors, cfg: Config,
                    lr_scale: float = 1.0, bn_state: Optional[dict] = None
                    ) -> Tuple[TrainState, torch.Tensor]:
    """(new state, global gradient norm before clipping and before any
    freezing). With `freeze_original` the original stage's gradients go to
    the optimizer as zeros and its parameters keep their values. `bn_state`
    replaces the state's running statistics (a training forward's
    "bn_updates")."""
    params = flatten(state.params)
    frozen = [k for k in grads if _frozen(k, cfg, state.params)]
    if frozen:
        gnorm = global_norm(grads)
        grads = dict(grads, **{k: torch.zeros_like(grads[k]) for k in frozen})
    new_p, mu, nu, inner = adam_update(params, grads, state.mu, state.nu, state.step,
                                       cfg.train, lr_scale)
    if not frozen:
        gnorm = inner
    for k in frozen:
        new_p[k] = params[k]
    return TrainState(unflatten(new_p), mu, nu, state.step + 1,
                      state.bn_state if bn_state is None else bn_state), gnorm


def train_step(state: TrainState, batch, cfg: Config, lr_scale: float = 1.0,
               loss_fn_: Optional[LossFn] = None, drop=None) -> Tuple[TrainState, Tensors]:
    """One optimizer step. Returns the new state and the metrics of
    `step_body`: loss, ligand_coors_loss, receptor_coors_loss, ot_loss,
    intersection_loss, grad_norm, clipped and ligand_coords. `drop`
    (`models.layers.Dropout`) gives the dropout masks (required for dropout
    above 0). `loss_fn_` swaps the forward and loss (`parallel/halo.py`
    passes its HaloBatch loss) and keeps the optimizer and the metrics; the
    batch's device is then that loss's to check."""
    check_supported(cfg.model)
    if loss_fn_ is None:
        dev = next(iter(flatten(state.params).values())).device
        if batch.lig.x.device != dev:
            raise ValueError(f"batch on {batch.lig.x.device}, train state on {dev}")
    grads, metrics, out = loss_and_grads(state.params, cfg, batch, loss_fn_, drop,
                                         state.bn_state)
    state, gnorm = apply_gradients(state, grads, cfg, lr_scale, out.get("bn_updates"))
    metrics["grad_norm"] = gnorm
    metrics["clipped"] = (gnorm > cfg.train.clip).to(torch.float32)
    metrics["ligand_coords"] = out["ligand_coords"]
    return state, metrics


@torch.no_grad()
def eval_step(params, batch: PairBatch, cfg: Config, bn_state: Optional[dict] = None
              ) -> Tensors:
    """The loss terms and ligand_coords of a forward, without a gradient
    (BatchNorm from the running statistics `bn_state`)."""
    out = docking_forward(params, cfg.model, batch, bn_state=bn_state or None)
    _, metrics = total_loss(out, batch, cfg.train)
    metrics = dict(metrics)
    metrics["ligand_coords"] = out["ligand_coords"]
    return metrics
