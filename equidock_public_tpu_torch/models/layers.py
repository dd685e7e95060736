"""Functional NN primitives on explicit parameter dicts: the port of
`equidock_public_tpu/models/layers.py`. A parameter dict uses the JAX
package's key names: linear {"w" (in, out), "b"}, layer norm and batch norm
{"g", "b"}, embedding {"e"}.

BatchNorm is functional, as in the JAX package: `batch_norm` returns the
output and the new running statistics, and `BNContext` chains them across
the sites of a forward; no buffer is updated in place, so a recomputed
forward cannot apply the momentum twice. Dropout draws its masks from an
explicit `torch.Generator`, or replays recorded masks in call order
(`Dropout`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, object]


# The compute dtypes a config may name (`ModelConfig.dtype`): the operands
# of `linear` are rounded to the dtype, the product and its sum are f32.
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def linear(p: Params, x: torch.Tensor, compute_dtype: Optional[str] = None) -> torch.Tensor:
    """Affine map x @ w (+ b), returned in f32. With compute_dtype
    'bfloat16' both operands are rounded to bf16 and multiplied in f32, as
    the JAX package's `linear` (bf16 operands, `preferred_element_type=f32`).
    The operands go to bf16 and back rather than into a bf16 matmul, whose
    output torch rounds to bf16 where JAX keeps f32; with TF32 off the
    product of two bf16 values is exact in f32, so only the order of the
    sum differs. Autograd rounds the operands' cotangents to bf16 on the way
    back (the cast's backward), as JAX's transposed bf16 products do. The
    parameters stay f32."""
    w = p["w"]
    low = COMPUTE_DTYPES[compute_dtype or "float32"]
    if low is not None:
        x, w = x.to(low).float(), w.to(low).float()
    y = torch.matmul(x, w)
    if "b" in p:
        y = y + p["b"]
    return y


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def init_bn_state(dim: int, device="cpu") -> Params:
    """Running statistics of one BatchNorm1d site (torch's defaults: mean 0,
    variance 1)."""
    return {"mean": torch.zeros(dim, dtype=torch.float32, device=device),
            "var": torch.ones(dim, dtype=torch.float32, device=device)}


def batch_norm(p: Params, st: Params, x: torch.Tensor, mask: Optional[torch.Tensor],
               train: bool, momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm1d over every valid row of x (..., D): (out, new statistics).
    `mask` (broadcastable to x[..., :1]) keeps padded rows out of the
    statistics. Training normalises by the biased batch variance and folds
    the unbiased one into the running variance with `momentum`; evaluation
    normalises by the running statistics, which it returns unchanged."""
    affine = lambda y: y * p["g"] + p["b"]
    if not train:
        return affine((x - st["mean"]) * torch.rsqrt(st["var"] + eps)), st
    axes = tuple(range(x.ndim - 1))
    if mask is None:
        mean = x.mean(dim=axes)
        var = ((x - mean) ** 2).mean(dim=axes)
        n = torch.tensor(float(x.numel() // x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        w = mask.expand(x.shape[:-1] + (1,))
        n = torch.clamp(w.sum(), min=1.0)
        mean = (x * w).sum(dim=axes) / n
        var = (((x - mean) ** 2) * w).sum(dim=axes) / n
    out = affine((x - mean) * torch.rsqrt(var + eps))
    unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
    new = {"mean": ((1.0 - momentum) * st["mean"] + momentum * mean).detach(),
           "var": ((1.0 - momentum) * st["var"] + momentum * unbiased).detach()}
    return out, new


class BNContext:
    """The running statistics of a forward's BatchNorm sites. Each site reads
    its current statistics (the update of an earlier application of the
    same site where there was one: a shared layer applies its sites several
    times a forward) and, in training, records its update in `updates`,
    which the train step returns as the new state."""

    def __init__(self, state: Dict[str, Params], train: bool):
        self.state = state
        self.train = train
        self.updates: Dict[str, Params] = {}

    def __call__(self, name: str, p: Params, x: torch.Tensor, mask) -> torch.Tensor:
        out, new = batch_norm(p, self.updates.get(name, self.state[name]), x, mask,
                              self.train)
        if self.train:
            self.updates[name] = new
        return out


class Dropout:
    """The dropout masks of a training forward: Bernoulli(1 - rate) draws
    from `generator` (on the tensors' device), or, with `masks`, recorded
    keep-masks replayed in call order (a mask source: the tests replay the
    JAX package's draws through it). `rate` 0 never draws."""

    def __init__(self, rate: float, generator: Optional[torch.Generator] = None,
                 masks: Optional[List] = None):
        if rate > 0 and generator is None and masks is None:
            raise ValueError("dropout > 0 needs a generator or a mask source")
        self.rate, self.generator = float(rate), generator
        self.masks = None if masks is None else list(masks)
        self.drawn = 0

    def mask(self, shape, device) -> torch.Tensor:
        if self.masks is not None:
            if self.drawn >= len(self.masks):
                raise RuntimeError(f"mask source exhausted after {self.drawn} masks")
            m = self.masks[self.drawn]
            m = (m if isinstance(m, torch.Tensor) else torch.from_numpy(np.array(m))
                 ).to(device=device, dtype=torch.bool)
            if tuple(m.shape) != tuple(shape):
                raise ValueError(f"recorded mask {self.drawn} has shape {tuple(m.shape)}, "
                                 f"the forward asks for {tuple(shape)}")
        else:
            m = torch.rand(shape, generator=self.generator, device=device) < 1.0 - self.rate
        self.drawn += 1
        return m


class ReplayLayer:
    """The masks of one recomputed layer (remat): the first pass draws from
    `drop` and keeps each mask; `rewind` starts the next pass, which
    replays them in order, so the recompute sees the forward's masks (a
    checkpoint restores only the default generator's state)."""

    def __init__(self, drop: Dropout):
        self.rate, self.drop = drop.rate, drop
        self.kept: List[torch.Tensor] = []
        self.pos = 0

    def rewind(self) -> None:
        self.pos = 0

    def mask(self, shape, device) -> torch.Tensor:
        if self.pos < len(self.kept):
            m = self.kept[self.pos]
        else:
            m = self.drop.mask(shape, device)
            self.kept.append(m)
        self.pos += 1
        return m


def dropout(x: torch.Tensor, drop) -> torch.Tensor:
    """x with a `Dropout`'s (or `ReplayLayer`'s) next mask applied: kept
    entries scaled by 1 / (1 - rate). Identity for `drop` None (evaluation)
    or rate 0."""
    if drop is None or drop.rate == 0.0:
        return x
    keep = 1.0 - drop.rate
    return torch.where(drop.mask(x.shape, x.device), x / keep, torch.zeros_like(x))


def embedding(p: Params, idx: torch.Tensor) -> torch.Tensor:
    return p["e"][idx]


def nonlin(x: torch.Tensor, kind: str, neg_slope: float) -> torch.Tensor:
    if kind == "swish":
        return F.silu(x)
    if kind != "lkyrelu":
        raise ValueError(f"unknown nonlinearity {kind!r}")
    return F.leaky_relu(x, negative_slope=neg_slope)


def graph_norm(p: Params, x: torch.Tensor, node_mask: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Per-graph feature normalization over the valid nodes (GraphNorm):
    (x - mean) / (std + eps) with the sample std (ddof=1). x (B, N, D)."""
    w = node_mask[..., None]
    n = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    mean = (x * w).sum(dim=1, keepdim=True) / n
    var = (((x - mean) ** 2) * w).sum(dim=1, keepdim=True) / torch.clamp(n - 1.0, min=1.0)
    out = (x - mean) / (torch.sqrt(var) + eps)
    return out * p["g"] + p["b"]
