"""Functional NN primitives on explicit parameter dicts: the port of
`equidock_public_tpu/models/layers.py`. A parameter dict uses the JAX
package's key names: linear {"w" (in, out), "b"}, layer norm and batch norm
{"g", "b"}, embedding {"e"}.

BatchNorm is functional, as in the JAX package: `batch_norm` returns the
output and the new running statistics, and `BNContext` chains them across
the sites of a forward; no buffer is updated in place, so a recomputed
forward cannot apply the momentum twice. Dropout draws its masks from an
explicit `torch.Generator`, or replays recorded masks in call order
(`Dropout`); a shard of a mesh step takes its part of the whole batch's
masks (`DropoutCut`). Every mask is asked for with its side (`LIG` or
`REC`), which a cut needs to place it in the whole batch.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, object]


# The compute dtypes a config may name (`ModelConfig.dtype`): the operands
# of `linear` are rounded to the dtype, the product and its sum are f32.
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
# the side of a dropout mask (`dropout`)
LIG, REC = 0, 1


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
               train: bool, momentum: float = 0.1, eps: float = 1e-5,
               reduce: Optional[Callable] = None):
    """BatchNorm1d over every valid row of x (..., D): (out, new statistics).
    `mask` (broadcastable to x[..., :1]) keeps padded rows out of the
    statistics. Training normalises by the biased batch variance and folds
    the unbiased one into the running variance with `momentum`; evaluation
    normalises by the running statistics, which it returns unchanged.

    With the rows spread over ranks (a mesh step), `reduce` sums a rank's
    partial sums over the group, so the statistics are the whole batch's,
    in the JAX package's two passes: the masked rows and their count, then
    the mean; the masked squared deviations from that mean, then the biased
    variance (a one-pass sum of squares parts from it at N mean^2 >> var).
    The unbiased running variance uses the group's count, and every rank
    ends with the same statistics, bit for bit."""
    affine = lambda y: y * p["g"] + p["b"]
    if not train:
        return affine((x - st["mean"]) * torch.rsqrt(st["var"] + eps)), st
    axes = tuple(range(x.ndim - 1))
    if mask is None and reduce is None:
        mean = x.mean(dim=axes)
        var = ((x - mean) ** 2).mean(dim=axes)
        n = torch.tensor(float(x.numel() // x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        w = (mask.expand(x.shape[:-1] + (1,)) if mask is not None
             else torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device))
        if reduce is None:
            n = torch.clamp(w.sum(), min=1.0)
            mean = (x * w).sum(dim=axes) / n
            var = (((x - mean) ** 2) * w).sum(dim=axes) / n
        else:
            first = reduce(torch.cat([(x * w).sum(dim=axes), w.sum().reshape(1)]))
            n = torch.clamp(first[-1], min=1.0)
            mean = first[:-1] / n
            var = reduce((((x - mean) ** 2) * w).sum(dim=axes)) / n
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
    which the train step returns as the new state. `reduce` sums each
    site's partial sums over the ranks that hold the batch's rows
    (`batch_norm`); None for a batch held whole."""

    def __init__(self, state: Dict[str, Params], train: bool,
                 reduce: Optional[Callable] = None):
        self.state = state
        self.train = train
        self.reduce = reduce
        self.updates: Dict[str, Params] = {}

    def __call__(self, name: str, p: Params, x: torch.Tensor, mask) -> torch.Tensor:
        out, new = batch_norm(p, self.updates.get(name, self.state[name]), x, mask,
                              self.train, reduce=self.reduce)
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

    def mask(self, shape, device, side: int) -> torch.Tensor:
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


class DropoutCut:
    """The masks of one shard of a mesh step, or of a batch whose parts draw
    alike: each mask is drawn from `drop` (its generator, whose state every
    rank shares, or its recorded masks) at `whole(shape, side)` and cut to
    the shard's part by `cut(mask, side)`. A shard that takes its part of
    the whole batch's masks computes the masks of the one-process step."""

    def __init__(self, drop, whole: Callable, cut: Callable):
        self.rate, self.drop, self.whole, self.cut = drop.rate, drop, whole, cut

    def mask(self, shape, device, side: int) -> torch.Tensor:
        m = self.cut(self.drop.mask(tuple(self.whole(tuple(shape), side)), device, side), side)
        if tuple(m.shape) != tuple(shape):
            raise ValueError(f"mask cut to {tuple(m.shape)}, the shard asks for {tuple(shape)}")
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

    def mask(self, shape, device, side: int) -> torch.Tensor:
        if self.pos < len(self.kept):
            m = self.kept[self.pos]
        else:
            m = self.drop.mask(shape, device, side)
            self.kept.append(m)
        self.pos += 1
        return m


def dropout(x: torch.Tensor, drop, side: int) -> torch.Tensor:
    """x with a `Dropout`'s (or `ReplayLayer`'s, or `DropoutCut`'s) next mask
    applied: kept entries scaled by 1 / (1 - rate). `side` is the protein x
    belongs to (`LIG` or `REC`). Identity for `drop` None (evaluation) or
    rate 0."""
    if drop is None or drop.rate == 0.0:
        return x
    keep = 1.0 - drop.rate
    return torch.where(drop.mask(x.shape, x.device, side), x / keep, torch.zeros_like(x))


def embedding(p: Params, idx: torch.Tensor) -> torch.Tensor:
    return p["e"][idx]


def nonlin(x: torch.Tensor, kind: str, neg_slope: float) -> torch.Tensor:
    if kind == "swish":
        return F.silu(x)
    if kind != "lkyrelu":
        raise ValueError(f"unknown nonlinearity {kind!r}")
    return F.leaky_relu(x, negative_slope=neg_slope)


def graph_norm(p: Params, x: torch.Tensor, node_mask: torch.Tensor,
               eps: float = 1e-5, reduce: Optional[Callable] = None) -> torch.Tensor:
    """Per-graph feature normalization over the valid nodes (GraphNorm):
    (x - mean) / (std + eps) with the sample std (ddof=1). x (B, N, D).
    With the node axis sharded (the halo path), `reduce` sums each per-shard
    statistic (B, 1, .) over the shards, so it covers the whole complex:
    JAX's `axis` (its psum over the graph mesh axis)."""
    w = node_mask[..., None]

    def _sum(v):
        s = v.sum(dim=1, keepdim=True)
        return reduce(s) if reduce is not None else s

    n = torch.clamp(_sum(w), min=1.0)
    mean = _sum(x * w) / n
    var = _sum(((x - mean) ** 2) * w) / torch.clamp(n - 1.0, min=1.0)
    out = (x - mean) / (torch.sqrt(var) + eps)
    return out * p["g"] + p["b"]
