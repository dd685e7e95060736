"""Training steps across ranks: the port of
`equidock_public_tpu/parallel/train.py::make_parallel_train_step`.

The JAX package's SPMD step runs `step_body` over the whole batch with the
batch sharded over 'data' and the parameters replicated; XLA inserts the
gradient psum. Here each of dp ranks holds B/dp rows of the batch and a
full copy of the state, and one step is:
  1. the count of valid complexes of the whole batch, an all_reduce over
     the data group, so each loss term is a rank's share of the global
     mean (`train/losses.py::total_loss(denom=...)`);
  2. the forward and backward of the rank's rows (the halo forward of its
     shard with gp > 1, `parallel/halo.py`);
  3. one all_reduce over every rank of the gradients and the loss terms,
     in one flat buffer, BEFORE clipping and Adam, so the clip sees the
     global norm (`train/step.py::apply_gradients`);
  4. the optimizer, the same on every rank, so every rank ends the step
     with the same bits.
With gp > 1 every rank of a graph group computes the same dense head and
loss on the gathered trunk output: the trunk's gradients are a rank's
shard's part and are summed, while the head's (`head_leaf`) and the loss
terms are whole on each rank and are taken from graph rank 0 alone. As in
the JAX package the step's metrics leave out ligand_coords. BatchNorm's
statistics are the whole batch's (its sums go over the ranks that hold
rows, so every rank ends with the same statistics), and each rank takes its
part of the whole batch's dropout masks.

A world of one (the stacked form) runs the one-process step.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from ..config import Config
from ..models.iegmn import docking_forward
from ..models.layers import DropoutCut
from ..train.losses import total_loss
from ..train.step import apply_gradients, loss_and_grads, train_step
from .dist import all_reduce_, all_reduce_sum
from .mesh import ParallelMesh

# The keypoint head's modules of a stage (`models/iegmn.py::keypoint_head`):
# computed densely on every rank of a graph group.
HEAD_MODULES = ("mlp_h_mean_rot", "att_key_rot", "att_query_rot")
LOSS_TERMS = ("loss", "ligand_coors_loss", "receptor_coors_loss", "ot_loss",
              "intersection_loss")


def head_leaf(key: str) -> bool:
    """Whether a flat parameter key ("original/att_key_rot/w") is the head's."""
    parts = key.split("/")
    return len(parts) > 1 and parts[1] in HEAD_MODULES


def global_count(mask: torch.Tensor, mesh: ParallelMesh) -> torch.Tensor:
    """The valid complexes of the whole batch, clamped at 1: a rank's count
    summed over its data group."""
    n = all_reduce_(mask.sum().to(torch.float32).reshape(1), mesh.data)
    return torch.clamp(n[0], min=1.0)


def reduce_over_ranks(grads: Dict[str, torch.Tensor], metrics: Dict[str, torch.Tensor],
                      mesh: ParallelMesh, halo: bool
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The gradients and loss terms summed over every rank in one
    all_reduce; with `halo`, the head's gradients and the loss terms of
    graph ranks other than 0 enter as zeros."""
    whole = not halo or mesh.p == 0
    parts = [g if whole or not head_leaf(k) else torch.zeros_like(g) for k, g in grads.items()]
    terms = [metrics[k] if whole else torch.zeros_like(metrics[k]) for k in LOSS_TERMS]
    flat = torch.cat([t.reshape(-1) for t in parts] + [t.reshape(1) for t in terms])
    dist.all_reduce(flat, group=mesh.world.group)
    out, at = {}, 0
    for k, g in grads.items():
        out[k] = flat[at:at + g.numel()].reshape(g.shape)
        at += g.numel()
    metrics = dict(metrics, **{k: flat[at + i] for i, k in enumerate(LOSS_TERMS)})
    return out, metrics


def ranked_step(state, batch, cfg: Config, lr_scale: float, mesh: ParallelMesh,
                loss_fn_: Callable, halo: bool, keep_coords: bool = False):
    """One step of this rank: its loss and gradients, the sums over the
    ranks, the optimizer, and the BatchNorm statistics of the forward (the
    whole batch's, the same bits on every rank). Returns (state, metrics;
    with `keep_coords` the ligand_coords of this rank's rows)."""
    grads, metrics, out = loss_and_grads(state.params, cfg, batch, loss_fn_)
    grads, metrics = reduce_over_ranks(grads, metrics, mesh, halo)
    state, gnorm = apply_gradients(state, grads, cfg, lr_scale, out.get("bn_updates"))
    metrics["grad_norm"] = gnorm
    metrics["clipped"] = (gnorm > cfg.train.clip).to(torch.float32)
    if keep_coords:
        metrics["ligand_coords"] = out["ligand_coords"]
    return state, metrics


def rank_dropout(drop, mesh: ParallelMesh):
    """This rank's part of the whole batch's dropout masks in a dp step: each
    mask drawn at the whole batch's shape (dp times the rank's rows) from
    the generator state every rank shares, or replayed, and cut to the
    rank's rows (`models/layers.py::DropoutCut`). `drop` itself in one
    process (the whole batch) and for no dropout."""
    if drop is None or drop.rate == 0.0 or not mesh.ranked:
        return drop
    return DropoutCut(drop, lambda shape, side: (mesh.dp * shape[0],) + shape[1:],
                      lambda m, side: m[mesh.local_slice(m.shape[0])])


def make_parallel_train_step(cfg: Config, mesh: ParallelMesh, keep_coords: bool = False):
    """Returns step(state, batch, lr_scale=1.0, drop=None) -> (state,
    metrics). Across ranks `batch` is this rank's B/dp rows of the global
    batch (`mesh.local_slice`, or `parallel/input_pipeline.py`); in one
    process (the stacked form) the whole batch and the one-process step.
    Node sharding (gp > 1) is the halo step, `parallel/halo.py::
    make_halo_train_step`. `keep_coords` keeps the rows' ligand_coords in
    the metrics (the dp-resident epoch meters them).

    BatchNorm's statistics are the whole batch's: a rank's partial sums go
    over the data group (`models/layers.py::batch_norm(reduce=)`). `drop`
    gives the masks of the step's rows: the caller's choice. `fit`'s mesh
    step passes `rank_dropout` of the epoch's `Dropout` (each rank takes its
    rows of the whole batch's masks, as the JAX package's mesh step draws
    them for the whole batch); the dp-resident epoch passes the `Dropout`
    itself, so every rank draws its own rows' shape from the same state
    (the JAX package's dp-resident scan)."""
    if mesh.gp != 1:
        raise ValueError(f"{mesh}: graph shards train through make_halo_train_step")

    def step(state, batch, lr_scale: float = 1.0, drop=None):
        if not mesh.ranked:
            state, metrics = train_step(state, batch, cfg, lr_scale, drop=drop)
            if not keep_coords:
                metrics.pop("ligand_coords", None)
            return state, metrics
        denom = global_count(batch.complex_mask, mesh)
        reduce = lambda v: all_reduce_sum(v, mesh.data)

        def loss_fn_(params, cfg_: Config, b):
            out = docking_forward(params, cfg_.model, b, train=True, drop=drop,
                                  bn_state=state.bn_state or None, bn_reduce=reduce)
            loss, metrics = total_loss(out, b, cfg_.train, denom=denom)
            return loss, (metrics, out)

        return ranked_step(state, batch, cfg, lr_scale, mesh, loss_fn_, halo=False,
                           keep_coords=keep_coords)

    return step


def params_digest(state, mesh: ParallelMesh) -> List[str]:
    """Every rank's sha256 of its parameters' and BatchNorm statistics'
    bytes (keys in sorted order), gathered over the host group in rank
    order: all equal when every rank holds the same bits."""
    from ..params import flatten

    h = hashlib.sha256()
    bn = {f"bn_state/{site}/{k}": v for site, st in state.bn_state.items()
          for k, v in st.items()}
    for k, v in sorted({**flatten(state.params), **bn}.items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    if not mesh.ranked:
        return [h.hexdigest()]
    out = [None] * mesh.world.size
    dist.all_gather_object(out, h.hexdigest(), group=mesh.world.cpu_group)
    return out
