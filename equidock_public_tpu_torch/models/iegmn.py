"""IEGMN docking model, forward: the port of
`equidock_public_tpu/models/iegmn.py` (`iegmn_layer_forward`, `iegmn_forward`,
`keypoint_head`, `docking_forward`, `init_bn_state`, `fused_edge_eligible`,
`kernel_path_report`), unpacked and packed; differentiable end to end (the
kernels' autograd Functions carry the gradient on CUDA tensors).

The cross-attention always goes through `ops/cuda/cross_attention.py`
(packed batches pass their segment ids as tags). The edge step goes
through `ops/cuda/edge_message.py` wherever the edge kernel covers the
config (`fused_edge_eligible`: LeakyReLU, layer_norm LN or none, no
coordinate norm, no dropout in training): the JAX computation with
`fused_edge_message` on. Other configs run the plain layer body of the JAX
package's XLA path (`_edge_messages`, `_coord_update`) on the same device,
and `kernel_path_report` says so. On CUDA tensors the wrappers launch the
hand-written kernels; on CPU tensors they run their plain versions. The
halo path (`parallel/halo.py`) runs this forward with its trunk on node
shards (`Shards`: each layer's exchange of source rows, the ring
attention, GraphNorm's sums, the gather before the head).

Training forwards take `train=True`, a `Dropout` (`models/layers.py`) for
dropout above 0, and a `BNContext` through `bn_state` for the 'BN' norm
options. With `cfg.remat` (and no 'BN' option) layers 1..n-1 are
recomputed in the backward (`torch.utils.checkpoint`); their dropout masks
are kept from the first pass (`ReplayLayer`), since a checkpoint restores
only the default generator's state.

With `cfg.dtype='bfloat16'` the linears that the JAX package runs at that
dtype round their operands to bf16 (`models/layers.py::linear`): both of
each MLP (node, and in the plain body edge and coordinate), q, k and v,
and the keypoint head's; the edge kernel's inputs, the fine-tune stage's
own linears and every kernel stay f32, as JAX's fused edge path and its
Pallas kernels do.

Parameters are nested dicts with the JAX package's keys (see `params.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..graph import PairBatch, ProteinBatch
from ..ops.attention import cross_attention
from ..ops.cuda.cross_attention import cross_attention_fused
from ..ops.cuda.edge_message import edge_message_aggregate, inverse_neighbors
from ..ops.kabsch import apply_rigid, apply_rigid_packed, rigid_fit
from ..ops.segment import gather_neighbors, masked_mean_over_k, masked_mean_over_nodes
from .layers import (COMPUTE_DTYPES, LIG, REC, BNContext, Params, ReplayLayer, dropout,
                     embedding, graph_norm, init_bn_state as _init_bn_site, layer_norm, linear,
                     nonlin)

RBF_SIGMAS = tuple(1.5 ** x for x in range(15))
# Sides run through the plain layer body (`_edge_messages`), counted so that
# a run can show which configs reached it; no kernel is counted here.
plain_body_calls = 0


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config outside what the port computes: a compute dtype
    other than float32 or bfloat16 (`models/layers.py::COMPUTE_DTYPES`), or
    parameters other than f32."""
    problems = []
    if cfg.dtype not in COMPUTE_DTYPES or cfg.param_dtype != "float32":
        problems.append(f"dtype={cfg.dtype!r}/{cfg.param_dtype!r}")
    if problems:
        raise NotImplementedError("config not covered by the port: " + ", ".join(problems))


def fused_edge_eligible(cfg: ModelConfig, train: bool, debug: bool = False) -> bool:
    """Whether the edge kernels (rows 1-2) cover this config: the JAX
    package's eligibility (LeakyReLU, layer_norm LN or none, no coordinate
    norm, no dropout in training, no debug trace) without its
    `fused_edge_message` flag, since the port always runs the kernel where
    it can."""
    return (not debug and cfg.nonlin == "lkyrelu" and (not train or cfg.dropout == 0.0)
            and cfg.layer_norm in ("LN", "0") and cfg.layer_norm_coors == "0")


def uses_batch_norm(cfg: ModelConfig) -> bool:
    return "BN" in (cfg.layer_norm, cfg.layer_norm_coors, cfg.final_h_layer_norm)


def remat_active(cfg: ModelConfig) -> bool:
    """Layers 1..n-1 are recomputed in the backward: `remat` without a 'BN'
    option (the JAX package checkpoints only its scan trunk, which BN's
    chained statistics turn off)."""
    return cfg.remat and not uses_batch_norm(cfg)


def kernel_path_report(cfg: ModelConfig, packed: bool = False) -> str:
    """One line naming the compute path of each layer part in a training
    step, so that a config outside the edge kernel is visible at startup."""
    if fused_edge_eligible(cfg, train=True):
        parts = ["edge-message: CUDA rows 1-2"]
    else:
        eval_note = (" (evaluation forwards run rows 1-2)"
                     if fused_edge_eligible(cfg, train=False) else "")
        parts = ["edge-message: plain PyTorch layer body in training" + eval_note
                 + " (rows 1-2 need lkyrelu, layer_norm in {LN,0}, -layer_norm_coors 0 "
                 "and dropout 0 in training)"]
    if cfg.cross_msgs:
        parts.append("cross-attention: CUDA rows 3-5" + (" (packed seg tags)" if packed else ""))
    else:
        parts.append("cross-attention: disabled (-cross_msgs 0)")
    if uses_batch_norm(cfg):
        parts.append("BatchNorm: running statistics chained through the layer loop"
                     + ("; remat off (a 'BN' option)" if cfg.remat else ""))
    elif cfg.remat:
        parts.append("remat: layers 1..n-1 recomputed in the backward")
    return "; ".join(parts)


def init_bn_state(cfg: ModelConfig, n_lays: Optional[int] = None, device="cpu") -> dict:
    """The running statistics of every BatchNorm site the config enables,
    keyed "<stage>/<layer>/<mlp>" as in the JAX package; empty when no
    option is 'BN'."""
    n_lays = n_lays if n_lays is not None else cfg.iegmn_n_lays
    in_dim, hid = cfg.input_node_feats_dim, cfg.iegmn_lay_hid_dim
    st: dict = {}
    stages = [("original/", n_lays)] + ([("finetune/", 2)] if cfg.fine_tune else [])
    for spfx, n in stages:
        layers = [("layer0/", in_dim)]
        if n > 1:
            layers += ([("rest/", hid)] if cfg.shared_layers
                       else [(f"rest{i}/", hid) for i in range(n - 1)])
        for lpfx, node_hid in layers:
            scope = spfx + lpfx
            if cfg.layer_norm == "BN":
                st[scope + "edge_mlp"] = _init_bn_site(hid, device)
                st[scope + "node_mlp"] = _init_bn_site(node_hid, device)
            if cfg.layer_norm_coors == "BN":
                st[scope + "coors_mlp"] = _init_bn_site(hid, device)
            if cfg.final_h_layer_norm == "BN":
                st[scope + "final_h"] = _init_bn_site(hid, device)
    return st


def _mlp2_tail(p: Params, pre: torch.Tensor, cfg: ModelConfig, ln_kind: str, drop, side: int,
               bn=None, bn_name: str = "", bn_mask=None) -> torch.Tensor:
    """Everything after lin1: dropout (the masks of `side`, `LIG` or `REC`)
    -> nonlin -> (LN | BN) -> lin2. `bn` (a BNContext) is required for
    'BN'; `bn_mask` keeps padded rows out of its statistics."""
    h = nonlin(dropout(pre, drop, side), cfg.nonlin, cfg.leakyrelu_neg_slope)
    if ln_kind == "LN":
        h = layer_norm(p["ln"], h)
    elif ln_kind == "BN":
        if bn is None:
            raise ValueError("a 'BN' norm option needs running statistics: pass bn_state "
                             "(models.iegmn.init_bn_state) into docking_forward")
        h = bn(bn_name, p["ln"], h, bn_mask)
    return linear(p["lin2"], h, cfg.dtype)


def _mlp2(p: Params, x: torch.Tensor, cfg: ModelConfig, ln_kind: str, drop, side: int,
          bn=None, bn_name: str = "", bn_mask=None) -> torch.Tensor:
    """Linear -> dropout -> nonlin -> (LN | BN) -> Linear, both linears at
    `cfg.dtype`."""
    return _mlp2_tail(p, linear(p["lin1"], x, cfg.dtype), cfg, ln_kind, drop, side, bn, bn_name,
                      bn_mask)


def edge_kernel_inputs(p: Params, x: torch.Tensor, h: torch.Tensor, he: torch.Tensor,
                       src: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(src, dst, kernel params) of the edge-message kernel for one side:
    the split first edge layer of the JAX fused path, `lin1(concat) =
    h_src W_a + h_dst W_b + he Wc + rbf Wd + b1`, with the two per-node
    products taken here. `src` (x_src, h_src) is the array the neighbour
    table indexes when it is not (x, h) itself (the halo path's local block
    and received rows, Nsrc > N)."""
    ep, cp = p["edge_mlp"], p["coors_mlp"]
    W = ep["lin1"]["w"]
    Dh, E = h.shape[-1], he.shape[-1]
    x_s, h_s = src if src is not None else (x, h)
    src = torch.cat([x_s, torch.matmul(h_s, W[:Dh])], dim=-1).contiguous()
    dst = torch.cat([x, torch.matmul(h, W[Dh:2 * Dh]) + ep["lin1"]["b"]],
                    dim=-1).contiguous()
    Do = ep["lin2"]["w"].shape[0]
    if "ln" in ep:
        ln_g, ln_b = ep["ln"]["g"], ep["ln"]["b"]
    else:
        ln_g = torch.ones(Do, dtype=torch.float32, device=x.device)
        ln_b = torch.zeros(Do, dtype=torch.float32, device=x.device)
    kparams = dict(Wc=W[2 * Dh:2 * Dh + E].contiguous(),
                   Wd=W[2 * Dh + E:].contiguous(),
                   ln_g=ln_g, ln_b=ln_b, W2=ep["lin2"]["w"], b2=ep["lin2"]["b"],
                   W1c=cp["lin1"]["w"], b1c=cp["lin1"]["b"],
                   W2c=cp["lin2"]["w"], b2c=cp["lin2"]["b"])
    return src, dst, kparams


def _edge_step(p: Params, cfg: ModelConfig, side: ProteinBatch,
               x: torch.Tensor, h: torch.Tensor, he: torch.Tensor, src=None, inverse=None):
    """Per-edge messages + masked means over K for one side; `inverse`: the
    side's inverse neighbour list, for the backward's scatter."""
    src, dst, kparams = edge_kernel_inputs(p, x, h, he, src)
    return edge_message_aggregate(
        src, dst, he, side.nbr, side.nbr_mask, kparams,
        slope=cfg.leakyrelu_neg_slope, use_ln=cfg.layer_norm == "LN",
        use_dist=cfg.use_dist_in_layers, inverse=inverse)


def _rbf_of_sq_dist(x_rel: torch.Tensor, enabled: bool) -> torch.Tensor:
    """(B, N, K, 3) relative coordinates -> (B, N, K, 15) RBF of ||x_rel||^2."""
    d2 = (x_rel * x_rel).sum(dim=-1, keepdim=True)
    out = torch.exp(-d2 / torch.tensor(RBF_SIGMAS, dtype=d2.dtype, device=d2.device))
    return out if enabled else out * 0.0


def _edge_messages(p: Params, cfg: ModelConfig, side: ProteinBatch, which: int, x, h, he,
                   drop, bn, scope: str, src=None):
    """The plain edge step (the JAX package's XLA path): (x_rel (B, N, K,
    3), msg (B, N, K, D)) of one side (`which`: `LIG` or `REC`), `src` as in
    `edge_kernel_inputs`."""
    global plain_body_calls
    plain_body_calls += 1
    x_s, h_s = src if src is not None else (x, h)
    x_rel = gather_neighbors(x_s, side.nbr) - x[:, :, None, :]            # src - dst
    rbf = _rbf_of_sq_dist(x_rel, cfg.use_dist_in_layers)
    h_src = gather_neighbors(h_s, side.nbr)
    h_dst = h[:, :, None, :].expand(h_src.shape[:-1] + (h.shape[-1],))
    msg = _mlp2(p["edge_mlp"], torch.cat([h_src, h_dst, he, rbf], dim=-1), cfg,
                cfg.layer_norm, drop, which, bn, scope + "edge_mlp", side.nbr_mask[..., None])
    return x_rel, msg


def _coord_update(p: Params, cfg: ModelConfig, side: ProteinBatch, which: int, x_rel, msg,
                  drop, bn, scope: str) -> torch.Tensor:
    """The plain coordinate step: the masked mean over K of x_rel times the
    coordinate MLP of each message (with `layer_norm_coors`)."""
    coef = _mlp2(p["coors_mlp"], msg, cfg, cfg.layer_norm_coors, drop, which, bn,
                 scope + "coors_mlp", side.nbr_mask[..., None])
    return masked_mean_over_k(x_rel * coef, side.nbr_mask)


def iegmn_layer_forward(p: Params, cfg: ModelConfig, fine_tune: bool, skip: bool,
                        lig: ProteinBatch, rec: ProteinBatch,
                        x_l, h_l, x_r, h_r, orig_h_l, orig_h_r, he_l, he_r,
                        orig_x_l, orig_x_r, src_l=None, src_r=None,
                        attend: Optional[Callable] = None, inv_l=None, inv_r=None,
                        train: bool = False, drop=None, bn=None, bn_scope: str = "",
                        gn_reduce: Optional[Callable] = None, stats: Optional[dict] = None):
    """One IEGMN layer on both proteins. Returns (x_l, h_l, x_r, h_r).

    Node-sharded (halo) mode, used by `parallel/halo.py` so that one layer
    body serves both paths, as in the JAX package:
      * `src_l` / `src_r`: (x_src, h_src) the neighbour gathers read, the
        local block followed by the received halo rows, indexed by the
        remapped `side.nbr`. Default: (x, h) themselves.
      * `attend`: a cross-attention callable with the signature of
        `ops.attention.cross_attention` (the halo path passes the ring
        attention over the shards' K/V chunks; packed slots pass their
        segment ids); it replaces the attention kernel and the fine-tune
        stage's attention.
      * `gn_reduce`: sums GraphNorm's per-shard statistics over the shards
        (JAX's `gn_axis`).
    `inv_l` / `inv_r`: each side's inverse neighbour list
    (`inverse_neighbors(side.nbr, rows of the source)`), built once per
    forward that records gradients by the caller and shared by its layers;
    None builds one in each backward. `train`, `drop` (dropout masks) and
    `bn` (a BNContext, its sites under `bn_scope`) as in `docking_forward`.
    Dropout masks and BatchNorm statistics are taken in the JAX package's
    order: edge MLP ligand, receptor, coordinate MLP ligand, receptor, node
    MLP (and final norm) ligand, receptor. `stats`, a dict, records the
    ligand's activation maxima under the JAX package's labels (its debug
    trace), through the plain layer body."""
    def rec_stat(name, value, mask):
        if stats is not None:
            stats[name] = torch.where(mask > 0, value, torch.full_like(value, float("-inf"))).max()

    if fused_edge_eligible(cfg, train, debug=stats is not None):
        aggr_l, xupd_l = _edge_step(p, cfg, lig, x_l, h_l, he_l, src_l, inv_l)
        aggr_r, xupd_r = _edge_step(p, cfg, rec, x_r, h_r, he_r, src_r, inv_r)
    else:
        x_rel_l, msg_l = _edge_messages(p, cfg, lig, LIG, x_l, h_l, he_l, drop, bn, bn_scope,
                                        src_l)
        x_rel_r, msg_r = _edge_messages(p, cfg, rec, REC, x_r, h_r, he_r, drop, bn, bn_scope,
                                        src_r)
        aggr_l = masked_mean_over_k(msg_l, lig.nbr_mask)
        aggr_r = masked_mean_over_k(msg_r, rec.nbr_mask)
        xupd_l = _coord_update(p, cfg, lig, LIG, x_rel_l, msg_l, drop, bn, bn_scope)
        xupd_r = _coord_update(p, cfg, rec, REC, x_rel_r, msg_r, drop, bn, bn_scope)
        rec_stat("x_now", x_l, lig.node_mask[..., None])
        rec_stat("h_feat", h_l, lig.node_mask[..., None])
        rec_stat("x_rel", x_rel_l, lig.nbr_mask[..., None])
        rec_stat("msg", msg_l, lig.nbr_mask[..., None])

    def qk(h, which, dtype=cfg.dtype):
        return nonlin(linear(p[which], h, dtype), cfg.nonlin, cfg.leakyrelu_neg_slope)

    def v(h):
        return linear(p["att_v"], h, cfg.dtype)

    # q, k and v at cfg.dtype; the attention kernels take their f32 outputs
    if attend is not None:
        cross_l = attend(qk(h_l, "att_q"), qk(h_r, "att_k"), v(h_r),
                         lig.node_mask, rec.node_mask, cfg.cross_msgs, lig.seg_id, rec.seg_id)
        cross_r = attend(qk(h_r, "att_q"), qk(h_l, "att_k"), v(h_l),
                         rec.node_mask, lig.node_mask, cfg.cross_msgs, rec.seg_id, lig.seg_id)
    elif cfg.cross_msgs:
        cross_l = cross_attention_fused(qk(h_l, "att_q"), qk(h_r, "att_k"), v(h_r),
                                        lig.node_mask, rec.node_mask,
                                        q_seg=lig.seg_id, k_seg=rec.seg_id)
        cross_r = cross_attention_fused(qk(h_r, "att_q"), qk(h_l, "att_k"), v(h_l),
                                        rec.node_mask, lig.node_mask,
                                        q_seg=rec.seg_id, k_seg=lig.seg_id)
    else:
        cross_l = torch.zeros_like(h_l)
        cross_r = torch.zeros_like(h_r)

    rec_stat("aggr_cross_msg", cross_l, lig.node_mask[..., None])

    def x_update(x, orig_x, x_upd):
        return (cfg.x_connection_init * orig_x
                + (1.0 - cfg.x_connection_init) * x + x_upd)

    x_final_l = x_update(x_l, orig_x_l, xupd_l)
    x_final_r = x_update(x_r, orig_x_r, xupd_r)
    rec_stat("x_final", x_final_l, lig.node_mask[..., None])

    if fine_tune:
        def ft_v(h):
            z = nonlin(linear(p["ft_att_v1"], h), cfg.nonlin, cfg.leakyrelu_neg_slope)
            return linear(p["ft_att_v2"], z)

        def ft_attend(q, k, v, qm, km, q_seg, k_seg):
            if attend is not None:
                return attend(q, k, v, qm, km, cfg.cross_msgs, q_seg, k_seg)
            return cross_attention(q, k, v, qm, km, cfg.cross_msgs, q_seg=q_seg, k_seg=k_seg)

        # the fine-tune stage's own linears stay f32, as in the JAX package
        att_x_l = ft_attend(qk(h_l, "ft_att_q", None), qk(h_r, "ft_att_k", None), x_r,
                            lig.node_mask, rec.node_mask, lig.seg_id, rec.seg_id)
        att_x_r = ft_attend(qk(h_r, "ft_att_q", None), qk(h_l, "ft_att_k", None), x_l,
                            rec.node_mask, lig.node_mask, rec.seg_id, lig.seg_id)
        x_final_l = x_final_l + ft_v(h_l) * (x_l - att_x_l)
        x_final_r = x_final_r + ft_v(h_r) * (x_r - att_x_r)

    def node_update(side: ProteinBatch, which: int, h, aggr, cross, orig_h):
        upd = _mlp2(p["node_mlp"], torch.cat([h, aggr, cross, orig_h], dim=-1), cfg,
                    cfg.layer_norm, drop, which, bn, bn_scope + "node_mlp",
                    side.node_mask[..., None])
        if skip:
            upd = cfg.skip_weight_h * upd + (1.0 - cfg.skip_weight_h) * h
        if cfg.final_h_layer_norm == "LN":
            upd = layer_norm(p["final_h_norm"], upd)
        elif cfg.final_h_layer_norm == "GN":
            if side.seg_id is not None:
                raise ValueError("final_h_layer_norm='GN' normalizes per graph and is not "
                                 "segment-aware; train packed batches with 'LN'/'0'")
            upd = graph_norm(p["final_h_norm"], upd, side.node_mask, reduce=gn_reduce)
        elif cfg.final_h_layer_norm == "BN":
            if bn is None:
                raise ValueError("final_h_layer_norm='BN' needs running statistics: pass "
                                 "bn_state (models.iegmn.init_bn_state) into docking_forward")
            # one site for both sides, the ligand first (chained statistics)
            upd = bn(bn_scope + "final_h", p["final_h_norm"], upd, side.node_mask[..., None])
        return upd

    h_final_l = node_update(lig, LIG, h_l, aggr_l, cross_l, orig_h_l)
    h_final_r = node_update(rec, REC, h_r, aggr_r, cross_r, orig_h_r)
    rec_stat("h_final", h_final_l, lig.node_mask[..., None])
    return x_final_l, h_final_l, x_final_r, h_final_r


def layer_params(cfg: ModelConfig, p: Params, i: int) -> Params:
    """Parameters of layer i: layer0, then the shared layer or slice i-1 of
    the stacked unshared layers."""
    if i == 0:
        return p["layer0"]
    if cfg.shared_layers:
        return p["rest"]

    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[i - 1]

    return take(p["rest"])


def layer_scope(cfg: ModelConfig, i: int) -> str:
    """The BatchNorm scope of layer i within a stage (the JAX package's)."""
    if i == 0:
        return "layer0/"
    return "rest/" if cfg.shared_layers else f"rest{i - 1}/"


def trunk_inputs(p: Params, cfg: ModelConfig, lig: ProteinBatch, rec: ProteinBatch):
    """(h_l, h_r, he_l, he_r): the input node features (residue embedding,
    with the log surface features) and the gated edge features of both
    sides."""
    h_l = embedding(p["embedding"], lig.res_id)
    h_r = embedding(p["embedding"], rec.res_id)
    if cfg.use_mean_node_features:
        h_l = torch.cat([h_l, torch.log(lig.mu_r_norm)], dim=-1)
        h_r = torch.cat([h_r, torch.log(rec.mu_r_norm)], dim=-1)
    gate = 1.0 if cfg.use_edge_features_in_gmn else 0.0
    return h_l, h_r, (lig.edge_feat * gate).contiguous(), (rec.edge_feat * gate).contiguous()


@dataclasses.dataclass
class Shards:
    """The trunk on node shards (the halo path, `parallel/halo.py`): the
    hooks that turn the whole-batch trunk of `iegmn_forward` into a shard's,
    so that one layer loop (with remat) serves the dense and the sharded
    forward.
      * `lig`, `rec`: this shard's sides;
      * `x_in(x_l_in)`: this shard's rows of a stage's input ligand
        coordinates;
      * `exchange(x_l, h_l, x_r, h_r)`: (xs_l, hs_l, xs_r, hs_r), the rows a
        layer's neighbour gathers read (the local block followed by the
        received halo rows);
      * `attend`, `gn_reduce`: as in `iegmn_layer_forward`;
      * `gather(a)`: a trunk output's shards -> the whole batch's rows;
      * `dropout(drop)`: (trunk's, head's) masks of a training forward's
        `drop`, each the shard's part of the whole batch's."""
    lig: ProteinBatch
    rec: ProteinBatch
    x_in: Callable
    exchange: Callable
    attend: Callable
    gn_reduce: Callable
    gather: Callable
    dropout: Callable


def iegmn_forward(p: Params, cfg: ModelConfig, batch: PairBatch,
                  x_l_in: torch.Tensor, n_lays: int, fine_tune: bool,
                  train: bool = False, drop=None, head_drop=None, bn=None, bn_scope: str = "",
                  trace: Optional[list] = None, shards: Optional[Shards] = None):
    """IEGMN trunk + keypoint head. Returns (R, t, keypts_lig, keypts_rec):
    (B, 3, 3), (B, 1, 3), (B, H, 3) x 2, packed (B, C, 3, 3), (B, C, 1, 3),
    (B, C, H, 3) x 2. When the forward records gradients through the edge
    kernels, each side's inverse neighbour list (read only by the backward's
    scatter) is built once, at the first layer, and shared by every layer;
    with `remat_active(cfg)` layers 1..n-1 (with `shards`, their exchanges
    too) are recomputed in the backward. `drop` gives the trunk's dropout
    masks, `head_drop` the keypoint head's. `trace`, a list, gets one dict
    of activation maxima a layer (the debug trace: the plain layer body, no
    remat). `shards` runs the trunk on node shards and gathers its outputs
    before the head."""
    lig, rec = batch.lig, batch.rec
    t_lig, t_rec, x_l = ((lig, rec, x_l_in) if shards is None
                         else (shards.lig, shards.rec, shards.x_in(x_l_in)))
    x_in, x_r = x_l, t_rec.x
    h_l, h_r, he_l, he_r = trunk_inputs(p, cfg, t_lig, t_rec)
    orig_h_l, orig_h_r = h_l, h_r
    grad = torch.is_grad_enabled()
    edge_kernel = grad and fused_edge_eligible(cfg, train, debug=trace is not None)
    remat = grad and remat_active(cfg) and trace is None
    attend, gn_reduce = (None, None) if shards is None else (shards.attend, shards.gn_reduce)
    inv: Dict[str, torch.Tensor] = {}
    for i in range(n_lays):
        layer = dict(p=layer_params(cfg, p, i), skip=i > 0, bn_scope=bn_scope + layer_scope(cfg, i))
        stats = {} if trace is not None else None

        def run(x_l, h_l, x_r, h_r, layer=layer, drop=drop, stats=stats):
            if isinstance(drop, ReplayLayer):
                drop.rewind()
            if shards is None:
                src_l = src_r = None
            else:
                xs_l, hs_l, xs_r, hs_r = shards.exchange(x_l, h_l, x_r, h_r)
                src_l, src_r = (xs_l, hs_l), (xs_r, hs_r)
            if edge_kernel and not inv:          # each side's inverse lists, once
                inv["l"] = inverse_neighbors(t_lig.nbr, (src_l or (x_l,))[0].shape[1])
                inv["r"] = inverse_neighbors(t_rec.nbr, (src_r or (x_r,))[0].shape[1])
            return iegmn_layer_forward(
                layer["p"], cfg, fine_tune, layer["skip"], t_lig, t_rec, x_l, h_l, x_r, h_r,
                orig_h_l, orig_h_r, he_l, he_r, x_in, t_rec.x, src_l=src_l, src_r=src_r,
                attend=attend, inv_l=inv.get("l"), inv_r=inv.get("r"), train=train,
                drop=drop, bn=bn, bn_scope=layer["bn_scope"], gn_reduce=gn_reduce, stats=stats)

        if remat and i > 0:
            layer_drop = ReplayLayer(drop) if drop is not None and drop.rate > 0 else drop
            x_l, h_l, x_r, h_r = checkpoint(run, x_l, h_l, x_r, h_r, drop=layer_drop,
                                            use_reentrant=False)
        else:
            x_l, h_l, x_r, h_r = run(x_l, h_l, x_r, h_r)
        if trace is not None:
            trace.append(stats)
    if shards is not None:
        x_l, h_l, x_r, h_r = (shards.gather(a) for a in (x_l, h_l, x_r, h_r))
    oh = ((lig.seg_onehot(batch.n_segs), rec.seg_onehot(batch.n_segs))
          if batch.n_segs > 1 else (None, None))
    return keypoint_head(p, cfg, h_l, x_l, h_r, x_r, lig.node_mask, rec.node_mask,
                         drop=head_drop, lig_oh=oh[0], rec_oh=oh[1])


def keypoint_head(p: Params, cfg: ModelConfig, h_l, x_l, h_r, x_r,
                  lig_mask, rec_mask, drop=None, lig_oh=None, rec_oh=None):
    """Attention-pooled keypoints + batched Kabsch fit. Packed slots
    (`lig_oh` / `rec_oh`, (B, N, C) segment one-hots): pooling, keypoint
    attention and the fit run per packed complex."""
    d = cfg.iegmn_lay_hid_dim
    H = cfg.num_att_heads
    packed = lig_oh is not None

    def h_mean(h, mask, oh, which):
        z = dropout(linear(p["mlp_h_mean_rot"], h, cfg.dtype), drop, which)
        z = nonlin(z, cfg.nonlin, cfg.leakyrelu_neg_slope)
        if not packed:
            return masked_mean_over_nodes(z, mask)                       # (B, d)
        total = torch.einsum("bnd,bnc->bcd", z, oh)                      # (B, C, d)
        return total / torch.clamp(oh.sum(dim=1)[..., None], min=1.0)

    mean_l = h_mean(h_l, lig_mask, lig_oh, LIG)
    mean_r = h_mean(h_r, rec_mask, rec_oh, REC)

    def keypoints(h_side, x_side, mask_side, oh_side, mean_other):
        keys = linear(p["att_key_rot"], h_side, cfg.dtype).reshape(h_side.shape[0], -1, H, d)
        if not packed:
            query = linear(p["att_query_rot"], mean_other, cfg.dtype).reshape(-1, H, d)
            logits = torch.einsum("bnhd,bhd->bhn", keys, query) / math.sqrt(d)
            logits = torch.where(mask_side[:, None, :] > 0, logits,
                                 torch.full_like(logits, -1e9))
            att = torch.softmax(logits, dim=-1)                          # (B, H, N)
            return torch.einsum("bhn,bnc->bhc", att, x_side)             # (B, H, 3)
        B, C = mean_other.shape[:2]
        query = linear(p["att_query_rot"], mean_other, cfg.dtype).reshape(B, C, H, d)
        logits = torch.einsum("bnhd,bchd->bchn", keys, query) / math.sqrt(d)
        seg_ok = oh_side.permute(0, 2, 1)[:, :, None, :]                 # (B, C, 1, N)
        logits = torch.where(seg_ok > 0, logits, torch.full_like(logits, -1e9))
        att = torch.softmax(logits, dim=-1)                              # (B, C, H, N)
        return torch.einsum("bchn,bnx->bchx", att, x_side)               # (B, C, H, 3)

    keypts_rec = keypoints(h_r, x_r, rec_mask, rec_oh, mean_l)
    keypts_lig = keypoints(h_l, x_l, lig_mask, lig_oh, mean_r)
    if not packed:
        R, t = rigid_fit(keypts_lig, keypts_rec)
        return R, t, keypts_lig, keypts_rec
    B, C = keypts_lig.shape[:2]
    R, t = rigid_fit(keypts_lig.reshape(B * C, H, 3), keypts_rec.reshape(B * C, H, 3))
    return R.reshape(B, C, 3, 3), t.reshape(B, C, 1, 3), keypts_lig, keypts_rec


def docking_forward(p: Params, cfg: ModelConfig, batch: PairBatch,
                    n_lays: Optional[int] = None, train: bool = False, drop=None,
                    bn_state: Optional[dict] = None, debug: bool = False,
                    bn_reduce: Optional[Callable] = None, shards: Optional[Shards] = None):
    """Rigid docking forward. Returns ligand_coords (B, N_l, 3) = R x + t of
    the input ligand (packed: each node by its complex's transform),
    keypts_lig / keypts_rec, R and t; with a fine-tune stage, (R, t) is the
    composed transform from the ORIGINAL input ligand, as in the JAX
    package. `train` marks a training forward: BatchNorm uses and updates
    batch statistics, and dropout (rate above 0) draws its masks from
    `drop` (`layers.Dropout`). `bn_state` (required when an option is 'BN';
    `init_bn_state`) adds "bn_updates", the new running statistics, to a
    training forward's outputs. `debug` adds "trace", one dict of the
    ligand's activation maxima a layer (both stages' layers in turn) under
    the JAX package's labels, and runs the plain layer body (as the JAX
    package's debug mode runs its XLA path). `bn_reduce` sums BatchNorm's
    partial sums over the ranks that hold the batch's rows (a mesh step,
    `parallel/train.py`), so its statistics are the whole batch's.
    `shards` runs each stage's trunk on node shards (`Shards`; the halo
    path), the keypoint head and the fit on the gathered outputs."""
    check_supported(cfg)
    if debug and shards is not None:
        raise ValueError("the debug trace reads the whole batch's activations: run it unsharded")
    if uses_batch_norm(cfg) and bn_state is None:
        raise ValueError("config uses 'BN' normalization: pass bn_state=init_bn_state(cfg) "
                         "(TrainState.bn_state carries it)")
    if train and cfg.dropout > 0 and drop is None:
        raise ValueError(f"dropout={cfg.dropout} in a training forward needs `drop` "
                         "(layers.Dropout: a generator or a mask source)")
    drop = drop if train else None
    trunk_drop, head_drop = (drop, drop) if shards is None else shards.dropout(drop)
    bn = BNContext(bn_state, train, reduce=bn_reduce) if bn_state else None
    n_lays = n_lays if n_lays is not None else cfg.iegmn_n_lays
    x_l = batch.lig.x
    C = batch.n_segs

    def apply(x, R, t):
        return apply_rigid(x, R, t) if C == 1 else apply_rigid_packed(x, R, t,
                                                                       batch.lig.seg_id, C)

    trace: Optional[list] = [] if debug else None
    kw = dict(train=train, drop=trunk_drop, head_drop=head_drop, bn=bn, trace=trace,
              shards=shards)
    if cfg.fine_tune and "finetune" in p:
        R0, t0, _, _ = iegmn_forward(p["original"], cfg, batch, x_l, n_lays, False,
                                     bn_scope="original/", **kw)
        x_l = apply(x_l, R0, t0)
        R2, t2, kl, kr = iegmn_forward(p["finetune"], cfg, batch, x_l, 2, True,
                                       bn_scope="finetune/", **kw)
        lig_pred = apply(x_l, R2, t2)
        # x2 = R2 (R0 x + t0) + t2 = (R2 R0) x + (R2 t0 + t2)
        R = torch.einsum("...ij,...jk->...ik", R2, R0)
        t = torch.einsum("...ij,...nj->...ni", R2, t0) + t2
    else:
        R, t, kl, kr = iegmn_forward(p["original"], cfg, batch, x_l, n_lays, False,
                                     bn_scope="original/", **kw)
        lig_pred = apply(x_l, R, t)
    out = {"ligand_coords": lig_pred, "keypts_lig": kl, "keypts_rec": kr, "R": R, "t": t}
    if bn is not None and train:
        out["bn_updates"] = {**bn.state, **bn.updates}
    if debug:
        out["trace"] = trace
    return out
