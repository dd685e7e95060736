"""IEGMN docking model, forward: the port of
`equidock_public_tpu/models/iegmn.py` (`iegmn_layer_forward`, `iegmn_forward`,
`keypoint_head`, `docking_forward`) for unpacked batches. Dropout is off,
so the training and inference forwards are one function; it is
differentiable end to end (the kernels' autograd Functions carry the
gradient on CUDA tensors).

The edge step and the cross-attention always go through
`ops/cuda/edge_message.py` and `ops/cuda/cross_attention.py`: the JAX
computation with `fused_edge_message` and `use_fused_attention` on. On CUDA
tensors those launch the hand-written kernels; on CPU tensors they run their
plain PyTorch versions. Configs the fused edge kernel does not cover raise
instead of taking another path. The halo path (`parallel/halo.py`) runs the
same layer body on node shards, with its own source rows and attention.

Parameters are nested dicts with the JAX package's keys (see `params.py`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import ModelConfig
from ..graph import PairBatch, ProteinBatch
from ..ops.attention import cross_attention
from ..ops.cuda.cross_attention import cross_attention_fused
from ..ops.cuda.edge_message import edge_message_aggregate, inverse_neighbors
from ..ops.kabsch import apply_rigid, rigid_fit
from ..ops.segment import masked_mean_over_nodes
from .layers import Params, embedding, graph_norm, layer_norm, linear, nonlin


def check_supported(cfg: ModelConfig, training: bool = False) -> None:
    """Raise for a config outside what the port's kernels compute (the JAX
    package's `fused_edge_eligible` at inference, f32, no BatchNorm); with
    `training`, also for what the training step does not cover yet."""
    problems = []
    if cfg.nonlin != "lkyrelu":
        problems.append(f"nonlin={cfg.nonlin!r} (the edge kernel is LeakyReLU)")
    if cfg.layer_norm not in ("LN", "0"):
        problems.append(f"layer_norm={cfg.layer_norm!r}")
    if cfg.layer_norm_coors != "0":
        problems.append(f"layer_norm_coors={cfg.layer_norm_coors!r}")
    if cfg.final_h_layer_norm not in ("0", "LN", "GN"):
        problems.append(f"final_h_layer_norm={cfg.final_h_layer_norm!r}")
    if cfg.dtype != "float32" or cfg.param_dtype != "float32":
        problems.append(f"dtype={cfg.dtype!r}/{cfg.param_dtype!r}")
    if training:
        if cfg.dropout > 0:
            problems.append(f"dropout={cfg.dropout} (training runs dropout 0)")
        if cfg.fine_tune:
            problems.append("fine_tune (two-stage training)")
        if cfg.remat:
            problems.append("remat")
    if problems:
        raise NotImplementedError("config not covered by the port's kernels: "
                                  + ", ".join(problems))


def _mlp2(p: Params, x: torch.Tensor, cfg: ModelConfig, use_ln: bool) -> torch.Tensor:
    """Linear -> nonlin -> (LN) -> Linear (dropout is off at inference)."""
    h = nonlin(linear(p["lin1"], x), cfg.nonlin, cfg.leakyrelu_neg_slope)
    if use_ln:
        h = layer_norm(p["ln"], h)
    return linear(p["lin2"], h)


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


def iegmn_layer_forward(p: Params, cfg: ModelConfig, fine_tune: bool, skip: bool,
                        lig: ProteinBatch, rec: ProteinBatch,
                        x_l, h_l, x_r, h_r, orig_h_l, orig_h_r, he_l, he_r,
                        orig_x_l, orig_x_r, src_l=None, src_r=None,
                        attend: Optional[Callable] = None, inv_l=None, inv_r=None):
    """One IEGMN layer on both proteins. Returns (x_l, h_l, x_r, h_r).

    Node-sharded (halo) mode, used by `parallel/halo.py` so that one layer
    body serves both paths, as in the JAX package:
      * `src_l` / `src_r`: (x_src, h_src) the neighbour gathers read, the
        local block followed by the received halo rows, indexed by the
        remapped `side.nbr`. Default: (x, h) themselves.
      * `attend`: a cross-attention callable with the signature of
        `ops.attention.cross_attention` (the halo path passes the ring
        attention over the shards' K/V chunks); it replaces the attention
        kernel and the fine-tune stage's attention.
    `inv_l` / `inv_r`: each side's inverse neighbour list
    (`inverse_neighbors(side.nbr, rows of the source)`), built once per
    forward that records gradients by the caller and shared by its layers;
    None builds one in each backward."""
    aggr_l, xupd_l = _edge_step(p, cfg, lig, x_l, h_l, he_l, src_l, inv_l)
    aggr_r, xupd_r = _edge_step(p, cfg, rec, x_r, h_r, he_r, src_r, inv_r)

    def qk(h, which):
        return nonlin(linear(p[which], h), cfg.nonlin, cfg.leakyrelu_neg_slope)

    if attend is not None:
        cross_l = attend(qk(h_l, "att_q"), qk(h_r, "att_k"), linear(p["att_v"], h_r),
                         lig.node_mask, rec.node_mask, cfg.cross_msgs)
        cross_r = attend(qk(h_r, "att_q"), qk(h_l, "att_k"), linear(p["att_v"], h_l),
                         rec.node_mask, lig.node_mask, cfg.cross_msgs)
    elif cfg.cross_msgs:
        cross_l = cross_attention_fused(qk(h_l, "att_q"), qk(h_r, "att_k"),
                                        linear(p["att_v"], h_r),
                                        lig.node_mask, rec.node_mask)
        cross_r = cross_attention_fused(qk(h_r, "att_q"), qk(h_l, "att_k"),
                                        linear(p["att_v"], h_l),
                                        rec.node_mask, lig.node_mask)
    else:
        cross_l = torch.zeros_like(h_l)
        cross_r = torch.zeros_like(h_r)

    def x_update(x, orig_x, x_upd):
        return (cfg.x_connection_init * orig_x
                + (1.0 - cfg.x_connection_init) * x + x_upd)

    x_final_l = x_update(x_l, orig_x_l, xupd_l)
    x_final_r = x_update(x_r, orig_x_r, xupd_r)

    if fine_tune:
        def ft_v(h):
            z = nonlin(linear(p["ft_att_v1"], h), cfg.nonlin, cfg.leakyrelu_neg_slope)
            return linear(p["ft_att_v2"], z)

        ft_attend = attend if attend is not None else cross_attention
        att_x_l = ft_attend(qk(h_l, "ft_att_q"), qk(h_r, "ft_att_k"), x_r,
                            lig.node_mask, rec.node_mask, cfg.cross_msgs)
        att_x_r = ft_attend(qk(h_r, "ft_att_q"), qk(h_l, "ft_att_k"), x_l,
                            rec.node_mask, lig.node_mask, cfg.cross_msgs)
        x_final_l = x_final_l + ft_v(h_l) * (x_l - att_x_l)
        x_final_r = x_final_r + ft_v(h_r) * (x_r - att_x_r)

    def node_update(side: ProteinBatch, h, aggr, cross, orig_h):
        upd = _mlp2(p["node_mlp"], torch.cat([h, aggr, cross, orig_h], dim=-1),
                    cfg, cfg.layer_norm == "LN")
        if skip:
            upd = cfg.skip_weight_h * upd + (1.0 - cfg.skip_weight_h) * h
        if cfg.final_h_layer_norm == "LN":
            upd = layer_norm(p["final_h_norm"], upd)
        elif cfg.final_h_layer_norm == "GN":
            upd = graph_norm(p["final_h_norm"], upd, side.node_mask)
        return upd

    h_final_l = node_update(lig, h_l, aggr_l, cross_l, orig_h_l)
    h_final_r = node_update(rec, h_r, aggr_r, cross_r, orig_h_r)
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


def iegmn_forward(p: Params, cfg: ModelConfig, batch: PairBatch,
                  x_l_in: torch.Tensor, n_lays: int, fine_tune: bool):
    """IEGMN trunk + keypoint head. Returns (R (B, 3, 3), t (B, 1, 3),
    keypts_lig (B, H, 3), keypts_rec (B, H, 3)). When the forward records
    gradients, each side's inverse neighbour list (read only by the
    backward's scatter) is built once here and shared by every layer."""
    lig, rec = batch.lig, batch.rec
    x_l, x_r = x_l_in, rec.x
    h_l, h_r, he_l, he_r = trunk_inputs(p, cfg, lig, rec)
    orig_h_l, orig_h_r = h_l, h_r
    inv_l = inv_r = None
    if torch.is_grad_enabled():
        inv_l = inverse_neighbors(lig.nbr, lig.nbr.shape[1])
        inv_r = inverse_neighbors(rec.nbr, rec.nbr.shape[1])
    for i in range(n_lays):
        x_l, h_l, x_r, h_r = iegmn_layer_forward(
            layer_params(cfg, p, i), cfg, fine_tune, i > 0, lig, rec, x_l, h_l, x_r, h_r,
            orig_h_l, orig_h_r, he_l, he_r, x_l_in, rec.x, inv_l=inv_l, inv_r=inv_r)
    return keypoint_head(p, cfg, h_l, x_l, h_r, x_r, lig.node_mask, rec.node_mask)


def keypoint_head(p: Params, cfg: ModelConfig, h_l, x_l, h_r, x_r,
                  lig_mask, rec_mask):
    """Attention-pooled keypoints + batched Kabsch fit."""
    d = cfg.iegmn_lay_hid_dim
    H = cfg.num_att_heads

    def h_mean(h, mask):
        z = nonlin(linear(p["mlp_h_mean_rot"], h), cfg.nonlin, cfg.leakyrelu_neg_slope)
        return masked_mean_over_nodes(z, mask)                      # (B, d)

    mean_l = h_mean(h_l, lig_mask)
    mean_r = h_mean(h_r, rec_mask)

    def keypoints(h_side, x_side, mask_side, mean_other):
        keys = linear(p["att_key_rot"], h_side).reshape(h_side.shape[0], -1, H, d)
        query = linear(p["att_query_rot"], mean_other).reshape(-1, H, d)
        logits = torch.einsum("bnhd,bhd->bhn", keys, query) / math.sqrt(d)
        logits = torch.where(mask_side[:, None, :] > 0, logits,
                             torch.full_like(logits, -1e9))
        att = torch.softmax(logits, dim=-1)                          # (B, H, N)
        return torch.einsum("bhn,bnc->bhc", att, x_side)             # (B, H, 3)

    keypts_rec = keypoints(h_r, x_r, rec_mask, mean_l)
    keypts_lig = keypoints(h_l, x_l, lig_mask, mean_r)
    R, t = rigid_fit(keypts_lig, keypts_rec)
    return R, t, keypts_lig, keypts_rec


def docking_forward(p: Params, cfg: ModelConfig, batch: PairBatch,
                    n_lays: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Rigid docking forward. Returns ligand_coords (B, N_l, 3) = R x + t of
    the input ligand, keypts_lig / keypts_rec (B, H, 3), R (B, 3, 3) and
    t (B, 1, 3). With a fine-tune stage, (R, t) is the composed transform
    from the ORIGINAL input ligand, as in the JAX package."""
    check_supported(cfg)
    n_lays = n_lays if n_lays is not None else cfg.iegmn_n_lays
    x_l = batch.lig.x
    if cfg.fine_tune and "finetune" in p:
        R0, t0, _, _ = iegmn_forward(p["original"], cfg, batch, x_l, n_lays, False)
        x_l = apply_rigid(x_l, R0, t0)
        R2, t2, kl, kr = iegmn_forward(p["finetune"], cfg, batch, x_l, 2, True)
        lig_pred = apply_rigid(x_l, R2, t2)
        # x2 = R2 (R0 x + t0) + t2 = (R2 R0) x + (R2 t0 + t2)
        R = torch.einsum("...ij,...jk->...ik", R2, R0)
        t = torch.einsum("...ij,...nj->...ni", R2, t0) + t2
    else:
        R, t, kl, kr = iegmn_forward(p["original"], cfg, batch, x_l, n_lays, False)
        lig_pred = apply_rigid(x_l, R, t)
    return {"ligand_coords": lig_pred, "keypts_lig": kl, "keypts_rec": kr,
            "R": R, "t": t}
