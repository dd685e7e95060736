"""Training CLI: the port of `equidock_public_tpu/cli/train.py`, cut down to
what the port trains (DB5-layout npz caches on one device).

    python -m equidock_public_tpu_torch.cli.train -toy [-max_epochs N] [flags]

The caches are read from `<cache_dir>/<data>_residues_..._pocketCut_<c>/
cv_<split>/{train,val,test}.npz` (`Config.cache_path`), in the layout
either package writes (`data/dataset.py::write_cache`, `data/synth.py`).
With `-max_epochs` or `-max_seconds`, `fit` runs with the flags as given;
without them, `-toy` runs the DB5 stage of the curriculum (lr 1e-4,
patience 500), and a run without `-toy` would start with the DIPS stage,
which is not ported. The flags of the JAX CLI that the port does not honour
raise NotImplementedError with their name. `-device` chooses the device
(default the card; `cpu` runs the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from ..config import Config, DataConfig, GraphConfig, ModelConfig, TrainConfig
from ..device import resolve_device

# Flags of the JAX training CLI that the port does not honour: what each
# selects there.
REFUSED = {
    "fine_tune_from": "two-stage fine-tuning", "freeze_original": "fine-tuning",
    "fine_tune_init": "fine-tuning", "pack": "packed batches",
    "pack_max_per_slot": "packed batches", "device_resident": "device-resident epochs",
    "trim_remainder": "device-resident epochs", "dp": "mesh training",
    "gp": "mesh training", "pallas_ring_halo": "mesh training",
    "stream_dips": "DIPS streaming", "stream_window": "DIPS streaming",
    "distill_dir": "pose distillation", "distill_alpha": "pose distillation",
    "pad_cache_gb": "the JAX collate cache", "compile_cache": "the XLA compile cache",
    "n_jobs": "building caches from PDB files", "raw_data_path": "building caches",
    "split_files_path": "building caches", "debug": "the JAX debug mode",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train EquiDock (PyTorch/CUDA port)")
    m, t, g = ModelConfig(), TrainConfig(), GraphConfig()
    # model
    p.add_argument("-iegmn_lay_hid_dim", type=int, default=m.iegmn_lay_hid_dim)
    p.add_argument("-iegmn_n_lays", type=int, default=m.iegmn_n_lays)
    p.add_argument("-residue_emb_dim", type=int, default=m.residue_emb_dim)
    p.add_argument("-num_att_heads", type=int, default=m.num_att_heads)
    p.add_argument("-shared_layers", action="store_true")
    p.add_argument("-cross_msgs", action="store_true", default=True)
    p.add_argument("-dropout", type=float, default=m.dropout)
    p.add_argument("-layer_norm", default=m.layer_norm, choices=["0", "LN", "BN"])
    p.add_argument("-layer_norm_coors", default=m.layer_norm_coors, choices=["0", "LN", "BN"])
    p.add_argument("-final_h_layer_norm", default=m.final_h_layer_norm,
                   choices=["0", "LN", "GN", "BN"])
    p.add_argument("-nonlin", default=m.nonlin, choices=["lkyrelu", "swish"])
    p.add_argument("-leakyrelu_neg_slope", type=float, default=m.leakyrelu_neg_slope)
    p.add_argument("-skip_weight_h", type=float, default=m.skip_weight_h)
    p.add_argument("-x_connection_init", type=float, default=m.x_connection_init)
    p.add_argument("-fine_tune", action="store_true")
    for flag in ("use_dist_in_layers", "use_edge_features_in_gmn", "use_mean_node_features"):
        p.add_argument("-" + flag, type=int, choices=[0, 1], default=1)
    p.add_argument("-divide_coors_dist", type=int, choices=[0, 1], default=0)
    for flag in ("use_fused_attention", "factored_edge_mlp", "fused_edge_message",
                 "fused_edge_bwd"):      # the port always runs its kernels
        p.add_argument("-" + flag, action="store_true")
    p.add_argument("-use_fused_intersection", action="store_true",
                   help="the soft-min field kernels for the intersection loss")
    p.add_argument("-remat", action="store_true")
    p.add_argument("-dtype", default="float32", choices=["float32", "bfloat16"])
    # train
    for flag, typ in (("lr", float), ("w_decay", float), ("patience", int),
                      ("num_epochs", int), ("clip", float), ("bs", int), ("warmup", float),
                      ("save_every_epochs", int), ("pocket_ot_loss_weight", float),
                      ("intersection_loss_weight", float), ("intersection_sigma", float),
                      ("intersection_surface_ct", float), ("random_seed", int),
                      ("val_repeats", int)):
        p.add_argument("-" + flag, type=typ, default=getattr(t, flag))
    p.add_argument("-scheduler", default=t.scheduler, choices=["warmup", "cyclic", "ROP"])
    p.add_argument("-select_metric", default=t.select_metric,
                   choices=["crmsd", "irmsd", "sum", "bar"])
    p.add_argument("-ot_solver", default=t.ot_solver, choices=["sinkhorn", "exact"])
    # graph
    for flag in ("graph_cutoff", "pocket_cutoff", "translation_interval"):
        p.add_argument("-" + flag, type=float, default=getattr(g, flag))
    p.add_argument("-graph_max_neighbor", type=int, default=g.graph_max_neighbor)
    # data
    p.add_argument("-data", default="db5", choices=["db5", "dips"])
    p.add_argument("-data_fraction", type=float, default=1.0)
    p.add_argument("-split", type=int, default=0)
    p.add_argument("-cache_dir", default="./cache")
    p.add_argument("-node_buckets", default="", help="comma-separated node buckets")
    p.add_argument("-pocket_buckets", default="", help="comma-separated pocket buckets")
    p.add_argument("-checkpoint_dir", default="./checkpts")
    # the run
    p.add_argument("-toy", action="store_true", help="train on DB5 only")
    p.add_argument("-max_epochs", type=int, default=None)
    p.add_argument("-max_seconds", type=float, default=None)
    p.add_argument("-continue_train_model", default="",
                   help="a checkpoint of the port to resume from; its model config is adopted")
    p.add_argument("-device", default="cuda", help="cuda (default) or cpu")
    for flag in REFUSED:
        p.add_argument("-" + flag, nargs="?", const=True, default=None,
                       help=f"not ported ({REFUSED[flag]})")
    return p


def _buckets(flag: str, value: str, default):
    if not value:
        return default
    if value.startswith("auto"):
        raise NotImplementedError(f"-{flag} {value}: auto buckets are not ported")
    return tuple(int(x) for x in value.split(","))


def config_from_args(a: argparse.Namespace) -> Config:
    model = ModelConfig(
        residue_emb_dim=a.residue_emb_dim, iegmn_lay_hid_dim=a.iegmn_lay_hid_dim,
        iegmn_n_lays=a.iegmn_n_lays, shared_layers=a.shared_layers,
        num_att_heads=a.num_att_heads, nonlin=a.nonlin,
        leakyrelu_neg_slope=a.leakyrelu_neg_slope, dropout=a.dropout,
        layer_norm=a.layer_norm, layer_norm_coors=a.layer_norm_coors,
        final_h_layer_norm=a.final_h_layer_norm, skip_weight_h=a.skip_weight_h,
        x_connection_init=a.x_connection_init, fine_tune=a.fine_tune,
        use_dist_in_layers=bool(a.use_dist_in_layers),
        use_edge_features_in_gmn=bool(a.use_edge_features_in_gmn),
        use_mean_node_features=bool(a.use_mean_node_features),
        divide_coors_dist=bool(a.divide_coors_dist),
        use_fused_attention=a.use_fused_attention, factored_edge_mlp=a.factored_edge_mlp,
        fused_edge_message=a.fused_edge_message, fused_edge_bwd=a.fused_edge_bwd,
        remat=a.remat, dtype=a.dtype)
    train = TrainConfig(
        lr=a.lr, w_decay=a.w_decay, patience=a.patience, num_epochs=a.num_epochs,
        clip=a.clip, bs=a.bs, warmup=a.warmup, scheduler=a.scheduler,
        pocket_ot_loss_weight=a.pocket_ot_loss_weight,
        intersection_loss_weight=a.intersection_loss_weight,
        intersection_sigma=a.intersection_sigma,
        intersection_surface_ct=a.intersection_surface_ct, random_seed=a.random_seed,
        save_every_epochs=a.save_every_epochs,
        use_fused_intersection=a.use_fused_intersection, val_repeats=a.val_repeats,
        ot_solver=a.ot_solver, select_metric=a.select_metric)
    d = DataConfig()
    data = DataConfig(data=a.data, data_fraction=a.data_fraction, split=a.split,
                      cache_dir=a.cache_dir,
                      node_buckets=_buckets("node_buckets", a.node_buckets, d.node_buckets),
                      pocket_buckets=_buckets("pocket_buckets", a.pocket_buckets,
                                              d.pocket_buckets))
    graph = GraphConfig(graph_cutoff=a.graph_cutoff, graph_max_neighbor=a.graph_max_neighbor,
                        pocket_cutoff=a.pocket_cutoff,
                        translation_interval=a.translation_interval)
    return Config(model=model, graph=graph, data=data, train=train,
                  checkpoint_dir=a.checkpoint_dir)


def kernel_path_report(cfg: Config, device) -> str:
    """Which of the port's kernels a training step of `cfg` launches."""
    if device.type != "cuda":
        return f"none: the plain PyTorch versions on {device}"
    names = ["edge_message", "edge_message_bwd"]
    if cfg.model.cross_msgs:
        names += ["cross_attention", "cross_attention_dq", "cross_attention_dkv"]
    if cfg.train.use_fused_intersection:
        names += ["softmin_field", "softmin_field_bwd"]
    return f"{len(names)} of 7 CUDA kernels: " + ", ".join(names)


def main(argv: Optional[List[str]] = None) -> int:
    from ..train.checkpoint import load_checkpoint
    from ..train.loop import check_fit_supported, fit, make_logger

    a = _parser().parse_args(argv)
    given = [f"-{f}" for f in REFUSED if getattr(a, f) is not None]
    if given:
        raise NotImplementedError("flags not ported: " + ", ".join(
            f"{f} ({REFUSED[f[1:]]})" for f in given))
    if a.max_epochs is None and a.max_seconds is None and not a.toy:
        raise NotImplementedError("a run without -toy, -max_epochs or -max_seconds starts "
                                  "with the DIPS stage of the curriculum, which is not ported")
    cfg = config_from_args(a)
    dev = resolve_device(a.device)
    state = None
    if a.continue_train_model:
        state, cfg_ckpt, epoch = load_checkpoint(a.continue_train_model, dev)
        cfg = dataclasses.replace(cfg, model=cfg_ckpt.model)
        print(f"Continuing from {a.continue_train_model} (epoch {epoch})")
    if a.max_epochs is None and a.max_seconds is None:
        # the DB5 stage of `curriculum(cfg, toy=True)`
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, data="db5"),
            train=dataclasses.replace(cfg.train, lr=1e-4, patience=500))
    check_fit_supported(cfg)
    log = make_logger(cfg)
    log("Model name ===> ", cfg.banner())
    log("Kernel paths ===> ", kernel_path_report(cfg, dev))
    fit(cfg, state=state, max_epochs=a.max_epochs, log=log, max_seconds=a.max_seconds,
        device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
