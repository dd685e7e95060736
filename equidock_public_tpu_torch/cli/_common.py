"""Config flags shared by the port's CLIs (`train`, `inference`,
`ensemble_inference`, `preprocess`, `crop_corpus`, `padding_report`,
`hyper_search`): the flags of `equidock_public_tpu/cli/_common.py`, with
the JAX package's names and defaults. The port honours every one of them
(`REFUSED`, the flags it would refuse by name, is empty)."""

from __future__ import annotations

import argparse

from ..config import (Config, DataConfig, GraphConfig, ModelConfig, ParallelConfig, TrainConfig,
                      reference_root)

# Flags of the JAX package's CLIs that the port does not honour, with what
# each selects there: none.
REFUSED: dict = {}


def add_config_args(p: argparse.ArgumentParser) -> None:
    """The config flags of the JAX package's CLIs that the port reads, and
    those it refuses by name (`REFUSED`)."""
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
    p.add_argument("-n_jobs", type=int, default=DataConfig().n_jobs,
                   help="worker processes that build caches from PDB files")
    p.add_argument("-raw_data_path", default=reference_root("data/benchmark5.5/structures"),
                   help="the <code>_{l,r}_b.pdb files (default under $EQUIDOCK_REFERENCE_ROOT)")
    p.add_argument("-split_files_path", default=reference_root("data/benchmark5.5/cv/cv_0"),
                   help="the {train,val,test}.txt split files")
    p.add_argument("-cache_dir", default="./cache")
    p.add_argument("-node_buckets", default="",
                   help="comma-separated node buckets, or auto[:G] (a ladder of at most G "
                        "steps, default 12, from the splits' sizes)")
    p.add_argument("-pocket_buckets", default="",
                   help="comma-separated pocket buckets, or auto[:G] (default 8)")
    p.add_argument("-checkpoint_dir", default="./checkpts")
    p.add_argument("-device_resident", action="store_true",
                   help="hold the padded splits on the device, draw the augmentation there")
    p.add_argument("-trim_remainder", action="store_true",
                   help="device-resident epochs: a group's n %% bs leftover pairs as one "
                        "narrow step")
    p.add_argument("-stream_dips", action="store_true",
                   help="stream DIPS shards through a bounded LRU instead of loading them all")
    p.add_argument("-stream_window", type=int, default=DataConfig().stream_window)
    p.add_argument("-pack", action="store_true",
                   help="training: bin-pack several small complexes into one padded slot")
    p.add_argument("-pack_max_per_slot", type=int, default=DataConfig().pack_max_per_slot)
    p.add_argument("-distill_dir", default="",
                   help="pose distillation: blend each train target with the teacher pose "
                        "<code>_l_b_*.pdb of this directory")
    p.add_argument("-distill_alpha", type=float, default=DataConfig().distill_alpha)
    p.add_argument("-pad_cache_gb", type=float, default=DataConfig().pad_cache_gb,
                   help="byte budget of the collate cache of padded static fields "
                        "(graph.py::PadCache, least recently used out first)")
    # the mesh: ranks as processes (torchrun), or stacked in one process
    p.add_argument("-dp", type=int, default=1,
                   help="data-parallel ranks (each holds bs / dp complexes of a batch)")
    p.add_argument("-gp", type=int, default=1,
                   help="graph-parallel ranks (the halo path: each holds a shard of the nodes)")
    p.add_argument("-pallas_ring_halo", action="store_true",
                   help="read and kept in the config; changes nothing in the port, which "
                        "always runs the halo exchange kernels (rows 8-9)")
    p.add_argument("-debug", action="store_true",
                   help="kept in the config (docking_forward(debug=True) gives the "
                        "per-layer activation trace)")
    for flag in REFUSED:
        p.add_argument("-" + flag, nargs="?", const=True, default=None,
                       help=f"not ported ({REFUSED[flag]})")


def refuse_unported(a: argparse.Namespace, training: bool = True) -> None:
    """Raise NotImplementedError naming every refused flag that was given,
    and, for the CLIs that do not train, `-pack` (they collate one complex
    a slot)."""
    if not training and a.pack:
        raise NotImplementedError("-pack: packing is a training option; the inference "
                                  "CLIs collate one complex a slot")
    given = [f"-{f}" for f in REFUSED if getattr(a, f) is not None]
    if given:
        raise NotImplementedError("flags not ported: " + ", ".join(
            f"{f} ({REFUSED[f[1:]]})" for f in given))


def _buckets(value: str, key: str, auto_key: str, auto_groups: int) -> dict:
    """The DataConfig fields of a bucket flag, as the JAX package parses it:
    none when empty, `{auto_key: G}` for auto[:G] (G defaults to
    `auto_groups`), else `{key: the comma-separated sizes}`."""
    if not value:
        return {}
    if value.startswith("auto"):
        return {auto_key: int(value.split(":")[1]) if ":" in value else auto_groups}
    return {key: tuple(int(x) for x in value.split(","))}


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
        ot_solver=a.ot_solver, select_metric=a.select_metric,
        trim_remainder=a.trim_remainder,
        freeze_original=bool(getattr(a, "freeze_original", False)))
    data = DataConfig(data=a.data, data_fraction=a.data_fraction, split=a.split,
                      n_jobs=a.n_jobs, raw_data_path=a.raw_data_path,
                      split_files_path=a.split_files_path, cache_dir=a.cache_dir,
                      **_buckets(a.node_buckets, "node_buckets", "auto_buckets_max", 12),
                      **_buckets(a.pocket_buckets, "pocket_buckets", "auto_pocket_max", 8),
                      device_resident=a.device_resident, stream_dips=a.stream_dips,
                      stream_window=a.stream_window, pack=a.pack,
                      pack_max_per_slot=a.pack_max_per_slot, distill_dir=a.distill_dir,
                      distill_alpha=a.distill_alpha, pad_cache_gb=a.pad_cache_gb)
    graph = GraphConfig(graph_cutoff=a.graph_cutoff, graph_max_neighbor=a.graph_max_neighbor,
                        pocket_cutoff=a.pocket_cutoff,
                        translation_interval=a.translation_interval)
    return Config(model=model, graph=graph, data=data, train=train,
                  parallel=ParallelConfig(dp=a.dp, gp=a.gp,
                                          pallas_ring_halo=a.pallas_ring_halo),
                  debug=a.debug, checkpoint_dir=a.checkpoint_dir)
