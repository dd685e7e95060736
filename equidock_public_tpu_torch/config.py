"""Typed configuration: the port's own copy of the model, graph, training
and data settings of `equidock_public_tpu/config.py`, plus the
`*.config.json` sidecar loader, and `auto_node_buckets` (the ladders of
`-node_buckets auto:G` / `-pocket_buckets auto:G`), and `reference_root`,
where the raw structures and frozen test sets lie by default. Field names
and defaults are the JAX package's, so a sidecar written by either package
loads here unchanged.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Tuple

import numpy as np


def reference_root(*parts: str, must_exist: bool = False) -> str:
    """A path under the reference data checkout (raw structures, split
    files, frozen test sets): `$EQUIDOCK_REFERENCE_ROOT`, by default
    `~/reference`. Read when called, so the variable moves every default
    built after it is set."""
    root = os.environ.get("EQUIDOCK_REFERENCE_ROOT",
                          os.path.join(os.path.expanduser("~"), "reference"))
    path = os.path.join(root, *parts)
    if must_exist and not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: set EQUIDOCK_REFERENCE_ROOT to the reference data "
            "checkout (PDB structures, frozen test sets)")
    return path


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """IEGMN + keypoint/Kabsch-head hyperparameters (reference flag names)."""

    residue_emb_dim: int = 64
    iegmn_lay_hid_dim: int = 64
    iegmn_n_lays: int = 5
    shared_layers: bool = False
    num_att_heads: int = 50          # == number of keypoints
    nonlin: str = "lkyrelu"          # 'lkyrelu' | 'swish'
    leakyrelu_neg_slope: float = 1e-2
    dropout: float = 0.0
    layer_norm: str = "LN"           # inside edge/node MLPs: '0' | 'BN' | 'LN'
    layer_norm_coors: str = "0"      # inside coors MLP: '0' | 'BN' | 'LN'
    final_h_layer_norm: str = "0"    # after each layer: '0' | 'LN' | 'GN' | 'BN'
    cross_msgs: bool = True
    use_dist_in_layers: bool = True
    use_edge_features_in_gmn: bool = True
    use_mean_node_features: bool = True
    skip_weight_h: float = 0.5
    x_connection_init: float = 0.0
    fine_tune: bool = False
    divide_coors_dist: bool = False  # parsed, never read (as in the reference)
    num_residue_types: int = 21
    input_edge_feats_dim: int = 27
    num_dist_sigmas: int = 15
    dtype: str = "float32"
    param_dtype: str = "float32"
    # Kernel-path flags of the JAX package. They select TPU code paths there;
    # the port reads them only to accept sidecars that carry them: its CUDA
    # path runs the cross-attention kernels always and the edge-message
    # kernels wherever they cover the config (`models/iegmn.py::
    # fused_edge_eligible`); `remat` recomputes layers 1..n-1 in the backward.
    use_fused_attention: bool = False
    factored_edge_mlp: bool = False
    fused_edge_message: bool = False
    fused_edge_bwd: bool = False
    remat: bool = False

    @property
    def input_node_feats_dim(self) -> int:
        d = self.residue_emb_dim
        if self.use_mean_node_features:
            d += 5
        return d


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """kNN-graph construction parameters."""

    graph_nodes: str = "residues"
    graph_cutoff: float = 30.0
    graph_max_neighbor: int = 10     # K, the fixed in-degree of the tables
    graph_residue_loc_is_alphaC: bool = True
    pocket_cutoff: float = 8.0
    translation_interval: float = 5.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, loss, step and epoch-loop settings
    (`equidock_public_tpu/config.py::TrainConfig`, same defaults)."""

    lr: float = 2e-4
    w_decay: float = 1e-4
    scheduler: str = "warmup"        # 'warmup' | 'cyclic' | 'ROP'
    warmup: float = 1.0
    patience: int = 50               # epochs without a 2% better val metric
    num_epochs: int = 10000
    clip: float = 100.0
    bs: int = 10
    pocket_ot_loss_weight: float = 1.0
    intersection_loss_weight: float = 10.0
    intersection_sigma: float = 25.0
    intersection_surface_ct: float = 10.0
    random_seed: int = 8
    ot_solver: str = "sinkhorn"      # 'sinkhorn' | 'exact' (scipy's HiGHS LP on the host)
    sinkhorn_epsilon: float = 0.01
    sinkhorn_iters: int = 200
    train_rmsd_fraction: float = 0.1  # train batches whose RMSD is metered
    use_fused_intersection: bool = False  # the soft-min field kernels
    save_every_epochs: int = 0       # periodic checkpoint (0: only the best)
    val_repeats: int = 1             # val epochs averaged per epoch (fresh poses)
    # Two-stage fine-tuning: the original stage's gradients and updates are
    # zeroed, so only the fine-tune stage trains.
    freeze_original: bool = False
    select_metric: str = "crmsd"     # 'crmsd' | 'irmsd' | 'sum' | 'bar'
    # Device-resident epochs: each bucket group's n % bs leftover pairs run
    # as one narrow step of width n % bs (no dead slots) instead of a
    # bs-wide step with masked copies; the same step membership and update.
    trim_remainder: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Corpus, cache and batching settings."""

    data: str = "db5"                # 'db5' | 'dips'
    data_fraction: float = 1.0       # leading share of the train split kept
    split: int = 0
    # Building caches from PDB files (`data/dataset.py::build_cache`): worker
    # processes, the `<code>_{l,r}_b.pdb` directory and the `<split>.txt` one.
    n_jobs: int = 4
    raw_data_path: str = dataclasses.field(
        default_factory=lambda: reference_root("data/benchmark5.5/structures"))
    split_files_path: str = dataclasses.field(
        default_factory=lambda: reference_root("data/benchmark5.5/cv/cv_0"))
    cache_dir: str = "./cache"
    node_buckets: Tuple[int, ...] = (64, 128, 192, 256, 384, 512, 768, 1024, 1536)
    pocket_buckets: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
    # `-node_buckets auto[:G]`: a ladder of at most G steps resolved from
    # the splits' sizes before training (`auto_node_buckets`); 0 = off.
    auto_buckets_max: int = 0
    # `-pocket_buckets auto[:G]`: the same for pocket sizes (align 32,
    # quad_at 256: the Sinkhorn cost matrix is K x K).
    auto_pocket_max: int = 0
    swap_train: bool = True          # 50% ligand/receptor swap of training samples
    # Complex packing: up to pack_max_per_slot complexes share one padded
    # slot (block-diagonal neighbour tables, segment tags in the attention,
    # per-complex losses); the slot count pads to a slot_count_buckets entry.
    pack: bool = False
    pack_max_per_slot: int = 4
    slot_count_buckets: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
    # DIPS shards streamed through a shard LRU of `stream_window` shards
    # (at most 2 x stream_window resident) instead of loaded whole.
    stream_dips: bool = False
    stream_window: int = 4
    # The padded split held on the device, the augmentation drawn there
    # (`train/resident.py`).
    device_resident: bool = False
    # Pose distillation: each train target becomes (1 - a) gt + a teacher
    # pose, the teacher's `<code>_l_b_*.pdb` in distill_dir
    # (`data/dataset.py::blend_teacher_poses`).
    distill_dir: str = ""
    distill_alpha: float = 0.5


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    checkpoint_dir: str = "./checkpts"
    log_dir: str = "./stdouterr"

    def banner(self) -> str:
        """The run's name: the JAX package's `Config.banner`, which names the
        checkpoint directory and the log files."""
        m, t = self.model, self.train
        parts = [
            ("drp", m.dropout), ("Wdec", t.w_decay), ("ITS_lw", t.intersection_loss_weight),
            ("Hdim", m.iegmn_lay_hid_dim), ("Nlay", m.iegmn_n_lays),
            ("shrdLay", m.shared_layers), ("SURFfs", m.use_mean_node_features),
            ("ln", m.layer_norm), ("lnX", m.layer_norm_coors), ("Hnrm", m.final_h_layer_norm),
            ("NattH", m.num_att_heads), ("skH", m.skip_weight_h),
            ("xConnI", m.x_connection_init), ("LkySl", m.leakyrelu_neg_slope),
            ("pokOTw", t.pocket_ot_loss_weight),
        ]
        if m.fine_tune:
            parts.append(("FT", True))
        tostr = lambda v: ("T" if v else "F") if isinstance(v, bool) else str(v)
        name = "EQUIDOCK_TPU__" + "#".join(f"{k}_{tostr(v)}" for k, v in parts)
        if len(name) > 200:
            name = name[:160] + hashlib.sha1(name.encode()).hexdigest()[:12]
        return name

    def cache_path(self) -> str:
        """The split caches' directory, as the JAX package derives it:
        `<cache_dir>/<data>_<graph settings>/cv_<split>/{train,val,test}.npz`."""
        g = self.graph
        return (f"{self.data.cache_dir}/{self.data.data}_{g.graph_nodes}"
                f"_maxneighbor_{g.graph_max_neighbor}_cutoff_{g.graph_cutoff}"
                f"_pocketCut_{g.pocket_cutoff}/cv_{self.data.split}")


def auto_node_buckets(sizes, max_groups: int = 12, align: int = 64,
                      quad_at: int = 640) -> Tuple[int, ...]:
    """The cost-optimal bucket ladder of at most `max_groups` steps for a
    known size list, the JAX package's `auto_node_buckets`: it minimises
    sum over sizes of c(B(s)), c(B) = B + B^2 / quad_at (the O(N) edge work
    and the O(N^2) attention, equal near N = 640 at D 64, K 10), by an exact
    dynamic programme over the `align`-rounded sizes."""
    arr = np.sort(np.asarray([int(s) for s in sizes]))
    if arr.size == 0:
        raise ValueError("auto_node_buckets: empty size list")
    cand = sorted({-(-int(s) // align) * align for s in arr.tolist()})
    prefix = np.searchsorted(arr, cand, side="right")       # sizes <= cand[j]
    n = len(cand)
    cost_b = [b + b * b / float(quad_at) for b in cand]
    G = max(1, min(max_groups, n))
    INF = float("inf")
    best = [[INF] * (G + 1) for _ in range(n)]
    back = [[-1] * (G + 1) for _ in range(n)]
    for j in range(n):
        best[j][1] = float(prefix[j]) * cost_b[j]
    for k in range(2, G + 1):
        for j in range(k - 1, n):
            for i in range(k - 2, j):
                c = best[i][k - 1] + float(prefix[j] - prefix[i]) * cost_b[j]
                if c < best[j][k]:
                    best[j][k] = c
                    back[j][k] = i
    k_star = min(range(1, G + 1), key=lambda k: best[n - 1][k])
    out, j, k = [], n - 1, k_star
    while j >= 0 and k >= 1:
        out.append(cand[j])
        j, k = back[j][k], k - 1
    return tuple(sorted(out))


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n; beyond the largest, round up to its multiple."""
    for b in buckets:
        if n <= b:
            return b
    step = buckets[-1]
    return ((n + step - 1) // step) * step


def _pick(cls, d: dict, strict: bool):
    names = {f.name for f in dataclasses.fields(cls)}
    extra = set(d) - names
    if strict and extra:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(extra)}")
    kw = {k: v for k, v in d.items() if k in names}
    for k, v in kw.items():
        if isinstance(v, list):
            kw[k] = tuple(v)
    return cls(**kw)


def config_from_dict(d: dict) -> Config:
    """Build a Config from a sidecar dict: the port's (whole config, or the
    model / graph / data / train sections of its older weight files) or the
    JAX package's. Model and graph keys must all be known; the data and
    train sections keep the fields above (the others, such as the JAX
    collate cache's budget, are settings of its host code), missing fields
    take their defaults, and the parallel section is not read (a mesh of
    more than one device raises)."""
    par = d.get("parallel", {})
    if par.get("dp", 1) * par.get("gp", 1) > 1:
        raise NotImplementedError(f"parallel dp={par.get('dp', 1)} gp={par.get('gp', 1)}: "
                                  "mesh training is not ported")
    top = {k: d[k] for k in ("checkpoint_dir", "log_dir") if k in d}
    return Config(model=_pick(ModelConfig, d.get("model", {}), strict=True),
                  graph=_pick(GraphConfig, d.get("graph", {}), strict=True),
                  data=_pick(DataConfig, d.get("data", {}), strict=False),
                  train=_pick(TrainConfig, d.get("train", {}), strict=False), **top)


def load_config(path: str) -> Config:
    """Read a `*.config.json` sidecar."""
    with open(path) as f:
        return config_from_dict(json.load(f))
