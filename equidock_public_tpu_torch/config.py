"""Typed configuration: the port's own copy of the model, graph, training
and data settings of `equidock_public_tpu/config.py`, plus the
`*.config.json` sidecar loader. Field names and defaults are the JAX
package's, so a sidecar written by either package loads here unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


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
    # path always runs the edge-message and cross-attention kernels.
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
    """The optimizer, loss and step settings a training step reads
    (`equidock_public_tpu/config.py::TrainConfig`, same defaults). The
    epoch-loop settings (patience, epochs, metering, checkpointing) are not
    read yet."""

    lr: float = 2e-4
    w_decay: float = 1e-4
    scheduler: str = "warmup"        # 'warmup' | 'cyclic' | 'ROP'
    warmup: float = 1.0
    clip: float = 100.0
    bs: int = 10
    pocket_ot_loss_weight: float = 1.0
    intersection_loss_weight: float = 10.0
    intersection_sigma: float = 25.0
    intersection_surface_ct: float = 10.0
    ot_solver: str = "sinkhorn"      # 'sinkhorn' | 'exact' (a host LP: not ported)
    sinkhorn_epsilon: float = 0.01
    sinkhorn_iters: int = 200
    use_fused_intersection: bool = False
    freeze_original: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The data settings serving and the training batches read."""

    node_buckets: Tuple[int, ...] = (64, 128, 192, 256, 384, 512, 768, 1024, 1536)
    pocket_buckets: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
    swap_train: bool = True          # 50% ligand/receptor swap of training samples
    pack: bool = False               # packed batches (not ported)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


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
    """Build a Config from a sidecar dict. Model and graph keys must all be
    known; the data and train sections keep the fields above (the rest are
    loop and corpus settings), and the parallel section is not read."""
    return Config(model=_pick(ModelConfig, d.get("model", {}), strict=True),
                  graph=_pick(GraphConfig, d.get("graph", {}), strict=True),
                  data=_pick(DataConfig, d.get("data", {}), strict=False),
                  train=_pick(TrainConfig, d.get("train", {}), strict=False))


def load_config(path: str) -> Config:
    """Read a `*.config.json` sidecar."""
    with open(path) as f:
        return config_from_dict(json.load(f))
