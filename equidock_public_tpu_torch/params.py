"""The weight bridge: parameters as nested dicts of f32 tensors under the JAX
package's key names (`original/layer0/edge_mlp/lin1/w`, ...).

`params_from_numpy` takes the JAX params pytree as nested dicts of numpy
arrays; `save_params` / `load_checkpoint` write and read the port's own
weight file, an xz-compressed `torch.save` of the flat `{key: tensor}` dict
(`<stem>.pt.xz`) with a `<stem>.config.json` sidecar beside it. Every route checks the keys and
shapes against what the config implies: a missing, extra or misshapen
parameter raises. `load_model` reads what the serving entry points take: a
weight file or a training checkpoint of the port.
"""

from __future__ import annotations

import io
import lzma
import math
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import Config, ModelConfig, load_config


def _layer_shapes(cfg: ModelConfig, orig_dim: int, h_dim: int, out_dim: int,
                  fine_tune: bool) -> Dict[str, Tuple[int, ...]]:
    edge_in = 2 * h_dim + cfg.input_edge_feats_dim + cfg.num_dist_sigmas
    node_in = orig_dim + 2 * h_dim + out_dim
    s: Dict[str, Tuple[int, ...]] = {}

    def mlp2(name, i, hid, o, use_ln):
        s[f"{name}/lin1/w"], s[f"{name}/lin1/b"] = (i, hid), (hid,)
        if use_ln:
            s[f"{name}/ln/g"], s[f"{name}/ln/b"] = (hid,), (hid,)
        s[f"{name}/lin2/w"], s[f"{name}/lin2/b"] = (hid, o), (o,)

    mlp2("edge_mlp", edge_in, out_dim, out_dim, cfg.layer_norm in ("LN", "BN"))
    mlp2("node_mlp", node_in, h_dim, out_dim, cfg.layer_norm in ("LN", "BN"))
    mlp2("coors_mlp", out_dim, out_dim, 1, cfg.layer_norm_coors in ("LN", "BN"))
    for name in ("att_q", "att_k", "att_v"):
        s[f"{name}/w"] = (h_dim, h_dim)
    if cfg.final_h_layer_norm in ("LN", "GN", "BN"):
        s["final_h_norm/g"], s["final_h_norm/b"] = (out_dim,), (out_dim,)
    if fine_tune:
        s["ft_att_q/w"] = s["ft_att_k/w"] = (h_dim, h_dim)
        s["ft_att_v1/w"], s["ft_att_v1/b"] = (h_dim, h_dim), (h_dim,)
        s["ft_att_v2/w"], s["ft_att_v2/b"] = (h_dim, 1), (1,)
    return s


def _iegmn_shapes(cfg: ModelConfig, n_lays: int, fine_tune: bool):
    in_dim, hid = cfg.input_node_feats_dim, cfg.iegmn_lay_hid_dim
    s = {"embedding/e": (cfg.num_residue_types, cfg.residue_emb_dim),
         "att_key_rot/w": (hid, cfg.num_att_heads * hid),
         "att_query_rot/w": (hid, cfg.num_att_heads * hid),
         "mlp_h_mean_rot/w": (hid, hid), "mlp_h_mean_rot/b": (hid,)}
    for k, v in _layer_shapes(cfg, in_dim, in_dim, hid, fine_tune).items():
        s["layer0/" + k] = v
    if n_lays > 1:
        lead = () if cfg.shared_layers else (n_lays - 1,)
        for k, v in _layer_shapes(cfg, in_dim, hid, hid, fine_tune).items():
            s["rest/" + k] = lead + v
    return s


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat key -> shape of every parameter the config implies."""
    out = {"original/" + k: v
           for k, v in _iegmn_shapes(cfg, cfg.iegmn_n_lays, False).items()}
    if cfg.fine_tune:
        out.update({"finetune/" + k: v
                    for k, v in _iegmn_shapes(cfg, 2, True).items()})
    return out


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested dicts -> {"a/b/c": leaf}; None subtrees (no rest layers) drop."""
    out: Dict[str, object] = {}
    for k, v in tree.items():
        if v is None:
            continue
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: Mapping[str, object]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def params_from_flat(flat: Mapping[str, object], cfg: ModelConfig,
                     device="cpu") -> Dict[str, object]:
    """Check a flat {key: array or tensor} dict against `param_shapes(cfg)`
    and return the nested dict of contiguous f32 tensors on `device`."""
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"parameter keys do not match the config: "
                       f"missing {missing}, extra {extra}")
    out = {}
    for key, shape in want.items():
        v = flat[key]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        if tuple(t.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, config implies {shape}")
        out[key] = t.to(device=device, dtype=torch.float32).contiguous()
    return unflatten(out)


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device="cpu") -> Dict[str, object]:
    """The JAX params pytree (nested dicts of numpy arrays) -> port params."""
    return params_from_flat(flatten(tree), cfg, device)


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> Dict[str, object]:
    """Random parameters with PyTorch's default initialisation (linear
    weight and bias ~ U(+-1/sqrt(fan_in)), embedding ~ N(0, 1), norm gain 1
    and shift 0), drawn from a torch.Generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    shapes = param_shapes(cfg)
    flat = {}
    for key, shape in shapes.items():
        parent, leaf = key.rsplit("/", 1)
        if parent.endswith("/embedding"):
            flat[key] = torch.randn(shape, generator=gen)
        elif parent.endswith("/ln") or parent.endswith("final_h_norm"):
            flat[key] = torch.ones(shape) if leaf == "g" else torch.zeros(shape)
        else:
            bound = 1.0 / math.sqrt(shapes[parent + "/w"][-2])
            flat[key] = (torch.rand(shape, generator=gen) * 2 - 1) * bound
    return params_from_flat(flat, cfg, device)


WEIGHTS_SUFFIX = ".pt.xz"


def config_path(weights_path: str) -> str:
    """`<stem>.pt.xz` -> `<stem>.config.json`."""
    if not weights_path.endswith(WEIGHTS_SUFFIX):
        raise ValueError(f"{weights_path}: the port's weight files end in {WEIGHTS_SUFFIX}")
    return weights_path[:-len(WEIGHTS_SUFFIX)] + ".config.json"


def save_params(path: str, params: Mapping) -> None:
    """Write the flat {key: f32 tensor} dict with torch.save, xz-compressed
    (trained f32 weights shrink by about a tenth)."""
    config_path(path)
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu().contiguous() for k, v in flatten(params).items()}, buf)
    with lzma.open(path, "wb", preset=9 | lzma.PRESET_EXTREME) as f:
        f.write(buf.getvalue())


def load_checkpoint(path: str, device="cpu") -> Tuple[Dict[str, object], Config]:
    """Read the port's weight file and its `.config.json` sidecar."""
    cfg = load_config(config_path(path))
    with lzma.open(path, "rb") as f:
        flat = torch.load(io.BytesIO(f.read()), map_location="cpu", weights_only=True)
    return params_from_flat(flat, cfg.model, device), cfg


def load_model(path: str, device="cpu"
               ) -> Tuple[Dict[str, object], Config, Optional[Dict[str, Dict[str, torch.Tensor]]]]:
    """(params, config, bn_state) of a model to serve, from either kind of
    file the port writes: a weight file (`<stem>.pt.xz` with its
    `<stem>.config.json`, `load_checkpoint`) or a training checkpoint
    (`train/checkpoint.py::save_checkpoint`, with `<path>.config.json`).
    `bn_state` holds the BatchNorm running statistics of a model with a
    'BN' option, and is None for the others. A weight file holds no running
    statistics, so one of a 'BN' model raises: serve its training
    checkpoint."""
    from .models.iegmn import uses_batch_norm

    if path.endswith(WEIGHTS_SUFFIX):
        params, cfg = load_checkpoint(path, device)
        if uses_batch_norm(cfg.model):
            raise ValueError(f"{path}: a weight file of a 'BN' model holds no BatchNorm "
                             "running statistics; serve the model's training checkpoint")
        return params, cfg, None
    from .train.checkpoint import load_checkpoint as load_train_state

    state, cfg, _ = load_train_state(path, device)
    return state.params, cfg, state.bn_state if uses_batch_norm(cfg.model) else None


# The models shipped with the package, converted from the tracked JAX
# checkpoints `artifacts/<name>`: the DB5 paper model first.
TRACKED_MODELS = ("db5_model_best", "db5_model_curriculum", "dips_model_pretrained",
                  "db5_model_small", "db5_model_small_s2", "db5_model_small_l3",
                  "db5_model_finetuned")


def model_checkpoint(name: str) -> str:
    """The weight file of the shipped model `name` (`TRACKED_MODELS`)."""
    if name not in TRACKED_MODELS:
        raise KeyError(f"{name!r} is not a shipped model: {TRACKED_MODELS}")
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                        name + WEIGHTS_SUFFIX)


def default_checkpoint() -> str:
    """The DB5 paper model's weights shipped with the package."""
    return model_checkpoint("db5_model_best")


def bn_state_from_flat(flat: Mapping[str, object], cfg: ModelConfig,
                       device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """BatchNorm running statistics, flat ({"<site>/mean": array or tensor,
    "<site>/var": ...}) -> {site: {"mean", "var"}} of f32 tensors on
    `device`, checked against the sites and widths the config implies
    (`models.iegmn.init_bn_state`)."""
    from .models.iegmn import init_bn_state

    want = flatten(init_bn_state(cfg))
    if set(flat) != set(want):
        raise KeyError(f"BatchNorm statistics do not match the config: missing "
                       f"{sorted(set(want) - set(flat))}, extra {sorted(set(flat) - set(want))}")
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, ref in want.items():
        v = flat[key]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)}, config implies {tuple(ref.shape)}")
        site, stat = key.rsplit("/", 1)
        out.setdefault(site, {})[stat] = t.to(device=device, dtype=torch.float32).contiguous()
    return out


def train_state_from_numpy(params: Mapping, opt_state, step, cfg: ModelConfig,
                           device="cpu", bn_state=()):
    """A JAX `TrainState`'s leaves as numpy (params pytree, optax chain
    state, step, BatchNorm statistics) -> the port's `train.step.TrainState`
    on `device`. The chain's Adam state is the element with `mu` and `nu`
    (optax's ScaleByAdamState); its `count` must equal `step`, since the
    port's optimizer derives both the bias correction and the schedule from
    the step."""
    from .train.step import TrainState

    adam = [s for s in opt_state if hasattr(s, "mu") and hasattr(s, "nu")]
    if len(adam) != 1:
        raise ValueError(f"expected one Adam state in the optimizer state, found {len(adam)}")
    adam = adam[0]
    if int(np.asarray(adam.count)) != int(np.asarray(step)):
        raise ValueError(f"Adam count {int(np.asarray(adam.count))} != step "
                         f"{int(np.asarray(step))}")
    moments = [flatten(params_from_numpy(m, cfg, device)) for m in (adam.mu, adam.nu)]
    return TrainState(params=params_from_numpy(params, cfg, device), mu=moments[0],
                      nu=moments[1], step=int(np.asarray(step)),
                      bn_state=bn_state_from_flat(flatten(dict(bn_state or {})), cfg, device))
