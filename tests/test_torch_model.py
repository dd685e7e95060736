"""The port's IEGMN forward against the JAX package's `docking_forward` at
`tests/utils.py::tiny_config`, through `params_from_numpy`, with the JAX
fused-kernel flags off (XLA path) and on (Pallas in interpret mode).
Tolerance: f32 through a few layers and an SVD, atol 2e-4 on R and 2e-3 on
coordinates of ~10-unit scale."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu_torch.config import ModelConfig as PortModelConfig
from equidock_public_tpu_torch.models import iegmn as tm
from equidock_public_tpu_torch.params import (flatten, init_params, load_checkpoint,
                                              param_shapes, params_from_numpy,
                                              save_params)

from .torch_utils import f32_default, port_batch, t  # noqa: F401
from .utils import synth_batch, tiny_config

FLAGS = {"xla": {}, "fused": dict(use_fused_attention=True, fused_edge_message=True)}


def _port_cfg(jcfg):
    return PortModelConfig(**dataclasses.asdict(jcfg))


def _jax_params(mcfg, seed=0):
    p = jm.init_docking_model(jax.random.PRNGKey(seed), mcfg)
    return jax.tree.map(np.asarray, p)


def _batch(rng):
    # the JAX fused edge kernel tiles nodes by 8
    return synth_batch(rng, N_l=16, N_r=24, n_l=12, n_r=19)


def _compare(out, want, atol_r=2e-4, atol_x=2e-3):
    np.testing.assert_allclose(out["R"].numpy(), np.asarray(want["R"]), atol=atol_r)
    for key in ("t", "ligand_coords", "keypts_lig", "keypts_rec"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=atol_x, err_msg=key)


@pytest.mark.parametrize("path", sorted(FLAGS))
@pytest.mark.parametrize("model_kw", [
    dict(shared_layers=True, iegmn_n_lays=3),
    dict(shared_layers=False, iegmn_n_lays=3),
    dict(final_h_layer_norm="LN"),
    dict(final_h_layer_norm="GN", layer_norm="0"),
    dict(fine_tune=True, shared_layers=True),
], ids=["shared", "unshared", "final_ln", "gn_no_ln", "fine_tune"])
def test_docking_forward_matches_jax(rng, path, model_kw):
    cfg = tiny_config(**model_kw, **FLAGS[path]).model
    batch = _batch(rng)
    jp = _jax_params(cfg)
    want = jm.docking_forward(jp, cfg, batch)
    pcfg = _port_cfg(cfg)
    out = tm.docking_forward(params_from_numpy(jp, pcfg), pcfg, port_batch(batch))
    _compare(out, want)
    # (R, t) maps the ORIGINAL input ligand onto the output coordinates
    moved = torch.einsum("bij,bnj->bni", out["R"], port_batch(batch).lig.x) + out["t"]
    np.testing.assert_allclose(moved.numpy(), out["ligand_coords"].numpy(), atol=1e-3)


def test_one_layer_matches_jax(rng):
    cfg = tiny_config(fused_edge_message=True, use_fused_attention=True).model
    batch = _batch(rng)
    full = _jax_params(cfg)
    jp = full["original"]["layer0"]
    B, D = batch.lig.x.shape[0], cfg.input_node_feats_dim
    h_l = rng.standard_normal((B, batch.lig.x.shape[1], D)).astype(np.float32)
    h_r = rng.standard_normal((B, batch.rec.x.shape[1], D)).astype(np.float32)
    args = (batch.lig.x, h_l, batch.rec.x, h_r, h_l, h_r,
            batch.lig.edge_feat, batch.rec.edge_feat, batch.lig.x, batch.rec.x)
    want = jm.iegmn_layer_forward(jp, cfg, False, False, batch.lig, batch.rec, *args)
    pcfg = _port_cfg(cfg)
    pp = params_from_numpy(full, pcfg)["original"]["layer0"]
    pb = port_batch(batch)
    got = tm.iegmn_layer_forward(pp, pcfg, False, False, pb.lig, pb.rec,
                                 *[t(a) for a in args])
    masks = [np.asarray(batch.lig.node_mask), np.asarray(batch.lig.node_mask),
             np.asarray(batch.rec.node_mask), np.asarray(batch.rec.node_mask)]
    for g, w, m in zip(got, want, masks):
        # padded nodes differ by design (the JAX fused path pads keys)
        np.testing.assert_allclose(g.numpy() * m[..., None], np.asarray(w) * m[..., None],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", [dict(layer_norm="BN"), dict(layer_norm_coors="LN"),
                                 dict(nonlin="swish"), dict(final_h_layer_norm="BN"),
                                 dict(dtype="bfloat16")])
def test_configs_outside_the_kernels_raise(bad):
    """Every option here is ported (`tests/test_torch_options.py` and, for
    bf16 operands, `tests/test_torch_bf16.py` hold them to the JAX
    package): each passes `check_supported`. The edge kernel covers a 'BN'
    final norm and bf16 (its inputs stay f32, as JAX's fused edge path's),
    not the others, which run the plain layer body in training. A compute
    dtype other than float32 and bfloat16, or parameters other than f32,
    still raise."""
    cfg = PortModelConfig(**bad)
    tm.check_supported(cfg)
    covered = "final_h_layer_norm" in bad or "dtype" in bad
    assert tm.fused_edge_eligible(cfg, train=True) == covered
    assert tm.fused_edge_eligible(cfg, train=False) == covered
    if "dtype" in bad:
        for other in (dict(dtype="float16"), dict(param_dtype="bfloat16")):
            with pytest.raises(NotImplementedError, match="dtype"):
                tm.check_supported(PortModelConfig(**other))


def test_params_from_numpy_checks_keys_and_shapes():
    cfg = tiny_config().model
    jp = _jax_params(cfg)
    pcfg = _port_cfg(cfg)
    flat = flatten(jp)
    assert set(flat) == set(param_shapes(pcfg))
    assert all(tuple(flat[k].shape) == s for k, s in param_shapes(pcfg).items())
    missing = {**jp, "original": {k: v for k, v in jp["original"].items()
                                  if k != "att_key_rot"}}
    with pytest.raises(KeyError, match="att_key_rot"):
        params_from_numpy(missing, pcfg)
    extra = {**jp, "stray": {"w": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="stray"):
        params_from_numpy(extra, pcfg)
    bad = jax.tree.map(lambda a: a, jp)
    bad["original"]["mlp_h_mean_rot"]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="mlp_h_mean_rot"):
        params_from_numpy(bad, pcfg)


def test_save_and_load_round_trip(tmp_path):
    import json

    pcfg = _port_cfg(tiny_config(fine_tune=True).model)
    params = init_params(pcfg, seed=3)
    path = str(tmp_path / "w.pt.xz")
    save_params(path, params)
    with open(tmp_path / "w.config.json", "w") as f:
        json.dump({"model": dataclasses.asdict(pcfg)}, f)
    loaded, cfg = load_checkpoint(path)
    assert cfg.model == pcfg
    a, b = flatten(params), flatten(loaded)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_init_params_follow_torch_default_init():
    pcfg = _port_cfg(tiny_config().model)
    p = flatten(init_params(pcfg, seed=0))
    assert torch.equal(p["original/layer0/edge_mlp/ln/g"], torch.ones(8))
    w = p["original/layer0/edge_mlp/lin1/w"]
    assert w.abs().max() <= 1 / np.sqrt(w.shape[0])
    assert all(v.dtype == torch.float32 for v in p.values())
    again = flatten(init_params(pcfg, seed=0))
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_weight_files_must_end_in_pt_xz(tmp_path):
    with pytest.raises(ValueError, match=".pt.xz"):
        save_params(str(tmp_path / "w.pt"), init_params(_port_cfg(tiny_config().model)))
