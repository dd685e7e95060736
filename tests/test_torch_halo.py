"""The port's halo path (`parallel/halo.py`) against the port's dense path,
torch only, on the CPU (the ring's plain versions).

* Forward at padded gp=2 (dp=4), a forced residual tier at gp=4 (dp=2) and
  ragged gp=2 (dp=2), with and without the fine-tune stage: R, t and the
  keypoints match the dense forward, and `ligand_coords` matches through
  `perm_l`, to the tolerances of the JAX package's `tests/test_halo.py`
  (R 1e-4; t, keypoints and coordinates rtol 1e-4, atol 1e-3: the ring
  attention sums in another order).
* A training step's loss terms (rtol 1e-5) and every leaf gradient
  (relative norm 1e-5) match the dense step's, in the three tiers.
* One forward at full width: the DB5 paper model's weights on the tracked
  512 x 1024 request, halo (gp=2) against dense.
* What the path does not take raises by name.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from equidock_public_tpu_torch.config import Config, ModelConfig, TrainConfig, load_config
from equidock_public_tpu_torch.eval.inference import featurize_request
from equidock_public_tpu_torch.models.iegmn import docking_forward
from equidock_public_tpu_torch.params import (config_path, default_checkpoint, flatten,
                                              init_params, load_checkpoint, unflatten)
from equidock_public_tpu_torch.parallel.halo import (build_halo_batch, make_halo_forward,
                                                     make_halo_loss, make_halo_train_step)
from equidock_public_tpu_torch.parallel.mesh import ParallelMesh
from equidock_public_tpu_torch.train.step import create_train_state, loss_and_grads, train_step

from .torch_utils import f32_default, port_batch  # noqa: F401
from .utils import synth_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (planner options, dp, gp)
TIERS = {"padded_gp2": (dict(gp=2), 4, 2),
         "residual_gp4": (dict(gp=4, spatial=False, hmax=4), 2, 4),
         "ragged_gp2": (dict(gp=2, ragged=True, dp=2), 2, 2)}
LOSS_KEYS = ("loss", "ligand_coors_loss", "receptor_coors_loss", "ot_loss",
             "intersection_loss")


def _setup(rng, fine_tune=False):
    cfg = Config(model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=3,
                                   num_att_heads=4, fine_tune=fine_tune),
                 train=TrainConfig(sinkhorn_iters=50))
    batch = port_batch(synth_batch(rng, B=4, N_l=16, N_r=16, n_l=14, n_r=13,
                                   coord_scale=50.0))
    return cfg, batch, init_params(cfg.model, 0)


def compare_to_dense(out, dense, perm_l):
    torch.testing.assert_close(out["R"], dense["R"], rtol=1e-4, atol=1e-4)
    for key in ("t", "keypts_lig", "keypts_rec"):
        torch.testing.assert_close(out[key], dense[key], rtol=1e-4, atol=1e-3, msg=key)
    for b in range(perm_l.shape[0]):
        torch.testing.assert_close(out["ligand_coords"][b],
                                   dense["ligand_coords"][b][torch.from_numpy(perm_l[b])],
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("fine_tune", [False, True], ids=["one_stage", "fine_tune"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_halo_forward_matches_dense(rng, tier, fine_tune):
    cfg, batch, params = _setup(rng, fine_tune)
    dense = docking_forward(params, cfg.model, batch)
    kw, dp, gp = TIERS[tier]
    hb, stats, perm_l, _ = build_halo_batch(batch, **kw)
    if tier == "residual_gp4":
        assert stats.hres_lig == 4 and stats.sizes_lig[:, 0, 2:].sum() > 0
    out = make_halo_forward(cfg, ParallelMesh(dp, gp, "cpu"))(params, hb)
    compare_to_dense(out, dense, perm_l)
    # (R, t) maps the original input ligand onto the output coordinates
    moved = torch.einsum("bij,bnj->bni", out["R"], hb.pair.lig.x) + out["t"]
    torch.testing.assert_close(moved, out["ligand_coords"], rtol=0, atol=1e-3)


def _rel(got, want):
    return float((got - want).norm()) / max(float(want.norm()), 1e-12)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_halo_gradients_match_dense(rng, tier):
    cfg, batch, params = _setup(rng)
    kw, dp, gp = TIERS[tier]
    hb, _, _, _ = build_halo_batch(batch, **kw)
    halo_loss = make_halo_loss(cfg, ParallelMesh(dp, gp, "cpu"))
    dgrads, dmetrics, _ = loss_and_grads(params, cfg, batch)
    hgrads, hmetrics, _ = loss_and_grads(params, cfg, hb, loss_fn_=halo_loss)
    assert set(hgrads) == set(dgrads)
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(hmetrics[key]), float(dmetrics[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    for key, g in hgrads.items():
        assert torch.isfinite(g).all(), key
        assert _rel(g, dgrads[key]) <= 1e-5, (key, _rel(g, dgrads[key]))


def test_halo_train_step_matches_the_dense_step(rng):
    """make_halo_train_step: the same optimizer step as train_step."""
    cfg, batch, params = _setup(rng)
    hb, _, _, _ = build_halo_batch(batch, gp=2)
    d_state, d_m = train_step(create_train_state(params, cfg, "cpu"), batch, cfg, 0.5)
    step = make_halo_train_step(cfg, ParallelMesh(2, 2, "cpu"))
    h_state, h_m = step(create_train_state(params, cfg, "cpu"), hb, 0.5)
    assert "ligand_coords" not in h_m and h_state.step == 1
    for key in LOSS_KEYS + ("grad_norm", "clipped"):
        np.testing.assert_allclose(float(h_m[key]), float(d_m[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    hp, dpp = flatten(h_state.params), flatten(d_state.params)
    for key, v in hp.items():
        torch.testing.assert_close(v, dpp[key], rtol=0, atol=6 * cfg.train.lr, msg=key)


def test_full_width_halo_forward_matches_dense():
    """The DB5 paper model (64 wide, 5 layers, 50 heads) on the served
    1AVX -> 1N2C request, buckets 512 x 1024, halo gp=2 against dense."""
    params, cfg = load_checkpoint(default_checkpoint())
    with open(os.path.join(REPO, "equidock_public_tpu_torch", "assets",
                           "db5_model_best.golden.json")) as f:
        g = json.load(f)["requests"][0]
    batch = featurize_request(cfg, os.path.join(REPO, g["ligand"]),
                              os.path.join(REPO, g["receptor"]), "cpu").batch
    with torch.inference_mode():
        dense = docking_forward(params, cfg.model, batch)
        hb, stats, perm_l, _ = build_halo_batch(batch, gp=2)
        out = make_halo_forward(cfg, ParallelMesh(1, 2, "cpu"))(params, hb)
    compare_to_dense(out, dense, perm_l)
    # the serving gate against the JAX package's golden values
    np.testing.assert_allclose(out["R"][0].numpy(), g["R"], atol=1e-3)
    np.testing.assert_allclose(out["t"][0, 0].numpy(), g["t"], atol=1e-2)
    assert stats.bytes_per_layer(64) < stats.full_gather_bytes_per_layer(64, 512, 1024, 1)


def test_what_the_halo_path_does_not_take_raises(rng):
    cfg, batch, params = _setup(rng)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A9\)"):
        ParallelMesh(1, 2, ["cpu", "meta"])
    assert ParallelMesh(1, 2, ["cpu", "cpu"]).device == torch.device("cpu")
    gn = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, final_h_layer_norm="GN"))
    with pytest.raises(NotImplementedError, match="GraphNorm"):
        make_halo_forward(gn, ParallelMesh(1, 2, "cpu"))
    drop = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.1))
    with pytest.raises(NotImplementedError, match="dropout"):
        make_halo_forward(drop, ParallelMesh(1, 2, "cpu"))
    hb, _, _, _ = build_halo_batch(batch, gp=2)
    with pytest.raises(ValueError, match="split"):
        make_halo_forward(cfg, ParallelMesh(3, 2, "cpu"))(params, hb)
    hbr, _, _, _ = build_halo_batch(batch, gp=2, ragged=True, dp=2)
    with pytest.raises(ValueError, match="ragged plan"):
        make_halo_forward(cfg, ParallelMesh(4, 2, "cpu"))(params, hbr)
    state = create_train_state(params, cfg, "cpu")
    meta = dataclasses.replace(state, params=unflatten({k: v.to("meta")
                                                        for k, v in flatten(params).items()}))
    with pytest.raises(ValueError, match="train state on meta"):
        make_halo_train_step(cfg, ParallelMesh(1, 2, "cpu"))(meta, hb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ParallelMesh(1, 2)              # the card unless the caller asks otherwise


def test_config_accepts_the_parallel_section():
    from equidock_public_tpu_torch.config import config_from_dict

    cfg = load_config(config_path(default_checkpoint()))
    d = dataclasses.asdict(cfg)
    d["parallel"] = {"dp": 1, "gp": 1, "mesh_axis_names": ["data", "graph"],
                     "pallas_ring_halo": True}
    assert config_from_dict(d) == cfg       # one shard: the section is not read
    d["parallel"]["gp"] = 2
    with pytest.raises(NotImplementedError, match="mesh training"):
        config_from_dict(d)
