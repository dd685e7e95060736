"""One training step of the port against the JAX package.

* The whole step on `tests/utils.py::tiny_config` / `synth_batch` against
  the JAX `train_step`, three steps from identical params: the loss terms,
  the gradient norm and `clipped` per step (rtol 1e-5; the Sinkhorn fixed
  point amplifies f32 rounding, so its term rtol 1e-4), each leaf's
  gradient (relative norm error 1e-4), and the updated params (absolute
  6 * lr: the first Adam step moves an element by about +-lr whatever its
  gradient's size, so an element whose gradient is near zero may move the
  other way in one of the two).
* One step at full width, the DB5 paper model from its committed weights
  on the golden batch of ten split chains, against
  `equidock_public_tpu_torch/assets/db5_train_step.golden.json` (written
  from the JAX package by `python -m tests.torch_golden`), with the
  tolerances stated in that file.
* Options outside the slice raise. (That every parameter leaf gets a
  finite gradient through the kernels on a CUDA card is a test of
  `tests/test_torch_cuda.py`, which imports no JAX and so runs on the
  card's machine.)
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.train import step as js
from equidock_public_tpu_torch import config as tc
from equidock_public_tpu_torch.graph import batch_digest, digests_agree
from equidock_public_tpu_torch.params import flatten, load_checkpoint, params_from_numpy
from equidock_public_tpu_torch.train import step as ts

from . import torch_golden as tg
from .torch_utils import f32_default, port_batch  # noqa: F401
from .utils import synth_batch, tiny_config

LOSS_KEYS = ("loss", "ligand_coors_loss", "receptor_coors_loss", "ot_loss",
             "intersection_loss")


def _port_cfg(jcfg, **data):
    train = {f.name: getattr(jcfg.train, f.name) for f in dataclasses.fields(tc.TrainConfig)}
    return tc.Config(model=tc.ModelConfig(**dataclasses.asdict(jcfg.model)),
                     train=tc.TrainConfig(**train), data=tc.DataConfig(**data))


def _rel(got, want):
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-12)


def test_tiny_steps_match_jax(rng):
    """The paper's lr and w_decay, a clip the gradient exceeds (its norm is
    about 60), and an epoch factor of 0.5."""
    lr_scale = 0.5
    jcfg = tiny_config(shared_layers=True)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, lr=2e-4, w_decay=1e-3, clip=20.0))
    pcfg = _port_cfg(jcfg)
    batch = synth_batch(rng, N_l=16, N_r=24, n_l=12, n_r=19)
    jp = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(0), jcfg.model))
    pb = port_batch(batch)

    jgrads = flatten(jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: js.loss_fn(p, jcfg, batch, None, True)[0]))(jp)))
    pgrads, _, _ = ts.loss_and_grads(params_from_numpy(jp, pcfg.model), pcfg, pb)
    assert set(pgrads) == set(jgrads)
    for k, g in pgrads.items():
        assert _rel(g.numpy(), jgrads[k]) <= 1e-4, k

    jstate = js.create_train_state(jp, jcfg)
    pstate = ts.create_train_state(params_from_numpy(jp, pcfg.model), pcfg, "cpu")
    for i in range(3):
        jstate, jm_ = js.train_step(jstate, batch, jax.random.PRNGKey(i), jcfg, lr_scale)
        pstate, pm_ = ts.train_step(pstate, pb, pcfg, lr_scale)
        for key in LOSS_KEYS + ("grad_norm", "clipped"):
            rtol = 1e-4 if key in ("ot_loss", "loss") else 1e-5
            np.testing.assert_allclose(float(pm_[key]), float(jm_[key]), rtol=rtol,
                                       atol=1e-6, err_msg=f"step {i} {key}")
        np.testing.assert_allclose(pm_["ligand_coords"].numpy(),
                                   np.asarray(jm_["ligand_coords"]), atol=1e-3)
    assert float(pm_["clipped"]) == 1.0
    jflat = flatten(jax.tree.map(np.asarray, jstate.params))
    for k, v in flatten(pstate.params).items():
        np.testing.assert_allclose(v.numpy(), jflat[k], rtol=0,
                                   atol=6 * pcfg.train.lr, err_msg=k)
    assert pstate.step == 3


def _golden():
    with open(tg.TRAIN_GOLDEN) as f:
        return json.load(f)


def port_train_batch(golden, cfg, device="cpu"):
    """The golden batch built by the port alone: the recorded chains, cut
    and featurized by the port, through its DockingDataset under the
    recorded seed."""
    from equidock_public_tpu_torch.data.dataset import DockingDataset, split_chain_complex
    from equidock_public_tpu_torch.data.featurize import filter_residues
    from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb

    samples = [split_chain_complex(filter_residues(group_residues(read_pdb(
        os.path.join(tg.REPO, tg.pdb_path(code))))), cfg.graph) for code in golden["codes"]]
    ds = DockingDataset(cfg, samples)
    return next(ds.batches(np.random.default_rng(golden["seed"]), device=device))


def test_full_width_step_matches_the_golden_file():
    golden = _golden()
    params, cfg = load_checkpoint(tg.os.path.join(tg.ASSETS, "db5_model_best.pt.xz"))
    assert dataclasses.asdict(cfg.train) == {
        k: v for k, v in golden["train"].items() if k in dataclasses.asdict(cfg.train)}
    batch = port_train_batch(golden, cfg)
    assert digests_agree(batch_digest(batch), golden["batch_digest"]) == []
    assert tuple(batch.lig.x.shape[:2]) == (10, 512) and batch.rec.x.shape[1] == 512
    tol = golden["tolerance"]
    grads, metrics, _ = ts.loss_and_grads(params, cfg, batch)
    want = golden["steps"][0]
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(metrics[key]), want[key],
                                   rtol=tol["loss_rtol_step1"], atol=tol["loss_atol"],
                                   err_msg=key)
    assert set(grads) == set(golden["grad_norms_step1"])
    for key, g in grads.items():
        np.testing.assert_allclose(float(g.norm()), golden["grad_norms_step1"][key],
                                   rtol=tol["leaf_grad_norm_rtol"], atol=1e-6, err_msg=key)
    state = ts.create_train_state(params, cfg, "cpu")
    _, gnorm = ts.apply_gradients(state, grads, cfg)
    np.testing.assert_allclose(float(gnorm), want["grad_norm"], rtol=tol["grad_norm_rtol"])
    assert float(gnorm > cfg.train.clip) == want["clipped"]


@pytest.mark.parametrize("section,field,value", [
    ("train", "ot_solver", "exact"),
    ("train", "freeze_original", True), ("data", "pack", True),
    ("model", "dropout", 0.1), ("model", "fine_tune", True), ("model", "remat", True),
    ("model", "layer_norm", "BN"), ("model", "dtype", "bfloat16")])
def test_options_outside_the_slice_raise(section, field, value):
    """Every option here is ported (slices 7 and 8; `tests/test_torch_options.py`,
    `test_torch_bn.py`, `test_torch_finetune.py`, `test_torch_packing.py`
    and, for bf16 operands, `test_torch_bf16.py` hold them to the JAX
    package): a train state is made, with BatchNorm statistics for 'BN'
    only, and f32 parameters and moments at bf16."""
    cfg = tc.Config()
    cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section),
                                                                   **{field: value})})
    state = ts.create_train_state({}, cfg, "cpu")
    assert bool(state.bn_state) == (field == "layer_norm")
    assert all(v["mean"].shape == v["var"].shape and (v["var"] == 1).all()
               for v in state.bn_state.values())


def test_batch_and_state_on_other_devices_raise(rng):
    jcfg = tiny_config()
    pcfg = _port_cfg(jcfg)
    jp = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(0), jcfg.model))
    state = ts.create_train_state(params_from_numpy(jp, pcfg.model), pcfg, "cpu")
    batch = port_batch(synth_batch(rng))
    batch.lig.x = batch.lig.x.to("meta")
    with pytest.raises(ValueError, match="batch on meta"):
        ts.train_step(state, batch, pcfg)
