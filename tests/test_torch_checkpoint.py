"""The port's training checkpoints (`train/checkpoint.py`) and the bridge
from a JAX training state (`params.train_state_from_numpy`):

* a save / load round trip is bit-exact: parameters, Adam moments, step,
  epoch and the whole config;
* resume rule: a step from the reloaded state equals, bit for bit, the step
  from the state that was saved;
* a JAX state after 2 steps, carried over, then one port step, equals the
  JAX package's third step: loss terms rtol 1e-5 (the Sinkhorn term 1e-4),
  parameters within 6 lr (tests/test_torch_train_step.py's limits);
* the sidecar loader reads the whole-config sidecar, the older weight
  files' sections and the JAX package's sidecar."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.train import step as js
from equidock_public_tpu_torch.config import config_from_dict
from equidock_public_tpu_torch.params import flatten, params_from_numpy, train_state_from_numpy
from equidock_public_tpu_torch.train import step as ts
from equidock_public_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

from . import torch_golden as tg
from .torch_utils import f32_default, port_batch, port_config  # noqa: F401
from .utils import synth_batch, tiny_config

LOSS_KEYS = ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss")


def _jax_setup(rng):
    jcfg = tiny_config(shared_layers=True)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, w_decay=1e-3,
                                                               save_every_epochs=3))
    batch = synth_batch(rng, N_l=16, N_r=24, n_l=12, n_r=19)
    params = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(0), jcfg.model))
    return jcfg, port_config(jcfg), batch, params


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in ((flatten(a.params), flatten(b.params)), (a.mu, b.mu), (a.nu, b.nu)):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_round_trip_is_bit_exact_and_resume_steps_alike(rng, tmp_path):
    _, pcfg, batch, params = _jax_setup(rng)
    pb = port_batch(batch)
    state = ts.create_train_state(params_from_numpy(params, pcfg.model), pcfg, "cpu")
    for _ in range(2):
        state, _ = ts.train_step(state, pb, pcfg)
    path = str(tmp_path / "run" / "db5_model_best")
    save_checkpoint(path, state, pcfg, epoch=4)
    loaded, cfg, epoch = load_checkpoint(path, "cpu")
    assert epoch == 4 and cfg == pcfg
    _assert_states_equal(loaded, state)
    after_saved, m1 = ts.train_step(state, pb, pcfg)
    after_loaded, m2 = ts.train_step(loaded, pb, pcfg)
    _assert_states_equal(after_loaded, after_saved)
    for k in LOSS_KEYS:
        assert float(m1[k]) == float(m2[k])
    save_checkpoint(path, after_saved, pcfg, epoch=5)     # overwrites in place
    assert load_checkpoint(path, "cpu")[2] == 5


def test_a_jax_state_carried_over_steps_as_the_jax_package(rng):
    jcfg, pcfg, batch, params = _jax_setup(rng)
    jstate = js.create_train_state(jax.tree.map(jax.numpy.array, params), jcfg)
    for i in range(2):
        jstate, _ = js.train_step(jstate, batch, jax.random.PRNGKey(i), jcfg, 1.0)
    host = jax.tree.map(np.asarray, jstate)
    pstate = train_state_from_numpy(host.params, host.opt_state, host.step, pcfg.model)
    assert pstate.step == 2
    jstate, jm_ = js.train_step(jstate, batch, jax.random.PRNGKey(2), jcfg, 1.0)
    pstate, pm_ = ts.train_step(pstate, port_batch(batch), pcfg)
    for key in LOSS_KEYS + ("grad_norm",):
        rtol = 1e-4 if key in ("ot_loss", "loss") else 1e-5
        np.testing.assert_allclose(float(pm_[key]), float(jm_[key]), rtol=rtol, atol=1e-6,
                                   err_msg=key)
    jflat = flatten(jax.tree.map(np.asarray, jstate.params))
    for k, v in flatten(pstate.params).items():
        np.testing.assert_allclose(v.numpy(), jflat[k], rtol=0, atol=6 * pcfg.train.lr,
                                   err_msg=k)


def test_train_state_from_numpy_checks_the_adam_count(rng):
    jcfg, pcfg, _, params = _jax_setup(rng)
    host = jax.tree.map(np.asarray, js.create_train_state(params, jcfg))
    with pytest.raises(ValueError, match="Adam count"):
        train_state_from_numpy(host.params, host.opt_state, 3, pcfg.model)


def test_sidecars_of_both_packages_load(tmp_path):
    with open(tg.CHECKPOINT + ".config.json") as f:
        jax_sidecar = json.load(f)
    cfg = config_from_dict(jax_sidecar)
    assert cfg.train.patience == jax_sidecar["train"]["patience"]
    assert config_from_dict(dataclasses.asdict(cfg)) == cfg
    older = {k: jax_sidecar[k] for k in ("model", "graph")}
    older["data"] = {k: jax_sidecar["data"][k] for k in ("node_buckets", "pocket_buckets",
                                                         "swap_train")}
    older["train"] = {k: v for k, v in jax_sidecar["train"].items() if k != "patience"}
    old = config_from_dict(older)
    assert old.model == cfg.model and old.data.node_buckets == cfg.data.node_buckets
    with pytest.raises(NotImplementedError, match="mesh"):
        config_from_dict(dict(jax_sidecar, parallel={"dp": 2, "gp": 1}))


def test_other_files_are_refused(tmp_path):
    path = tmp_path / "weights"
    torch.save({"params": {}}, path)
    (tmp_path / "weights.config.json").write_text(json.dumps(dataclasses.asdict(
        port_config(tiny_config()))))
    with pytest.raises(ValueError, match="format"):
        load_checkpoint(str(path), "cpu")
