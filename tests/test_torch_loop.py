"""The port's epoch loop (`train/loop.py`) against the JAX package's, on a
synthetic cache the JAX package writes, from the same weights, with the
fused intersection loss on both sides (the JAX side runs its Pallas kernel
in interpret mode, the port the plain versions of rows 6 and 7):

* one `run_train_epoch`: the average loss terms within 1e-4 relative, and
  the same num_batches and num_clips;
* one `run_eval_epoch`: the loss terms and the RMSD medians within 1e-4
  relative;
* `selection_value` for all four metrics;
* `fit` for 2 epochs: the per-epoch train and val numbers within 1e-4
  relative, the same best epoch, and the final test numbers of the best
  checkpoint reloaded.

The tolerance covers f32 sums in other orders, carried over a few Adam
steps. The JAX side runs its products at "highest" precision (see
tests/test_torch_softmin_field.py)."""

import dataclasses
import os

import jax
import numpy as np
import pytest

from equidock_public_tpu.config import DataConfig as JaxDataConfig
from equidock_public_tpu.data import synth as jsynth
from equidock_public_tpu.data.dataset import DockingDataset as JaxDataset
from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.train import loop as jloop
from equidock_public_tpu.train import step as js
from equidock_public_tpu_torch.data.dataset import DockingDataset
from equidock_public_tpu_torch.params import params_from_numpy
from equidock_public_tpu_torch.train import loop as tloop
from equidock_public_tpu_torch.train import step as ts

from .torch_utils import f32_default, port_config  # noqa: F401
from .utils import tiny_config

SIZES = [(10, 14), (12, 20), (9, 11), (20, 25), (15, 18)]
LOSS_KEYS = ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss")
RTOL = 1e-4


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _setup(tmp_path):
    """(JAX config, port config, params as numpy) with the three split
    caches written under tmp_path."""
    jcfg = tiny_config()
    jcfg = dataclasses.replace(
        jcfg, train=dataclasses.replace(jcfg.train, bs=2, sinkhorn_iters=20,
                                        use_fused_intersection=True, patience=5),
        data=JaxDataConfig(node_buckets=(32,), pocket_buckets=(16,),
                           cache_dir=str(tmp_path / "cache")),
        checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"))
    for i, split in enumerate(("train", "val", "test")):
        jsynth.write_synth_split(os.path.join(jcfg.cache_path(), f"{split}.npz"),
                                 SIZES, seed=7 + i, k=4)
    params = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(0), jcfg.model))
    return jcfg, port_config(jcfg), params


def _close(got, want, keys, what):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=f"{what} {k}")


def test_train_and_eval_epochs_match_jax(tmp_path):
    jcfg, pcfg, params = _setup(tmp_path)
    jstate = js.create_train_state(jax.tree.map(jax.numpy.array, params), jcfg)
    pstate = ts.create_train_state(params_from_numpy(params, pcfg.model), pcfg, "cpu")
    jds, pds = JaxDataset(jcfg, "train"), DockingDataset.from_cache(pcfg, "train")
    rj, rp = np.random.default_rng(3), np.random.default_rng(3)
    jstate, jtr = jloop.run_train_epoch(jstate, jds, jcfg, rj, jax.random.PRNGKey(0), 0,
                                        log=lambda *a: None, lr_scale=0.5)
    pstate, ptr = tloop.run_train_epoch(pstate, pds, pcfg, rp, 0, log=lambda *a: None,
                                        lr_scale=0.5)
    _close(ptr, jtr, LOSS_KEYS + ("complex_rmsd_median", "complex_rmsd_mean"), "train")
    assert (ptr["num_batches"], ptr["num_clips"]) == (jtr["num_batches"], jtr["num_clips"]) \
        == (3, jtr["num_clips"])
    jva = jloop.run_eval_epoch(jstate.params, JaxDataset(jcfg, "val", swap=False), jcfg, rj)
    pva = tloop.run_eval_epoch(pstate.params, DockingDataset.from_cache(pcfg, "val", swap=False),
                               pcfg, rp)
    assert set(pva) == set(jva)
    _close(pva, jva, list(jva), "val")


@pytest.mark.parametrize("metric", ["crmsd", "irmsd", "sum", "bar"])
def test_selection_value_matches(metric):
    for va in ({"complex_rmsd_median": 13.0, "interface_rmsd_median": 12.5},
               {"complex_rmsd_median": 15.1, "interface_rmsd_median": 10.0}):
        assert tloop.selection_value(va, metric) == jloop.selection_value(va, metric)
    with pytest.raises(ValueError, match="select_metric"):
        tloop.selection_value({}, "loss")


def test_fit_two_epochs_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("orbax.checkpoint")
    monkeypatch.chdir(tmp_path)              # the JAX loop writes ./tb_logs
    jcfg, pcfg, params = _setup(tmp_path)
    pcfg = dataclasses.replace(pcfg, checkpoint_dir=str(tmp_path / "port_ckpt"),
                               log_dir=str(tmp_path / "port_logs"))
    want = {"train": [], "eval": [], "best": []}
    train_epoch, eval_epoch, save = jloop.run_train_epoch, jloop.run_eval_epoch, \
        jloop.save_checkpoint

    def record(store, fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            store.append(out[1] if isinstance(out, tuple) else out)
            return out
        return wrapper

    monkeypatch.setattr(jloop, "run_train_epoch", record(want["train"], train_epoch))
    monkeypatch.setattr(jloop, "run_eval_epoch", record(want["eval"], eval_epoch))
    monkeypatch.setattr(jloop, "save_checkpoint",
                        lambda path, state, cfg, epoch: (want["best"].append(epoch),
                                                         save(path, state, cfg, epoch)))
    jloop.fit(jcfg, js.create_train_state(jax.tree.map(jax.numpy.array, params), jcfg),
              max_epochs=2, log=lambda *a: None)
    history = []
    state = tloop.fit(pcfg, ts.create_train_state(params_from_numpy(params, pcfg.model), pcfg,
                                                  "cpu"),
                      max_epochs=2, log=lambda *a: None, device="cpu", history=history)
    assert len(history) == 3 and len(want["train"]) == 2 and len(want["eval"]) == 3
    for epoch in range(2):
        _close(history[epoch]["train"], want["train"][epoch],
               LOSS_KEYS + ("complex_rmsd_median",), f"epoch {epoch} train")
        _close(history[epoch]["val"], want["eval"][epoch],
               LOSS_KEYS + ("complex_rmsd_median", "interface_rmsd_median"),
               f"epoch {epoch} val")
    assert history[-1]["best_epoch"] == want["best"][-1]
    _close(history[-1]["test"], want["eval"][2],
           LOSS_KEYS + ("complex_rmsd_median", "interface_rmsd_median"), "test")
    best = os.path.join(pcfg.checkpoint_dir, pcfg.banner(), "db5_model_best")
    assert os.path.exists(best) and os.path.exists(best + ".config.json")
    lines = open(os.path.join(pcfg.log_dir, pcfg.banner() + ".scalars.jsonl")).readlines()
    assert len(lines) == 2
    assert state.step == 3 * (want["best"][-1] + 1)     # the best checkpoint's state


def test_unported_loop_options_raise(tmp_path):
    """Auto buckets are ported: `fit` resolves each ladder from the three
    splits as the JAX package's `fit` does (`auto_node_buckets` of each
    pair's larger side, or of the pocket sizes at align 32 and quad_at
    256), logs it and trains an epoch on it
    (tests/test_torch_auto_buckets.py holds the ladders to JAX's at more
    sizes and steps)."""
    from equidock_public_tpu.config import auto_node_buckets as jax_auto

    jcfg, pcfg, _ = _setup(tmp_path)
    jsets = [JaxDataset(jcfg, s) for s in ("train", "val", "test")]
    pairs = [d.pair_max_nodes(i) for d in jsets for i in range(len(d.codes))]
    pockets = [d.pocket_size(i) for d in jsets for i in range(len(d.codes))]
    want = {"auto_buckets_max": f"auto node buckets (1 steps): {jax_auto(pairs, 1)}",
            "auto_pocket_max": "auto pocket buckets (1 steps): "
                               f"{jax_auto(pockets, 1, align=32, quad_at=256)}"}
    for field in ("auto_pocket_max", "auto_buckets_max"):
        cfg = dataclasses.replace(pcfg, data=dataclasses.replace(pcfg.data, **{field: 1}))
        logged, history = [], []
        tloop.fit(cfg, max_epochs=1, device="cpu", history=history,
                  log=lambda *a: logged.append(" ".join(map(str, a))))
        assert want[field] in logged
        assert len(history) == 2 and np.isfinite(history[0]["train"]["loss"])
