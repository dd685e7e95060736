"""The port's DIPS -> DB5 curriculum (`train/loop.py::curriculum`) and `fit`
on DIPS shards, on the CPU at tiny width:

* the stages are the JAX package's: DIPS at lr 2e-4 and patience 100, then
  DB5 at lr 1e-4 and patience 500 from the DIPS stage's best state; `toy`
  runs the DB5 stage alone;
* the curriculum with streamed, device-resident DIPS epochs runs both
  stages, writes both best checkpoints and carries the optimizer state
  over;
* a streamed-resident DIPS fit equals the whole-resident fit of the same
  shards loaded whole (1e-6), and both the streamed and the loaded host-loop
  DIPS fits run to a finite test.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from equidock_public_tpu.config import Config as JConfig
from equidock_public_tpu.train import loop as jloop
from equidock_public_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from equidock_public_tpu_torch.data.synth import write_synth_shards, write_synth_split
from equidock_public_tpu_torch.params import flatten
from equidock_public_tpu_torch.train import loop
from equidock_public_tpu_torch.train.checkpoint import load_checkpoint

from .torch_utils import f32_default, port_config  # noqa: F401

SIZES = [(10, 14), (12, 15), (9, 11), (13, 8), (18, 20)]


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfg(tmp_path, **data_kw):
    dk = dict(node_buckets=(16, 32), pocket_buckets=(8, 16), cache_dir=str(tmp_path / "cache"))
    dk.update(data_kw)
    return Config(model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=2,
                                    num_att_heads=4),
                  train=TrainConfig(bs=3, sinkhorn_iters=20, num_epochs=1, trim_remainder=True,
                                    use_fused_intersection=True),
                  data=DataConfig(**dk), checkpoint_dir=str(tmp_path / "ckpt"),
                  log_dir=str(tmp_path / "logs"))


def write_corpora(cfg):
    """DIPS shards (4 train shards of 6 pairs, one val and one test shard)
    and DB5 npz caches under cfg's cache_dir."""
    dips = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data="dips"))
    for i, (split, n) in enumerate((("train", 4), ("val", 1), ("test", 1))):
        write_synth_shards(dips.cache_path(), split, n_shards=n, per_shard=6, seed=i)
    db5 = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data="db5"))
    for i, split in enumerate(("train", "val", "test")):
        write_synth_split(os.path.join(db5.cache_path(), f"{split}.npz"), SIZES, seed=i, k=4)
    return dips


@pytest.mark.parametrize("toy", [False, True])
def test_the_stages_are_the_jax_ones(monkeypatch, toy):
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jloop, "fit", lambda cfg, state, log=None: seen["jax"].append(cfg))
    monkeypatch.setattr(loop, "fit", lambda cfg, state, **kw: seen["port"].append(cfg))
    jcfg = JConfig()
    jloop.curriculum(jcfg, toy=toy, log=lambda *a: None)
    loop.curriculum(port_config(jcfg), toy=toy, log=lambda *a: None)
    assert len(seen["port"]) == len(seen["jax"]) == (1 if toy else 2)
    for p, j in zip(seen["port"], seen["jax"]):
        assert p == port_config(j)
        assert (p.data.data, p.train.lr, p.train.patience) == (
            j.data.data, j.train.lr, j.train.patience)


def test_the_curriculum_streams_dips_then_trains_db5(tmp_path):
    cfg = _cfg(tmp_path, device_resident=True, stream_dips=True, stream_window=1)
    write_corpora(cfg)
    history = []
    state = loop.curriculum(cfg, device="cpu", history=history, log=lambda *a: None)
    assert [h["stage"] for h in history if "stage" in h] == ["dips", "db5"]
    epochs = [h for h in history if "epoch" in h]
    assert len(epochs) == 2 and all("resident_mb" in h for h in epochs)
    assert all(np.isfinite(h["test"]["loss"]) for h in history if "test" in h)
    ckpt = os.path.join(cfg.checkpoint_dir, cfg.banner())
    dips_state, dips_cfg, _ = load_checkpoint(os.path.join(ckpt, "dips_model_best"), "cpu")
    assert dips_cfg.data.data == "dips" and dips_cfg.train.lr == 2e-4
    steps = [h["train"]["num_batches"] for h in epochs]
    assert dips_state.step == steps[0]
    assert state.step == steps[0] + steps[1]      # the DB5 stage went on from it


def test_a_streamed_resident_dips_fit_equals_the_whole_resident_fit(tmp_path):
    cfg = _cfg(tmp_path, data="dips", device_resident=True, stream_window=1)
    write_corpora(cfg)
    states, hist = [], []
    for stream in (True, False):
        c = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, stream_dips=stream),
                                checkpoint_dir=str(tmp_path / f"ckpt{stream}"))
        h = []
        states.append(loop.fit(c, max_epochs=2, device="cpu", history=h, log=lambda *a: None))
        hist.append(h)
    for a, b in zip(*hist):
        for part in ("train", "val", "test"):
            if part in a:
                np.testing.assert_allclose(a[part]["loss"], b[part]["loss"], rtol=1e-6)
    b = flatten(states[1].params)
    for k, v in flatten(states[0].params).items():
        np.testing.assert_allclose(v.numpy(), b[k].numpy(), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("stream", [True, False])
def test_a_host_loop_dips_fit_runs(tmp_path, stream):
    cfg = _cfg(tmp_path, data="dips", stream_dips=stream, stream_window=2)
    write_corpora(cfg)
    history = []
    loop.fit(cfg, max_epochs=1, device="cpu", history=history, log=lambda *a: None)
    assert history[0]["train"]["num_batches"] == 8        # 24 pairs, bs 3
    assert np.isfinite(history[-1]["test"]["loss"])
