"""`fit`'s mesh path, its config and CLI, against the JAX package's mesh
`fit` (`tests/test_loop_mesh.py`'s runs).

* `fit` at dp 2 on 2 ranks (processes with gloo groups) against JAX's
  `fit` on `make_mesh(2, 1)`, unpacked and packed (slot-count buckets
  rounded to multiples of dp), from the same weights on the same caches:
  every parameter within rtol 2e-4, atol 2e-5 and the final test CRMSD
  median within 1e-2 (`tests/test_loop_mesh.py`'s gates); both ranks end
  with the same bits; rank 0 alone logs. One epoch at one node bucket
  (32: every synthetic chain of 8-17 nodes fits it), so that JAX compiles
  one train and one eval step a run: its compiles are what the test's time
  goes to.
* The world-1 stacked form: dp 2 x gp 2 `fit` in one process (the halo
  step on stacked shards) against the port's one-device `fit`, same gates.
* The training CLI across 2 ranks (`-dp 2`, the ranks joined as torchrun
  would): exit 0, rank 0's checkpoint and log.
* A JAX sidecar with a `parallel` section and `debug` loads.
Every launch runs under a 120 s limit with one intra-op thread a rank.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from equidock_public_tpu.config import (Config, DataConfig, ModelConfig, ParallelConfig,
                                        TrainConfig)
from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.train import step as js
from equidock_public_tpu.train.loop import fit as jax_fit
from equidock_public_tpu_torch.config import config_from_dict
from equidock_public_tpu_torch.params import flatten, params_from_numpy
from equidock_public_tpu_torch.parallel.launch import run_ranks
from equidock_public_tpu_torch.train import loop as tloop
from equidock_public_tpu_torch.train import step as ts

from .test_curriculum import _synth_split
from .torch_dist_bodies import run_module_ranks
from .torch_utils import f32_default, port_config  # noqa: F401

TIMEOUT_S = 120
RANKS = dict(timeout_s=TIMEOUT_S, device="cpu")     # every launch: its limit, the CPU


def _cfg(tmp_path, dp, gp, tag, pack=False):
    return Config(
        model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=2,
                          num_att_heads=4),
        train=TrainConfig(sinkhorn_iters=20, bs=4, num_epochs=2, val_repeats=1, lr=1e-3),
        data=DataConfig(cache_dir=str(tmp_path / "cache"), node_buckets=(32,),
                        pocket_buckets=(8,), pack=pack, pack_max_per_slot=2,
                        slot_count_buckets=(2, 4)),
        parallel=ParallelConfig(dp=dp, gp=gp),
        checkpoint_dir=str(tmp_path / f"ckpt_{tag}"), log_dir=str(tmp_path / f"logs_{tag}"))


def _write_caches(cfg, seed, n_train):
    rng = np.random.default_rng(seed)
    os.makedirs(cfg.cache_path(), exist_ok=True)
    for split, n in (("train", n_train), ("val", 4), ("test", 4)):
        np.savez(os.path.join(cfg.cache_path(), f"{split}.npz"), **_synth_split(rng, n))


def _final_test(lines):
    line = [ln for ln in lines if "[FINAL TEST" in ln][0]
    return float(line.split("crmsd med ")[1].split()[0])


@pytest.fixture(scope="module")
def mesh_fits(tmp_path_factory):
    """JAX's mesh fits and the port's on 2 ranks (one launch), unpacked and
    packed, from the same weights."""
    tmp = tmp_path_factory.mktemp("dist_fit")
    runs, want = [], {}
    for pack, seed, n in ((False, 0, 8), (True, 1, 10)):
        tag = "packed" if pack else "unpacked"
        jcfg = _cfg(tmp / tag, 2, 1, "jax", pack=pack)
        _write_caches(jcfg, seed, n)
        jp = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(0), jcfg.model))
        logs = []
        with jax.default_matmul_precision("highest"):
            state = jax_fit(jcfg, js.create_train_state(jax.tree.map(jax.numpy.array, jp), jcfg),
                            max_epochs=1, log=lambda *a: logs.append(" ".join(map(str, a))))
        want[tag] = (flatten(jax.tree.map(np.asarray, state.params)), logs)
        pcfg = dataclasses.replace(port_config(jcfg), checkpoint_dir=str(tmp / tag / "port_ckpt"),
                                   log_dir=str(tmp / tag / "port_logs"))
        runs.append(("tests.torch_dist_bodies:fit_run", 2,
                     dict(cfg=pcfg, epochs=1, params=params_from_numpy(jp, pcfg.model))))
    got = run_ranks("tests.torch_dist_bodies:several", 2, dict(runs=runs), **RANKS)
    return want, {"unpacked": [g[0] for g in got], "packed": [g[1] for g in got]}


@pytest.mark.parametrize("tag", ["unpacked", "packed"])
def test_fit_on_two_ranks_matches_jax_mesh_fit(mesh_fits, tag):
    want, got = mesh_fits
    jparams, jlogs = want[tag]
    for r in got[tag]:
        for k, v in r["params"].items():
            np.testing.assert_allclose(v.numpy(), jparams[k], rtol=2e-4, atol=2e-5, err_msg=k)
            assert torch.equal(v, got[tag][0]["params"][k]), k     # the same bits
    lead, other = got[tag]
    assert abs(_final_test(lead["logs"]) - _final_test(jlogs)) < 1e-2
    assert any("mesh training: dp=2 x gp=1 over 2 ranks (gloo)" in ln for ln in lead["logs"])
    assert other["logs"] == []                                    # rank 0 alone logs
    # the mesh step returns no coordinates: the train RMSD reads nan (None
    # in the JSON scalars), as in the JAX package's mesh path
    assert len(lead["history"]) == 2                         # 1 epoch and the test
    assert lead["history"][0]["train"]["complex_rmsd_median"] is None
    if tag == "packed":
        assert any("packed mesh training: slot-count buckets -> (2, 4)" in ln
                   for ln in lead["logs"])


def test_the_stacked_dp_gp_fit_matches_one_device(tmp_path):
    jcfg = _cfg(tmp_path, 1, 1, "single")
    _write_caches(jcfg, 0, 8)
    one = port_config(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jm.init_docking_model(
        jax.random.PRNGKey(0), jcfg.model)), one.model)
    logs = []
    s1 = tloop.fit(one, ts.create_train_state(params, one, "cpu"), max_epochs=2, device="cpu",
                   log=lambda *a: None)
    mesh = dataclasses.replace(one, parallel=dataclasses.replace(one.parallel, dp=2, gp=2),
                               checkpoint_dir=str(tmp_path / "ckpt_mesh"))
    s2 = tloop.fit(mesh, ts.create_train_state(params, mesh, "cpu"), max_epochs=2, device="cpu",
                   log=lambda *a: logs.append(" ".join(map(str, a))))
    assert any("mesh training: dp=2 x gp=2 stacked in one process" in ln for ln in logs)
    f1 = flatten(s1.params)
    for k, v in flatten(s2.params).items():
        np.testing.assert_allclose(v.numpy(), f1[k].numpy(), rtol=2e-4, atol=2e-5, err_msg=k)


def test_the_training_cli_on_two_ranks(tmp_path):
    from equidock_public_tpu_torch.config import Config as PortConfig
    from equidock_public_tpu_torch.config import DataConfig as PortData
    from equidock_public_tpu_torch.data.synth import write_synth_split

    cache = str(tmp_path / "cache")
    cfg = PortConfig(data=PortData(cache_dir=cache))
    for i, split in enumerate(("train", "val", "test")):
        write_synth_split(os.path.join(cfg.cache_path(), f"{split}.npz"),
                          [(10, 14), (12, 16), (9, 11), (14, 12)], seed=i, k=4)
    argv = ["-iegmn_lay_hid_dim", "8", "-residue_emb_dim", "8", "-iegmn_n_lays", "2",
            "-num_att_heads", "4", "-bs", "2", "-node_buckets", "16", "-pocket_buckets", "16",
            "-device", "cpu", "-toy", "-max_epochs", "1", "-dp", "2", "-cache_dir", cache,
            "-checkpoint_dir", str(tmp_path / "ckpt"), "-compile_cache", "unused",
            "-pad_cache_gb", "0.5", "-debug", "-pallas_ring_halo"]
    run_module_ranks("equidock_public_tpu_torch.cli.train", argv, 2, cwd=str(tmp_path),
                     timeout_s=TIMEOUT_S)
    from equidock_public_tpu_torch.cli import train as cli
    from equidock_public_tpu_torch.train.checkpoint import load_checkpoint

    pcfg = cli.config_from_args(cli._parser().parse_args(argv))
    state, saved, _ = load_checkpoint(os.path.join(pcfg.checkpoint_dir, pcfg.banner(),
                                                   "db5_model_best"), "cpu")
    assert saved.parallel.dp == 2 and saved.debug and saved.data.pad_cache_gb == 0.5
    assert state.step == 2                                 # 4 pairs at bs 2
    log = open(tmp_path / "stdouterr" / (pcfg.banner() + ".txt")).read()
    assert "mesh training: dp=2 x gp=1 over 2 ranks (gloo)" in log
    assert "-compile_cache unused: nothing to cache" in log
    assert not (tmp_path / "unused").exists()


def test_a_jax_sidecar_with_a_parallel_section_loads():
    from equidock_public_tpu.train.checkpoint import _config_to_json

    jcfg = dataclasses.replace(_cfg(__import__("pathlib").Path("."), 2, 2, "x"), debug=True,
                               parallel=ParallelConfig(dp=2, gp=2, pallas_ring_halo=True))
    cfg = config_from_dict(json.loads(_config_to_json(jcfg)))
    assert (cfg.parallel.dp, cfg.parallel.gp, cfg.parallel.pallas_ring_halo) == (2, 2, True)
    assert cfg.parallel.mesh_axis_names == ("data", "graph") and cfg.debug
    assert cfg.data.pad_cache_gb == jcfg.data.pad_cache_gb
