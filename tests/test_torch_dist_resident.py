"""dp-resident epochs (`train/resident.py::build_resident_split_dp`,
`run_train_epoch_resident_dp`) across ranks, after the pattern of
`tests/test_resident_dp.py`:

* the store's layout (each group's pairs dealt to dp shards, the shards
  padded with copies of their first pair) and the per-shard schedule equal
  the JAX package's bit for bit; the stacked store holds JAX's arrays;
* two epochs on 2 ranks (each its shard of the store, the augmentation
  drawn for the whole batch and sliced, the loss renormalised by the valid
  count summed over the data group, the gradients summed before the
  optimizer) reproduce the one-process run on the stacked store with the
  same schedule and draws: parameters within 2e-5, the averages within
  2e-4 relative (`tests/test_resident_dp.py`'s gates), with uneven shards
  (3 and 2 pairs); the ranks' parameters bit-equal;
* `fit` with -device_resident -dp 2 on 2 ranks trains and checkpoints.
Every launch runs under a 120 s limit with one intra-op thread a rank.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from equidock_public_tpu.data.dataset import DockingDataset as JaxDataset
from equidock_public_tpu.parallel.mesh import make_mesh
from equidock_public_tpu.train import resident as jres
from equidock_public_tpu_torch.data.dataset import DockingDataset
from equidock_public_tpu_torch.data.synth import write_synth_split
from equidock_public_tpu_torch.params import params_from_numpy
from equidock_public_tpu_torch.parallel.launch import run_ranks
from equidock_public_tpu_torch.parallel.mesh import ParallelMesh
from equidock_public_tpu_torch.train import resident as tres

from .torch_utils import f32_default, port_config  # noqa: F401
from .utils import tiny_config

TIMEOUT_S = 120
RANKS = dict(timeout_s=TIMEOUT_S, device="cpu")     # every launch: its limit, the CPU
# 5 pairs in one 16-node bucket: dp 2 shards hold (3, 2) pairs
SIZES = [(10, 14), (12, 15), (9, 11), (13, 8), (11, 12)]


def _setup(tmp_path):
    jcfg = tiny_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, bs=4),
                               data=dataclasses.replace(jcfg.data, node_buckets=(16, 32),
                                                        pocket_buckets=(8, 16)))
    cache = write_synth_split(str(tmp_path / "train.npz"), SIZES, seed=3, k=4)
    return jcfg, port_config(jcfg), cache


def test_the_store_and_schedule_are_jax(tmp_path):
    jcfg, cfg, cache = _setup(tmp_path)
    jrs = jres.build_resident_split_dp(JaxDataset(jcfg, "train", cache_path=cache), jcfg,
                                       make_mesh(2, 1, devices=jax.devices()[:2]))
    rs = tres.build_resident_split_dp(DockingDataset.from_cache(cfg, "train", cache_path=cache),
                                      cfg, ParallelMesh(2, 1, "cpu"))
    assert rs.n_locs == jrs.n_locs and rs.p_loc == jrs.p_loc and rs.n_locs[16] == [3, 2]
    for b, g in rs.groups.items():
        jg = jrs.groups[b]
        for side in ("lig", "rec"):
            for f in tres._SIDE_FIELDS:
                np.testing.assert_array_equal(getattr(getattr(g, side), f).numpy(),
                                              np.asarray(getattr(getattr(jg, side), f)))
        for f in ("gt_lig", "gt_rec", "pocket", "pocket_mask"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f)))
    for seed in (0, 11):
        got = tres._schedule_dp(rs.n_locs[16], 2, np.random.default_rng(seed))
        want = jres._schedule_dp(jrs.n_locs[16], 2, np.random.default_rng(seed))
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)


def test_dp_epochs_on_two_ranks_match_the_stacked_run(tmp_path):
    from equidock_public_tpu.models import iegmn as jm

    _, cfg, cache = _setup(tmp_path)
    params = params_from_numpy(jax.tree.map(np.asarray, jm.init_docking_model(
        jax.random.PRNGKey(0), tiny_config().model)), cfg.model)
    from .torch_dist_bodies import resident_dp_epochs
    from equidock_public_tpu_torch.parallel.dist import World

    payload = dict(cfg=cfg, dp=2, cache=cache, params=params, epochs=2)
    want = resident_dp_epochs(World(), payload)
    got = run_ranks("tests.torch_dist_bodies:resident_dp_epochs", 2, payload,
                    **RANKS)
    assert want["rows"] == {16: 6} and [g["rows"] for g in got] == [{16: 3}, {16: 3}]
    for r in got:
        for k, v in r["params"].items():
            np.testing.assert_allclose(v.numpy(), want["params"][k].numpy(), atol=2e-5,
                                       err_msg=k)
            assert torch.equal(v, got[0]["params"][k]), k
        for e in range(2):
            a, w = r["averages"][e], want["averages"][e]
            assert a["num_batches"] == w["num_batches"] == 2    # ceil(3 / 2)
            for k in ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss",
                      "complex_rmsd_median"):
                np.testing.assert_allclose(a[k], w[k], rtol=2e-4, err_msg=f"epoch {e} {k}")


def test_fit_dp_resident_on_two_ranks(tmp_path):
    _, cfg, _ = _setup(tmp_path)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, patience=3, val_repeats=2),
        data=dataclasses.replace(cfg.data, device_resident=True, cache_dir=str(tmp_path / "c")),
        parallel=dataclasses.replace(cfg.parallel, dp=2),
        checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"))
    os.makedirs(cfg.cache_path(), exist_ok=True)
    for split in ("train", "val", "test"):
        write_synth_split(os.path.join(cfg.cache_path(), f"{split}.npz"), SIZES, seed=7, k=4)
    got = run_ranks("tests.torch_dist_bodies:fit_run", 2, dict(cfg=cfg, epochs=2),
                    **RANKS)
    lead = got[0]
    assert any("dp-resident epochs: pair axis sharded over dp=2 ranks (gloo)" in ln
               for ln in lead["logs"])
    assert len(lead["history"]) == 3 and np.isfinite(lead["history"][1]["train"]["loss"])
    assert os.path.exists(os.path.join(cfg.checkpoint_dir, cfg.banner(), "db5_model_best"))
    for k, v in got[1]["params"].items():
        assert torch.equal(v, lead["params"][k]), k
    with pytest.raises(ValueError, match="drop -gp or -device_resident"):
        from equidock_public_tpu_torch.train.loop import check_fit_supported

        check_fit_supported(dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, dp=1, gp=2)))
