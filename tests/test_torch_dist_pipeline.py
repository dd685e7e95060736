"""The multi-host input pipeline (`parallel/input_pipeline.py`) against
the JAX package's, modelled on `tests/test_parallel.py::
test_multihost_input_pipeline_agrees_on_shapes`: on one synthetic split
cache, the schedules of both packages are equal, every rank's schedule is
the same, each rank's batches are bit-equal to the JAX host's, the ranks'
shapes agree and their complexes cover the epoch once."""

import os

import numpy as np
import pytest
import torch

from equidock_public_tpu.data.dataset import DockingDataset as JaxDataset
from equidock_public_tpu.parallel.input_pipeline import (
    global_batch_schedule as jax_schedule, host_sharded_batches as jax_host_batches)
from equidock_public_tpu_torch.data.dataset import DockingDataset
from equidock_public_tpu_torch.data.synth import write_synth_split
from equidock_public_tpu_torch.parallel.input_pipeline import (global_batch_schedule,
                                                               host_sharded_batches,
                                                               local_rows, slice_rows)

from .torch_utils import port_config
from .utils import tiny_config

SIZES = [(12, 20), (30, 18), (25, 40), (9, 14), (44, 33), (16, 16), (21, 37), (38, 12),
         (27, 27), (13, 50), (35, 22)]


@pytest.fixture()
def datasets(tmp_path):
    import dataclasses

    jcfg = tiny_config()
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, cache_dir=str(tmp_path), node_buckets=(16, 32, 48, 64),
        pocket_buckets=(8, 16)))
    cfg = port_config(jcfg)
    path = os.path.join(cfg.cache_path(), "val.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_synth_split(path, SIZES, seed=3, k=4)
    return JaxDataset(jcfg, "val", swap=False), DockingDataset.from_cache(cfg, "val", swap=False)


def test_schedules_are_jax_and_the_same_on_every_rank(datasets):
    jds, ds = datasets
    want = jax_schedule(jds, np.random.default_rng(7), bs=4)
    for _ in range(2):                        # every rank, from the shared seed
        got = global_batch_schedule(ds, np.random.default_rng(7), bs=4)
        assert len(got) == len(want)
        for (c, shape), (jc, jshape) in zip(got, want):
            np.testing.assert_array_equal(c, jc)
            assert shape == jshape


@pytest.mark.parametrize("ranks", [2, 4])
def test_each_rank_collates_the_jax_hosts_batches(datasets, ranks):
    jds, ds = datasets
    per_rank = [list(host_sharded_batches(ds, np.random.default_rng(7), 4, h, ranks))
                for h in range(ranks)]
    seen = []
    for h, batches in enumerate(per_rank):
        want = list(jax_host_batches(jds, np.random.default_rng(7), 4, process_index=h,
                                     process_count=ranks))
        assert len(batches) == len(want)
        for b, w in zip(batches, want):
            for side in ("lig", "rec"):
                pb, jb = getattr(b, side), getattr(w, side)
                for name in ("res_id", "x", "mu_r_norm", "nbr", "nbr_mask", "edge_feat",
                             "node_mask"):
                    np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                                  np.asarray(getattr(jb, name)),
                                                  err_msg=f"{side}.{name}")
            for name in ("gt_lig", "pocket_lig", "pocket_rec", "pocket_mask", "pair_mask"):
                np.testing.assert_array_equal(getattr(b, name).numpy(),
                                              np.asarray(getattr(w, name)), err_msg=name)
        seen.append(batches)
    for step in zip(*seen):                   # the ranks agree on every shape
        assert len({(b.lig.x.shape, b.rec.x.shape, b.pocket_lig.shape) for b in step}) == 1
    # the complexes cover the epoch once; a rank whose share of a short last
    # chunk is empty repeats the chunk's first complex, as the JAX host does
    empty = sum(1 for chunk, _ in global_batch_schedule(ds, np.random.default_rng(7), 4)
                for h in range(ranks) if len(chunk[h * (4 // ranks):(h + 1) * (4 // ranks)]) == 0)
    valid = sum(int(b.pair_mask.sum()) for batches in seen for b in batches)
    assert valid == len(SIZES) + empty


def test_local_rows_cut_a_batch_as_p_data_does(datasets):
    from equidock_public_tpu_torch.parallel.mesh import ParallelMesh

    _, ds = datasets
    batch = next(ds.batches(np.random.default_rng(1), device="cpu"))
    mesh = ParallelMesh(2, 1, "cpu")
    assert mesh.local_slice(4) == slice(0, 2)
    part = slice_rows(batch, slice(2, 4))
    assert torch.equal(part.lig.x, batch.lig.x[2:4]) and part.n_segs == batch.n_segs
    half = batch.pair_mask.shape[0] // 2
    assert torch.equal(local_rows(batch, mesh).pair_mask, batch.pair_mask[:half])
    with pytest.raises(ValueError, match="split"):
        list(host_sharded_batches(ds, np.random.default_rng(7), 4, 0, 3))
