"""Training steps across ranks (processes with gloo groups on the CPU)
against the JAX package's mesh steps and the port's one-process step.

* A dp 2 step (`parallel/train.py::make_parallel_train_step`, each rank
  B/dp rows) and a dp 2 x gp 2 halo step (`make_halo_train_step` across 4
  ranks, each data group's own halo batch) against one JAX mesh step,
  `make_parallel_train_step(shard_nodes=True)` on `make_mesh(2, 2)`: the
  step `fit` takes at dp 2 x gp 2, which equals its dp 2 step and its
  one-device step (the JAX package's `tests/test_parallel.py`);
  `tests/test_torch_halo_jax_step.py` holds the halo step to JAX's own
  halo step.
  Both: the loss terms and the gradient norm within 1e-5 relative, and
  every leaf's move (new minus old parameters) within 1e-5 of its norm
  (`tests/test_torch_halo_jax_step.py`'s gates). With gp 2 the head's
  gradients are whole on each rank and the trunk's a shard's part: a
  step that summed the head's gp times would move it twice as far.
* One full-width dp 2 step (the paper model on 4 complexes of the training
  golden's batch at 512) against the port's one-process step from the same
  state: loss terms and gradient norm within 1e-5 relative (C8: a step
  against a step).
* Every rank ends each step with the same bits: each rank's sha256 of its
  parameters' bytes gathered to every rank, and the returned parameters
  compared directly.
Every launch runs under a 120 s limit with one intra-op thread a rank.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from equidock_public_tpu.parallel.train import make_parallel_train_step
from equidock_public_tpu.train import step as js
from equidock_public_tpu_torch.params import flatten, load_checkpoint, params_from_numpy
from equidock_public_tpu_torch.parallel.halo import build_halo_batch
from equidock_public_tpu_torch.parallel.input_pipeline import slice_rows
from equidock_public_tpu_torch.parallel.launch import run_ranks
from equidock_public_tpu_torch.train.step import create_train_state, train_step

from . import torch_golden as tg
from .test_torch_train_step import _golden, port_train_batch
from .torch_utils import f32_default, port_batch, port_config  # noqa: F401
from .utils import synth_batch, tiny_config

TIMEOUT_S = 120
RANKS = dict(timeout_s=TIMEOUT_S, device="cpu")     # every launch: its limit, the CPU
LOSS_KEYS = ("loss", "ligand_coors_loss", "receptor_coors_loss", "ot_loss",
             "intersection_loss", "grad_norm")


def _same_bits_on_every_rank(results):
    for r in results:
        assert len(set(r["digests"])) == 1     # every rank's sha256 of its bits
        assert r["digests"] == results[0]["digests"]
        for k, v in r["params"].items():
            assert torch.equal(v, results[0]["params"][k]), k


def _held_to_jax(rank, jmetrics, j0, j1, p0):
    for key in LOSS_KEYS:
        np.testing.assert_allclose(rank["metrics"][0][key], float(jmetrics[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    assert "ligand_coords" not in rank["metrics"][0]
    for key, v in rank["params"].items():
        move = v.numpy().astype(np.float64) - p0[key].numpy()
        want = j1[key].astype(np.float64) - j0[key]
        assert np.linalg.norm(want) > 0, key
        assert np.linalg.norm(move - want) <= 1e-5 * np.linalg.norm(want), key


def jax_mesh_step(jcfg, jp, batch, key):
    """JAX's mesh step of `fit` at dp 2 x gp 2 (`make_parallel_train_step`
    with the node axis sharded; packed batches with their slots over
    'data') from a fresh state: (state, metrics)."""
    packed = getattr(batch, "seg_mask", None) is not None
    with jax.default_matmul_precision("highest"):
        mesh = make_mesh(2, 2, devices=jax.devices()[:4])
        with mesh:
            state = js.create_train_state(jax.tree.map(jnp.asarray, jp), jcfg)
            state = jax.tree.map(lambda x: replicate(x, mesh), state)
            step = make_parallel_train_step(jcfg, mesh, shard_nodes=True, packed=packed,
                                            n_segs=batch.n_segs if packed else 1)
            return step(state, shard_batch(batch, mesh, shard_nodes=True), key,
                        jnp.asarray(1.0))


@pytest.fixture(scope="module")
def tiny_runs():
    """One 4-rank launch: a dp 2 step on ranks 0-1, then a dp 2 x gp 2 halo
    step on all 4; with JAX's mesh step on the same state and batch."""
    rng = np.random.default_rng(5)
    jcfg = tiny_config(iegmn_n_lays=3)
    pcfg = port_config(jcfg)
    jp = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(0), jcfg.model))
    batch = synth_batch(rng, B=4, N_l=16, N_r=16, n_l=14, n_r=13, coord_scale=50.0)
    jstate, jmetrics = jax_mesh_step(jcfg, jp, batch, jax.random.PRNGKey(1))
    params = params_from_numpy(jp, pcfg.model)
    pb = port_batch(batch)
    hbs = [build_halo_batch(slice_rows(pb, slice(g * 2, g * 2 + 2)), gp=2)[0] for g in range(2)]
    runs = [("tests.torch_dist_bodies:dp_steps", 2,
             dict(dp=2, gp=1, cfg=pcfg, params=params, batches=[pb])),
            ("tests.torch_dist_bodies:halo_steps", 4,
             dict(dp=2, gp=2, cfg=pcfg, params=params, hbs=hbs))]
    got = run_ranks("tests.torch_dist_bodies:several", 4, dict(runs=runs), **RANKS)
    flat = lambda t: flatten(jax.tree.map(np.asarray, t))
    return dict(params=params, j0=flat(jp),
                dp=([g[0] for g in got[:2]], jmetrics, flat(jstate.params)),
                halo=([g[1] for g in got], jmetrics, flat(jstate.params)))


@pytest.mark.parametrize("path", ["dp", "halo"])
def test_steps_across_ranks_match_jax_mesh_steps(tiny_runs, path):
    ranks, jmetrics, j1 = tiny_runs[path]
    p0 = flatten(tiny_runs["params"])
    for r in ranks:
        assert r["step"] == 1
        _held_to_jax(r, jmetrics, tiny_runs["j0"], j1, p0)


@pytest.mark.parametrize("path", ["dp", "halo"])
def test_every_rank_ends_the_step_with_the_same_bits(tiny_runs, path):
    _same_bits_on_every_rank(tiny_runs[path][0])


@pytest.fixture()
def one_thread():
    """The parent's full-width step on one intra-op thread, as the ranks'
    (several test workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_full_width_dp_step_matches_the_one_process_step(one_thread):
    golden = _golden()
    params, cfg = load_checkpoint(tg.os.path.join(tg.ASSETS, "db5_model_best.pt.xz"))
    batch = slice_rows(port_train_batch(golden, cfg), slice(0, 4))   # 2 a rank
    assert tuple(batch.lig.x.shape[:2]) == (4, 512)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, bs=4))
    _, want = train_step(create_train_state(params, cfg, "cpu"), batch, cfg)
    got = run_ranks("tests.torch_dist_bodies:dp_steps", 2,
                    dict(dp=2, gp=1, cfg=cfg, params=params, batches=[batch]),
                    **RANKS)
    for r in got:
        for key in LOSS_KEYS:
            np.testing.assert_allclose(r["metrics"][0][key], float(want[key]), rtol=1e-5,
                                       err_msg=key)
    _same_bits_on_every_rank(got)
    assert dataclasses.asdict(cfg.parallel) == {"dp": 1, "gp": 1, "pallas_ring_halo": False,
                                                "mesh_axis_names": ("data", "graph")}


def test_what_a_step_across_ranks_does_not_take_raises():
    """Graph shards train through the halo step, not the dp one. 'BN' and
    dropout models train across ranks (tests/test_torch_dist_options.py):
    here their stacked dp 2 steps run. The head's leaves are named."""
    from equidock_public_tpu_torch.models.layers import Dropout
    from equidock_public_tpu_torch.parallel.mesh import ParallelMesh
    from equidock_public_tpu_torch.parallel.train import head_leaf, make_parallel_train_step

    cfg = port_config(tiny_config())
    with pytest.raises(ValueError, match="make_halo_train_step"):
        make_parallel_train_step(cfg, ParallelMesh(1, 2, "cpu"))
    batch = port_batch(synth_batch(np.random.default_rng(0), B=2))
    for model_kw in (dict(layer_norm="BN"), dict(dropout=0.1)):
        c = port_config(tiny_config(**model_kw))
        p = params_from_numpy(jax.tree.map(np.asarray, jm.init_docking_model(
            jax.random.PRNGKey(0), tiny_config(**model_kw).model)), c.model)
        drop = Dropout(0.1, torch.Generator().manual_seed(0)) if c.model.dropout else None
        state, m = make_parallel_train_step(c, ParallelMesh(2, 1, "cpu"))(
            create_train_state(p, c, "cpu"), batch, 1.0, drop)
        assert state.step == 1 and np.isfinite(float(m["loss"]))
        assert bool(state.bn_state) == ("layer_norm" in model_kw)
    heads = {k for k in flatten(params_from_numpy(jax.tree.map(
        np.asarray, jm.init_docking_model(jax.random.PRNGKey(0), tiny_config().model)),
        cfg.model)) if head_leaf(k)}
    assert heads and all(k.split("/")[1] in ("mlp_h_mean_rot", "att_key_rot", "att_query_rot")
                         for k in heads)
