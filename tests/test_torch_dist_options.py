"""Everything the JAX package's mesh step trains, on ranks (processes with
gloo groups on the CPU) and on stacked node shards, against the JAX
package:

* BatchNorm with dropout ('BN' layer norm, dropout 0.1) and the 'BN' final
  norm: dp 2 steps on 2 ranks, dp 2 x gp 2 halo steps on 4 ranks and the
  stacked dp 2 x gp 2 halo step, against JAX's mesh step of `fit` at dp 2
  x gp 2 (`make_parallel_train_step(shard_nodes=True)`, which equals its
  dp 2 step and its one-device step). Dropout replays JAX's masks, recorded
  from its one-device training forward with the step's key: a rank takes
  its rows (dp) and its node shard through the halo batch's permutation
  (gp) of every mask. BatchNorm's statistics are the whole batch's: its
  sums go over the ranks. Running statistics within 1e-5 relative of
  JAX's.
* Swish with coordinate LN (configs outside the edge kernel) at gp 2: the
  halo forward against JAX's `make_halo_forward` and the halo step
  against JAX's `make_halo_train_step` on `make_mesh(2, 2)`, stacked and on
  4 ranks.
* A packed step at dp 2 x gp 2 (each slot planned as one graph, the ring
  attention on segment tags) against JAX's packed node-sharded mesh step
  and the port's one-process packed step.
* A fine-tune stage on node shards (dp 2 x gp 2, stacked and on 4 ranks):
  the second stage's input ligand needs a gradient, so on ranks its shards
  come in through `scatter_own` and its backward runs; against the port's
  one-process step.
* Remat in both halo trunks: the remat halo step equals the plain halo
  step bit for bit (the edge kernel path and the plain body with dropout,
  whose masks the recompute replays), stacked and on 4 ranks.
* A dp-resident dropout epoch slice (one group of 4 pairs, one step of 2
  pairs a shard: a step against a step, C8) on 2 ranks and stacked against
  JAX's `run_train_epoch_resident_dp`, its draws and its masks replayed:
  every data rank draws its own rows' shape from the same key, so each
  applies the same pattern.
Gates (`tests/test_torch_dist_train.py`'s): the loss terms and the gradient
norm within 1e-5 relative, every leaf's move within 1e-5 of its norm. Two
kinds of element are held to 2 lr instead, as `tests/test_torch_bn.py`
holds elements whose gradient is within rounding of 0: those of a leaf
whose gradient is rounding noise of a true 0 (below 1e-5 of the gradient
norm in the port's one-process step: the biases in front of the 'BN' final
norm), and those where Adam's first step is not saturated (JAX's move below
0.999 lr: the clipped gradient plus the L2 term lies within 1e-5 of 0, so
f32 rounding of that sum moves the step; in the 'BN' dropout model one
element of 128 in a leaf, which the port's one-process step also moves by
4e-5 of the leaf's norm from JAX's). Every rank ends with the same bits
(parameters and BatchNorm statistics). Every launch runs under a 120 s
limit with one intra-op thread a rank.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu import graph as jg
from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.parallel import halo as jh
from equidock_public_tpu.parallel.mesh import make_mesh, replicate
from equidock_public_tpu.train import step as js
from equidock_public_tpu_torch import graph as tg_
from equidock_public_tpu_torch.models import iegmn as tm
from equidock_public_tpu_torch.models.layers import Dropout
from equidock_public_tpu_torch.params import flatten, params_from_numpy
from equidock_public_tpu_torch.parallel.halo import (build_halo_batch, make_halo_forward,
                                                     make_halo_train_step)
from equidock_public_tpu_torch.parallel.input_pipeline import slice_rows
from equidock_public_tpu_torch.parallel.dist import World
from equidock_public_tpu_torch.parallel.launch import run_ranks
from equidock_public_tpu_torch.parallel.mesh import ParallelMesh
from equidock_public_tpu_torch.train.step import create_train_state, loss_and_grads, train_step

from .test_torch_dist_train import LOSS_KEYS, _same_bits_on_every_rank, jax_mesh_step
from .test_torch_packing import POCKET_BUCKETS, _complexes
from .torch_dist_bodies import resident_dp_epochs
from .torch_utils import f32_default, port_batch, port_config  # noqa: F401
from .utils import synth_batch, tiny_config

TIMEOUT_S = 120
RANKS = dict(timeout_s=TIMEOUT_S, device="cpu")     # every launch: its limit, the CPU
# the configurations held to JAX's mesh step
# (tiny widths; 3 layers where the shared layer's statistics chain over two
# applications)
MESH_MODELS = {"bn_dropout": dict(layer_norm="BN", dropout=0.1, n_lays=3),
               "final_bn": dict(final_h_layer_norm="BN")}
HALO_MODEL = dict(nonlin="swish", layer_norm_coors="LN")
# the packed complexes: 8 in 4 slots of 2 (bucket 32), 2 slots a data group
PACKED_SIZES = ((10, 14), (12, 9), (7, 20), (15, 11), (9, 9), (11, 13), (6, 8), (13, 10))


def _model(seed=0, n_lays=2, **kw):
    jcfg = tiny_config(iegmn_n_lays=n_lays, **kw)
    jp = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(seed), jcfg.model))
    pcfg = port_config(jcfg)
    return jcfg, jp, pcfg, params_from_numpy(jp, pcfg.model)


def record_masks(jcfg, jp, batch, keys, bn_state=None):
    """The keep-masks of the JAX package's training forward on `batch`'s
    shapes with each key of `keys`, in call order (one list a key): its
    `dropout` patched to keep each mask it draws, exactly as
    `models/layers.py::dropout`, the forward traced once with the key as an
    argument (`debug=True` unrolls the layer loop; the keys are the scan's,
    `fold_in(rng, layer)`; `tests/test_torch_options.py` holds replayed
    masks to the scan path's loss and gradients)."""
    masks = []

    def recording(x, rate, rng, train):
        if not train or rate == 0.0 or rng is None:
            return x
        mask = jax.random.bernoulli(rng, 1.0 - rate, x.shape)
        masks.append(mask)
        return jnp.where(mask, x / (1.0 - rate), 0.0)

    def forward(p, key):
        masks.clear()
        jm.docking_forward(p, jcfg.model, batch, rng=key, train=True, bn_state=bn_state,
                           debug=True)
        return list(masks)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jm, "dropout", recording)
        fn = jax.jit(forward)
        return [[np.asarray(x) for x in fn(jp, key)] for key in keys]


def _groups(pb, gp=2, dp=2):
    """Each data group's halo batch of a whole batch (what `fit` builds on a
    rank), and the whole batch's (the stacked form)."""
    Bl = pb.pair_mask.shape[0] // dp
    return ([build_halo_batch(slice_rows(pb, slice(g * Bl, (g + 1) * Bl)), gp)[0]
             for g in range(dp)], build_halo_batch(pb, gp)[0])


def _stacked_step(cfg, params, hb, drop=None):
    state, m = make_halo_train_step(cfg, ParallelMesh(2, 2, "cpu"))(
        create_train_state(params, cfg, "cpu"), hb, 1.0, drop)
    return {"metrics": [{k: float(v) for k, v in m.items()}],
            "params": {k: v.detach() for k, v in flatten(state.params).items()},
            "bn_state": state.bn_state}


def _resident(tmp):
    """A dp-resident dropout epoch of JAX (`run_train_epoch_resident_dp`:
    one group of 4 pairs in shards of 2, one step), its draws and local
    masks for the port: (JAX's outputs, the ranks' payload)."""
    from equidock_public_tpu.data.dataset import DockingDataset as JaxDataset
    from equidock_public_tpu.train import resident as jres
    from equidock_public_tpu_torch.data.synth import write_synth_split

    from .test_torch_dist_resident import SIZES

    jcfg = tiny_config(dropout=0.2)
    jcfg = dataclasses.replace(
        jcfg, train=dataclasses.replace(jcfg.train, bs=4, train_rmsd_fraction=1.0),
        data=dataclasses.replace(jcfg.data, node_buckets=(16, 32), pocket_buckets=(8, 16)))
    cfg = port_config(jcfg)
    cache = write_synth_split(str(tmp / "train.npz"), SIZES[:4], seed=3, k=4)
    jp = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(0), jcfg.model))
    key = jax.random.PRNGKey(7)
    with jax.default_matmul_precision("highest"):
        mesh = make_mesh(2, 1, devices=jax.devices()[:2])
        jrs = jres.build_resident_split_dp(JaxDataset(jcfg, "train", cache_path=cache), jcfg,
                                           mesh)
        jstate, javg = jres.run_train_epoch_resident_dp(
            js.create_train_state(jax.tree.map(jnp.asarray, jp), jcfg), jrs, jcfg, mesh,
            np.random.default_rng(0), key, 0, do_swap=True)
    # the epoch's one scan (its one step metered): the scan's key, the step's
    assert jrs.n_locs[16] == [2, 2]
    _, k_aug, k_step = jax.random.split(jax.random.split(key)[1], 3)
    triples = [tuple(np.asarray(a) for a in jres.draw_augmentations(
        k_aug, 4, True, jcfg.graph.translation_interval))]
    local = synth_batch(np.random.default_rng(0), B=2, N_l=16, N_r=16, K=4)   # a rank's shapes
    masks = record_masks(jcfg, jp, local, [k_step])[0]
    payload = dict(cfg=cfg, dp=2, cache=cache, epochs=1, triples=triples, masks=masks,
                   params=params_from_numpy(jp, cfg.model))
    return dict(jax=(javg, flatten(jax.tree.map(np.asarray, jstate.params))), j0=flatten(jp),
                lr=cfg.train.lr), payload


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """`_runs` on one intra-op thread and with float32 as the default dtype
    (another test module sets float64 at import, and this module-scoped
    fixture runs before the autouse `f32_default`)."""
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    try:
        return _runs(tmp_path_factory.mktemp("dp_resident"))
    finally:
        torch.set_num_threads(threads)
        torch.set_default_dtype(dtype)


def _runs(tmp):
    """JAX's references, one 4-rank launch of every rank case, and the
    stacked forms in this process."""
    out, rank_runs, key = {}, [], jax.random.PRNGKey(1)
    batch = synth_batch(np.random.default_rng(5), B=4, N_l=16, N_r=16, n_l=14, n_r=13,
                        coord_scale=50.0)
    pb = port_batch(batch)
    hbs, hb = _groups(pb)
    # BatchNorm with dropout, and the 'BN' final norm: JAX's mesh step
    for name, kw in MESH_MODELS.items():
        jcfg, jp, pcfg, params = _model(**kw)
        jstate, jmetrics = jax_mesh_step(jcfg, jp, batch, key)
        pl = dict(cfg=pcfg, params=params)
        if pcfg.model.dropout:
            pl["masks"] = record_masks(jcfg, jp, batch, [key],
                                       jm.init_bn_state(jcfg.model))
        drop = Dropout(0.1, masks=pl["masks"][0]) if "masks" in pl else None
        grads, _, _ = loss_and_grads(params, pcfg, pb, drop=drop,
                                     bn_state=tm.init_bn_state(pcfg.model))
        drop = Dropout(0.1, masks=pl["masks"][0]) if "masks" in pl else None
        gnorm = float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))
        out[name] = dict(jax=(jmetrics, jax.tree.map(np.asarray, jstate)), j0=flatten(jp),
                         p0=flatten(params), lr=pcfg.train.lr,
                         null={k for k, g in grads.items() if float(g.norm()) < 1e-5 * gnorm})
        out[name]["stacked"] = _stacked_step(pcfg, params, hb, drop)
        rank_runs += [(name, "dp", "tests.torch_dist_bodies:dp_steps", 2,
                       dict(pl, dp=2, gp=1, batches=[pb])),
                      (name, "halo", "tests.torch_dist_bodies:halo_steps", 4,
                       dict(pl, dp=2, gp=2, hbs=hbs))]
    # swish with coordinate LN: JAX's halo forward and halo step
    jcfg, jp, pcfg, params = _model(**HALO_MODEL)
    jhb = jh.build_halo_batch(batch, gp=2)[0]
    with jax.default_matmul_precision("highest"):
        mesh = make_mesh(2, 2, devices=jax.devices()[:4])
        with mesh:
            jfwd = jax.jit(jh.make_halo_forward(jcfg, mesh))(replicate(jp, mesh),
                                                             jh.shard_halo_batch(jhb, mesh))
            state = jax.tree.map(lambda x: replicate(x, mesh),
                                 js.create_train_state(jax.tree.map(jnp.asarray, jp), jcfg))
            jstate, jmetrics = jh.make_halo_train_step(jcfg, mesh)(
                state, jh.shard_halo_batch(jhb, mesh), key, jnp.asarray(1.0))
    with torch.no_grad():
        stacked_fwd = make_halo_forward(pcfg, ParallelMesh(2, 2, "cpu"))(params, hb)
    out["halo_options"] = dict(jax=(jmetrics, jax.tree.map(np.asarray, jstate)), j0=flatten(jp),
                               p0=flatten(params), lr=pcfg.train.lr, null=set(),
                               jfwd=jax.tree.map(np.asarray, jfwd), stacked_fwd=stacked_fwd,
                               stacked=_stacked_step(pcfg, params, hb))
    rank_runs += [("halo_options", "halo", "tests.torch_dist_bodies:halo_steps", 4,
                   dict(cfg=pcfg, params=params, dp=2, gp=2, hbs=hbs)),
                  ("halo_options", "forward", "tests.torch_dist_bodies:halo_forwards", 4,
                   dict(dp=2, gp=2, hbs=hbs, models=[(pcfg, params)]))]
    # a packed batch: JAX's packed node-sharded mesh step, the one-process step
    jcfg, jp, pcfg, params = _model()
    j, t = _complexes(0, PACKED_SIZES)
    jpb = jg.collate_packed(*j, (32, 64), POCKET_BUCKETS, 3, (4,))
    ppb = tg_.collate_packed(*t, (32, 64), POCKET_BUCKETS, 3, (4,))
    assert ppb.n_segs == 3 and tuple(ppb.lig.x.shape[:2]) == (4, 32)
    jstate, jmetrics = jax_mesh_step(jcfg, jp, jpb, key)
    phbs, phb = _groups(ppb)
    one_state, one_metrics = train_step(create_train_state(params, pcfg, "cpu"), ppb, pcfg)
    out["packed"] = dict(jax=(jmetrics, jax.tree.map(np.asarray, jstate)), j0=flatten(jp),
                         p0=flatten(params), lr=pcfg.train.lr, null=set(),
                         stacked=_stacked_step(pcfg, params, phb),
                         one=(one_metrics, flatten(one_state.params)))
    rank_runs.append(("packed", "halo", "tests.torch_dist_bodies:halo_steps", 4,
                      dict(cfg=pcfg, params=params, dp=2, gp=2, hbs=phbs)))
    # a fine-tune stage on node shards: the port's one-process step
    _, _, pcfg, params = _model(fine_tune=True)
    assert "finetune" in params
    one_state, one_metrics = train_step(create_train_state(params, pcfg, "cpu"), pb, pcfg)
    out["fine_tune"] = dict(p0=flatten(params), lr=pcfg.train.lr,
                            stacked=_stacked_step(pcfg, params, hb),
                            one=(one_metrics, flatten(one_state.params)))
    rank_runs.append(("fine_tune", "halo", "tests.torch_dist_bodies:halo_steps", 4,
                      dict(cfg=pcfg, params=params, dp=2, gp=2, hbs=hbs)))
    # remat: the edge kernel path, and the plain body with dropout (a seeded generator)
    for name, kw in (("remat_kernel", {}), ("remat_dropout", dict(dropout=0.2))):
        _, _, pcfg, params = _model(**kw)
        rcfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model, remat=True))
        assert tm.remat_active(rcfg.model)
        seed = dict(drop_seed=3) if pcfg.model.dropout else {}
        gen = lambda: Dropout(0.2, torch.Generator().manual_seed(3)) if seed else None
        out[name] = dict(stacked=[_stacked_step(c, params, hb, gen()) for c in (pcfg, rcfg)])
        for tag, c in (("plain", pcfg), ("remat", rcfg)):
            rank_runs.append((name, tag, "tests.torch_dist_bodies:halo_steps", 4,
                              dict(seed, cfg=c, params=params, dp=2, gp=2, hbs=hbs)))
    # a dp-resident dropout epoch: JAX's, the stacked form here, ranks 0-1
    out["resident"], payload = _resident(tmp)
    out["resident"]["stacked"] = resident_dp_epochs(World(), payload)
    rank_runs.append(("resident", "ranks", "tests.torch_dist_bodies:resident_dp_epochs", 2,
                      payload))
    got = run_ranks("tests.torch_dist_bodies:several", 4,
                    dict(runs=[r[2:] for r in rank_runs]), **RANKS)
    for i, (name, path) in enumerate(r[:2] for r in rank_runs):
        out[name][path] = [g[i] for g in got if g[i] is not None]
    return out


def _moves_held(params, p0, j0, j1, lr, null=()):
    """Every leaf's move (new minus old parameters) within 1e-5 of JAX's in
    norm; an element of a `null` leaf, or where Adam's first step is not
    saturated (JAX's move below 0.999 lr), within 2 lr."""
    for key, v in params.items():
        move = v.numpy().astype(np.float64) - p0[key].numpy()
        want = j1[key].astype(np.float64) - j0[key]
        held = (np.abs(want) >= 0.999 * lr) & (key not in null)
        assert np.abs(move - want)[~held].max(initial=0.0) <= 2 * lr, key
        if held.any():
            assert np.linalg.norm(want[held]) > 0, key
            assert (np.linalg.norm((move - want)[held])
                    <= 1e-5 * np.linalg.norm(want[held])), key


def _held_to_jax(r, case):
    """One result (a rank's or the stacked step's) within the gates of JAX's
    step: loss terms and gradient norm, every leaf's move, BatchNorm's
    running statistics."""
    jmetrics, jstate = case["jax"]
    for key in LOSS_KEYS:
        np.testing.assert_allclose(r["metrics"][0][key], float(jmetrics[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert "ligand_coords" not in r["metrics"][0]
    _moves_held(r["params"], case["p0"], case["j0"], flatten(jstate.params), case["lr"],
                case["null"])
    if jstate.bn_state:
        assert set(r["bn_state"]) == set(jstate.bn_state)
        for site, st in r["bn_state"].items():
            for k in ("mean", "var"):
                np.testing.assert_allclose(st[k].numpy(), jstate.bn_state[site][k], rtol=1e-5,
                                           atol=1e-7, err_msg=f"{site}/{k}")


@pytest.mark.parametrize("path", ["dp", "halo", "stacked"])
@pytest.mark.parametrize("model", sorted(MESH_MODELS))
def test_bn_and_dropout_steps_match_jax_mesh_step(runs, model, path):
    case = runs[model]
    if model == "final_bn":
        assert case["null"] and all("node_mlp" in k for k in case["null"])
    else:
        assert not case["null"]
    for r in (case[path] if path != "stacked" else [case["stacked"]]):
        _held_to_jax(r, case)


@pytest.mark.parametrize("path", ["dp", "halo"])
@pytest.mark.parametrize("model", sorted(MESH_MODELS) + ["packed", "halo_options"])
def test_every_rank_ends_with_the_same_bits(runs, model, path):
    if path == "dp" and model not in MESH_MODELS:
        path = "halo" if model == "packed" else "forward"
    if path == "forward":            # ranks 2g and 2g + 1 return data group g's outputs
        fwd = runs[model]["forward"]
        for r in range(4):
            for k, v in fwd[r][0].items():
                assert torch.equal(v, fwd[r - r % 2][0][k]), k
        return
    ranks = runs[model][path]
    assert len(ranks) == (2 if path == "dp" else 4)
    _same_bits_on_every_rank(ranks)
    for r in ranks:
        for site, st in r["bn_state"].items():
            for k, v in st.items():
                assert torch.equal(v, ranks[0]["bn_state"][site][k]), (site, k)


@pytest.mark.parametrize("path", ["halo", "stacked"])
def test_halo_options_outside_the_edge_kernel_match_jax(runs, path):
    case = runs["halo_options"]
    for r in (case["halo"] if path == "halo" else [case["stacked"]]):
        _held_to_jax(r, case)
    # a rank returns its data group's rows (rank r: group r // 2)
    fwds = ([(r[0], slice(2 * (i // 2), 2 * (i // 2) + 2)) for i, r in enumerate(case["forward"])]
            if path == "halo" else [(case["stacked_fwd"], slice(None))])
    want = case["jfwd"]
    scale = float(np.abs(want["ligand_coords"]).max())
    for out, rows in fwds:
        np.testing.assert_allclose(out["R"].numpy(), want["R"][rows], atol=1e-5)
        for k in ("t", "keypts_lig", "keypts_rec", "ligand_coords"):
            np.testing.assert_allclose(out[k].numpy(), want[k][rows], atol=1e-5 * scale,
                                       err_msg=k)
    assert not tm.fused_edge_eligible(port_config(tiny_config(**HALO_MODEL)).model, train=True)


def _held_to_one_process(r, case, elementwise=False):
    """One result within the gates of the port's one-process step: loss
    terms and gradient norm, every leaf's move (`elementwise`: as
    `_moves_held` holds them, the elements where Adam's first step is not
    saturated within 2 lr)."""
    one_metrics, one_params = case["one"]
    for key in LOSS_KEYS:
        np.testing.assert_allclose(r["metrics"][0][key], float(one_metrics[key]), rtol=1e-5,
                                   err_msg=key)
    if elementwise:
        _moves_held(r["params"], case["p0"], {k: v.numpy() for k, v in case["p0"].items()},
                    {k: v.numpy() for k, v in one_params.items()}, case["lr"])
        return
    for key, v in r["params"].items():
        move = (v - case["p0"][key]).double()
        want = (one_params[key] - case["p0"][key]).double()
        assert float((move - want).norm()) <= 1e-5 * float(want.norm()), key


@pytest.mark.parametrize("path", ["halo", "stacked"])
def test_a_packed_node_sharded_step_matches_jax_and_the_one_process_step(runs, path):
    case = runs["packed"]
    for r in (case["halo"] if path == "halo" else [case["stacked"]]):
        _held_to_jax(r, case)
        _held_to_one_process(r, case)


@pytest.mark.parametrize("path", ["halo", "stacked"])
def test_a_fine_tune_stage_on_node_shards_matches_the_one_process_step(runs, path):
    case = runs["fine_tune"]
    ranks = case["halo"] if path == "halo" else [case["stacked"]]
    if path == "halo":
        assert len(ranks) == 4
        _same_bits_on_every_rank(ranks)
    for r in ranks:
        # one element of the fine-tune stage's embedding: its clipped gradient
        # plus the L2 term within 1e-5 of 0, Adam's first step 0.99 lr
        _held_to_one_process(r, case, elementwise=True)


@pytest.mark.parametrize("path", ["halo", "stacked"])
@pytest.mark.parametrize("model", ["remat_kernel", "remat_dropout"])
def test_a_remat_halo_step_equals_the_plain_one(runs, model, path):
    case = runs[model]
    pairs = ([case["stacked"]] if path == "stacked"
             else [[p, r] for p, r in zip(case["plain"], case["remat"])])
    for plain, remat in pairs:
        for key in LOSS_KEYS:
            assert plain["metrics"][0][key] == remat["metrics"][0][key], key
        for key, v in plain["params"].items():
            assert torch.equal(v, remat["params"][key]), key


@pytest.mark.parametrize("path", ["ranks", "stacked"])
def test_a_dp_resident_dropout_epoch_matches_jax(runs, path):
    resident_runs = runs["resident"]
    javg, j1 = resident_runs["jax"]
    got = resident_runs["ranks"] if path == "ranks" else [resident_runs["stacked"]]
    for r in got:
        avg = r["averages"][0]
        assert avg["num_batches"] == javg["num_batches"] == 1
        for k in ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss",
                  "complex_rmsd_median"):
            np.testing.assert_allclose(avg[k], javg[k], rtol=1e-5, err_msg=k)
        p0 = {k: torch.from_numpy(v) for k, v in resident_runs["j0"].items()}
        _moves_held(r["params"], p0, resident_runs["j0"], j1, resident_runs["lr"])
    if path == "ranks":
        for k, v in got[1]["params"].items():
            assert torch.equal(v, got[0]["params"][k]), k
