"""Packed batches of the port against the JAX package (the port's versions
of `tests/test_packing.py`'s cases):

* the planner (`plan_packing`, `packed_shape`, `_plan_cost`) and
  `collate_packed` are the JAX package's bit for bit, and so are the
  dataset's packed batches under one numpy seed;
* the packed forward equals the JAX package's on the same packed batch
  (with and without a fine-tune stage), and equals the port's unpacked
  forward complex by complex;
* the packed loss terms, the meter and one train step agree with JAX's;
* GraphNorm with packing raises by name, as in the JAX package;
* at full width, three packed steps of the DB5 paper model on the split
  chains against `assets/db5_train_step_packed.golden.json` (JAX's steps,
  written by `python -m tests.torch_golden packed`), and the packed steps
  equal the unpacked golden steps on the same complexes.

Tolerances: bit-equal for integer and host arrays; forward coordinates
atol 1e-3 A and R 1e-4 (f32 in two summation orders through five layers
and a Kabsch fit); loss terms rtol 1e-5 (the Sinkhorn term 1e-4, its fixed
point amplifies rounding); each leaf's gradient 1e-4 relative norm;
packed against unpacked as the JAX package's own test (2e-3)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from equidock_public_tpu import graph as jg
from equidock_public_tpu.data.featurize import ProteinGraph as JGraph
from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.train import losses as jl
from equidock_public_tpu.train import meter as jmeter
from equidock_public_tpu.train import step as js
from equidock_public_tpu_torch import graph as tg_
from equidock_public_tpu_torch.data.featurize import ProteinGraph as TGraph
from equidock_public_tpu_torch.data.synth import synth_graph
from equidock_public_tpu_torch.graph import batch_digest, digests_agree
from equidock_public_tpu_torch.models import iegmn as tm
from equidock_public_tpu_torch.params import flatten, load_checkpoint, params_from_numpy
from equidock_public_tpu_torch.train import losses as tl
from equidock_public_tpu_torch.train import step as ts
from equidock_public_tpu_torch.train.meter import RmsdMeter

from . import torch_golden as tgold
from .torch_utils import f32_default, port_batch, port_config  # noqa: F401
from .utils import tiny_config

BUCKETS = (32, 64, 128)
POCKET_BUCKETS = (8, 16)
SIZES = ((10, 14), (12, 9), (7, 20), (15, 11))
LOSS_KEYS = ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (small ops: no contention with the other
    workers), and float32 as the default dtype for the module's fixtures
    too (another test module sets float64 at import)."""
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _complexes(seed=0, sizes=SIZES):
    """The same complexes for both packages: (JAX items, port items), each
    (ligs, recs, new_xs, gts, pockets_lig, pockets_rec)."""
    rng = np.random.default_rng(seed)
    j, t = [[] for _ in range(6)], [[] for _ in range(6)]
    for nl, nr in sizes:
        dl, dr = synth_graph(rng, nl, k=4), synth_graph(rng, nr, k=4)
        e = np.zeros(0, np.int32)
        j[0].append(JGraph(**dl, src=e, dst=e))
        j[1].append(JGraph(**dr, src=e, dst=e))
        t[0].append(TGraph(**dl))
        t[1].append(TGraph(**dr))
        new_x = dl["x"] + rng.standard_normal((nl, 3)).astype(np.float32)
        p = rng.standard_normal((5, 3)).astype(np.float32)
        for items in (j, t):
            items[2].append(new_x)
            items[3].append(dl["x"])
            items[4].append(p)
            items[5].append(p + 0.5)
    return j, t


def _assert_packed_equal(got, want):
    """A port PairBatch equal, field by field, to a JAX packed one."""
    w = port_batch(want)
    assert got.n_segs == w.n_segs
    for side in ("lig", "rec"):
        for f in dataclasses.fields(tg_.ProteinBatch):
            np.testing.assert_array_equal(getattr(getattr(got, side), f.name).numpy(),
                                          getattr(getattr(w, side), f.name).numpy(),
                                          err_msg=f"{side}.{f.name}")
    for f in ("gt_lig", "pocket_lig", "pocket_rec", "pocket_mask", "pair_mask", "seg_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(w, f).numpy(), err_msg=f)


@pytest.mark.parametrize("seed,max_per_slot", [(1, 4), (2, 3), (3, 2)])
def test_the_planner_is_the_jax_packages(seed, max_per_slot):
    rng = np.random.default_rng(seed)
    slot_buckets = tuple(range(1, 21))
    for n in (3, 10, 20):
        nl, nr = rng.integers(5, 60, n).tolist(), rng.integers(5, 60, n).tolist()
        want = jg.plan_packing(nl, nr, BUCKETS, max_per_slot, slot_buckets)
        got = tg_.plan_packing(nl, nr, BUCKETS, max_per_slot, slot_buckets)
        assert got == want
        assert (tg_.packed_shape(got, nl, nr, BUCKETS, slot_buckets)
                == jg.packed_shape(want, nl, nr, BUCKETS, slot_buckets))
        assert (tg_._plan_cost(got, nl, nr, BUCKETS, slot_buckets)
                == jg._plan_cost(want, nl, nr, BUCKETS, slot_buckets))
        assert sorted(i for s in got for i in s) == list(range(n))


@pytest.mark.parametrize("max_per_slot,slots", [(2, (2, 4)), (3, (1, 2, 3, 4))])
def test_collate_packed_is_the_jax_packages(max_per_slot, slots):
    j, t = _complexes(seed=4)
    want = jg.collate_packed(*j, BUCKETS, POCKET_BUCKETS, max_per_slot, slots)
    got = tg_.collate_packed(*t, BUCKETS, POCKET_BUCKETS, max_per_slot, slots)
    _assert_packed_equal(got, want)
    # the pad tail: self-loops, the last segment id, tag (seg + 1) * mask 0
    lig = got.lig
    pad = lig.node_mask == 0
    assert (lig.seg_id[pad] == max_per_slot - 1).all()
    assert ((lig.seg_id.float() + 1) * lig.node_mask)[pad].eq(0).all()
    assert batch_digest(got)["n_segs"]["sha256"] == str(max_per_slot)


def test_the_datasets_packed_batches_are_the_jax_packages(tmp_path):
    from equidock_public_tpu.config import Config as JConfig
    from equidock_public_tpu.data.dataset import DockingDataset as JDataset
    from equidock_public_tpu.data.synth import write_synth_split
    from equidock_public_tpu_torch.data.dataset import DockingDataset

    sizes = [(10, 14), (12, 9), (7, 20), (15, 11), (30, 8), (9, 9), (11, 13)]
    cache = write_synth_split(str(tmp_path / "train.npz"), sizes, seed=2, k=4)
    jcfg = JConfig()
    jcfg = dataclasses.replace(
        jcfg, data=dataclasses.replace(jcfg.data, pack=True, pack_max_per_slot=3,
                                       node_buckets=BUCKETS, pocket_buckets=POCKET_BUCKETS),
        train=dataclasses.replace(jcfg.train, bs=4))
    want = list(JDataset(jcfg, "train", cache_path=cache).batches(np.random.default_rng(0)))
    got = list(DockingDataset.from_cache(port_config(jcfg), "train", cache_path=cache)
               .batches(np.random.default_rng(0), device="cpu"))
    assert len(got) == len(want) == 2
    total = 0
    for g, w in zip(got, want):
        _assert_packed_equal(g, w)
        total += int(g.seg_mask.sum())
        assert torch.equal(g.lig.seg_onehot(3).sum(-1), g.lig.node_mask)
    assert total == len(sizes)


def _models(fine_tune):
    jcfg = tiny_config(fine_tune=fine_tune)
    jp = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(0), jcfg.model))
    pcfg = port_config(jcfg)
    return jcfg, jp, pcfg, params_from_numpy(jp, pcfg.model)


@pytest.mark.parametrize("fine_tune", [False, True])
def test_the_packed_forward_is_the_jax_packages(fine_tune):
    jcfg, jp, pcfg, pp = _models(fine_tune)
    j, t = _complexes()
    jb = jg.collate_packed(*j, BUCKETS, POCKET_BUCKETS, 2, (2, 4))
    want = jax.jit(lambda b: jm.docking_forward(jp, jcfg.model, b))(jb)
    got = tm.docking_forward(pp, pcfg.model, tg_.collate_packed(*t, BUCKETS, POCKET_BUCKETS,
                                                                2, (2, 4)))
    m = np.asarray(jb.lig.node_mask)[..., None]
    np.testing.assert_allclose(got["ligand_coords"].numpy() * m,
                               np.asarray(want["ligand_coords"]) * m, atol=1e-3)
    seg = np.asarray(jb.seg_mask) > 0
    for k, atol in (("R", 1e-4), ("t", 1e-3), ("keypts_lig", 1e-3), ("keypts_rec", 1e-3)):
        np.testing.assert_allclose(got[k].numpy()[seg], np.asarray(want[k])[seg], atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("fine_tune", [False, True])
def test_the_packed_forward_equals_the_unpacked_one(fine_tune):
    _, _, pcfg, pp = _models(fine_tune)
    _, t = _complexes()
    unpacked = tg_.collate(*t, BUCKETS, POCKET_BUCKETS, "cpu")
    packed = tg_.collate_packed(*t, BUCKETS, POCKET_BUCKETS, 2, (2, 4))
    out_u = tm.docking_forward(pp, pcfg.model, unpacked)
    out_p = tm.docking_forward(pp, pcfg.model, packed)
    seg_l, mask_l = packed.lig.seg_id.numpy(), packed.lig.node_mask.numpy()
    matched = 0
    for i, g in enumerate(t[0]):
        for b in range(packed.seg_mask.shape[0]):
            for c in range(packed.n_segs):
                idx = np.where((mask_l[b] > 0) & (seg_l[b] == c))[0]
                if (packed.seg_mask[b, c] == 0 or len(idx) != g.num_nodes
                        or not np.allclose(packed.lig.x[b, idx].numpy(), t[2][i])):
                    continue
                np.testing.assert_allclose(out_p["ligand_coords"][b, idx].numpy(),
                                           out_u["ligand_coords"][i, :g.num_nodes].numpy(),
                                           atol=2e-3)
                for k in ("R", "t"):
                    np.testing.assert_allclose(out_p[k][b, c].numpy(), out_u[k][i].numpy(),
                                               atol=2e-3)
                matched += 1
    assert matched == len(t[0])


def test_the_packed_loss_and_meter_are_the_jax_packages():
    jcfg, jp, pcfg, pp = _models(False)
    j, t = _complexes(seed=3)
    jb = jg.collate_packed(*j, BUCKETS, POCKET_BUCKETS, 3, (1, 2, 3, 4))
    pb = tg_.collate_packed(*t, BUCKETS, POCKET_BUCKETS, 3, (1, 2, 3, 4))
    _, want = jax.jit(lambda b: jl.total_loss(jm.docking_forward(jp, jcfg.model, b), b,
                                              jcfg.train))(jb)
    _, got = tl.total_loss(tm.docking_forward(pp, pcfg.model, pb), pb, pcfg.train)
    for k in LOSS_KEYS:
        rtol = 1e-4 if k in ("ot_loss", "loss") else 1e-5
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-6,
                                   err_msg=k)
    # the loss is the unpacked one: the same complexes, one a slot
    ub = tg_.collate(*t, BUCKETS, POCKET_BUCKETS, "cpu")
    _, unpacked = tl.total_loss(tm.docking_forward(pp, pcfg.model, ub), ub, pcfg.train)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(unpacked[k]), rtol=1e-3, err_msg=k)
    # the meter, on the input pose, complex by complex
    jmet, tmet = jmeter.RmsdMeter(), RmsdMeter()
    jmet.update_batch(jb, np.asarray(jb.lig.x), meter_interface=True)
    tmet.update_batch(pb, pb.lig.x.numpy(), meter_interface=True)
    np.testing.assert_allclose(tmet.complex, jmet.complex, rtol=1e-6)
    np.testing.assert_allclose(tmet.interface, jmet.interface, rtol=1e-6)
    assert len(tmet.complex) == len(SIZES)


def _rel(got, want):
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-12)


def test_a_packed_train_step_is_the_jax_packages():
    jcfg, jp, pcfg, pp = _models(False)
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, pack=True,
                                                              pack_max_per_slot=3))
    pcfg = port_config(jcfg)
    j, t = _complexes(seed=7)
    jb = jg.collate_packed(*j, BUCKETS, POCKET_BUCKETS, 3)
    pb = tg_.collate_packed(*t, BUCKETS, POCKET_BUCKETS, 3)
    jgrads = flatten(jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: js.loss_fn(p, jcfg, jb, None, True)[0]))(jp)))
    jstate, jmetrics = js.train_step(js.create_train_state(jax.tree.map(jax.numpy.array, jp),
                                                           jcfg), jb, jax.random.PRNGKey(3),
                                     jcfg, 1.0)
    pstate = ts.create_train_state(pp, pcfg, "cpu")
    grads, _, _ = ts.loss_and_grads(pstate.params, pcfg, pb)
    for k, g in grads.items():
        assert _rel(g.numpy(), jgrads[k]) <= 1e-4, k
    pstate, pmetrics = ts.train_step(pstate, pb, pcfg)
    for k in LOSS_KEYS + ("grad_norm",):
        rtol = 1e-4 if k in ("ot_loss", "loss") else 1e-5
        np.testing.assert_allclose(float(pmetrics[k]), float(jmetrics[k]), rtol=rtol, err_msg=k)
    jp1 = flatten(jax.tree.map(np.asarray, jstate.params))
    lr = jcfg.train.lr
    for k, v in flatten(pstate.params).items():
        np.testing.assert_allclose(v.numpy(), jp1[k], atol=2 * lr, err_msg=k)


def test_graph_norm_with_packing_raises_by_name():
    jcfg, jp, _, _ = _models(False)
    pcfg = port_config(tiny_config(final_h_layer_norm="GN"))
    pp = params_from_numpy(jax.tree.map(np.asarray, jm.init_docking_model(
        jax.random.PRNGKey(0), tiny_config(final_h_layer_norm="GN").model)), pcfg.model)
    _, t = _complexes()
    with pytest.raises(ValueError, match="GN"):
        tm.docking_forward(pp, pcfg.model, tg_.collate_packed(*t, BUCKETS, POCKET_BUCKETS, 2))
    from equidock_public_tpu_torch.train.loop import check_fit_supported

    packed = dataclasses.replace(pcfg, data=dataclasses.replace(pcfg.data, pack=True))
    with pytest.raises(ValueError, match="-pack with final_h_layer_norm='GN'"):
        check_fit_supported(packed)


# --------------------------------------------------------------------------- #
# Full width: the DB5 paper model's packed steps against the JAX golden
# --------------------------------------------------------------------------- #

def test_full_width_packed_steps_match_the_golden_file():
    from .test_torch_train_step import port_train_batch

    with open(tgold.PACKED_GOLDEN) as f:
        golden = json.load(f)
    with open(tgold.TRAIN_GOLDEN) as f:
        unpacked = json.load(f)
    params, cfg = load_checkpoint(os.path.join(tgold.ASSETS, "db5_model_best.pt.xz"))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, pack=True, pack_max_per_slot=golden["pack_max_per_slot"]))
    batch = port_train_batch(golden, cfg)
    assert batch.n_segs == golden["pack_max_per_slot"]
    assert digests_agree(batch_digest(batch), golden["batch_digest"]) == []
    tol = golden["tolerance"]
    state = ts.create_train_state(params, cfg, "cpu")
    p0 = {k: v.clone() for k, v in flatten(state.params).items()}
    for i, want in enumerate(golden["steps"]):
        state, m = ts.train_step(state, batch, cfg)
        rtol = tol["loss_rtol_step1"] if i == 0 else tol["loss_rtol_later"]
        for key in LOSS_KEYS + ("grad_norm",):
            r = tol["grad_norm_rtol"] if key == "grad_norm" else rtol
            np.testing.assert_allclose(float(m[key]), want[key], rtol=r, atol=tol["loss_atol"],
                                       err_msg=f"step {i + 1} {key}")
    atol = tol["delta_norm_atol_lr"] * cfg.train.lr
    for key, v in flatten(state.params).items():
        want = golden["delta_norms_last"][key]
        assert abs(float((v - p0[key]).norm()) - want) <= tol["delta_norm_rtol"] * want + atol
    # the JAX package's packed steps are its unpacked steps on the same complexes
    for key in LOSS_KEYS + ("grad_norm",):
        np.testing.assert_allclose(golden["steps"][0][key], unpacked["steps"][0][key],
                                   rtol=1e-5, err_msg=key)
