"""The model and loss options outside the edge kernel, against the JAX
package on the CPU:

* swish, `layer_norm_coors` 'LN' and 'BN', `factored_edge_mlp` (the
  JAX package's factored edge MLP against the port's one concat form,
  which differs in summation order only) and dropout above 0 (the JAX package's masks, recorded by monkeypatching
  `equidock_public_tpu.models.iegmn.dropout` in a traced forward and
  replayed through the port's mask source): loss terms and every leaf's
  gradient of a training forward, which runs the port's plain layer body
  (`fused_edge_eligible` is False);
* one train step with dropout, as the JAX package's with the same masks;
* remat (`torch.utils.checkpoint` over layers 1..n-1) gives the gradients
  of the plain forward bit for bit, with dropout above 0 too (the
  recompute replays the first pass's masks), and only recomputes;
* `kernel_path_report` names each config's path;
* the exact OT solver: the host LP's plans are the JAX package's for the
  same cost, the loss within 1e-5, the gradient (through the cost only)
  where the LP is non-degenerate.

Tolerances: loss terms rtol 1e-5 (the Sinkhorn term and the total 1e-4:
its fixed point amplifies f32 rounding), each leaf's gradient 1e-4
relative norm, as `tests/test_torch_train_step.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.ops import sinkhorn as jsk
from equidock_public_tpu.train import step as js
from equidock_public_tpu_torch.models import iegmn as tm
from equidock_public_tpu_torch.models.layers import Dropout
from equidock_public_tpu_torch.ops import sinkhorn as tsk
from equidock_public_tpu_torch.params import flatten, params_from_numpy
from equidock_public_tpu_torch.train import step as ts

from .torch_utils import f32_default, port_batch, port_config  # noqa: F401
from .utils import synth_batch, tiny_config

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


def _rel(got, want):
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-12)


def _setup(seed=0, **model):
    jcfg = tiny_config(**model)
    batch = synth_batch(np.random.default_rng(seed), N_l=16, N_r=24, n_l=12, n_r=19)
    jp = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(seed), jcfg.model))
    pcfg = port_config(jcfg)
    return jcfg, batch, jp, pcfg, params_from_numpy(jp, pcfg.model), port_batch(batch)


def record_jax_masks(monkeypatch, jp, jcfg, batch, key, bn_state=None):
    """The keep-masks of the JAX package's training forward with `key`, in
    call order: its `dropout` monkeypatched to keep each mask it draws
    (exactly as `models/layers.py::dropout`), the forward traced once by
    `jax.jit` with its layer loop unrolled (`debug=True`, the same
    `fold_in(rng, layer)` keys as the scan; the test's comparison with the
    scan path's loss and gradients checks that), the masks returned."""
    masks = []

    def recording(x, rate, rng, train):
        if not train or rate == 0.0 or rng is None:
            return x
        keep = 1.0 - rate
        mask = jax.random.bernoulli(rng, keep, x.shape)
        masks.append(mask)
        return jnp.where(mask, x / keep, 0.0)

    def forward(p):
        masks.clear()
        jm.docking_forward(p, jcfg.model, batch, rng=key, train=True, bn_state=bn_state,
                           debug=True)
        return list(masks)

    with monkeypatch.context() as m:
        m.setattr(jm, "dropout", recording)
        return [np.asarray(x) for x in jax.jit(forward)(jp)]


def _jax_loss_grads(jp, jcfg, batch, key=None, bn_state=()):
    """(metrics, flat gradients) of the JAX package's training loss, and its
    BatchNorm updates (None without `bn_state`)."""
    def f(p):
        loss, (metrics, out) = js.loss_fn(p, jcfg, batch, key, True, bn_state)
        return loss, (metrics, out.get("bn_updates"))

    (_, (metrics, bn)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jp)
    return ({k: float(v) for k, v in metrics.items()},
            flatten(jax.tree.map(np.asarray, grads)), bn)


def _assert_close(pm, pg, jm_, jg):
    for k in LOSS_KEYS:
        rtol = 1e-4 if k in ("ot_loss", "loss") else 1e-5
        np.testing.assert_allclose(float(pm[k]), jm_[k], rtol=rtol, atol=1e-6, err_msg=k)
    assert set(pg) == set(jg)
    for k, g in pg.items():
        assert _rel(g.numpy(), jg[k]) <= 1e-4, k


@pytest.mark.parametrize("model", [dict(nonlin="swish"), dict(layer_norm_coors="LN"),
                                   dict(nonlin="swish", factored_edge_mlp=True,
                                        shared_layers=True, iegmn_n_lays=3)],
                         ids=["swish", "coors_LN", "swish_factored_shared"])
def test_an_option_outside_the_edge_kernel_matches_jax(model):
    jcfg, batch, jp, pcfg, pp, pb = _setup(**model)
    assert not tm.fused_edge_eligible(pcfg.model, train=True)
    jm_, jg, _ = _jax_loss_grads(jp, jcfg, batch)
    pg, pm, _ = ts.loss_and_grads(pp, pcfg, pb)
    _assert_close(pm, pg, jm_, jg)


def test_coordinate_batch_norm_matches_jax():
    jcfg, batch, jp, pcfg, pp, pb = _setup(layer_norm_coors="BN")
    jbn = jm.init_bn_state(jcfg.model)
    jm_, jg, want = _jax_loss_grads(jp, jcfg, batch, bn_state=jbn)
    pg, pm, out = ts.loss_and_grads(pp, pcfg, pb, bn_state=tm.init_bn_state(pcfg.model))
    _assert_close(pm, pg, jm_, jg)
    for site, st in out["bn_updates"].items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(want[site][k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{site}/{k}")


def test_dropout_with_the_jax_packages_masks_matches_jax(monkeypatch):
    jcfg, batch, jp, pcfg, pp, pb = _setup(dropout=0.25)
    key = jax.random.PRNGKey(11)
    masks = record_jax_masks(monkeypatch, jp, jcfg, batch, key)
    # per layer: edge, coordinate and node MLP of both sides; then the head's two
    assert len(masks) == 6 * jcfg.model.iegmn_n_lays + 2
    jm_, jg, _ = _jax_loss_grads(jp, jcfg, batch, key)
    drop = Dropout(0.25, masks=masks)
    pg, pm, _ = ts.loss_and_grads(pp, pcfg, pb, drop=drop)
    assert drop.drawn == len(masks)
    _assert_close(pm, pg, jm_, jg)
    # evaluation forwards take no mask and run the edge kernel's path
    assert tm.fused_edge_eligible(pcfg.model, train=False)
    with pytest.raises(ValueError, match="needs `drop`"):
        tm.docking_forward(pp, pcfg.model, pb, train=True)


def test_a_dropout_train_step_matches_jax(monkeypatch):
    jcfg, batch, jp, pcfg, pp, pb = _setup(seed=1, dropout=0.1, shared_layers=True)
    key = jax.random.PRNGKey(5)
    masks = record_jax_masks(monkeypatch, jp, jcfg, batch, key)
    jstate, jmet = js.train_step(js.create_train_state(jax.tree.map(jnp.array, jp), jcfg),
                                 batch, key, jcfg, 1.0)
    pstate, pmet = ts.train_step(ts.create_train_state(pp, pcfg, "cpu"), pb, pcfg,
                                 drop=Dropout(0.1, masks=masks))
    for k in LOSS_KEYS + ("grad_norm",):
        rtol = 1e-4 if k in ("ot_loss", "loss") else 1e-5
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=rtol, err_msg=k)
    jp1 = flatten(jax.tree.map(np.asarray, jstate.params))
    for k, v in flatten(pstate.params).items():
        np.testing.assert_allclose(v.numpy(), jp1[k], atol=2 * jcfg.train.lr, err_msg=k)


def _count_layer_calls(monkeypatch):
    calls = []
    inner = tm.iegmn_layer_forward

    def counting(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(tm, "iegmn_layer_forward", counting)
    return calls


@pytest.mark.parametrize("model", [dict(), dict(dropout=0.2, shared_layers=True,
                                                iegmn_n_lays=3)],
                         ids=["kernel_path", "dropout_shared"])
def test_remat_gradients_are_the_plain_ones(monkeypatch, model):
    _, _, _, pcfg, pp, pb = _setup(seed=2, **model)
    rcfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model, remat=True))
    assert tm.remat_active(rcfg.model)

    def drop():      # the same seed both ways: remat must replay, not redraw
        return (Dropout(pcfg.model.dropout, torch.Generator().manual_seed(3))
                if pcfg.model.dropout else None)

    calls = _count_layer_calls(monkeypatch)
    g0, m0, _ = ts.loss_and_grads(pp, pcfg, pb, drop=drop())
    plain_calls = len(calls)
    g1, m1, _ = ts.loss_and_grads(pp, rcfg, pb, drop=drop())
    n = pcfg.model.iegmn_n_lays
    assert plain_calls == n and len(calls) - plain_calls == n + (n - 1)   # rest recomputed
    for k in LOSS_KEYS:
        assert float(m0[k]) == float(m1[k]), k
    for k, g in g0.items():
        assert torch.equal(g, g1[k]), k


def test_remat_with_the_jax_packages_dropout_masks_matches_jax(monkeypatch):
    jcfg, batch, jp, pcfg, pp, pb = _setup(seed=4, dropout=0.2, iegmn_n_lays=3)
    key = jax.random.PRNGKey(2)
    masks = record_jax_masks(monkeypatch, jp, jcfg, batch, key)
    jcfg_r = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, remat=True))
    rcfg = port_config(jcfg_r)
    jm_, jg, _ = _jax_loss_grads(jp, jcfg_r, batch, key)
    pg, pm, _ = ts.loss_and_grads(pp, rcfg, pb, drop=Dropout(0.2, masks=masks))
    _assert_close(pm, pg, jm_, jg)


@pytest.mark.parametrize("model,want", [
    (dict(), "edge-message: CUDA rows 1-2; cross-attention: CUDA rows 3-5"),
    (dict(nonlin="swish"), "edge-message: plain PyTorch layer body in training ("),
    (dict(dropout=0.1), "edge-message: plain PyTorch layer body in training (evaluation "
                        "forwards run rows 1-2)"),
    (dict(final_h_layer_norm="BN", remat=True), "edge-message: CUDA rows 1-2; cross-attention: "
     "CUDA rows 3-5; BatchNorm: running statistics chained through the layer loop; remat off"),
    (dict(remat=True), "remat: layers 1..n-1 recomputed in the backward")])
def test_the_kernel_path_report_names_each_path(model, want):
    from equidock_public_tpu_torch.config import ModelConfig

    assert want in tm.kernel_path_report(ModelConfig(**model))
    assert "(packed seg tags)" in tm.kernel_path_report(ModelConfig(**model), packed=True)


# --------------------------------------------------------------------------- #
# The exact OT solver
# --------------------------------------------------------------------------- #

def test_the_exact_plans_are_the_jax_packages():
    rng = np.random.default_rng(0)
    cost = rng.uniform(0, 50, (3, 12, 5)).astype(np.float32)
    mask = np.ones((3, 12), np.float32)
    mask[1, 7:] = 0
    mask[2] = 0
    got = tsk.exact_emd_plan_host(cost, mask)
    np.testing.assert_array_equal(got, jsk.exact_emd_plan_host(cost, mask))
    assert (got[2] == 0).all() and (got[1, 7:] == 0).all()
    np.testing.assert_allclose(got[0].sum(axis=1), 1 / 12, rtol=1e-5)
    np.testing.assert_allclose(got[0].sum(axis=0), 1 / 5, rtol=1e-5)
    with pytest.raises(AssertionError, match="dense"):
        tsk.exact_emd_plan_host(np.zeros((1, 1001, 1000), np.float32), np.ones((1, 1001)))


def test_the_exact_ot_loss_matches_jax():
    jcfg, batch, jp, pcfg, pp, pb = _setup(seed=5)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, ot_solver="exact"))
    pcfg = port_config(jcfg)
    jm_, jg, _ = _jax_loss_grads(jp, jcfg, batch)
    pg, pm, out = ts.loss_and_grads(pp, pcfg, pb)
    np.testing.assert_allclose(float(pm["ot_loss"]), jm_["ot_loss"], rtol=1e-5)
    np.testing.assert_allclose(float(pm["loss"]), jm_["loss"], rtol=1e-5)
    # the gradient flows through the cost; the plan is unique here (a
    # non-degenerate LP: random real costs), so it is JAX's too
    for k, g in pg.items():
        assert _rel(g.numpy(), jg[k]) <= 1e-4, k
    # the loss is <plan, cost> with the plan the LP's optimum for that cost
    cost = (tsk.sq_dist_mat(pb.pocket_lig, out["keypts_lig"])
            + tsk.sq_dist_mat(pb.pocket_rec, out["keypts_rec"]))
    ot = tsk.pocket_ot_loss_exact(cost, pb.pocket_mask)
    np.testing.assert_allclose(float((ot * pb.pair_mask).sum() / pb.pair_mask.sum()),
                               float(pm["ot_loss"]), rtol=1e-6)
