"""BatchNorm of the port against the JAX package on the CPU:

* `batch_norm` in training (masked batch statistics, biased variance to
  normalise, unbiased into the running variance, momentum 0.1) and in
  evaluation (the running statistics), and `BNContext` chaining a site's
  statistics across its applications;
* `init_bn_state`: the JAX package's sites ("<stage>/<layer>/<mlp>") and
  widths, shared and unshared layers, with a fine-tune stage;
* a model with every 'BN' option (shared layers, so the statistics chain
  across the shared layer's reuses), on an unpacked batch and on a packed
  one (masked statistics over slots whose pad tail self-loops with mask
  0): three train steps against the JAX package's (loss terms,
  parameters, Adam moments and running statistics site by site), then an
  evaluation step from those statistics;
* the statistics through `save_checkpoint` / `load_checkpoint` bit for bit,
  and from a JAX train state (`train_state_from_numpy`).

Tolerances: loss terms rtol 1e-5 (the Sinkhorn term and the total 1e-4),
parameters 2 lr a step (an element whose gradient is within rounding of 0
may move the other way in one of the two), Adam moments rtol 1e-3 (or
within 1e-5 of the moment's largest element over the model: some leaves'
gradients are rounding noise of a true 0), running statistics rtol 1e-4 /
atol 1e-5 after the first step and 1e-3 / 1e-4 after later ones (they
then read activations of parameters that differ by the moves above)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu import graph as jg
from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.models import layers as jl
from equidock_public_tpu.train import step as js
from equidock_public_tpu_torch.models import iegmn as tm
from equidock_public_tpu_torch.models import layers as tl
from equidock_public_tpu_torch.params import flatten, params_from_numpy, train_state_from_numpy
from equidock_public_tpu_torch.train import step as ts
from equidock_public_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

from .test_torch_packing import BUCKETS, POCKET_BUCKETS, _complexes
from .torch_utils import f32_default, port_batch, port_config  # noqa: F401
from .utils import synth_batch, tiny_config

LOSS_KEYS = ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss")
ALL_BN = dict(layer_norm="BN", layer_norm_coors="BN", final_h_layer_norm="BN",
              shared_layers=True, iegmn_n_lays=3)


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


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_batch_norm_is_the_jax_packages(train, masked):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 5, 6)) * 3 + 1).astype(np.float32)
    mask = (rng.uniform(size=(3, 7, 5, 1)) > 0.3).astype(np.float32) if masked else None
    p = {"g": rng.uniform(0.5, 2, 6).astype(np.float32), "b": rng.standard_normal(6).astype(np.float32)}
    st = {"mean": rng.standard_normal(6).astype(np.float32),
          "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    want, want_st = jl.batch_norm(p, st, jnp.asarray(x), None if mask is None else jnp.asarray(mask),
                                  train)
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    got, got_st = tl.batch_norm(tt(p), tt(st), torch.from_numpy(x),
                                None if mask is None else torch.from_numpy(mask), train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_st[k].numpy(), np.asarray(want_st[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert not got_st["mean"].requires_grad


def test_bn_context_chains_a_sites_statistics():
    rng = np.random.default_rng(1)
    p = {"g": torch.ones(4), "b": torch.zeros(4)}
    xs = [torch.from_numpy(rng.standard_normal((5, 4)).astype(np.float32)) for _ in range(2)]
    ctx = tl.BNContext({"s": tl.init_bn_state(4)}, train=True)
    for x in xs:
        ctx("s", p, x, None)
    jctx = jl.BNContext({"s": jl.init_bn_state(4)}, train=True)
    for x in xs:
        jctx("s", jax.tree.map(jnp.asarray, {k: v.numpy() for k, v in p.items()}),
             jnp.asarray(x.numpy()), None)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ctx.updates["s"][k].numpy(),
                                   np.asarray(jctx.updates["s"][k]), rtol=1e-6)
    assert not tl.BNContext({"s": tl.init_bn_state(4)}, train=False).updates


@pytest.mark.parametrize("model", [ALL_BN, dict(layer_norm="BN", iegmn_n_lays=3),
                                   dict(final_h_layer_norm="BN", fine_tune=True)],
                         ids=["all_shared", "unshared", "fine_tune"])
def test_init_bn_state_has_the_jax_packages_sites(model):
    jcfg = tiny_config(**model)
    want = jm.init_bn_state(jcfg.model)
    got = tm.init_bn_state(port_config(jcfg).model)
    assert set(got) == set(want)
    for site, st in got.items():
        for k in ("mean", "var"):
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(want[site][k]))


def _adam(opt_state):
    return next(s for s in opt_state if hasattr(s, "mu") and hasattr(s, "nu"))


@pytest.fixture(scope="module", params=[False, True], ids=["unpacked", "packed"])
def bn_steps(request, one_thread):
    """Three train steps of an all-'BN' model in both packages from the
    same params and batch (unpacked, or four complexes packed 3 a slot):
    (JAX config, JAX batch, JAX states, port config, port batch, port
    states, metrics of each)."""
    jcfg = tiny_config(**ALL_BN)
    if request.param:
        jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, pack=True,
                                                                  pack_max_per_slot=3))
        batch = jg.collate_packed(*_complexes(seed=7)[0], BUCKETS, POCKET_BUCKETS, 3)
        assert batch.n_segs > 1
    else:
        batch = synth_batch(np.random.default_rng(3), N_l=16, N_r=24, n_l=12, n_r=19)
    jp = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(1), jcfg.model))
    pcfg = port_config(jcfg)
    pb = port_batch(batch)
    jstate = js.create_train_state(jax.tree.map(jnp.array, jp), jcfg)
    pstate = ts.create_train_state(params_from_numpy(jp, pcfg.model), pcfg, "cpu")
    jstates, pstates, jmets, pmets = [], [], [], []
    for i in range(3):
        jstate, m = js.train_step(jstate, batch, jax.random.PRNGKey(i), jcfg, 1.0)
        jstates.append(jax.tree.map(np.asarray, (jstate.params, jstate.opt_state,
                                                 jstate.step, jstate.bn_state)))
        jmets.append({k: float(v) for k, v in m.items() if np.ndim(v) == 0})
        pstate, pm = ts.train_step(pstate, pb, pcfg)
        pstates.append(pstate)
        pmets.append(pm)
    return jcfg, batch, jstates, pcfg, pb, pstates, jmets, pmets


def test_three_bn_train_steps_match_jax(bn_steps):
    jcfg, _, jstates, pcfg, _, pstates, jmets, pmets = bn_steps
    assert not tm.fused_edge_eligible(pcfg.model, train=True)
    lr = jcfg.train.lr
    for i, (jst, pst, jmet, pmet) in enumerate(zip(jstates, pstates, jmets, pmets)):
        for k in LOSS_KEYS + ("grad_norm",):
            rtol = 1e-4 if k in ("ot_loss", "loss") else 1e-5
            np.testing.assert_allclose(float(pmet[k]), jmet[k], rtol=rtol, err_msg=f"{i} {k}")
        jparams, jopt, _, jbn = jst
        for k, v in flatten(pst.params).items():
            np.testing.assert_allclose(v.numpy(), flatten(jparams)[k], atol=2 * lr * (i + 1),
                                       err_msg=f"step {i + 1} {k}")
        adam = _adam(jopt)
        for name, mom in (("mu", pst.mu), ("nu", pst.nu)):
            want = flatten(getattr(adam, name))
            scale = max(float(np.abs(w).max()) for w in want.values())
            for k, v in mom.items():
                np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-3, atol=1e-5 * scale,
                                           err_msg=f"step {i + 1} {name} {k}")
        assert set(pst.bn_state) == set(jbn) and len(jbn) == 2 * 4
        for site, st in pst.bn_state.items():
            for k in ("mean", "var"):
                tol = dict(rtol=1e-4, atol=1e-5) if i == 0 else dict(rtol=1e-3, atol=1e-4)
                np.testing.assert_allclose(st[k].numpy(), jbn[site][k], **tol,
                                           err_msg=f"step {i + 1} {site}/{k}")


def test_an_eval_step_reads_the_running_statistics(bn_steps):
    jcfg, batch, jstates, pcfg, pb, pstates, _, _ = bn_steps
    jparams, _, _, jbn = jstates[-1]
    want = js.eval_step(jax.tree.map(jnp.asarray, jparams), batch, jcfg,
                        jax.tree.map(jnp.asarray, jbn))
    got = ts.eval_step(pstates[-1].params, pb, pcfg, pstates[-1].bn_state)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, err_msg=k)
    # the statistics are read, not the batch's: an eval step with other ones differs
    fresh = ts.eval_step(pstates[-1].params, pb, pcfg, tm.init_bn_state(pcfg.model))
    assert float(fresh["loss"]) != float(got["loss"])
    with pytest.raises(ValueError, match="bn_state"):
        ts.eval_step(pstates[-1].params, pb, pcfg)


def test_the_statistics_go_through_checkpoints(bn_steps, tmp_path):
    _, _, jstates, pcfg, pb, pstates, _, _ = bn_steps
    state = pstates[-1]
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state, pcfg, 2)
    back, _, _ = load_checkpoint(path, "cpu")
    assert set(back.bn_state) == set(state.bn_state)
    for site, st in state.bn_state.items():
        for k in ("mean", "var"):
            assert torch.equal(back.bn_state[site][k], st[k])
    a, _ = ts.train_step(state, pb, pcfg)
    b, _ = ts.train_step(back, pb, pcfg)
    for k, v in flatten(a.params).items():
        assert torch.equal(v, flatten(b.params)[k]), k
    jparams, jopt, jstep, jbn = jstates[-1]
    conv = train_state_from_numpy(jparams, jopt, jstep, pcfg.model, bn_state=jbn)
    assert conv.step == 3 and set(conv.bn_state) == set(jbn)
    np.testing.assert_array_equal(conv.bn_state["original/rest/final_h"]["var"].numpy(),
                                  jbn["original/rest/final_h"]["var"])
    with pytest.raises(KeyError, match="BatchNorm statistics"):
        train_state_from_numpy(jparams, jopt, jstep, pcfg.model, bn_state={})
    noisy = dataclasses.replace(state, bn_state={})
    with pytest.raises(ValueError, match="bn_state"):
        ts.train_step(noisy, pb, pcfg)
