"""The port's training losses against the JAX package on the same padded
batch (`tests/utils.py::synth_batch`, one padding slot): the body
intersection, the Sinkhorn plan, the pocket OT loss and its gradient
(through the cost only), and `total_loss` with every term. Tolerance: f32
with other summation orders; the Sinkhorn fixed point amplifies rounding
over 200 iterations, so the plan is held to rtol 1e-4 / atol 1e-7 of its
entries (about 1/(P*H) = 1e-3 each), the losses to rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.config import TrainConfig as JaxTrainConfig
from equidock_public_tpu.ops import intersection as jint
from equidock_public_tpu.ops import sinkhorn as jsk
from equidock_public_tpu.train import losses as jlo
from equidock_public_tpu_torch.config import TrainConfig
from equidock_public_tpu_torch.ops import intersection as tint
from equidock_public_tpu_torch.ops import sinkhorn as tsk
from equidock_public_tpu_torch.train import losses as tlo

from .torch_utils import f32_default, port_batch, t  # noqa: F401
from .utils import synth_batch


def _batch(rng):
    b = synth_batch(rng, B=3, N_l=16, N_r=24, P=12, n_l=11, n_r=19, n_pocket=7)
    return b.replace(pair_mask=jnp.asarray([1.0, 1.0, 0.0]))     # slot 2 is padding


def _outputs(rng, b, H=5):
    B, N_l = b.lig.x.shape[:2]
    f = lambda *s: (rng.standard_normal(s) * 6).astype(np.float32)
    return {"ligand_coords": f(B, N_l, 3), "keypts_lig": f(B, H, 3), "keypts_rec": f(B, H, 3)}


@pytest.mark.parametrize("sigma,ct", [(25.0, 10.0), (8.0, 4.0)])
def test_body_intersection_loss(rng, sigma, ct):
    b = _batch(rng)
    lig = _outputs(rng, b)["ligand_coords"] * 0.3
    args = (lig, b.lig.node_mask, b.rec.x, b.rec.node_mask)
    want = jint.body_intersection_loss(*args, sigma, ct)
    got = tint.body_intersection_loss(*map(t, args), sigma, ct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("iters,eps", [(200, 0.01), (50, 0.05)])
def test_sinkhorn_plan(rng, iters, eps):
    B, P, H = 2, 12, 5
    cost = (rng.uniform(size=(B, P, H)) * 40).astype(np.float32)
    mask = np.zeros((B, P), np.float32)
    mask[0, :9] = 1
    mask[1, :4] = 1
    want = jsk.sinkhorn_log(cost, mask, epsilon=eps, iters=iters)
    got = tsk.sinkhorn_log(t(cost), t(mask), epsilon=eps, iters=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)
    assert (got.numpy()[mask == 0] == 0).all()
    np.testing.assert_allclose(got.sum(dim=(1, 2)).numpy(), 1.0, rtol=1e-4)


def test_pocket_ot_loss_and_its_gradient_through_the_cost_only(rng):
    B, P, H = 2, 12, 5
    kl = (rng.standard_normal((B, H, 3)) * 5).astype(np.float32)
    pl_ = (rng.standard_normal((B, P, 3)) * 5).astype(np.float32)
    mask = np.zeros((B, P), np.float32)
    mask[0, :9] = 1
    mask[1, :12] = 1

    def jax_loss(k):
        return jnp.sum(jsk.pocket_ot_loss(jsk.sq_dist_mat(pl_, k), mask))

    want, want_g = jax.value_and_grad(jax_loss)(kl)
    k = t(kl).requires_grad_(True)
    got = tsk.pocket_ot_loss(tsk.sq_dist_mat(t(pl_), k), t(mask)).sum()
    (got_g,) = torch.autograd.grad(got, k)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("weights", [(1.0, 10.0), (0.5, 0.0)])
def test_total_loss_terms(rng, weights):
    b = _batch(rng)
    out = _outputs(rng, b)
    jtc = JaxTrainConfig(pocket_ot_loss_weight=weights[0], intersection_loss_weight=weights[1])
    ttc = TrainConfig(pocket_ot_loss_weight=weights[0], intersection_loss_weight=weights[1])
    _, want = jlo.total_loss({k: jnp.asarray(v) for k, v in out.items()}, b, jtc)
    _, got = tlo.total_loss({k: t(v) for k, v in out.items()}, port_batch(b), ttc)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_masked_mse(rng):
    b = _batch(rng)
    pred = _outputs(rng, b)["ligand_coords"]
    want = jlo.masked_mse(pred, b.gt_lig, b.lig.node_mask)
    got = tlo.masked_mse(t(pred), t(b.gt_lig), t(b.lig.node_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_total_loss_with_the_fused_intersection(rng):
    """`use_fused_intersection`: the JAX package's Pallas soft-min field
    kernel (interpret mode, products at "highest" precision) against the
    port's soft-min field path; the terms equal the unfused loss's too."""
    b = _batch(rng)
    out = _outputs(rng, b)
    out["ligand_coords"] *= 0.3           # overlapping bodies: a non-zero penalty
    with jax.default_matmul_precision("highest"):
        _, want = jlo.total_loss({k: jnp.asarray(v) for k, v in out.items()}, b,
                                 JaxTrainConfig(use_fused_intersection=True))
    got = {fused: tlo.total_loss({k: t(v) for k, v in out.items()}, port_batch(b),
                                 TrainConfig(use_fused_intersection=fused))[1]
           for fused in (True, False)}
    assert float(want["intersection_loss"]) > 0
    for key in want:
        for fused in (True, False):
            np.testing.assert_allclose(float(got[fused][key]), float(want[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{key} fused={fused}")


@pytest.mark.parametrize("field,value", [("ot_solver", "exact")])
def test_options_outside_the_slice_raise(rng, field, value):
    """The exact OT solver is ported (slice 7): `total_loss` with it is the
    JAX package's (the host LP's plan, the loss through the cost), to rtol
    1e-5; a solver of neither package raises."""
    b = _batch(rng)
    outs = _outputs(rng, b)
    out = {k: t(v) for k, v in outs.items()}
    _, got = tlo.total_loss(out, port_batch(b), TrainConfig(**{field: value}))
    _, want = jlo.total_loss({k: jnp.asarray(v) for k, v in outs.items()}, b,
                             JaxTrainConfig(**{field: value}))
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    with pytest.raises(ValueError, match=field):
        tlo.total_loss(out, port_batch(b), TrainConfig(**{field: "greedy"}))
