"""The port's optimizer (`train/optim.py::adam_update`, plain tensor ops)
against the JAX package's optax chain (`train/optim.py::make_optimizer`)
on the same gradients, over several steps: a step where clipping
triggers, a non-unit lr_scale, a warmup schedule and the cyclic one; and
the host-side epoch schedulers, which are copies. Tolerance: the same f32
operations; the global norm sums the leaves in another order, which moves
the clipped gradient by an ulp: rtol 1e-6 / atol 1e-7 on parameters and
moments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.config import TrainConfig as JaxTrainConfig
from equidock_public_tpu.train import optim as jopt
from equidock_public_tpu_torch.config import TrainConfig
from equidock_public_tpu_torch.train import optim as topt

from .torch_utils import f32_default  # noqa: F401


def _tree(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"a/w": f(4, 3), "a/b": f(3), "c": f(5)}


@pytest.mark.parametrize("kw,lr_scales", [
    (dict(lr=1e-2, w_decay=1e-3, clip=8.0), [1.0, 1.0, 1.0, 1.0]),
    (dict(lr=2e-4, w_decay=1e-3, clip=100.0), [1.0, 0.5, 2.5, 1.0]),
    (dict(lr=1e-3, w_decay=0.0, clip=5.0, warmup=3.0), [1.0, 1.0, 1.0, 1.0, 1.0]),
    (dict(lr=1e-3, w_decay=1e-4, clip=5.0, scheduler="cyclic", warmup=4.0), [1.0, 3.25, 5.5]),
], ids=["clip_triggers", "lr_scale", "warmup", "cyclic"])
def test_steps_match_optax(rng, kw, lr_scales):
    jtc, ttc = JaxTrainConfig(**kw), TrainConfig(**kw)
    opt = jopt.make_optimizer(jtc)
    params = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in tp.items()}
    nu = {k: torch.zeros_like(v) for k, v in tp.items()}
    clipped = []
    for step, lr_scale in enumerate(lr_scales):
        grads = {k: (rng.standard_normal(v.shape) * (1 + 2 * step)).astype(np.float32)
                 for k, v in params.items()}
        upd, state = opt.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jp)
        jp = {k: jp[k] + upd[k] * lr_scale for k in jp}
        tp, mu, nu, gnorm = topt.adam_update(
            tp, {k: torch.from_numpy(g) for k, g in grads.items()}, mu, nu, step, ttc,
            lr_scale)
        np.testing.assert_allclose(float(gnorm), float(jax.numpy.sqrt(
            sum(jnp.sum(jnp.asarray(g) ** 2) for g in grads.values()))), rtol=1e-6)
        clipped.append(float(gnorm) > ttc.clip)
        adam = state[2]
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {k}")
            np.testing.assert_allclose(mu[k].numpy(), np.asarray(adam.mu[k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6,
                                       atol=1e-7)
    if kw["clip"] == 8.0:          # ||g|| is about 4.5 at step 0, then 3x, 5x, 7x
        assert any(clipped) and not all(clipped)


@pytest.mark.parametrize("step", [0, 1, 2, 9, 50])
def test_learning_rate_matches_the_jax_schedule(step):
    sched = jopt.warmup_schedule(2e-4, 10.0)
    np.testing.assert_allclose(topt.learning_rate(TrainConfig(lr=2e-4, warmup=10.0), step),
                               float(sched(step)), rtol=1e-6)


@pytest.mark.parametrize("epoch", [0, 1, 3, 4, 7, 8, 13])
def test_epoch_schedulers_are_copies(epoch):
    assert topt.cyclic_epoch_factor(epoch, 4.0) == jopt.cyclic_epoch_factor(epoch, 4.0)
    jrop, trop = jopt.ReduceOnPlateau(patience=2), topt.ReduceOnPlateau(patience=2)
    for v in [5.0, 4.0, 4.0, 4.0, 4.0, 3.0, 3.0, 3.0, 3.0][:epoch + 1]:
        assert jrop.step(v) == trop.step(v)
    for sched in ("warmup", "cyclic", "ROP"):
        jtc, ttc = JaxTrainConfig(scheduler=sched, warmup=4.0), TrainConfig(scheduler=sched,
                                                                           warmup=4.0)
        assert topt.epoch_lr_factor(ttc, epoch, trop) == jopt.epoch_lr_factor(jtc, epoch, jrop)
