"""The port's soft-min field sums (`ops/softmin_field.py`, the plain path of
kernel rows 6 and 7) against the JAX package's Pallas kernels in interpret
mode and its plain `g_fn`, on the same numpy inputs.

Tolerances: S at rtol 1e-4 / atol 1e-5 (f32 sums in other orders; the
Pallas kernel expands |x - a|^2 into |x|^2 + |a|^2 - 2 x.a, which cancels
in f32); dx and dA at rtol 1e-3 / atol 1e-5, the JAX package's own test's
limits for its custom VJP; the port's Function against autograd through the
plain formula in float64, 1e-10. The JAX side runs its products at
"highest" precision, so that the Pallas kernel's cross term x.a is taken in
f32 whatever matrix units the CPU has."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.ops import intersection as jint
from equidock_public_tpu.ops.pallas import softmin_field as jsf
from equidock_public_tpu_torch.ops import intersection as tint
from equidock_public_tpu_torch.ops import softmin_field as tsf

from .torch_utils import f32_default, t  # noqa: F401


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield

SIGMA, SURFACE = 25.0, 10.0


def _inputs(rng, B, M, N):
    # the coordinate scale of the JAX package's own test (tests/test_pallas.py)
    x = (rng.standard_normal((B, M, 3)) * 5).astype(np.float32)
    a = (rng.standard_normal((B, N, 3)) * 5).astype(np.float32)
    x_mask = np.ones((B, M), np.float32)
    a_mask = np.ones((B, N), np.float32)
    x_mask[:, int(M * 0.7):] = 0          # padded queries
    a_mask[:, int(N * 0.6):] = 0          # padded keys
    a_mask[0, 3] = 0
    c = (rng.standard_normal((B, M)) * x_mask).astype(np.float32)
    return x, a, x_mask, a_mask, c


@pytest.mark.parametrize("B,M,N", [(2, 70, 130), (2, 512, 512)])
def test_sums_match_the_pallas_kernel_and_g_fn(rng, B, M, N):
    x, a, _, a_mask, _ = _inputs(rng, B, M, N)
    got = tsf.softmin_field_sums(t(x), t(a), t(a_mask), SIGMA).numpy()
    want = np.asarray(jsf.softmin_field_sums(jnp.asarray(x), jnp.asarray(a),
                                             jnp.asarray(a_mask), SIGMA, True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # g_fn gives G = -sigma log(1e-3 + S): compare the S it implies (G near 0
    # would turn S's relative tolerance into a much larger one on G)
    g = np.asarray(jint.g_fn(jnp.asarray(a), jnp.asarray(a_mask), jnp.asarray(x), SIGMA),
                   np.float64)
    np.testing.assert_allclose(got, np.exp(-g / SIGMA) - 1e-3, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,M,N", [(2, 70, 130), (2, 512, 512)])
def test_gradients_match_the_jax_custom_vjp(rng, B, M, N):
    x, a, _, a_mask, c = _inputs(rng, B, M, N)
    _, vjp = jax.vjp(lambda x_, a_: jsf.softmin_field_sums(x_, a_, jnp.asarray(a_mask),
                                                           SIGMA, True),
                     jnp.asarray(x), jnp.asarray(a))
    wdx, wda = (np.asarray(g) for g in vjp(jnp.asarray(c)))
    xt, at = t(x).requires_grad_(True), t(a).requires_grad_(True)
    s = tsf.softmin_field_sums(xt, at, t(a_mask), SIGMA)
    dx, da = torch.autograd.grad(s, (xt, at), t(c))
    np.testing.assert_allclose(dx.numpy(), wdx, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(da.numpy(), wda, rtol=1e-3, atol=1e-5)


def test_function_gradient_equals_autograd_through_the_plain_formula(rng):
    x, a, _, a_mask, c = _inputs(rng, 2, 9, 13)
    xt, at = (t(v, torch.float64).requires_grad_(True) for v in (x, a))
    mask, ct = t(a_mask, torch.float64), t(c, torch.float64)
    got = torch.autograd.grad(tsf.softmin_field_sums(xt, at, mask, SIGMA), (xt, at), ct)
    want = torch.autograd.grad(tsf.softmin_field_sums_plain(xt, at, mask, SIGMA), (xt, at), ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)
    assert torch.autograd.gradcheck(lambda x_, a_: tsf.softmin_field_sums(x_, a_, mask, SIGMA),
                                    (xt[:, :4].detach().requires_grad_(True),
                                     at.detach().requires_grad_(True)))


@pytest.mark.parametrize("B,M,N", [(2, 70, 130), (2, 512, 512)])
def test_fused_loss_matches_jax_and_the_unfused_loss(rng, B, M, N):
    lig, rec, lig_mask, rec_mask, _ = _inputs(rng, B, M, N)
    rec_mask = np.ones((B, N), np.float32)
    rec_mask[:, int(N * 0.8):] = 0
    want = np.asarray(jsf.body_intersection_loss_fused(
        *(jnp.asarray(v) for v in (lig, lig_mask, rec, rec_mask)), SIGMA, SURFACE,
        interpret=True))
    args = [t(v) for v in (lig, lig_mask, rec, rec_mask)]
    got = tsf.body_intersection_loss_fused(*args, SIGMA, SURFACE).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, tint.body_intersection_loss(*args, SIGMA, SURFACE).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_other_devices_raise():
    x = torch.zeros(1, 4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsf.softmin_field_sums(x, x, torch.zeros(1, 4, device="meta"), SIGMA)
