"""The backward of the port's cross-attention (its plain version under
autograd, what CPU tensors take) against the JAX package: `jax.vjp` of the
Pallas `_fused_core` in interpret mode at M = 512, where the Pallas path's
key padding adds nothing, and `jax.vjp` of the oracle
`ops/attention.py::cross_attention` at M not a multiple of 512. Tagged
(packed-style) masks and fully masked query rows and complexes included.
Tolerance: f32 with different summation orders, rtol 1e-4 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.ops.attention import cross_attention as jax_oracle
from equidock_public_tpu.ops.pallas.cross_attention import _fused_core
from equidock_public_tpu_torch.ops.cuda import cross_attention as tca

from .torch_utils import f32_default, t  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(rng, B, N, M, D, Dv, tagged):
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    q, k, v, do = f(B, N, D), f(B, M, D), f(B, M, Dv), f(B, N, Dv)
    qm = np.zeros((B, N), np.float32)
    km = np.zeros((B, M), np.float32)
    qm[0, : N - 7] = 1                   # padded query rows
    km[0, : M - 50] = 1
    if B > 1:
        qm[1, : N // 2] = 1
        km[1] = 0                        # a complex with no valid key
    if tagged:                           # (segment id + 1) * mask
        qm *= rng.integers(1, 4, (B, N)).astype(np.float32)
        km *= rng.integers(1, 4, (B, M)).astype(np.float32)
    return q, k, v, qm, km, do


def _port_grads(q, k, v, qm, km, do):
    o, lse = tca.cross_attention_fwd(t(q), t(k), t(v), t(qm), t(km))
    return tca.cross_attention_bwd(t(q), t(k), t(v), t(qm), t(km), o, lse, t(do))


def _assert_close(got, want):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("N,D,Dv,tagged", [(40, 16, 16, False), (24, 69, 69, True)])
def test_grads_match_pallas_interpret_at_m512(rng, N, D, Dv, tagged):
    q, k, v, qm, km, do = _inputs(rng, 1, N, 512, D, Dv, tagged)
    _, vjp = jax.vjp(lambda a, b, c: _fused_core(a, b, c, jnp.asarray(qm), jnp.asarray(km),
                                                 True), q, k, v)
    _assert_close(_port_grads(q, k, v, qm, km, do), vjp(jnp.asarray(do)))


@pytest.mark.parametrize("tagged", [False, True])
@pytest.mark.parametrize("N,M,D,Dv", [(150, 700, 16, 16), (13, 548, 69, 69), (9, 40, 8, 3)])
def test_grads_match_the_oracle_at_other_m(rng, N, M, D, Dv, tagged):
    q, k, v, qm, km, do = _inputs(rng, 2, N, M, D, Dv, tagged)
    if tagged:   # the oracle takes segments beside 0/1 masks
        qs, ks = np.maximum(qm - 1, 0).astype(np.int32), np.maximum(km - 1, 0).astype(np.int32)
        qb, kb = (qm > 0).astype(np.float32), (km > 0).astype(np.float32)
        f = lambda a, b, c: jax_oracle(a, b, c, qb, kb, q_seg=qs, k_seg=ks)
    else:
        f = lambda a, b, c: jax_oracle(a, b, c, qm, km)
    _, vjp = jax.vjp(f, q, k, v)
    _assert_close(_port_grads(q, k, v, qm, km, do), vjp(jnp.asarray(do)))


def test_fused_is_differentiable_and_tags_get_no_gradient(rng):
    q, k, v, qm, km, do = _inputs(rng, 2, 20, 30, 8, 8, False)
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    qt, kt = t(qm).requires_grad_(True), t(km).requires_grad_(True)
    out = tca.cross_attention_fused(*leaves, qt, kt)
    grads = torch.autograd.grad(out, leaves + [qt, kt], t(do), allow_unused=True)
    want = tca.cross_attention_bwd_plain(t(q), t(k), t(v), t(qm), t(km), t(do))
    for g, w in zip(grads[:3], want):
        torch.testing.assert_close(g, w)
    before = (tca.dq_launches, tca.dkv_launches)
    tca.cross_attention_bwd(t(q), t(k), t(v), t(qm), t(km), out.detach(),
                            torch.zeros(2, 20), t(do))
    assert (tca.dq_launches, tca.dkv_launches) == before     # CPU: no kernel launch


def test_bwd_on_other_devices_raises(rng):
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tca.cross_attention_bwd(meta(1, 4, 8), meta(1, 6, 8), meta(1, 6, 8), meta(1, 4),
                                meta(1, 6), meta(1, 4, 8), meta(1, 4), meta(1, 4, 8))
