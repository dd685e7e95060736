"""The backward of the port's edge-message step against the JAX package's
fused Pallas backward: every cotangent (src, dst, he) and the ten parameter
gradients of the port's plain version under autograd (what CPU tensors
take) against `jax.vjp` of `edge_message_aggregate(..., interpret=True,
fused_bwd=True)`, over use_ln / use_dist and N not a multiple of 64; and
the assembly step the CUDA path runs after its kernel (scatter of per-edge
cotangents onto src rows, sum of per-block partials), fed per-edge
cotangents and split partials on the CPU. Tolerance: the one
tests/test_pallas.py uses for parameter gradients, rtol 1e-3 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.ops.pallas import edge_message as jem
from equidock_public_tpu_torch.ops.cuda import edge_message as tem

from .test_torch_edge_message import _inputs
from .torch_utils import f32_default, t  # noqa: F401

TOL = dict(rtol=1e-3, atol=1e-5)


def _cotangents(rng, B, N, D):
    return (rng.standard_normal((B, N, D)).astype(np.float32),
            rng.standard_normal((B, N, 3)).astype(np.float32))


def _port_bwd(src, dst, he, nbr, msk, prm, ga, gx, **kw):
    return tem.edge_message_bwd(t(src), t(dst), t(he), t(nbr), t(msk),
                                {k: t(v) for k, v in prm.items()}, t(ga), t(gx), **kw)


@pytest.mark.parametrize("N,use_ln,use_dist", [(72, True, True), (72, False, True),
                                               (72, True, False), (40, True, True)])
def test_grads_match_the_fused_pallas_backward(rng, N, use_ln, use_dist):
    src, dst, he, nbr, msk, prm = _inputs(rng, B=1, N=N, D=16, Nsrc=N + 11)
    ga, gx = _cotangents(rng, 1, N, 16)
    J = lambda a: jnp.asarray(a)

    def f(s, d, h, p):
        return jem.edge_message_aggregate(s, d, h, J(nbr), J(msk), p, 0.01, use_ln,
                                          use_dist, True, True)

    _, vjp = jax.vjp(f, J(src), J(dst), J(he), {k: J(v) for k, v in prm.items()})
    w_src, w_dst, w_he, w_prm = vjp((J(ga), J(gx)))
    d_src, d_dst, d_he, d_prm = _port_bwd(src, dst, he, nbr, msk, prm, ga, gx,
                                          use_ln=use_ln, use_dist=use_dist)
    for name, g, w in [("src", d_src, w_src), ("dst", d_dst, w_dst), ("he", d_he, w_he)]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    assert set(d_prm) == set(w_prm) == set(tem.PARAM_NAMES)
    for name in tem.PARAM_NAMES:
        np.testing.assert_allclose(d_prm[name].numpy(), np.asarray(w_prm[name]),
                                   err_msg=name, **TOL)


def test_assembly_of_kernel_outputs(rng):
    """Per-edge cotangents come from the same function on a source table
    with one row per edge (src'[b, i*K + k] = src[b, nbr[b, i, k]]), whose
    gradient IS the per-edge cotangent; the parameter gradients arrive split
    over three blocks, each a row of `partial_layout`."""
    B, N, K, D, E = 2, 9, 10, 16, 27
    src, dst, he, nbr, msk, prm = _inputs(rng, B=B, N=N, D=D, Nsrc=13)
    ga, gx = _cotangents(rng, B, N, D)
    want = _port_bwd(src, dst, he, nbr, msk, prm, ga, gx)
    per_edge_src = np.take_along_axis(src, nbr.reshape(B, N * K)[..., None], axis=1)
    per_edge_nbr = np.arange(N * K, dtype=np.int32).reshape(1, N, K).repeat(B, 0)
    g_edge, d_dst, d_he, d_prm = _port_bwd(per_edge_src, dst, he, per_edge_nbr, msk, prm,
                                           ga, gx)
    layout = tem.partial_layout(D, E)
    parts = torch.zeros(3, sum(size for _, size in layout.values()))
    for name, (o, size) in layout.items():
        split = torch.from_numpy(rng.uniform(size=3).astype(np.float32))
        parts[:, o:o + size] = (split / split.sum())[:, None] * d_prm[name].reshape(1, size)
    got = tem.assemble_bwd(t(nbr), 13, g_edge[..., :3].contiguous(),
                           g_edge[..., 3:].contiguous(), d_he.reshape(B, N * K, E),
                           d_dst, parts)
    for g, w, name in zip(got[:3], want[:3], ("src", "dst", "he")):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)
    for name in tem.PARAM_NAMES:
        torch.testing.assert_close(got[3][name], want[3][name], rtol=1e-5, atol=1e-5)


def test_aggregate_is_differentiable_on_the_cpu(rng):
    src, dst, he, nbr, msk, prm = _inputs(rng, B=1, N=12, D=16)
    ga, gx = _cotangents(rng, 1, 12, 16)
    leaves = [t(x).requires_grad_(True) for x in (src, dst, he)]
    params = {k: t(v).requires_grad_(True) for k, v in prm.items()}
    out = tem.edge_message_aggregate(*leaves, t(nbr), t(msk), params)
    names = list(params)
    grads = torch.autograd.grad(out, leaves + [params[n] for n in names], (t(ga), t(gx)))
    want = _port_bwd(src, dst, he, nbr, msk, prm, ga, gx)
    for g, w in zip(grads[:3], want[:3]):
        torch.testing.assert_close(g, w)
    for g, n in zip(grads[3:], names):
        torch.testing.assert_close(g, want[3][n])


def test_bwd_on_other_devices_raises(rng):
    src, dst, he, nbr, msk, prm = _inputs(rng, B=1, N=9)
    meta = lambda a: torch.empty(a.shape, dtype=t(a).dtype, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tem.edge_message_bwd(meta(src), meta(dst), meta(he), meta(nbr), meta(msk),
                             {k: meta(v) for k, v in prm.items()},
                             torch.empty(1, 9, 16, device="meta"),
                             torch.empty(1, 9, 3, device="meta"))


def test_bwd_blocks_cover_every_node_within_the_cap():
    """The backward's tile plan: tiles of 64 // K whole nodes cover every
    node of every graph once; the grid is one block an SM, or a block a tile
    when there are fewer tiles."""
    for B, N, K in ((10, 512, 10), (1, 9, 10), (3, 300, 10), (2, 40, 16)):
        tn, blocks = tem.edge_tile_plan(B, N, 64, K)
        tiles = B * -(-N // tn)
        assert tn == tem.TILE_ROWS // K and tn * (-(-N // tn)) >= N > tn * (-(-N // tn) - 1)
        assert blocks == min(tiles, tem.BWD_MAX_BLOCKS)
    assert tem.edge_tile_plan(10, 512, 64, 10) == (6, tem.SMS)
    assert tem.edge_tile_plan(1, 9, 64, 10) == (6, 2)


def test_bwd_blocks_at_width_16():
    """At D = 16 the plan is D = 64's: one block an SM (two to four run in
    waves were slower on the card), a block a tile below that."""
    assert tem.edge_tile_plan(1, 40, 16, 10) == (6, 7) == tem.edge_tile_plan(1, 40, 64, 10)
    assert tem.edge_tile_plan(10, 512, 16, 10) == (6, tem.SMS)


def test_inverse_neighbors_give_the_transpose_of_the_gather(rng):
    """The scatter kernel's inputs: summing each src row's edges in `order`
    between its `offsets` (as the kernel does, here in numpy) gives the
    gather's transpose, `index_add_` of the per-edge rows."""
    B, N, K, Nsrc, C = 2, 9, 4, 11, 5
    nbr = torch.from_numpy(rng.integers(0, Nsrc, (B, N, K)).astype(np.int32))
    per_edge = torch.from_numpy(rng.standard_normal((B * N * K, C)).astype(np.float32))
    order, offsets = tem.inverse_neighbors(nbr, Nsrc)
    assert order.dtype == offsets.dtype == torch.int32 and offsets[-1] == B * N * K
    rows = (nbr.long() + Nsrc * torch.arange(B)[:, None, None]).reshape(-1)
    want = torch.zeros(B * Nsrc, C).index_add_(0, rows, per_edge)
    got = np.zeros((B * Nsrc, C), np.float32)
    for r in range(B * Nsrc):
        edges = order[offsets[r]:offsets[r + 1]].long()
        assert (rows[edges] == r).all() and (edges.diff() > 0).all()   # ascending edge order
        for e in edges:
            got[r] += per_edge[e].numpy()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)
