"""The halo path across ranks (processes with gloo groups on the CPU,
`parallel/launch.py`) against the stacked one-process form and the JAX
package.

* Rows 8-9's cross-rank form (plain: the group's rows gathered by an
  all_reduce, then the stacked plain gather; on the card the peer kernels
  compute the same) at gp 2 and 4: bit-equal to the stacked exchange,
  forward and backward, in the padded, ragged and residual tiers.
* The halo forward on 2 ranks against JAX's `make_halo_forward` on
  `make_mesh(dp=1, gp=2)` (its ppermute ring; `tests/test_torch_halo_jax_fwd.py`
  holds the port to the Pallas ring), and a 'GN' model's,
  stacked and across ranks, against JAX's (GraphNorm's sums over the
  shards, JAX's `gn_axis`): R 1e-5 absolute; t, keypoints and coordinates
  1e-5 of the largest JAX coordinate (`tests/test_torch_halo_jax_fwd.py`).
* Ring cross-attention across 4 ranks against JAX's
  `make_ring_cross_attention`: 1e-5 of the output's scale (f32 sums of
  another association).
Every launch runs under a 120 s limit with one intra-op thread a rank.
"""

import jax
import numpy as np
import pytest
import torch

from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.parallel import halo as jh
from equidock_public_tpu.parallel.mesh import make_mesh, replicate
from equidock_public_tpu.parallel.ring_attention import make_ring_cross_attention
from equidock_public_tpu_torch.ops.cuda import halo_ring as hr
from equidock_public_tpu_torch.params import params_from_numpy
from equidock_public_tpu_torch.parallel.halo import build_halo_batch, make_halo_forward
from equidock_public_tpu_torch.parallel.launch import run_ranks
from equidock_public_tpu_torch.parallel.mesh import ParallelMesh

from .torch_utils import f32_default, port_batch, port_config  # noqa: F401
from .utils import synth_batch, tiny_config

TIMEOUT_S = 120
RANKS = dict(timeout_s=TIMEOUT_S, device="cpu")     # every launch: its limit, the CPU
# gp -> the planner options of the tiers exchanged on that many ranks
EXCHANGE_TIERS = {2: (dict(gp=2), dict(gp=2, ragged=True)),
                  4: (dict(gp=4, spatial=False, hmax=4), dict(gp=4))}


@pytest.mark.parametrize("gp", sorted(EXCHANGE_TIERS))
def test_cross_rank_exchange_is_bit_equal_to_the_stacked_one(rng, gp):
    batch = port_batch(synth_batch(rng, B=2, N_l=16, N_r=16, n_l=14, n_r=13, coord_scale=50.0))
    cases, want = [], []
    for kw in EXCHANGE_TIERS[gp]:
        hb, stats, _, _ = build_halo_batch(batch, **kw)
        if "hmax" in kw:
            assert stats.hres_lig > 0          # the residual tier ships
        mesh = ParallelMesh(1, gp, "cpu")
        x = hb.pair.lig.x
        h = torch.from_numpy(rng.standard_normal(x.shape[:2] + (8,)).astype(np.float32))
        xf, hf = mesh.fold(x).requires_grad_(True), mesh.fold(h).requires_grad_(True)
        xs, hs = hr.halo_exchange_sides((hb.table_lig,), (xf, hf))
        gx = torch.from_numpy(rng.standard_normal(xs.shape).astype(np.float32))
        gh = torch.from_numpy(rng.standard_normal(hs.shape).astype(np.float32))
        torch.autograd.backward((xs, hs), (gx, gh))
        cases.append(dict(x=x, h=h, table=hb.table_lig, gx=gx, gh=gh))
        want.append((xs.detach(), hs.detach(), xf.grad, hf.grad))
    got = run_ranks("tests.torch_dist_bodies:exchange", gp, dict(gp=gp, cases=cases),
                    **RANKS)
    for p, per_rank in enumerate(got):
        for (gx_, gh_, dx, dh), (wx, wh, wdx, wdh), kw in zip(per_rank, want,
                                                              EXCHANGE_TIERS[gp]):
            own = slice(p * 2, (p + 1) * 2)
            for name, a, b in (("x_src", gx_, wx), ("h_src", gh_, wh), ("d_x", dx, wdx),
                               ("d_h", dh, wdh)):
                assert torch.equal(a, b[own]), (kw, p, name)


def _jax_halo_forward(jcfg, jp, batch, gp):
    jhb, _, _, _ = jh.build_halo_batch(batch, gp=gp)
    mesh = make_mesh(dp=1, gp=gp, devices=jax.devices()[:gp])
    with jax.default_matmul_precision("highest"), mesh:
        out = jax.jit(jh.make_halo_forward(jcfg, mesh))(replicate(jp, mesh),
                                                        jh.shard_halo_batch(jhb, mesh))
    return {k: np.asarray(v) for k, v in out.items()}


def _close_to_jax(out, want):
    np.testing.assert_allclose(out["R"].numpy(), want["R"], rtol=0, atol=1e-5)
    scale = float(np.abs(want["ligand_coords"]).max())
    for key in ("t", "keypts_lig", "keypts_rec", "ligand_coords"):
        np.testing.assert_allclose(out[key].numpy(), want[key], rtol=0, atol=1e-5 * scale,
                                   err_msg=key)


@pytest.fixture(scope="module")
def two_rank_forwards():
    """(JAX outputs, stacked outputs, the 2 ranks' outputs) of the plain and
    the 'GN' model, from one 2-rank launch."""
    rng = np.random.default_rng(11)
    batch = synth_batch(rng, B=2, N_l=16, N_r=16, n_l=14, n_r=13, coord_scale=50.0)
    models, jax_outs = [], []
    for gn in ("0", "GN"):
        jcfg = tiny_config(iegmn_n_lays=3, final_h_layer_norm=gn)
        pcfg = port_config(jcfg)
        jp = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(0), jcfg.model))
        jax_outs.append(_jax_halo_forward(jcfg, jp, batch, 2))
        models.append((pcfg, params_from_numpy(jp, pcfg.model)))
    hb, _, _, _ = build_halo_batch(port_batch(batch), gp=2)
    with torch.no_grad():
        stacked = [make_halo_forward(c, ParallelMesh(1, 2, "cpu"))(p, hb) for c, p in models]
    ranks = run_ranks("tests.torch_dist_bodies:halo_forwards", 2,
                      dict(gp=2, hbs=[hb], models=models), **RANKS)
    return jax_outs, stacked, ranks


def test_the_halo_forward_on_two_ranks_matches_jax(two_rank_forwards):
    jax_outs, stacked, ranks = two_rank_forwards
    for rank_out in ranks:
        _close_to_jax(rank_out[0], jax_outs[0])
        for key, v in stacked[0].items():       # the rank form is the stacked form's
            torch.testing.assert_close(rank_out[0][key], v, rtol=0, atol=0, msg=key)


def test_graph_norm_across_shards_matches_jax(two_rank_forwards):
    jax_outs, stacked, ranks = two_rank_forwards
    _close_to_jax(stacked[1], jax_outs[1])
    for rank_out in ranks:
        _close_to_jax(rank_out[1], jax_outs[1])
    # GraphNorm moved the outputs: the check reads the 'GN' model
    assert float(np.abs(jax_outs[1]["t"] - jax_outs[0]["t"]).max()) > 1e-3


def test_ring_attention_across_ranks_matches_jax(rng):
    B, N, D = 2, 16, 8
    q, k, v = (rng.standard_normal((B, N, D)).astype(np.float32) for _ in range(3))
    qm = (rng.uniform(size=(B, N)) > 0.2).astype(np.float32)
    km = (rng.uniform(size=(B, N)) > 0.3).astype(np.float32)
    mesh = make_mesh(dp=1, gp=4, devices=jax.devices()[:4])
    with jax.default_matmul_precision("highest"), mesh:
        want = np.asarray(jax.jit(make_ring_cross_attention(mesh))(q, k, v, qm, km))
    args = tuple(torch.from_numpy(a) for a in (q, k, v, qm, km))
    got = run_ranks("tests.torch_dist_bodies:ring_attention", 4, dict(gp=4, args=args),
                    **RANKS)
    from equidock_public_tpu_torch.parallel.ring_attention import (
        make_ring_cross_attention as port_ring)

    stacked = port_ring(ParallelMesh(1, 4, "cpu"))(*args)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(stacked.numpy(), want, rtol=0, atol=1e-5 * scale)
    for out in got:
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5 * scale)
        torch.testing.assert_close(out, stacked, rtol=0, atol=1e-6 * scale)
