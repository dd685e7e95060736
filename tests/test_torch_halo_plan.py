"""The port's halo planner and ring transport against the JAX package.

* `parallel/halo.py::build_halo_batch` of the port equals the JAX
  package's bit for bit (plans are indices): the permutations, every node
  array of the permuted pair, the remapped neighbour tables, every plan
  array and `HaloStats`, on `tests/utils.py::synth_batch` inputs (padded
  gp=2, a forced residual tier at gp=4, ragged at dp=2) and on one tracked
  512 x 1024 request.
* The plain versions of rows 8 and 9 (`ops/cuda/halo_ring.py`), and their
  autograd backwards, equal JAX `pallas_halo.ring_exchange` / `ring_ship`
  and their `jax.vjp` exactly, at gp=4 (interior shards and both chain
  ends), the JAX side inside `shard_map` in Mosaic interpret mode.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from equidock_public_tpu.parallel import halo as jh
from equidock_public_tpu.parallel import pallas_halo as jph
from equidock_public_tpu.parallel.mesh import make_mesh
from equidock_public_tpu_torch.config import load_config
from equidock_public_tpu_torch.eval.inference import featurize_request
from equidock_public_tpu_torch.graph import ProteinBatch
from equidock_public_tpu_torch.ops.cuda import halo_ring as hr
from equidock_public_tpu_torch.params import config_path, default_checkpoint
from equidock_public_tpu_torch.parallel import halo as th

from .torch_utils import f32_default, jax_batch, port_batch, port_halo_batch  # noqa: F401
from .utils import synth_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"padded_gp2": dict(gp=2), "residual_gp4": dict(gp=4, spatial=False, hmax=4),
         "ragged_dp2": dict(gp=2, ragged=True, dp=2),
         "ragged_gp4_dp2": dict(gp=4, ragged=True, dp=2)}


def assert_halo_batches_equal(got, want):
    for name in ("lig", "rec"):
        for f in dataclasses.fields(ProteinBatch):
            a, b = getattr(getattr(got.pair, name), f.name), getattr(getattr(want.pair, name), f.name)
            if b is None:                   # the packed segment ids of an unpacked batch
                assert a is None, f"{name}.{f.name}"
                continue
            assert a.shape == b.shape and torch.equal(a.to(b.dtype), b), f"{name}.{f.name}"
    for f in ("gt_lig", "pocket_lig", "pocket_rec", "pocket_mask", "pair_mask"):
        assert torch.equal(getattr(got.pair, f), getattr(want.pair, f)), f
    for side in ("plan_lig", "plan_rec"):
        for f in dataclasses.fields(th.HaloPlan):
            a, b = getattr(getattr(got, side), f.name), getattr(getattr(want, side), f.name)
            assert (a is None) == (b is None), f"{side}.{f.name}"
            if a is not None:
                assert a.dtype == torch.int32 and a.shape == b.shape and torch.equal(a, b), \
                    f"{side}.{f.name}"


def assert_stats_equal(got, want):
    for f in ("sizes_lig", "sizes_rec"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("hring_lig", "hring_rec", "hres_lig", "hres_rec", "ring_flat_lig",
              "ring_flat_rec", "dp"):
        assert getattr(got, f) == getattr(want, f), f
    for padded in (True, False):
        assert got.bytes_per_layer(64, padded) == want.bytes_per_layer(64, padded)
    B, n_l, n_r = 2, 16, 24
    assert (got.full_gather_bytes_per_layer(64, n_l, n_r, B)
            == want.full_gather_bytes_per_layer(64, n_l, n_r, B))


def check_planner(pb, jbatch, kw):
    jhb, jst, jpl, jpr = jh.build_halo_batch(jbatch, **kw)
    hb, st, pl, pr = th.build_halo_batch(pb, **kw)
    np.testing.assert_array_equal(pl, jpl)
    np.testing.assert_array_equal(pr, jpr)
    assert_halo_batches_equal(hb, port_halo_batch(jhb))
    assert_stats_equal(st, jst)
    return hb, st


@pytest.mark.parametrize("case", sorted(CASES))
def test_planner_matches_jax_on_synthetic_batches(rng, case):
    # hmax=4 forces both tiers to the shard width S = 16 / 4
    batch = synth_batch(rng, B=4, N_l=16, N_r=16, n_l=14, n_r=13, coord_scale=50.0)
    hb, st = check_planner(port_batch(batch), batch, CASES[case])
    if case == "residual_gp4":
        assert st.hres_lig == 4 and np.asarray(st.sizes_lig)[:, 0, 2:].sum() > 0


def test_planner_matches_jax_on_a_tracked_request():
    """1AVX -> 1N2C, buckets 512 x 1024, as the server featurizes it:
    padded gp=2, ragged gp=4 and a forced residual tier at gp=4."""
    with open(os.path.join(REPO, "equidock_public_tpu_torch", "assets",
                           "db5_model_best.golden.json")) as f:
        g = json.load(f)["requests"][0]
    cfg = load_config(config_path(default_checkpoint()))
    req = featurize_request(cfg, os.path.join(REPO, g["ligand"]),
                            os.path.join(REPO, g["receptor"]), "cpu")
    pb = req.batch
    assert (pb.lig.x.shape[1], pb.rec.x.shape[1]) == (512, 1024)
    jbatch = jax_batch(pb)
    _, st = check_planner(pb, jbatch, dict(gp=2))
    assert st.bytes_per_layer(64) < st.full_gather_bytes_per_layer(64, 512, 1024, 1)
    check_planner(pb, jbatch, dict(gp=4, ragged=True, dp=1))
    check_planner(pb, jbatch, dict(gp=4, spatial=False, hmax=64))


def test_planner_keeps_the_pair_on_its_device_and_dtypes(rng):
    pb = port_batch(synth_batch(rng, B=2, N_l=16, N_r=24, n_l=14, n_r=19))
    hb, _, _, _ = th.build_halo_batch(pb, gp=4, ragged=True, dp=2)
    assert hb.pair.lig.nbr.dtype == torch.int32 and hb.pair.lig.res_id.dtype == torch.int64
    assert hb.plan_rec.unpack_prev.shape[:3] == (2, 4, 1) and hb.plan_rec.ragged


# --------------------------------------------------------------------------- #
# Rows 8 and 9: the plain versions against the JAX ring (interpret mode)
# --------------------------------------------------------------------------- #

G, GP, BL, S, H, F = 2, 4, 2, 5, 3, 7


def _global(stacked):
    """(G, P, Bl, X, F) -> the shard_map global (G Bl, P X, F)."""
    g, p, b, x, f = stacked.shape
    return np.ascontiguousarray(stacked.transpose(0, 2, 1, 3, 4).reshape(g * b, p * x, f))


def _stacked(glob, x):
    """The inverse of `_global`, as a writable torch tensor."""
    return torch.from_numpy(np.array(np.asarray(glob).reshape(G, BL, GP, x, F)
                                     .transpose(0, 2, 1, 3, 4)))


def _shard_mapped(fn, n_in, n_out):
    spec = P("data", "graph", None)
    mesh = make_mesh(dp=G, gp=GP)
    return mesh, jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                               out_specs=spec if n_out == 1 else (spec,) * n_out,
                               check_vma=False)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_ring_exchange_plain_and_its_backward_match_jax(rng):
    local, sn, sp = _rand(rng, G, GP, BL, S, F), _rand(rng, G, GP, BL, H, F), _rand(rng, G, GP, BL, H, F)
    ct = _rand(rng, G, GP, BL, S + 2 * H, F)
    mesh, fn = _shard_mapped(lambda a, b, c: jph.ring_exchange(a, b, c, "graph", GP, True), 3, 1)
    with mesh:
        out, vjp = jax.vjp(jax.jit(fn), *(jnp.asarray(_global(a)) for a in (local, sn, sp)))
        jgrads = vjp(jnp.asarray(_global(ct)))
    want = _stacked(out, S + 2 * H)
    wgrads = [_stacked(g, x) for g, x in zip(jgrads, (S, H, H))]

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (local, sn, sp)]
    for fwd in (hr.ring_exchange_plain, hr.ring_exchange):   # autograd / the Function
        got = fwd(*leaves)
        assert torch.equal(got, want)
        grads = torch.autograd.grad(got, leaves, torch.from_numpy(ct))
        for g, w in zip(grads, wgrads):
            assert torch.equal(g, w)
    # chain ends: shard 0 received nothing from prev, shard gp-1 nothing from next
    assert not want[:, 0, :, S:S + H].any() and not want[:, -1, :, S + H:].any()
    assert not wgrads[1][:, -1].any() and not wgrads[2][:, 0].any()


def test_ring_ship_plain_and_its_backward_match_jax(rng):
    """Independent widths per direction, as the ragged tier ships them."""
    ra, rb = 6, 4
    a, b = _rand(rng, G, GP, BL, ra, F), _rand(rng, G, GP, BL, rb, F)
    ca, cb = _rand(rng, G, GP, BL, ra, F), _rand(rng, G, GP, BL, rb, F)
    mesh, fn = _shard_mapped(lambda x, y: jph.ring_ship(x, y, "graph", GP, True), 2, 2)
    with mesh:
        outs, vjp = jax.vjp(jax.jit(fn), jnp.asarray(_global(a)), jnp.asarray(_global(b)))
        jgrads = vjp((jnp.asarray(_global(ca)), jnp.asarray(_global(cb))))
    want = [_stacked(o, x) for o, x in zip(outs, (ra, rb))]
    wgrads = [_stacked(g, x) for g, x in zip(jgrads, (ra, rb))]

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (a, b)]
    for fwd in (hr.ring_ship_plain, hr.ring_ship):
        got = fwd(*leaves)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        grads = torch.autograd.grad(got, leaves, (torch.from_numpy(ca), torch.from_numpy(cb)))
        for g, w in zip(grads, wgrads):
            assert torch.equal(g, w)


def test_take_rows_transpose_sums_repeated_rows(rng):
    """Padding slots all name row 0 and a row can ship both ways: the
    transpose adds every slot's cotangent onto its row."""
    src = torch.from_numpy(_rand(rng, 2, 6, 5)).requires_grad_(True)
    idx = torch.tensor([[0, 0, 3, 5], [1, 1, 1, 0]], dtype=torch.int32)
    out = hr.take_rows(src, idx)
    assert torch.equal(out, src.detach()[torch.arange(2)[:, None], idx.long()])
    g = torch.from_numpy(_rand(rng, 2, 4, 5))
    (d,) = torch.autograd.grad(out, [src], g)
    want = torch.zeros(2, 6, 5)
    for b in range(2):
        for i in range(4):
            want[b, idx[b, i]] += g[b, i]
    torch.testing.assert_close(d, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(hr.take_rows_bwd_plain(idx, 6, g), want, rtol=0, atol=1e-6)
