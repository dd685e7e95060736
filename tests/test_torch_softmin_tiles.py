"""The tile decomposition of the port's soft-min field kernels (rows 6 and
7, `csrc/softmin_field.cu`), emulated in float64 on the CPU by
`ops/cuda/softmin_field.py::softmin_tiles_fwd` / `softmin_tiles_bwd` (the
card runs the same decomposition in CUDA):

- own tiles of 32 x lane_points points, each a cluster of `splits` blocks of
  `warps` key ranges;
- the other set's tiles of 32 points that hold a weight != 0 (a_mask; the
  dA role's other set is the queries, weighted by the cotangent) dealt to
  the key ranges in turn; the others neither loaded nor visited;
- backward: own tiles whose own weights (c for dx, a_mask for dA) are all 0
  write zeros;
- partial sums added warp by warp within a block, then block by block in
  rank order.

The emulation runs in float64: it checks the decomposition, not f32
rounding. Held against the plain versions (`softmin_field_sums_plain`,
`softmin_field_bwd_plain`) in float64 at 1e-5 relative (norm-wise), and
against the JAX package's Pallas kernels in interpret mode on the same f32
inputs at the tolerances of tests/test_torch_softmin_field.py (S rtol 1e-4 /
atol 1e-5, dx and dA rtol 1e-3 / atol 1e-5), with the JAX side's products
at "highest" precision. Also the plan: every (own point, other point) pair
of a kept tile pair is walked exactly once, no dropped tile holds a weight
!= 0, and no key range holds more than its share of kept tiles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.ops.pallas import softmin_field as jsf
from equidock_public_tpu_torch.ops import softmin_field as tsf
from equidock_public_tpu_torch.ops.cuda import softmin_field as ksf

from .torch_utils import f32_default, t  # noqa: F401

SIGMA = 25.0
REL = 1e-5


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _prefix(rng, B, n, lo, hi):
    """0/1 masks whose first rng.integers(lo, hi) points are valid."""
    m = np.zeros((B, n), np.float32)
    for b in range(B):
        m[b, :rng.integers(lo, hi)] = 1
    return m


def _holes(rng, B, n, keep=0.6):
    """0/1 masks with holes: whole 32-point tiles dropped at random, and
    single points dropped inside the others."""
    tiles = rng.uniform(size=(B, -(-n // 32))) < keep
    m = np.repeat(tiles, 32, axis=1)[:, :n] & (rng.uniform(size=(B, n)) > 0.3)
    return m.astype(np.float32)


def _case(name):
    """(x, a, a_mask, c) f32 numpy of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    B, M, N = {"70x130": (2, 70, 130), "training": (10, 512, 512), "holes": (3, 300, 700),
               "all_masked": (2, 100, 150), "zero_cotangent": (2, 200, 90),
               "one_query": (2, 1, 200), "few_keys": (2, 100, 20)}[name]
    x = (rng.standard_normal((B, M, 3)) * 5).astype(np.float32)
    a = (rng.standard_normal((B, N, 3)) * 5 + 1).astype(np.float32)
    if name == "training":                       # split-chain halves, 70-274 valid
        qm, am = _prefix(rng, B, M, 70, 275), _prefix(rng, B, N, 70, 275)
    elif name == "holes":
        qm, am = _holes(rng, B, M), _holes(rng, B, N)
        am[1] = 0                                # a complex with every key masked
        qm[2] = 0                                # and one with no cotangent
    else:
        qm, am = np.ones((B, M), np.float32), np.ones((B, N), np.float32)
        qm[:, max(1, int(0.8 * M)):] = 0
        am[:, max(1, int(0.9 * N)):] = 0
        if name == "all_masked":
            am[1] = 0
    c = (rng.standard_normal((B, M)) * qm).astype(np.float32)
    if name == "zero_cotangent":
        c[:] = 0
    return x, a, am, c


NAMES = ["70x130", "training", "holes", "all_masked", "zero_cotangent", "one_query",
         "few_keys"]
# (lane points, warps, splits): the default plan (None) and others, so that
# ranges hold several tiles, clusters several blocks
PLANS = [None, (1, 4, 1), (2, 8, 2), (4, 16, 8), (1, 16, 3)]


def _rel(g, w):
    return float((g - w).norm()) / max(float(w.norm()), 1e-30)


def _plan(B, M, N, backward, p):
    if p is None:
        return ksf.softmin_tile_plan(B, M, N, backward=backward)
    return ksf.softmin_tile_plan(B, M, N, backward, *p)


def _t64(*arrays):
    return [t(v, torch.float64) for v in arrays]


# ------------------------------------------------------------------------- #
# The emulated kernels against the plain versions and the JAX package
# ------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", NAMES)
def test_emulated_forward_matches_plain(name):
    x, a, am, _ = _t64(*_case(name))
    got = ksf.softmin_tiles_fwd(x, a, am, SIGMA)
    want = tsf.softmin_field_sums_plain(x, a, am, SIGMA)
    assert _rel(got, want) < REL
    if name in ("all_masked", "holes"):
        assert (got[1] == 0).all()               # S = 0 where every key is masked


@pytest.mark.parametrize("name", NAMES)
def test_emulated_backward_matches_plain(name):
    x, a, am, c = _t64(*_case(name))
    dx, da = ksf.softmin_tiles_bwd(x, a, am, c, SIGMA)
    wdx, wda = tsf.softmin_field_bwd_plain(x, a, am, c, SIGMA)
    if name == "zero_cotangent":
        assert (dx == 0).all() and (da == 0).all() and (wdx == 0).all()
        return
    assert _rel(dx, wdx) < REL and _rel(da, wda) < REL
    if name in ("all_masked", "holes"):
        assert (da[1] == 0).all()                # dA = 0 where every key is masked
    if name == "holes":
        assert (dx[2] == 0).all() and (da[2] == 0).all()


@pytest.mark.parametrize("plan", PLANS[1:], ids=lambda p: "lp%d_w%d_s%d" % p)
def test_emulated_kernels_match_plain_on_other_plans(plan):
    x, a, am, c = _t64(*_case("holes"))
    B, M, N = x.shape[0], x.shape[1], a.shape[1]
    got = ksf.softmin_tiles_fwd(x, a, am, SIGMA, _plan(B, M, N, False, plan))
    assert _rel(got, tsf.softmin_field_sums_plain(x, a, am, SIGMA)) < REL
    got = ksf.softmin_tiles_bwd(x, a, am, c, SIGMA, _plan(B, M, N, True, plan))
    for g, w in zip(got, tsf.softmin_field_bwd_plain(x, a, am, c, SIGMA)):
        assert _rel(g, w) < REL


@pytest.mark.parametrize("name", ["70x130", "training", "holes", "one_query", "few_keys"])
def test_emulated_kernels_match_pallas(name):
    x, a, am, c = _case(name)
    J = lambda v: jnp.asarray(v)
    want = np.asarray(jsf.softmin_field_sums(J(x), J(a), J(am), SIGMA, True))
    got = ksf.softmin_tiles_fwd(t(x), t(a), t(am), SIGMA).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    _, vjp = jax.vjp(lambda x_, a_: jsf.softmin_field_sums(x_, a_, J(am), SIGMA, True),
                     J(x), J(a))
    wdx, wda = (np.asarray(g) for g in vjp(J(c)))
    dx, da = ksf.softmin_tiles_bwd(t(x), t(a), t(am), t(c), SIGMA)
    np.testing.assert_allclose(dx.numpy(), wdx, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(da.numpy(), wda, rtol=1e-3, atol=1e-5)


# ------------------------------------------------------------------------- #
# The plan
# ------------------------------------------------------------------------- #

def _coverage(own_w, oth_w, n_own, plan):
    """(B, n_own, n_oth) int: how often the kernel's walk visits each (own
    point, other point) pair, and (B, own tiles) bool of the own tiles that
    do any work."""
    B, n_oth = oth_w.shape
    own = plan.own_tile
    own_tiles = -(-n_own // own)
    own_keep = (torch.ones(B, own_tiles, dtype=torch.bool) if own_w is None
                else ksf.kept_tiles(own_w, own))
    seen = torch.zeros(B, n_own, n_oth, dtype=torch.int64)
    for b, ranges in enumerate(ksf.range_tiles(oth_w, plan.ranges)):
        assert len(ranges) == plan.splits * plan.warps
        for j in range(own_tiles):
            if not own_keep[b, j]:
                continue
            for tiles in ranges:
                assert tiles == sorted(tiles)
                for tt in tiles:
                    seen[b, j * own:(j + 1) * own, tt * ksf.KEY_TILE:(tt + 1) * ksf.KEY_TILE] += 1
    return seen, own_keep


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "default" if p is None else
                         "lp%d_w%d_s%d" % p)
def test_plan_walks_every_kept_pair_once(name, plan):
    _, _, am, c = (t(v) for v in _case(name))
    B, M = c.shape
    N = am.shape[1]
    for role, (own_w, oth_w, n_own) in {"forward": (None, am, M), "dx": (c, am, M),
                                        "dA": (am, c, N)}.items():
        p = _plan(B, M, N, role != "forward", plan)
        seen, own_keep = _coverage(own_w, oth_w, n_own, p)
        oth_keep = ksf.kept_tiles(oth_w, ksf.KEY_TILE)
        rows = own_keep.repeat_interleave(p.own_tile, dim=1)[:, :n_own]
        cols = oth_keep.repeat_interleave(ksf.KEY_TILE, dim=1)[:, :oth_w.shape[1]]
        want = (rows[:, :, None] & cols[:, None, :]).to(torch.int64)
        assert torch.equal(seen, want), role
        # no dropped tile holds a weight != 0
        assert (oth_w[~cols] == 0).all(), role
        if own_w is not None:
            assert (own_w[~rows] == 0).all(), role
        # kept tiles dealt in turn: no range holds more than its share
        for b, ranges in enumerate(ksf.range_tiles(oth_w, p.ranges)):
            share = -(-int(oth_keep[b].sum()) // p.ranges)
            assert max(len(r) for r in ranges) == share, role


def test_plan_splits_and_grid():
    """Splits give each key range about RANGE_TILES of the other set's tiles
    (the larger set's, backward), MAX_SPLITS at most; the grid holds a
    cluster an own tile."""
    fwd = ksf.softmin_tile_plan(10, 512, 512)
    assert (fwd.lane_points, fwd.warps, fwd.own_tile) == (1, 8, 32)
    assert fwd.splits == 1 and fwd.blocks == 10 * 16                # 16 key tiles
    bwd = ksf.softmin_tile_plan(10, 512, 512, backward=True)
    assert bwd.splits == 1 and bwd.blocks == 10 * 32
    big = ksf.softmin_tile_plan(2, 3072, 3072)
    assert big.splits == 2 and big.blocks == 2 * 96 * 2             # 96 key tiles
    assert ksf.softmin_tile_plan(2, 3072, 3072, backward=True).blocks == 2 * 192 * 2
    assert ksf.softmin_tile_plan(1, 100, 3072, backward=True).splits == 2
    assert ksf.softmin_tile_plan(1, 3072, 100, backward=True).splits == 2
    assert ksf.softmin_tile_plan(1, 64, 100000).splits == ksf.MAX_SPLITS
    assert ksf.softmin_tile_plan(2, 70, 130, False, 4, 16, 3) == (4, 16, 3, 2 * 1 * 3)
    with pytest.raises(ValueError, match="no kernel"):
        ksf.softmin_tile_plan(1, 64, 64, lane_points=3)
    with pytest.raises(ValueError, match="splits"):
        ksf.softmin_tile_plan(1, 64, 64, splits=9)


def test_emulated_kernels_at_full_width():
    """The largest node bucket's shape the main path gives the kernels, cut
    to one complex: 3072 x 3072, 80% / 90% valid."""
    rng = np.random.default_rng(3072)
    x = torch.from_numpy(rng.standard_normal((1, 3072, 3)) * 15)
    a = torch.from_numpy(rng.standard_normal((1, 3072, 3)) * 15 + 5)
    am = torch.ones(1, 3072, dtype=torch.float64)
    am[:, int(0.9 * 3072):] = 0
    c = torch.from_numpy(rng.standard_normal((1, 3072)))
    c[:, int(0.8 * 3072):] = 0
    got = ksf.softmin_tiles_fwd(x, a, am, SIGMA)
    assert _rel(got, tsf.softmin_field_sums_plain(x, a, am, SIGMA)) < REL
    for g, w in zip(ksf.softmin_tiles_bwd(x, a, am, c, SIGMA),
                    tsf.softmin_field_bwd_plain(x, a, am, c, SIGMA)):
        assert _rel(g, w) < REL
