"""The tile decomposition of the port's edge-message kernels, emulated in
torch on the CPU (`csrc/edge_message.cu`, `csrc/edge_message_bwd.cu`, with
`csrc/edge_tiles.cuh`; the card runs the same arithmetic in CUDA):

- tiles of TN = 64 // K whole destination nodes of one graph, the tile's
  TN K edges the rows of 64-row products (rows past them zero, mask 0);
- a tile whose masks are all 0 writes zeros (aggr, x_upd; dgx, dgh, dhe,
  ddx, ddh) and adds nothing to any sum;
- the forward's tiles dealt to the grid's blocks in turn; the backward's
  kept tiles (some edge with m != 0) dealt in turn, and its other tiles
  apart; each block's weight-gradient partials summed over its tiles and
  the partials summed in block order;
- the masked means and ddx / ddh one owner a (node, channel), the node's K
  edges in order; d_src by the scatter's transpose of the gather.

The emulation runs in float64: it checks the decomposition, not f32
rounding. Held against the plain versions (`edge_message_plain`,
`edge_message_bwd_plain`) in float64 at 1e-5 relative, and against the JAX
package's `edge_message_aggregate(interpret=True, fused_bwd=True)` on the
same f32 inputs at the tolerances of tests/test_torch_edge_message*.py
(forward rtol / atol 1e-4; backward rtol 1e-3, atol 1e-5). Also the tile
plan (`edge_tile_plan`) and the inverse neighbour list's threading: built
once per side per forward that records gradients, the same list handed to
every layer, none without gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.ops.pallas import edge_message as jem
from equidock_public_tpu_torch.config import Config, ModelConfig
from equidock_public_tpu_torch.data.featurize import ProteinGraph
from equidock_public_tpu_torch.data.synth import synth_graph
from equidock_public_tpu_torch.graph import pad_protein
from equidock_public_tpu_torch.models import iegmn as tm
from equidock_public_tpu_torch.ops.cuda import edge_message as em
from equidock_public_tpu_torch.params import init_params
from equidock_public_tpu_torch.parallel.halo import build_halo_batch, make_halo_forward
from equidock_public_tpu_torch.parallel.mesh import ParallelMesh

from .torch_utils import f32_default, port_batch, t  # noqa: F401
from .utils import synth_batch

REL = 1e-5
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
BWD_TOL = dict(rtol=1e-3, atol=1e-5)
SIG = torch.tensor(em.RBF_SIGMAS, dtype=torch.float64)


def _inputs(rng, B, N, Nsrc, D, valid, K=10, E=27):
    """Random f32 inputs; graph b has valid[b] nodes (0: every node padded),
    a valid node keeps each edge with probability 0.8."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    src, dst = f(B, Nsrc, 3 + D), f(B, N, 3 + D)
    src[..., :3] *= 4
    dst[..., :3] *= 4
    nbr = rng.integers(0, Nsrc, (B, N, K)).astype(np.int32)
    msk = (rng.uniform(size=(B, N, K)) > 0.2).astype(np.float32)
    for b, n in enumerate(valid):
        msk[b, n:] = 0
    he = f(B, N, K, E) * msk[..., None]
    prm = {k: f(*s) * 0.3 for k, s in em.param_shapes(D, E).items()}
    return src, dst, he, nbr, msk, prm, f(B, N, D), f(B, N, 3)


def _t64(arrays):
    src, dst, he, nbr, msk, prm, ga, gx = arrays
    d = lambda a: t(a, torch.float64)
    return (d(src), d(dst), d(he), t(nbr), d(msk), {k: d(v) for k, v in prm.items()},
            d(ga), d(gx))


def _leaky(x, slope):
    return torch.where(x >= 0, x, x * slope)


def _tile(src, dst, he, nbr, msk, p, b, node0, nodes, slope, use_ln, use_dist):
    """The staged rows and the forward of one tile: every per-row tensor has
    TILE_ROWS rows, those past the tile's edges zero with mask 0."""
    K, R, T = nbr.shape[2], nodes * nbr.shape[2], em.TILE_ROWS
    D = src.shape[-1] - 3
    i = node0 + torch.arange(R) // K
    k = torch.arange(R) % K
    s, d = src[b, nbr[b, i, k].long()], dst[b, i]
    z = lambda *shape: torch.zeros(T, *shape, dtype=torch.float64)
    h, xr, m = z(D), z(3), z()
    h[:R], xr[:R], m[:R] = s[:, 3:] + d[:, 3:], s[:, :3] - d[:, :3], msk[b, i, k]
    rbf = torch.exp(-(xr * xr).sum(-1, keepdim=True) / SIG) * float(use_dist)
    rbf[R:] = 0
    hr = torch.cat([z(he.shape[-1]), rbf], dim=1)
    hr[:R, :he.shape[-1]] = he[b, i, k]
    pre = h + hr @ torch.cat([p["Wc"], p["Wd"]])
    a0 = _leaky(pre, slope)
    mean = a0.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((a0 - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    nrm = (a0 - mean) * rstd
    act = nrm * p["ln_g"] + p["ln_b"] if use_ln else a0
    msg = act @ p["W2"] + p["b2"]
    c1p = msg @ p["W1c"] + p["b1c"]
    coef = _leaky(c1p, slope) @ p["W2c"] + p["b2c"]
    cnt = torch.clamp(m[:R].reshape(nodes, K).sum(-1), min=1.0)
    return dict(R=R, K=K, node=torch.arange(R) // K, xr=xr, m=m, hr=hr, pre=pre, nrm=nrm,
                rstd=rstd, act=act, msg=msg, c1p=c1p, coef=coef, cnt=cnt)


def _walk(B, N, tn, grid):
    """(block, graph, first node, nodes) of each tile in the kernels' order:
    block blk takes tiles blk, blk + grid, ..."""
    per_graph = -(-N // tn)
    for blk in range(grid):
        for ti in range(blk, B * per_graph, grid):
            b, node0 = ti // per_graph, (ti % per_graph) * tn
            yield blk, b, node0, min(tn, N - node0)


def _deal(msk, tn, grid):
    """The backward's order: (block, graph, first node, nodes, kept) of each
    tile, the kept tiles (some m != 0) dealt to the blocks in turn, the
    others likewise, by tile index."""
    B, N, _ = msk.shape
    per = -(-N // tn)
    tiles = [(t // per, (t % per) * tn) for t in range(B * per)]
    kept = [bool((msk[b, n0:n0 + tn] != 0).any()) for b, n0 in tiles]
    for flag in (True, False):
        mine = [t for t, k in zip(tiles, kept) if k == flag]
        for blk in range(grid):
            for b, n0 in mine[blk::grid]:
                yield blk, b, n0, min(tn, N - n0), flag


def edge_tiles_fwd(src, dst, he, nbr, msk, p, slope=0.01, use_ln=True, use_dist=True,
                   tn=None, grid=None, seen=None):
    """(aggr, x_upd) by the forward kernel's decomposition."""
    B, N, K = nbr.shape
    D = src.shape[-1] - 3
    plan = em.edge_tile_plan(B, N, D, K, backward=False)
    tn, grid = tn or plan[0], grid or plan[1]
    aggr = torch.full((B, N, D), float("nan"), dtype=torch.float64)
    xupd = torch.full((B, N, 3), float("nan"), dtype=torch.float64)
    for _, b, node0, nodes in _walk(B, N, tn, grid):
        rows = slice(node0, node0 + nodes)
        if not (msk[b, rows] != 0).any():
            aggr[b, rows], xupd[b, rows] = 0.0, 0.0
            if seen is not None:
                seen["masked"] += 1
            continue
        if seen is not None:
            seen["kept"] += 1
        r = _tile(src, dst, he, nbr, msk, p, b, node0, nodes, slope, use_ln, use_dist)
        R = r["R"]
        w = r["m"][:R, None]
        aggr[b, rows] = (w * r["msg"][:R]).reshape(nodes, K, D).sum(1) / r["cnt"][:, None]
        xupd[b, rows] = ((w * r["xr"][:R] * r["coef"][:R]).reshape(nodes, K, 3).sum(1)
                         / r["cnt"][:, None])
    return aggr, xupd


def edge_tiles_bwd(src, dst, he, nbr, msk, p, ga, gx, slope=0.01, use_ln=True,
                   use_dist=True, tn=None, grid=None, seen=None):
    """(dgx, dgh, dhe, ddx, ddh, per-block partials) by the backward kernel's
    decomposition."""
    B, N, K = nbr.shape
    D, E = src.shape[-1] - 3, he.shape[-1]
    plan = em.edge_tile_plan(B, N, D, K)
    tn, grid = tn or plan[0], grid or plan[1]
    nan = lambda *s: torch.full(s, float("nan"), dtype=torch.float64)
    dgx, dgh, dhe = nan(B, N * K, 3), nan(B, N * K, D), nan(B, N * K, E)
    ddx, ddh = nan(B, N, 3), nan(B, N, D)
    shapes = dict(em.param_shapes(D, E), W2c=(D,), b2c=())
    parts = {n: torch.zeros(grid, *shapes[n], dtype=torch.float64) for n in em.PARAM_NAMES}
    for blk, b, node0, nodes, kept in _deal(msk, tn, grid):
        rows, R = slice(node0, node0 + nodes), nodes * K
        edges = slice(node0 * K, node0 * K + R)
        if not kept:
            for out in (dgx, dgh, dhe):
                out[b, edges] = 0.0
            ddx[b, rows], ddh[b, rows] = 0.0, 0.0
            if seen is not None:
                seen["masked"] += 1
            continue
        r = _tile(src, dst, he, nbr, msk, p, b, node0, nodes, slope, use_ln, use_dist)
        T = em.TILE_ROWS
        gan = torch.zeros(T, D, dtype=torch.float64)
        gxn = torch.zeros(T, 3, dtype=torch.float64)
        gan[:R] = (ga[b, rows] / r["cnt"][:, None])[r["node"]]
        gxn[:R] = (gx[b, rows] / r["cnt"][:, None])[r["node"]]
        m = r["m"][:, None]
        g_coef = m * (gxn * r["xr"]).sum(-1, keepdim=True)
        g_c1p = g_coef * p["W2c"][:, 0] * torch.where(r["c1p"] >= 0, 1.0, slope)
        g_msg = m * gan + g_c1p @ p["W1c"].T
        g_act = g_msg @ p["W2"].T
        if use_ln:
            g_nrm = g_act * p["ln_g"]
            g_a0 = r["rstd"] * (g_nrm - g_nrm.mean(-1, keepdim=True)
                                - r["nrm"] * (g_nrm * r["nrm"]).mean(-1, keepdim=True))
        else:
            g_a0 = g_act
        g_pre = g_a0 * torch.where(r["pre"] >= 0, 1.0, slope)
        g_rbf = (g_pre @ p["Wd"].T) * r["hr"][:, E:] * (-1.0 / SIG)
        g_x = m * gxn * r["coef"] + 2 * r["xr"] * g_rbf.sum(-1, keepdim=True)
        dgx[b, edges], dgh[b, edges], dhe[b, edges] = g_x[:R], g_pre[:R], (g_pre @ p["Wc"].T)[:R]
        ddx[b, rows] = -g_x[:R].reshape(nodes, K, 3).sum(1)
        ddh[b, rows] = g_pre[:R].reshape(nodes, K, D).sum(1)
        dwcd = r["hr"].T @ g_pre
        add = {"Wc": dwcd[:E], "Wd": dwcd[E:], "W1c": r["msg"].T @ g_c1p,
               "W2": r["act"].T @ g_msg, "b1c": g_c1p.sum(0), "b2": g_msg.sum(0),
               "W2c": (_leaky(r["c1p"], slope) * g_coef).sum(0), "b2c": g_coef.sum(),
               "ln_g": (g_act * r["nrm"]).sum(0) if use_ln else 0.0,
               "ln_b": g_act.sum(0) if use_ln else 0.0}
        for n, v in add.items():
            parts[n][blk] += v
        if seen is not None:
            seen["kept"] += 1
    return dgx, dgh, dhe, ddx, ddh, parts


def _assemble(nbr, Nsrc, raw):
    """The CUDA path's assembly: the scatter's transpose of the gather, the
    partials summed in block order."""
    dgx, dgh, dhe, ddx, ddh, parts = raw
    B, N, K = nbr.shape
    shapes = em.param_shapes(dgh.shape[-1], dhe.shape[-1])
    total = {}
    for n in em.PARAM_NAMES:
        acc = torch.zeros(parts[n].shape[1:], dtype=torch.float64)
        for blk in range(parts[n].shape[0]):
            acc = acc + parts[n][blk]
        total[n] = acc.reshape(shapes[n])
    return (em.scatter_src_plain(nbr, Nsrc, dgx, dgh), torch.cat([ddx, ddh], -1),
            dhe.reshape(B, N, K, -1), total)


def _rel(g, w):
    return float((g - w).norm() / max(float(w.norm()), 1e-300))


def _flat(r):
    return [*r[:3], *(r[3][n] for n in em.PARAM_NAMES)]


# ------------------------------------------------------------------------- #
# The tile plan
# ------------------------------------------------------------------------- #

@pytest.mark.parametrize("B,N,K", [(10, 512, 10), (3, 300, 10), (2, 23, 16), (1, 30, 7)])
def test_tile_plan_puts_every_node_in_exactly_one_tile(B, N, K):
    for D in em.KERNEL_WIDTHS:
        for backward in (False, True):
            tn, grid = em.edge_tile_plan(B, N, D, K, backward=backward)
            assert tn == em.TILE_ROWS // K and tn * K <= em.TILE_ROWS
            seen = np.zeros((B, N), int)
            for _, b, node0, nodes in _walk(B, N, tn, grid):
                assert 0 < nodes <= tn
                seen[b, node0:node0 + nodes] += 1
            assert (seen == 1).all()


def test_tile_plan_keeps_the_grid_within_its_cap():
    """The forward takes a block a tile up to FWD_MAX_BLOCKS; the backward
    one block an SM, each writing one set of partials."""
    assert em.edge_tile_plan(1, 1024, 64, 10, backward=False) == (6, 171)
    assert em.edge_tile_plan(10, 512, 64, 10, backward=False) == (6, 860)
    assert em.edge_tile_plan(10, 512, 64, 10) == (6, em.BWD_MAX_BLOCKS)
    assert em.edge_tile_plan(10, 512, 16, 10) == (6, em.BWD_MAX_BLOCKS)
    assert em.edge_tile_plan(1, 9, 64, 10) == (6, 2)
    assert em.edge_tile_plan(40, 3072, 64, 10, backward=False)[1] == em.FWD_MAX_BLOCKS
    assert em.edge_tile_plan(2, 30, 16, 10, tile_nodes=3) == (3, 20)
    with pytest.raises(ValueError, match="exceed a tile"):
        em.edge_tile_plan(1, 30, 64, 10, tile_nodes=7)


# ------------------------------------------------------------------------- #
# The emulated kernels against the plain versions and the JAX package
# ------------------------------------------------------------------------- #

CASES = {"D64": dict(D=64), "D16": dict(D=16)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("opts", [(True, True), (False, True), (True, False)],
                         ids=["ln_dist", "no_ln", "no_dist"])
def test_emulated_kernels_match_plain(rng, case, opts):
    """N = 300 (not a multiple of 6 nodes), Nsrc = 337, graph 1 all padded,
    a grid small enough that each block walks several tiles."""
    use_ln, use_dist = opts
    a = _t64(_inputs(rng, 3, 300, 337, CASES[case]["D"], valid=(250, 0, 131)))
    seen = {"masked": 0, "kept": 0}
    fwd = edge_tiles_fwd(*a[:6], 0.01, use_ln, use_dist, grid=7, seen=seen)
    want = em.edge_message_plain(*a[:6], 0.01, use_ln, use_dist)
    for g, w in zip(fwd, want):
        assert _rel(g, w) < REL
    got = _assemble(a[3], 337, edge_tiles_bwd(*a, 0.01, use_ln, use_dist, grid=5, seen=seen))
    want = em.edge_message_bwd_plain(*a, 0.01, use_ln, use_dist)
    for g, w in zip(_flat(got), _flat(want)):
        assert _rel(g, w) < REL
    # graph 1's 50 tiles and graph 0's and 2's padded tails, both kernels
    assert seen["masked"] == 2 * (50 + 8 + 28) and seen["kept"] == 2 * (42 + 22)


def test_masked_tiles_write_zeros_and_add_nothing(rng):
    """Every output of an all-padded graph is exactly 0, and blocks that only
    met masked tiles write all-zero partials."""
    a = _t64(_inputs(rng, 2, 60, 60, 16, valid=(12, 0)))
    aggr, xupd = edge_tiles_fwd(*a[:6])
    assert (aggr[1] == 0).all() and (xupd[1] == 0).all()
    dgx, dgh, dhe, ddx, ddh, parts = edge_tiles_bwd(*a, grid=4)
    for out in (dgx, dgh, dhe, ddx, ddh):
        assert (out[1] == 0).all() and not torch.isnan(out).any()
    # 20 tiles: only tiles 0 and 1 (graph 0's 12 valid nodes) keep an edge,
    # dealt to blocks 0 and 1
    for n in em.PARAM_NAMES:
        assert (parts[n][2:] == 0).all() and (parts[n][:2] != 0).any()


def test_backward_deals_kept_tiles_in_turn():
    """Kept tiles go to the blocks in turn, so no block holds more than one
    kept tile above another. On the masks of chip_smoke's training case (10
    kNN graphs of 70-274 nodes padded to 512) plain turns over all tiles
    would give some blocks a fourth kept tile where three do."""
    rng = np.random.default_rng(5)
    sides = []
    for _ in range(10):
        d = synth_graph(rng, int(rng.integers(70, 275)), 10)
        sides.append(pad_protein(ProteinGraph(
            res_id=d["res_id"], x=d["x"], mu_r_norm=d["mu_r_norm"], nbr=d["nbr"],
            nbr_mask=d["nbr_mask"], edge_feat=d["edge_feat"]), 512)["nbr_mask"])
    msk = torch.from_numpy(np.stack(sides))
    tn, grid = em.edge_tile_plan(10, 512, 64, 10)
    count = np.zeros(grid, int)
    seen = np.zeros((10, 512), int)
    flags = em.tile_keep(msk, tn)          # the forward kernel's flags, plain
    per = -(-512 // tn)
    for blk, b, node0, nodes, kept in _deal(msk, tn, grid):
        count[blk] += kept
        seen[b, node0:node0 + nodes] += 1
        assert flags[b * per + node0 // tn] == kept
    assert (seen == 1).all() and count.max() - count.min() <= 1
    plain = np.zeros(grid, int)
    for blk, b, node0, nodes in _walk(10, 512, tn, grid):
        plain[blk] += bool(msk[b, node0:node0 + nodes].any())
    assert plain.max() > count.max()


@pytest.mark.parametrize("D", [16, 64])
def test_emulated_kernels_match_pallas(rng, D):
    """The fused Pallas kernels in interpret mode on the same f32 inputs:
    B=2, N=80 (not a multiple of 6 nodes), Nsrc=93, graph 1 all padded."""
    arrays = _inputs(rng, 2, 80, 93, D, valid=(61, 0))
    src, dst, he, nbr, msk, prm, ga, gx = arrays
    J = jnp.asarray

    def f(s, d, h, p):
        return jem.edge_message_aggregate(s, d, h, J(nbr), J(msk), p, 0.01, True, True,
                                          True, True)

    out, vjp = jax.vjp(f, J(src), J(dst), J(he), {k: J(v) for k, v in prm.items()})
    w_src, w_dst, w_he, w_prm = vjp((J(ga), J(gx)))
    a = _t64(arrays)
    for g, w in zip(edge_tiles_fwd(*a[:6]), out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)
    got = _assemble(a[3], 93, edge_tiles_bwd(*a))
    for name, g, w in (("src", got[0], w_src), ("dst", got[1], w_dst), ("he", got[2], w_he)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **BWD_TOL)
    for n in em.PARAM_NAMES:
        np.testing.assert_allclose(got[3][n].numpy(), np.asarray(w_prm[n]), err_msg=n,
                                   **BWD_TOL)


def test_emulated_kernels_at_full_width():
    """The training batch's shape: B=10, N=512, 70-274 valid nodes a graph,
    K=10, E=27, D=64, the plan's own tiles and grid."""
    rng = np.random.default_rng(5)
    a = _t64(_inputs(rng, 10, 512, 512, 64, valid=rng.integers(70, 275, 10)))
    for g, w in zip(edge_tiles_fwd(*a[:6]), em.edge_message_plain(*a[:6])):
        assert _rel(g, w) < REL
    got = _assemble(a[3], 512, edge_tiles_bwd(*a))
    for g, w in zip(_flat(got), _flat(em.edge_message_bwd_plain(*a))):
        assert _rel(g, w) < REL


# ------------------------------------------------------------------------- #
# The inverse neighbour list: once per side per forward
# ------------------------------------------------------------------------- #

def _recording(monkeypatch, module):
    calls = []
    inner = module.edge_message_aggregate

    def record(src, dst, he, nbr, msk, params, **kw):
        calls.append((nbr, kw.get("inverse")))
        return inner(src, dst, he, nbr, msk, params, **kw)

    monkeypatch.setattr(module, "edge_message_aggregate", record)
    return calls


def _check_shared(calls, builds, nbrs, n_lays):
    """One list per side, the same object handed to every layer of that
    side, and it is nbr's inverse list (for the given source rows)."""
    assert builds == 2 and len(calls) == 2 * n_lays
    for side in (0, 1):
        mine = calls[side::2]
        assert all(c[0] is nbrs[side] and c[1] is mine[0][1] for c in mine)
        order, offsets = mine[0][1]
        assert order.dtype == offsets.dtype == torch.int32 and int(offsets[-1]) == order.numel()
    return [calls[0][1], calls[1][1]]


def test_forward_builds_one_inverse_list_per_side(rng, monkeypatch):
    cfg = ModelConfig(residue_emb_dim=16, iegmn_lay_hid_dim=16, iegmn_n_lays=3,
                      num_att_heads=4)
    batch = port_batch(synth_batch(rng, B=2, N_l=16, N_r=24, n_l=12, n_r=19))
    calls = _recording(monkeypatch, tm)
    before = em.inverse_builds
    tm.docking_forward(init_params(cfg, 0), cfg, batch)
    inv = _check_shared(calls, em.inverse_builds - before, (batch.lig.nbr, batch.rec.nbr), 3)
    for side, (order, offsets) in zip((batch.lig, batch.rec), inv):
        want = em.inverse_neighbors(side.nbr, side.nbr.shape[1])
        assert torch.equal(order, want[0]) and torch.equal(offsets, want[1])
    # a forward without gradients has no backward to read a list: none built
    calls.clear()
    before = em.inverse_builds
    with torch.no_grad():
        tm.docking_forward(init_params(cfg, 0), cfg, batch)
    assert em.inverse_builds == before and all(c[1] is None for c in calls)


def test_halo_forward_builds_one_inverse_list_per_side(rng, monkeypatch):
    """The halo path's remapped nbr index its source view (the local block
    and the received halo rows): one list per side over those rows."""
    cfg = Config(model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=3,
                                   num_att_heads=4))
    batch = port_batch(synth_batch(rng, B=4, N_l=16, N_r=16, n_l=14, n_r=13,
                                   coord_scale=50.0))
    hb, _, _, _ = build_halo_batch(batch, gp=2)
    calls = _recording(monkeypatch, tm)
    before = em.inverse_builds
    make_halo_forward(cfg, ParallelMesh(4, 2, "cpu"))(init_params(cfg.model, 0), hb)
    nbrs = (calls[0][0], calls[1][0])
    inv = _check_shared(calls, em.inverse_builds - before, nbrs, 3)
    for nbr, (order, offsets) in zip(nbrs, inv):
        assert offsets.numel() - 1 > nbr.shape[0] * nbr.shape[1]    # Nsrc > N: halo rows
