"""The halo exchange as a gather by a fixed table (`parallel/halo.py::
exchange_table`, `ops/cuda/halo_ring.py`), on the CPU.

* The table is the ring composition: row ids (float64, id + 1) pushed
  through `ring_composition` (the takes, `ring_exchange_plain` or
  `ring_ship_plain` and the unpack, the residual transpose) come out as
  `src_row + 1` slot for slot, zeros where the table says -1; random f32
  rows through the Function (its CPU path, the table's index_select) equal
  the composition bit for bit. Padded gp=2 (dp 4 and 2), ragged gp=2
  (dp 2) and gp=4 (dp 1 and 2), a forced residual tier at gp=4, and the
  tracked 512 x 1024 request at full width.
* The backward: the sequential index_add_ over the inverse (the plain row
  9) is within 1e-12 of autograd through the composition in float64, and
  the inverse lists every read slot once, ascending within its row.
* A numpy emulation of the kernels' index arithmetic (every thread of the
  grid, both sides' block ranges, the folded mapping, the multiply-high
  divisions, the backward's rounds of up to 16 slots over long lists)
  writes every output float exactly once and equals the plain versions
  bit for bit, at each of the three (lanes, load width) variants the
  kernels are built for.
* Tables are built once a side per `build_halo_batch`, never in a forward
  or a training step; the CUDA wrappers refuse CPU tensors.
"""

import json
import os

import numpy as np
import pytest
import torch

from equidock_public_tpu_torch.config import Config, ModelConfig, TrainConfig, load_config
from equidock_public_tpu_torch.eval.inference import featurize_request
from equidock_public_tpu_torch.ops.cuda import halo_ring as hr
from equidock_public_tpu_torch.params import config_path, default_checkpoint, init_params
from equidock_public_tpu_torch.parallel import halo as th
from equidock_public_tpu_torch.parallel.mesh import ParallelMesh
from equidock_public_tpu_torch.train.step import create_train_state

from .torch_utils import f32_default, port_batch  # noqa: F401
from .utils import synth_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (planner options, dp, gp)
PLANS = {"padded_gp2_dp4": (dict(gp=2), 4, 2), "padded_gp2_dp2": (dict(gp=2), 2, 2),
         "ragged_gp2_dp2": (dict(gp=2, ragged=True, dp=2), 2, 2),
         "ragged_gp4_dp1": (dict(gp=4, ragged=True, dp=1), 1, 4),
         "ragged_gp4_dp2": (dict(gp=4, ragged=True, dp=2), 2, 4),
         "residual_gp4_dp2": (dict(gp=4, spatial=False, hmax=4), 2, 4)}


def _pair(seed=0):
    return port_batch(synth_batch(np.random.default_rng(seed), B=4, N_l=16, N_r=16, n_l=14,
                                  n_r=13, coord_scale=50.0))


def _sides(pair, kw, dp, gp, D=8, seed=0):
    """(mesh, [(ExchangeTable on the mesh, HaloPlan, x, h)] of both sides)
    with random f32 rows."""
    hb, _, _, _ = th.build_halo_batch(pair, **kw)
    mesh = ParallelMesh(dp, gp, "cpu")
    rng = np.random.default_rng(seed)
    out = []
    for side in ("lig", "rec"):
        tab = th.mesh_table(getattr(hb, "table_" + side), mesh)
        x = mesh.fold(getattr(hb.pair, side).x)
        h = torch.from_numpy(rng.standard_normal(tuple(x.shape[:2]) + (D,)).astype(np.float32))
        out.append((tab, getattr(hb, "plan_" + side), x, h))
    return mesh, out


def check_table_is_the_composition(mesh, sides):
    for tab, plan, x, h in sides:
        Bp, S = x.shape[:2]
        ids = (torch.arange(Bp * S, dtype=torch.float64) + 1).reshape(Bp, S, 1)
        xs, hs = th.ring_composition(ids.expand(Bp, S, 3), ids.expand(Bp, S, 2), plan, mesh)
        want = hr._table_to_folded(hr.gather_index(tab).reshape(Bp // tab.dims[4], tab.dims[4],
                                                                -1), tab).double() + 1
        want = torch.where(want > Bp * S, torch.zeros_like(want), want)
        assert torch.equal(xs[..., 0], want.reshape(Bp, -1))
        assert torch.equal(hs[..., 1], want.reshape(Bp, -1))
        got = th.halo_exchange(x, h, tab, mesh)
        for a, b in zip(got, th.ring_composition(x, h, plan, mesh)):
            assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_table_gather_equals_the_ring_composition(name):
    kw, dp, gp = PLANS[name]
    mesh, sides = _sides(_pair(), kw, dp, gp)
    check_table_is_the_composition(mesh, sides)
    if name.startswith("residual"):
        assert sides[0][1].send_res.shape[-1] == 4 * 4


@pytest.mark.parametrize("name", sorted(PLANS))
def test_inverse_sum_matches_autograd_through_the_composition(name):
    kw, dp, gp = PLANS[name]
    mesh, sides = _sides(_pair(1), kw, dp, gp)
    rng = np.random.default_rng(2)
    for tab, plan, x, h in sides:
        leaves = [x.double().requires_grad_(True), h.double().requires_grad_(True)]
        out = th.ring_composition(*leaves, plan, mesh)
        cts = [torch.from_numpy(rng.standard_normal(tuple(o.shape))) for o in out]
        want = torch.autograd.grad(out, leaves, cts)
        got = hr.exchange_bwd_plain(*cts, tab)
        for g, w in zip(got, want):
            assert g.dtype == torch.float64
            torch.testing.assert_close(g, w, rtol=0, atol=1e-12)
        # the inverse: every read slot once, ascending within each row
        order, offsets = tab.order.numpy(), tab.offsets.numpy()
        src = tab.src_row.numpy().reshape(-1)
        assert sorted(order.tolist()) == np.flatnonzero(src >= 0).tolist()
        for v in range(len(offsets) - 1):
            row = order[offsets[v]:offsets[v + 1]]
            assert (np.diff(row) > 0).all() and (src[row] == v).all()


def test_the_function_on_the_cpu_is_the_plain_versions():
    """The autograd Function over both sides: forward bit-equal to the
    composition, backward bit-equal to the sequential index_add_."""
    mesh, sides = _sides(_pair(3), *PLANS["ragged_gp2_dp2"][:1], 2, 2, D=16)
    leaves = [a.clone().requires_grad_(True) for _, _, x, h in sides for a in (x, h)]
    out = hr.halo_exchange_pair(*leaves, sides[0][0], sides[1][0])
    for (_, plan, x, h), got in zip(sides, (out[:2], out[2:])):
        for a, b in zip(got, th.ring_composition(x, h, plan, mesh)):
            assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(0)
    cts = [torch.randn(o.shape, generator=gen) for o in out]
    grads = torch.autograd.grad(out, leaves, cts)
    for i, (tab, _, _, _) in enumerate(sides):
        want = hr.exchange_bwd_plain(cts[2 * i], cts[2 * i + 1], tab)
        assert all(torch.equal(a, b) for a, b in zip(grads[2 * i:2 * i + 2], want))


def check_emulation(sides, D):
    """Both kernels emulated over both sides at once: each output float
    written once, values bit-equal to the plain versions. Returns the
    longest slot list."""
    args = [(x, h, tab) for tab, _, x, h in sides]
    vec = 4 if D % 4 == 0 else 1
    res, writes = hr.exchange_tiles_fwd(args, vec)
    for (x, h, tab), got, (wx, wh) in zip(args, res, writes):
        assert (wx == 1).all() and (wh == 1).all()
        assert all(torch.equal(a, b) for a, b in zip(got, hr.exchange_plain(x, h, tab)))
    gen = torch.Generator().manual_seed(1)
    cts = [(torch.randn(xo.shape, generator=gen), torch.randn(ho.shape, generator=gen), tab)
           for (xo, ho), (_, _, tab) in zip(res, args)]
    res, writes, longest = hr.exchange_tiles_bwd(cts, vec)
    for (gx, gh, tab), got, (wx, wh) in zip(cts, res, writes):
        assert (wx == 1).all() and (wh == 1).all()
        assert all(torch.equal(a, b) for a, b in zip(got, hr.exchange_bwd_plain(gx, gh, tab)))
    return longest


@pytest.mark.parametrize("name,D", [("padded_gp2_dp2", 64), ("ragged_gp4_dp2", 16),
                                    ("residual_gp4_dp2", 13), ("padded_gp2_dp4", 8)])
def test_kernel_index_arithmetic_covers_every_row_once(name, D):
    """Folded blocks at dp > 1 with Bl > 1 (dp 2) and Bl = 1 (dp 4); h as
    float4 (D 64, 16, 8) and as floats (D 13, 32 lanes a row)."""
    kw, dp, gp = PLANS[name]
    _, sides = _sides(_pair(4), kw, dp, gp, D=D)
    plans = hr.exchange_launch_plan([t.dims for t, _, _, _ in sides], [D, D],
                                    4 if D % 4 == 0 else 1, backward=False)
    assert plans[0].lpr == {64: 16, 16: 4, 13: 32, 8: 4}[D]
    check_emulation(sides, D)


def test_fast_division_is_exact():
    rng = np.random.default_rng(0)
    for d in [1, 2, 3, 5, 7, 16, 48, 256, 368, 656, 1000, 5120, 2 ** 20 + 1, 2 ** 30 + 3]:
        n = np.concatenate([rng.integers(0, 2 ** 31, 2000), np.arange(min(3 * d, 3000)),
                            [2 ** 31 - 1, d - 1, d, d + 1]])
        np.testing.assert_array_equal(hr.fast_div(n, d), n // d)


def test_launch_plan_takes_only_the_built_variants():
    """(lanes, floats a load) is (4, 4), (16, 4) or (32, 1), whatever the
    widths (rows wider than a group's loads loop over their columns); the
    wider side of a launch decides; rows fill whole blocks of 256 threads."""
    dims = [(4, 7, 14, 19, 2, 2), (4, 9, 18, 25, 2, 2)]
    for Ds, vec, lpr in [([16, 8], 4, 4), ([16, 64], 4, 16), ([128, 64], 4, 16),
                         ([13, 64], 1, 32), ([3, 200], 1, 32)]:
        for backward in (False, True):
            plans = hr.exchange_launch_plan(dims, Ds, vec, backward)
            assert {(p.lpr, p.vec) for p in plans} == {(lpr, vec)}
            for p, (Bp, S, _, Ssrc, _, _) in zip(plans, dims):
                assert p.rows == Bp * (S if backward else Ssrc)
                assert p.blocks == -(-p.rows // (hr.THREADS // lpr))
    with pytest.raises(ValueError, match="floats a load"):
        hr.exchange_launch_plan(dims, [16, 16], 2, False)


def test_mesh_table_refuses_a_mesh_it_does_not_fit():
    """A padded plan's table folds for any dp dividing B (the same
    tensors); a ragged one only for the dp it was packed for."""
    pair = _pair()
    hb, _, _, _ = th.build_halo_batch(pair, gp=2)
    for dp in (1, 2, 4):
        tab = th.mesh_table(hb.table_lig, ParallelMesh(dp, 2, "cpu"))
        assert tab.dp == dp and tab.src_row is hb.table_lig.src_row
    with pytest.raises(ValueError, match="does not fit"):
        th.mesh_table(hb.table_lig, ParallelMesh(1, 4, "cpu"))
    hb, _, _, _ = th.build_halo_batch(pair, gp=2, ragged=True, dp=2)
    assert th.mesh_table(hb.table_rec, ParallelMesh(2, 2, "cpu")).dp == 2
    with pytest.raises(ValueError, match="packed for"):
        th.mesh_table(hb.table_rec, ParallelMesh(1, 2, "cpu"))


def _request():
    with open(os.path.join(REPO, "equidock_public_tpu_torch", "assets",
                           "db5_model_best.golden.json")) as f:
        g = json.load(f)["requests"][0]
    cfg = load_config(config_path(default_checkpoint()))
    return featurize_request(cfg, os.path.join(REPO, g["ligand"]),
                             os.path.join(REPO, g["receptor"]), "cpu").batch


@pytest.mark.parametrize("kw,gp,longest", [(dict(gp=2), 2, 57),
                                           (dict(gp=4, ragged=True), 4, 137),
                                           (dict(gp=4, spatial=False, hmax=64), 4, 385)])
def test_full_width_request(kw, gp, longest):
    """1AVX -> 1N2C (512 x 1024) as served, D = 64: the table is the
    composition, and the emulated kernels over both sides cover every row
    once, bit-equal; each shard's row 0 collects every padding slot, so the
    backward walks lists of up to `longest` slots in rounds of 16."""
    mesh, sides = _sides(_request(), kw, 1, gp, D=64)
    check_table_is_the_composition(mesh, sides)
    assert check_emulation(sides, 64) == longest


def test_tables_are_built_once_a_batch():
    cfg = Config(model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=3,
                                   num_att_heads=4),
                 train=TrainConfig(sinkhorn_iters=20))
    pair = _pair(5)
    before = th.table_builds
    hb, _, _, _ = th.build_halo_batch(pair, gp=2)
    assert th.table_builds == before + 2
    params = init_params(cfg.model, 0)
    mesh = ParallelMesh(2, 2, "cpu")
    th.make_halo_forward(cfg, mesh)(params, hb)
    th.make_halo_train_step(cfg, mesh)(create_train_state(params, cfg, "cpu"), hb)
    assert th.table_builds == before + 2


def test_the_kernels_refuse_cpu_tensors():
    _, sides = _sides(_pair(), dict(gp=2), 2, 2)
    args = [(x, h, tab) for tab, _, x, h in sides]
    with pytest.raises(ValueError, match="cpu"):
        hr.exchange_kernel(args)
    with pytest.raises(ValueError, match="cpu"):
        hr.exchange_bwd_kernel(args)
