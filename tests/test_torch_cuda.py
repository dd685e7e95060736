"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the model forward on the card against the CPU path. These tests need a
CUDA card and skip without one; they import no JAX, so they also run on the
card's machine, where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: both sides f32 FMA in different orders, rtol/atol 1e-4; the
model, five products deep, atol 1e-3. Gradients (the backward kernels
against autograd through the plain versions) are held norm-wise,
||kernel - plain|| <= 1e-4 ||plain|| per tensor: an edge whose
pre-activation lies within rounding of 0 takes the other branch of
LeakyReLU's derivative in one of the two (the kernel and cuBLAS sum in
other orders), which moves that one edge's cotangents by up to 99%, a
single-entry change that an elementwise bound would report as a fault.
Model gradients on the card against the CPU path: norm-wise 1e-3. The
soft-min field kernels (smooth): S at rtol 1e-5 / atol 1e-4, dx and dA
norm-wise 1e-5; the fused-intersection step against the unfused one at
rtol 1e-4. The halo ring kernels move floats: bit for bit. Every backward
gives the same bits on two launches."""

import numpy as np
import pytest
import torch

from equidock_public_tpu_torch.config import ModelConfig
from equidock_public_tpu_torch.graph import PairBatch, ProteinBatch
from equidock_public_tpu_torch.models.iegmn import docking_forward
from equidock_public_tpu_torch.ops.cuda import cross_attention as ca
from equidock_public_tpu_torch.ops.cuda import edge_message as em
from equidock_public_tpu_torch.params import init_params

from .torch_utils import f32_default  # noqa: F401

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _edge_inputs(rng, dev, B=1, N=512, D=64, E=27, K=10, n_valid=431):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    src, dst = f(B, N, 3 + D), f(B, N, 3 + D)
    src[..., :3] *= 8
    dst[..., :3] *= 8
    nbr = torch.from_numpy(rng.integers(0, n_valid, (B, N, K)).astype(np.int32))
    msk = torch.from_numpy((rng.uniform(size=(B, N, K)) > 0.2).astype(np.float32))
    msk[:, n_valid:] = 0
    he = f(B, N, K, E) * msk[..., None]
    prm = {k: (f(*s) * 0.3).to(dev) for k, s in em.param_shapes(D, E).items()}
    return tuple(x.to(dev) for x in (src, dst, he, nbr, msk)) + (prm,)


@pytest.mark.parametrize("N", [512, 1024])
@pytest.mark.parametrize("use_ln,use_dist", [(True, True), (False, True), (True, False)])
def test_edge_kernel_matches_plain(cuda, N, use_ln, use_dist):
    args = _edge_inputs(np.random.default_rng(N), cuda, N=N)
    before = em.launches
    got = em.edge_message_aggregate(*args, use_ln=use_ln, use_dist=use_dist)
    assert em.launches == before + 1
    want = em.edge_message_plain(*args, use_ln=use_ln, use_dist=use_dist)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_edge_kernel_rejects_what_it_does_not_take(cuda):
    src, dst, he, nbr, msk, prm = _edge_inputs(np.random.default_rng(0), cuda)
    with pytest.raises(ValueError, match="dtype"):
        em.edge_message_aggregate(src, dst, he, nbr.long(), msk, prm)
    with pytest.raises(ValueError, match="contiguous"):
        em.edge_message_aggregate(src, dst, he.transpose(1, 2).contiguous().transpose(1, 2),
                                  nbr, msk, prm)
    with pytest.raises(ValueError, match="D=48"):   # the kernel is built for D=64
        bad = _edge_inputs(np.random.default_rng(0), cuda, N=8, D=48, n_valid=8)
        em.edge_message_aggregate(*bad)


@pytest.mark.parametrize("N,M,D,Dv,tags", [
    (172, 548, 64, 64, False), (512, 1024, 69, 69, False), (33, 70, 96, 3, False),
    (9, 40, 16, 16, False), (172, 548, 64, 64, True), (300, 1000, 64, 64, False),
    (40, 100, 32, 20, False)])
def test_attention_kernel_matches_plain(cuda, N, M, D, Dv, tags):
    """Widths pad to a multiple of 8; N and M are not multiples of the 64-row
    tile; the forward and its combine pass launch once a call and give the
    same bits twice."""
    gen = torch.Generator().manual_seed(N + M)
    q, k = torch.randn(2, N, D, generator=gen), torch.randn(2, M, D, generator=gen)
    v = torch.randn(2, M, Dv, generator=gen)
    qt, kt = torch.ones(2, N), torch.ones(2, M)
    qt[:, N // 3:] = 0                 # padded query rows
    kt[0, M // 2:] = 0
    kt[1] = 0                          # a complex with no valid key at all
    if tags:
        qt *= torch.randint(1, 4, (2, N), generator=gen)
        kt *= torch.randint(1, 4, (2, M), generator=gen)
    args = [x.to(cuda) for x in (q, k, v, qt, kt)]
    before = (ca.launches, ca.combine_launches)
    got = ca.cross_attention_fwd(*args)
    assert (ca.launches, ca.combine_launches) == (before[0] + 1, before[1] + 1)
    want = ca.cross_attention_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    assert all(torch.equal(g, a) for g, a in zip(got, ca.cross_attention_fwd(*args)))


def _batch(rng, dev, N_l=64, N_r=96, n_l=50, n_r=80, K=10):
    def side(N, n):
        x = rng.standard_normal((1, N, 3)).astype(np.float32) * 10
        nbr = rng.integers(0, n, (1, N, K)).astype(np.int32)
        nm = np.zeros((1, N), np.float32)
        nm[:, :n] = 1
        msk = (rng.uniform(size=(1, N, K)) > 0.2).astype(np.float32) * nm[..., None]
        T = lambda a: torch.from_numpy(a).to(dev)
        return ProteinBatch(res_id=T(rng.integers(0, 21, (1, N))), x=T(x),
                            mu_r_norm=T((np.abs(rng.standard_normal((1, N, 5))) + 0.5
                                         ).astype(np.float32)),
                            nbr=T(nbr), nbr_mask=T(msk),
                            edge_feat=T(rng.standard_normal((1, N, K, 27)).astype(np.float32)
                                        * msk[..., None]),
                            node_mask=T(nm))
    z = torch.zeros(1, 4, 3, device=dev)
    return PairBatch(lig=side(N_l, n_l), rec=side(N_r, n_r), gt_lig=torch.zeros(1, N_l, 3, device=dev),
                     pocket_lig=z, pocket_rec=z, pocket_mask=torch.ones(1, 4, device=dev),
                     pair_mask=torch.ones(1, device=dev))


def test_model_on_the_card_matches_the_cpu_path(cuda):
    cfg = ModelConfig(residue_emb_dim=16, iegmn_lay_hid_dim=64, iegmn_n_lays=3,
                      shared_layers=True, num_att_heads=8)
    batch_cpu = _batch(np.random.default_rng(1), "cpu")
    batch_gpu = _batch(np.random.default_rng(1), cuda)
    e0, a0 = em.launches, ca.launches
    with torch.inference_mode():
        got = docking_forward(init_params(cfg, 0, cuda), cfg, batch_gpu)
        want = docking_forward(init_params(cfg, 0, "cpu"), cfg, batch_cpu)
    assert em.launches - e0 == 6 and ca.launches - a0 == 6
    for key in ("R", "t", "ligand_coords"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4, atol=1e-3)


def test_attention_kernel_rejects_widths_past_96(cuda):
    q = torch.zeros(1, 4, 128, device=cuda)
    t = torch.ones(1, 4, device=cuda)
    with pytest.raises(ValueError, match="D=128"):
        ca.cross_attention_fwd(q, q, q, t, t)


def _assert_grads_close(got, want, names, rel=1e-4):
    for g, w, name in zip(got, want, names):
        assert torch.isfinite(g).all(), name
        err = float((g - w).norm()) / max(float(w.norm()), 1e-12)
        assert err <= rel, f"{name}: relative error {err:.3g} > {rel}"


@pytest.mark.parametrize("N", [512, 200])
@pytest.mark.parametrize("use_ln,use_dist", [(True, True), (False, True), (True, False)])
def test_edge_bwd_kernel_matches_plain(cuda, N, use_ln, use_dist):
    """N=200 is not a multiple of the block's 4 nodes times the grid."""
    src, dst, he, nbr, msk, prm = _edge_inputs(np.random.default_rng(N), cuda, B=2, N=N,
                                               n_valid=min(N, 431))
    gen = torch.Generator().manual_seed(N)
    ga = torch.randn(2, N, 64, generator=gen).to(cuda)
    gx = torch.randn(2, N, 3, generator=gen).to(cuda)
    args = (src, dst, he, nbr, msk, prm, ga, gx)
    before = em.bwd_launches
    got = em.edge_message_bwd(*args, use_ln=use_ln, use_dist=use_dist)
    assert em.bwd_launches == before + 1
    want = em.edge_message_bwd_plain(*args, use_ln=use_ln, use_dist=use_dist)
    torch.cuda.synchronize()
    names = ["d_src", "d_dst", "d_he"] + list(em.PARAM_NAMES)
    _assert_grads_close([*got[:3], *(got[3][n] for n in em.PARAM_NAMES)],
                        [*want[:3], *(want[3][n] for n in em.PARAM_NAMES)], names)


@pytest.mark.parametrize("N,M,D,Dv,tags", [
    (172, 548, 64, 64, False), (512, 512, 69, 69, False), (33, 70, 96, 3, False),
    (9, 40, 16, 16, False), (172, 548, 64, 64, True), (40, 100, 32, 20, False),
    (300, 1000, 64, 64, False)])
def test_attention_bwd_kernels_match_plain(cuda, N, M, D, Dv, tags):
    gen = torch.Generator().manual_seed(N + M)
    q, k = torch.randn(2, N, D, generator=gen) * 0.3, torch.randn(2, M, D, generator=gen) * 0.3
    v = torch.randn(2, M, Dv, generator=gen)
    do = torch.randn(2, N, Dv, generator=gen)
    qt, kt = torch.ones(2, N), torch.ones(2, M)
    qt[:, N // 3:] = 0
    kt[0, M // 2:] = 0
    kt[1] = 0
    if tags:
        qt *= torch.randint(1, 4, (2, N), generator=gen)
        kt *= torch.randint(1, 4, (2, M), generator=gen)
    q, k, v, qt, kt, do = (x.to(cuda) for x in (q, k, v, qt, kt, do))
    o, lse = ca.cross_attention_plain(q, k, v, qt, kt)
    counts = lambda: (ca.dq_launches, ca.dq_combine_launches, ca.dkv_launches,
                      ca.dkv_combine_launches)
    before = counts()
    got = ca.cross_attention_bwd(q, k, v, qt, kt, o, lse, do)
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1, 1)
    want = ca.cross_attention_bwd_plain(q, k, v, qt, kt, do)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, ["dq", "dk", "dv"])
    again = ca.cross_attention_bwd(q, k, v, qt, kt, o, lse, do)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_attention_combines_match_plain(cuda):
    """Each combine pass of rows 3-5 against its plain version on the
    partials its kernel writes, one launch a call."""
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, n, 64, generator=gen).to(cuda) * 0.3
                   for n in (300, 1000, 1000, 300))
    qt, kt = torch.ones(2, 300, device=cuda), torch.ones(2, 1000, device=cuda)
    qt[:, 250:] = 0
    kt[:, 900:] = 0
    o, lse = ca.cross_attention_plain(q, k, v, qt, kt)
    bwd = (q, k, v, qt, kt, lse, do, (do * o).sum(-1).contiguous())
    for parts, combine, plain, counter in (
            (ca.fwd_partials(q, k, v, qt, kt), ca.fwd_combine, ca.fwd_combine_plain,
             "combine_launches"),
            ((ca.dq_partials(*bwd),), ca.dq_combine, ca.split_sum_plain, "dq_combine_launches"),
            (ca.dkv_partials(*bwd), ca.dkv_combine, ca.split_sum_plain,
             "dkv_combine_launches")):
        before = getattr(ca, counter)
        got = combine(*parts)
        assert getattr(ca, counter) == before + 1
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, plain(*parts)):
            torch.testing.assert_close(g, w, **TOL)


def test_model_gradients_on_the_card_match_the_cpu_path(cuda):
    """Autograd through both kernels' Functions reaches every parameter."""
    from equidock_public_tpu_torch.params import flatten, unflatten

    cfg = ModelConfig(residue_emb_dim=16, iegmn_lay_hid_dim=64, iegmn_n_lays=3,
                      shared_layers=True, num_att_heads=8)
    grads = {}
    for dev in (cuda, "cpu"):
        flat = {k: v.requires_grad_(True) for k, v in flatten(init_params(cfg, 0, dev)).items()}
        batch = _batch(np.random.default_rng(1), dev)
        out = docking_forward(unflatten(flat), cfg, batch)
        w = torch.linspace(-1, 1, out["ligand_coords"].numel()).reshape(
            out["ligand_coords"].shape).to(dev)
        (out["ligand_coords"] * w).sum().backward()
        grads[str(dev)] = {k: v.grad for k, v in flat.items()}
    for key, want in grads["cpu"].items():
        assert grads[str(cuda)][key] is not None, key
    keys = sorted(grads["cpu"])
    _assert_grads_close([grads[str(cuda)][k].cpu() for k in keys],
                        [grads["cpu"][k] for k in keys], keys, rel=1e-3)


def test_train_step_on_the_card_gives_every_leaf_a_finite_gradient(cuda):
    """A training step through all five kernels: no parameter is left with
    no gradient (a backward that stopped at a kernel would leave it None),
    every gradient is finite, and each kernel runs once per layer and side."""
    import dataclasses

    from equidock_public_tpu_torch.config import Config, TrainConfig
    from equidock_public_tpu_torch.params import flatten
    from equidock_public_tpu_torch.train.step import (create_train_state, eval_step,
                                                      loss_and_grads, train_step)

    cfg = Config(model=ModelConfig(residue_emb_dim=16, iegmn_lay_hid_dim=64, iegmn_n_lays=3,
                                   shared_layers=True, num_att_heads=8),
                 train=TrainConfig(sinkhorn_iters=20))
    batch = _batch(np.random.default_rng(2), cuda)
    batch = dataclasses.replace(batch, gt_lig=batch.lig.x + 1.0)
    state = create_train_state(init_params(cfg.model, 0, cuda), cfg, cuda)
    counts = lambda: (em.launches, em.bwd_launches, ca.launches, ca.dq_launches,
                      ca.dkv_launches)
    before = counts()
    grads, _, _ = loss_and_grads(state.params, cfg, batch)
    assert tuple(a - b for a, b in zip(counts(), before)) == (6, 6, 6, 6, 6)
    assert set(grads) == set(flatten(state.params))
    for key, g in grads.items():
        assert g is not None and torch.isfinite(g).all(), key
    new, metrics = train_step(state, batch, cfg)
    assert new.step == 1 and torch.isfinite(metrics["loss"])
    for key, v in flatten(new.params).items():
        assert torch.isfinite(v).all(), key
    evaluated = eval_step(new.params, batch, cfg)
    assert torch.isfinite(evaluated["loss"]) and evaluated["ligand_coords"].is_cuda


def test_backward_kernels_reject_what_they_do_not_take(cuda):
    src, dst, he, nbr, msk, prm = _edge_inputs(np.random.default_rng(0), cuda, N=16, n_valid=16)
    ga, gx = torch.zeros(1, 16, 64, device=cuda), torch.zeros(1, 16, 3, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        em.edge_message_bwd(src, dst, he, nbr.long(), msk, prm, ga, gx)
    with pytest.raises(ValueError, match="g_aggr"):
        em.edge_message_bwd(src, dst, he, nbr, msk, prm, ga[:, :8].contiguous(), gx)
    q = torch.zeros(1, 4, 16, device=cuda)
    tag = torch.ones(1, 4, device=cuda)
    with pytest.raises(ValueError, match="dout"):
        ca.cross_attention_bwd(q, q, q, tag, tag, q, tag, q.double())
    wide = torch.zeros(1, 4, 128, device=cuda)
    with pytest.raises(ValueError, match="D=128"):
        ca.cross_attention_bwd(wide, wide, wide, tag, tag, wide, tag, wide)


@pytest.mark.parametrize("N", [512, 200])
def test_edge_kernels_at_width_16_match_plain(cuda, N):
    """D = 16, the small DB5 models' width: 16 groups of half a warp a block."""
    src, dst, he, nbr, msk, prm = _edge_inputs(np.random.default_rng(N), cuda, B=2, N=N,
                                               D=16, n_valid=min(N, 431))
    got = em.edge_message_aggregate(src, dst, he, nbr, msk, prm)
    want = em.edge_message_plain(src, dst, he, nbr, msk, prm)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    gen = torch.Generator().manual_seed(N)
    ga = torch.randn(2, N, 16, generator=gen).to(cuda)
    gx = torch.randn(2, N, 3, generator=gen).to(cuda)
    args = (src, dst, he, nbr, msk, prm, ga, gx)
    got = em.edge_message_bwd(*args)
    want = em.edge_message_bwd_plain(*args)
    torch.cuda.synchronize()
    names = ["d_src", "d_dst", "d_he"] + list(em.PARAM_NAMES)
    _assert_grads_close([*got[:3], *(got[3][n] for n in em.PARAM_NAMES)],
                        [*want[:3], *(want[3][n] for n in em.PARAM_NAMES)], names)


@pytest.mark.parametrize("D", [64, 16])
def test_edge_bwd_is_bit_reproducible(cuda, D):
    """Two launches on the same inputs give the same bits, d_src included
    (its sum runs over each row's edges in a fixed order, no atomics)."""
    src, dst, he, nbr, msk, prm = _edge_inputs(np.random.default_rng(3), cuda, B=3, N=512, D=D)
    gen = torch.Generator().manual_seed(3)
    ga, gx = torch.randn(3, 512, D, generator=gen).to(cuda), torch.randn(3, 512, 3, generator=gen).to(cuda)
    s0 = em.scatter_launches
    runs = [em.edge_message_bwd(src, dst, he, nbr, msk, prm, ga, gx) for _ in range(2)]
    assert em.scatter_launches == s0 + 2
    flat = lambda r: [*r[:3], *(r[3][n] for n in em.PARAM_NAMES)]
    for a, b in zip(flat(runs[0]), flat(runs[1])):
        assert torch.equal(a, b)


def _tile_edge_inputs(rng, dev, D, B=3, N=300, nsrc=337, n_valid=(250, 0, 131)):
    """The edges of the kernels' tiles of 64 // K nodes: N not a multiple of
    6, graph 1 all padded, a source wider than the destinations."""
    src, dst, he, nbr, msk, prm = _edge_inputs(rng, dev, B=B, N=N, D=D, n_valid=N)
    for b, n in enumerate(n_valid):
        msk[b, n:] = 0
    he = he * msk[..., None]
    src = torch.cat([src, torch.randn(B, nsrc - N, 3 + D, device=dev)], dim=1).contiguous()
    nbr = torch.randint(0, nsrc, nbr.shape, device=dev, dtype=torch.int32)
    gen = torch.Generator().manual_seed(D)
    grads = (torch.randn(B, N, D, generator=gen).to(dev),
             torch.randn(B, N, 3, generator=gen).to(dev))
    return (src, dst, he, nbr, msk, prm), grads


@pytest.mark.parametrize("D", [64, 16])
def test_edge_kernels_at_the_edges_of_their_tiles_match_plain(cuda, D):
    """N = 300, an all-padded graph, Nsrc != N: the forward to TOL, the
    backward norm-wise (1e-3, as at Nsrc != N above), the padded graph's
    outputs exactly 0, both kernels bit-equal on two launches."""
    args, grads = _tile_edge_inputs(np.random.default_rng(300), cuda, D)
    got = em.edge_message_aggregate(*args)
    want = em.edge_message_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
        assert (g[1] == 0).all()
    assert all(torch.equal(a, b) for a, b in zip(got, em.edge_message_aggregate(*args)))
    flat = lambda r: [*r[:3], *(r[3][n] for n in em.PARAM_NAMES)]
    got = em.edge_message_bwd(*args, *grads)
    want = em.edge_message_bwd_plain(*args, *grads)
    torch.cuda.synchronize()
    names = ["d_src", "d_dst", "d_he"] + list(em.PARAM_NAMES)
    _assert_grads_close(flat(got), flat(want), names, rel=1e-3)
    assert (got[1][1] == 0).all() and (got[2][1] == 0).all()
    again = em.edge_message_bwd(*args, *grads)
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))


@pytest.mark.parametrize("D", [64, 16])
def test_edge_forward_is_bit_reproducible(cuda, D):
    """Two forward launches on the same inputs give the same bits (the
    masked means have one owner a (node, channel), edges in order)."""
    args = _edge_inputs(np.random.default_rng(4), cuda, B=3, N=512, D=D)
    before = em.launches
    runs = [em.edge_message_aggregate(*args) for _ in range(2)]
    assert em.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_a_forward_builds_one_inverse_list_per_side(cuda):
    """The model builds each side's inverse neighbour list once per forward
    that records gradients; the backward's scatters read those lists and
    build none; a forward without gradients builds none."""
    from equidock_public_tpu_torch.params import flatten, unflatten

    cfg = ModelConfig(residue_emb_dim=16, iegmn_lay_hid_dim=64, iegmn_n_lays=3,
                      shared_layers=True, num_att_heads=8)
    flat = {k: v.requires_grad_(True) for k, v in flatten(init_params(cfg, 0, cuda)).items()}
    builds, scatters = em.inverse_builds, em.scatter_launches
    out = docking_forward(unflatten(flat), cfg, _batch(np.random.default_rng(1), cuda))
    assert em.inverse_builds == builds + 2
    out["ligand_coords"].sum().backward()
    assert em.inverse_builds == builds + 2 and em.scatter_launches == scatters + 6
    with torch.no_grad():
        docking_forward(unflatten(flat), cfg, _batch(np.random.default_rng(1), cuda))
    assert em.inverse_builds == builds + 2


def _softmin_inputs(rng, dev, B, M, N):
    x = torch.from_numpy((rng.standard_normal((B, M, 3)) * 12).astype(np.float32))
    a = torch.from_numpy((rng.standard_normal((B, N, 3)) * 12 + 3).astype(np.float32))
    am = torch.from_numpy((rng.uniform(size=(B, N)) > 0.3).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((B, M)).astype(np.float32))
    c[:, M // 2:] = 0                  # padded query rows carry no cotangent
    return [t.to(dev) for t in (x, a, am, c)]


@pytest.mark.parametrize("B,M,N", [(2, 70, 130), (10, 512, 512), (1, 3072, 3072),
                                   (3, 300, 700), (2, 1, 200), (2, 100, 20), (1, 40, 300000)])
def test_softmin_field_kernels_match_plain(cuda, B, M, N):
    from equidock_public_tpu_torch.ops import softmin_field as sf
    from equidock_public_tpu_torch.ops.cuda import softmin_field as ksf

    x, a, am, c = _softmin_inputs(np.random.default_rng(M + N), cuda, B, M, N)
    f0, b0 = ksf.launches, ksf.bwd_launches
    got = ksf.softmin_field_fwd(x, a, am, 25.0)
    dx, da = ksf.softmin_field_bwd(x, a, am, c, 25.0)
    assert (ksf.launches, ksf.bwd_launches) == (f0 + 1, b0 + 1)
    want = sf.softmin_field_sums_plain(x, a, am, 25.0)
    wdx, wda = sf.softmin_field_bwd_plain(x, a, am, c, 25.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    _assert_grads_close([dx, da], [wdx, wda], ["dx", "dA"], rel=1e-5)
    again = ksf.softmin_field_bwd(x, a, am, c, 25.0)
    assert torch.equal(again[0], dx) and torch.equal(again[1], da)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("lane_points,warps", [(lp, w) for lp in (1, 2, 4) for w in (4, 8, 16)])
def test_softmin_field_kernels_on_every_built_tiling(cuda, lane_points, warps, splits):
    """Every (lane points, warps) pair the kernels are built for, at 1 to 8
    blocks a cluster, on masks with holes; complex 1 has every key masked
    (S and dA exactly 0), complex 2 no cotangent (dx and dA exactly 0)."""
    from equidock_public_tpu_torch.ops import softmin_field as sf
    from equidock_public_tpu_torch.ops.cuda import softmin_field as ksf

    x, a, am, c = _softmin_inputs(np.random.default_rng(splits), cuda, 3, 300, 700)
    am[1], c[2] = 0, 0
    fwd = ksf.softmin_tile_plan(3, 300, 700, False, lane_points, warps, splits)
    bwd = ksf.softmin_tile_plan(3, 300, 700, True, lane_points, warps, splits)
    got = ksf.softmin_field_fwd(x, a, am, 25.0, plan=fwd)
    dx, da = ksf.softmin_field_bwd(x, a, am, c, 25.0, plan=bwd)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sf.softmin_field_sums_plain(x, a, am, 25.0),
                               rtol=1e-5, atol=1e-4)
    _assert_grads_close([dx, da], list(sf.softmin_field_bwd_plain(x, a, am, c, 25.0)),
                        ["dx", "dA"], rel=1e-5)
    assert (got[1] == 0).all() and (da[1] == 0).all()
    assert (dx[2] == 0).all() and (da[2] == 0).all()


def test_fused_intersection_step_matches_the_unfused_one(cuda):
    """`use_fused_intersection` on the card: the soft-min field kernels run
    twice forward and twice backward a step, and the loss terms and the
    gradient norm equal the unfused step's."""
    import dataclasses

    from equidock_public_tpu_torch.config import Config, TrainConfig
    from equidock_public_tpu_torch.ops.cuda import softmin_field as ksf
    from equidock_public_tpu_torch.train.step import create_train_state, train_step

    cfg = Config(model=ModelConfig(residue_emb_dim=16, iegmn_lay_hid_dim=64, iegmn_n_lays=3,
                                   shared_layers=True, num_att_heads=8),
                 train=TrainConfig(sinkhorn_iters=20))
    batch = _batch(np.random.default_rng(2), cuda)
    batch = dataclasses.replace(batch, gt_lig=batch.lig.x + 1.0)
    out = {}
    for fused in (False, True):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                use_fused_intersection=fused))
        state = create_train_state(init_params(cfg.model, 0, cuda), c, cuda)
        f0, b0 = ksf.launches, ksf.bwd_launches
        _, m = train_step(state, batch, c)
        out[fused] = m
        assert (ksf.launches - f0, ksf.bwd_launches - b0) == ((2, 2) if fused else (0, 0))
    for key in ("loss", "intersection_loss", "grad_norm"):
        torch.testing.assert_close(out[True][key], out[False][key], rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------- #
# Rows 8 and 9: the halo ring, and the edge kernels at Nsrc != N
# --------------------------------------------------------------------------- #

def _random_plan(rng, G, P, Bl, S, H, hres, dev):
    """A padded halo plan of random send rows: (its exchange table on the
    mesh, the HaloPlan, mesh)."""
    from equidock_public_tpu_torch.parallel.halo import HaloPlan, exchange_table, mesh_table
    from equidock_public_tpu_torch.parallel.mesh import ParallelMesh

    B = G * Bl
    plan = {"send_next": rng.integers(0, S, (B, P, H)), "send_prev": rng.integers(0, S, (B, P, H)),
            "send_res": rng.integers(0, S, (B, P, P * hres))}
    mesh = ParallelMesh(G, P, dev)
    return (mesh_table(exchange_table(plan, P * S, dev), mesh),
            HaloPlan(**{k: torch.from_numpy(v.astype(np.int32)) for k, v in plan.items()}), mesh)


def _check_exchange(cuda, sides, plans, mesh):
    """Rows 8 and 9 on `sides` [(x, h, table)] in one launch each: row 8
    bit-equal to the table's index_select and to the ring composition, row
    9 to the sequential index_add_ on the CPU; two launches alike."""
    from equidock_public_tpu_torch.ops.cuda import halo_ring as hr
    from equidock_public_tpu_torch.parallel.halo import ring_composition

    before = (hr.launches, hr.bwd_launches)
    got, again = hr.exchange_kernel(sides), hr.exchange_kernel(sides)
    gen = torch.Generator().manual_seed(len(sides))
    grads = [(torch.randn(x.shape, generator=gen).to(cuda), torch.randn(h.shape, generator=gen)
              .to(cuda), t) for (x, h), (_, _, t) in zip(got, sides)]
    dgot, dagain = hr.exchange_bwd_kernel(grads), hr.exchange_bwd_kernel(grads)
    assert (hr.launches, hr.bwd_launches) == (before[0] + 2, before[1] + 2)
    torch.cuda.synchronize()
    for (x, h, t), g, a, plan in zip(sides, got, again, plans):
        for want in (hr.exchange_plain(x, h, t), ring_composition(x, h, plan, mesh)):
            assert all(torch.equal(u, v) for u, v in zip(g, want))
        assert all(torch.equal(u, v) for u, v in zip(g, a))
    for (gx, gh, t), g, a in zip(grads, dgot, dagain):
        cpu = hr.exchange_bwd_plain(gx.cpu(), gh.cpu(), t.to("cpu"))
        assert all(torch.equal(u.cpu(), v) for u, v in zip(g, cpu))
        assert all(torch.equal(u, v) for u, v in zip(g, a))


@pytest.mark.parametrize("G,P,Bl,S,H,F", [(1, 2, 1, 512, 64, 67), (2, 4, 3, 7, 5, 67),
                                          (1, 4, 2, 256, 8, 68), (1, 2, 10, 256, 1, 67),
                                          (2, 2, 5, 256, 48, 19)])
def test_ring_exchange_kernel_equals_plain(cuda, G, P, Bl, S, H, F):
    """Rows 8 and 9 on two sides of D = F - 3 (random padded plans at dp=G,
    gp=P, Bl complexes a group, shard widths S and S + 1, ring width H, a
    residual tier of 2 rows a pair): the float4 path (D 64, 16) and the
    scalar one (D 65), odd S, Hr = 1, interior shards and both chain ends,
    dp > 1 with Bl > 1; bit for bit, two launches alike."""
    rng = np.random.default_rng(S + H)
    sides, plans = [], []
    for s in (S, S + 1):
        tab, plan, mesh = _random_plan(rng, G, P, Bl, s, H, 2, cuda)
        x = torch.from_numpy(rng.standard_normal((G * P * Bl, s, 3)).astype(np.float32))
        h = torch.from_numpy(rng.standard_normal((G * P * Bl, s, F - 3)).astype(np.float32))
        sides.append((x.to(cuda), h.to(cuda), tab))
        plans.append(plan)
    _check_exchange(cuda, sides, plans, mesh)


@pytest.mark.parametrize("gp,dp,D", [(2, 1, 64), (4, 1, 64), (2, 2, 16)])
def test_ring_ship_kernel_equals_plain(cuda, gp, dp, D):
    """The ragged plans, whose rows the JAX package ships with row 9's TPU
    kernel (unpack slots past a complex's width may name another complex of
    its group), on 4 complexes: both sides in one launch of each kernel,
    bit for bit."""
    from equidock_public_tpu_torch.parallel.halo import build_halo_batch, mesh_table
    from equidock_public_tpu_torch.parallel.mesh import ParallelMesh

    rng = np.random.default_rng(gp + dp)
    pairs = [_batch(rng, cuda) for _ in range(4)]
    cat = lambda objs: torch.cat(objs)
    side = lambda name: ProteinBatch(**{k: cat([vars(getattr(p, name))[k] for p in pairs])
                                        for k in vars(pairs[0].lig)})
    pair = PairBatch(lig=side("lig"), rec=side("rec"), **{
        k: cat([getattr(p, k) for p in pairs])
        for k in ("gt_lig", "pocket_lig", "pocket_rec", "pocket_mask", "pair_mask")})
    hb, _, _, _ = build_halo_batch(pair, gp=gp, ragged=True, dp=dp)
    mesh = ParallelMesh(dp, gp, cuda)
    sides, plans = [], []
    for name in ("lig", "rec"):
        x = mesh.fold(getattr(hb.pair, name).x)
        h = torch.from_numpy(rng.standard_normal(tuple(x.shape[:2]) + (D,)).astype(np.float32))
        sides.append((x, h.to(cuda), mesh_table(getattr(hb, "table_" + name), mesh)))
        plans.append(getattr(hb, "plan_" + name))
    _check_exchange(cuda, sides, plans, mesh)


def test_ring_backward_on_the_card_equals_the_cpu(cuda):
    """The Function on both sides (rows 8 and 9) gives the CPU's values,
    forward and backward bit for bit, the same bits on two runs."""
    from equidock_public_tpu_torch.ops.cuda import halo_ring as hr

    rng = np.random.default_rng(0)
    tabs = [_random_plan(rng, 2, 4, 3, s, 5, 1, "cpu")[0] for s in (9, 11)]
    xh = [torch.from_numpy(rng.standard_normal((24, s, w)).astype(np.float32))
          for s in (9, 11) for w in (3, 64)]
    cts = None

    def run(dev):
        nonlocal cts
        leaves = [a.to(dev).requires_grad_(True) for a in xh]
        out = hr.halo_exchange_pair(*leaves, *(t.to(dev) for t in tabs))
        if cts is None:
            gen = torch.Generator().manual_seed(1)
            cts = [torch.randn(o.shape, generator=gen) for o in out]
        grads = torch.autograd.grad(out, leaves, [c.to(dev) for c in cts])
        return [o.detach().cpu() for o in out], [g.cpu() for g in grads]

    before = (hr.launches, hr.bwd_launches)
    first, second, cpu = run(cuda), run(cuda), run("cpu")
    assert (hr.launches, hr.bwd_launches) == (before[0] + 2, before[1] + 2)
    for a, b, c in zip(first[0] + first[1], second[0] + second[1], cpu[0] + cpu[1]):
        assert torch.equal(a, c) and torch.equal(a, b)


def test_edge_kernels_with_a_wider_source_match_plain(cuda):
    """The halo layer body's shape: src is the local block plus received
    rows (Nsrc = S + 2 Hr + gp Hres > N); forward to EDGE tolerance,
    backward norm-wise, the d_src scatter against index_add_, two launches
    bit-equal."""
    N, nsrc = 256, 256 + 2 * 48 + 2 * 8
    src, dst, he, nbr, msk, prm = _edge_inputs(np.random.default_rng(7), cuda, B=2, N=N,
                                               n_valid=N)
    src = torch.cat([src, torch.randn(2, nsrc - N, 67, device=cuda)], dim=1).contiguous()
    nbr = torch.randint(0, nsrc, nbr.shape, device=cuda, dtype=torch.int32)
    got = em.edge_message_aggregate(src, dst, he, nbr, msk, prm)
    want = em.edge_message_plain(src, dst, he, nbr, msk, prm)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    gen = torch.Generator().manual_seed(7)
    ga, gx = torch.randn(2, N, 64, generator=gen).to(cuda), torch.randn(2, N, 3, generator=gen).to(cuda)
    args = (src, dst, he, nbr, msk, prm, ga, gx)
    got = em.edge_message_bwd(*args)
    want = em.edge_message_bwd_plain(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (2, nsrc, 67)
    names = ["d_src", "d_dst", "d_he"] + list(em.PARAM_NAMES)
    flat = lambda r: [*r[:3], *(r[3][n] for n in em.PARAM_NAMES)]
    _assert_grads_close(flat(got), flat(want), names, rel=1e-3)
    raw = em.edge_message_bwd_kernel(*args)
    torch.testing.assert_close(em.scatter_src(nbr, nsrc, *raw[:2]),
                               em.scatter_src_plain(nbr, nsrc, *raw[:2]), **TOL)
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(em.edge_message_bwd(*args))))


def test_halo_forward_on_the_card_matches_the_cpu_path(cuda):
    """Padded gp=2 and ragged gp=4: row 8 launches once a layer for both
    sides, row 9 never (no gradient)."""
    from equidock_public_tpu_torch.config import Config
    from equidock_public_tpu_torch.ops.cuda import halo_ring as hr
    from equidock_public_tpu_torch.parallel.halo import build_halo_batch, make_halo_forward
    from equidock_public_tpu_torch.parallel.mesh import ParallelMesh

    cfg = Config(model=ModelConfig(residue_emb_dim=16, iegmn_lay_hid_dim=64, iegmn_n_lays=3,
                                   shared_layers=True, num_att_heads=8))
    for kw, grew in ((dict(gp=2), (3, 0)), (dict(gp=4, ragged=True), (3, 0))):
        out = {}
        for dev in (cuda, "cpu"):
            hb, _, _, _ = build_halo_batch(_batch(np.random.default_rng(1), dev), **kw)
            before = (hr.launches, hr.bwd_launches)
            with torch.inference_mode():
                out[str(dev)] = make_halo_forward(cfg, ParallelMesh(1, kw["gp"], dev))(
                    init_params(cfg.model, 0, dev), hb)
            if dev == cuda:
                assert (hr.launches - before[0], hr.bwd_launches - before[1]) == grew
        for key in ("R", "t", "ligand_coords"):
            torch.testing.assert_close(out[str(cuda)][key].cpu(), out["cpu"][key],
                                       rtol=1e-4, atol=1e-3)
