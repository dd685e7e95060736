"""The tile decomposition of the port's attention kernels, emulated in
torch on the CPU (`csrc/cross_attention.cu`, the dQ and dK/dV kernels of
`csrc/cross_attention_bwd.cu`; the card runs the same arithmetic in CUDA):

- the conservative tile test (positive-tag ranges of a query tile and a key
  tile overlap, or the pair keeps nothing);
- the forward's constant-logit update of a tile pair that keeps nothing
  (m' = max(m, -1000), l' = l e^(m-m') + cnt e^(-1000-m'),
  acc' = acc e^(m-m') + e^(-1000-m') sum V), the full online-softmax update
  of the others, keys past M left out, and the split of the key tiles with
  its combine in split order;
- dK/dV key-stationary: for a query tile that keeps nothing with the key
  tile, dK gets nothing and every key's dV the same u = sum_n
  exp(-1000 - lse_n) dO_n; the split of the query tiles summed in order;
- dQ query-stationary: a tile pair that keeps nothing has ds = 0 and is
  skipped, a query tile with no positive tag does nothing; the key tiles
  dealt to the splits in turn, the splits summed in order.

The emulation runs in float64: it checks the decomposition's closed forms,
not f32 rounding. (On the card, w = exp(a - lse) inherits the f32 rounding
of lse near -1000, up to 3e-5 relative on the padded rows' 1/M; chip_smoke
holds the kernels to their plain versions with it; against the Pallas
backward, which reads the same f32 lse, the emulation takes lse rounded to
f32.) Held against the plain
versions (`cross_attention_plain`, `cross_attention_bwd_plain`) on every row, and against the JAX package's
Pallas kernel in interpret mode on every row that keeps a key (on every
row at M = 512, where its key padding adds nothing; dQ on every row of
every case). Tolerance: forward 1e-5 abs and rel; dQ, dK and dV 1e-5
norm-wise (f32, other summation orders). Also pins ROADMAP C3: at M = 576
the Pallas path pads the keys to 1024 with mask 0, so rows that keep no key
differ from the port by M / 1024 in the forward; dQ cannot see it."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.ops.attention import cross_attention as jax_oracle
from equidock_public_tpu.ops.pallas.cross_attention import _fused_core
from equidock_public_tpu.ops.pallas.cross_attention import cross_attention_fused as jax_fused
from equidock_public_tpu_torch.ops.cuda import cross_attention as tca

from .torch_utils import f32_default, t  # noqa: F401

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
DKV_REL = 1e-5
MASKED = -1000.0


def tag_range(tags):
    pos = tags[tags > 0]
    return (float(pos.min()), float(pos.max())) if pos.numel() else None


def may_keep(a, b):
    return a is not None and b is not None and a[0] <= b[1] and b[0] <= a[1]


def runs(tiles, splits):
    """The kernels' cut of `tiles` tiles into `splits` runs of equal length."""
    per = -(-tiles // splits)
    assert (splits - 1) * per < tiles, "an empty split"
    return [range(s * per, min((s + 1) * per, tiles)) for s in range(splits)]


def fwd_tiles(q, k, v, qt, kt, tile, splits, seen):
    """(o, lse) by the forward kernel's decomposition; counts the masked and
    mixed tile pairs in `seen`."""
    B, N, _ = q.shape
    M = k.shape[1]
    o = torch.empty(B, N, v.shape[2], dtype=q.dtype)
    lse = torch.empty(B, N, dtype=q.dtype)
    for b in range(B):
        for n0 in range(0, N, tile):
            rows = slice(n0, min(n0 + tile, N))
            qtag, R = qt[b, rows], rows.stop - rows.start
            parts = []
            for run in runs(-(-M // tile), splits):
                m = torch.full((R,), -math.inf, dtype=q.dtype)
                l, acc = q.new_zeros(R), q.new_zeros(R, v.shape[2])
                for kt_i in run:
                    keys = slice(kt_i * tile, min(kt_i * tile + tile, M))
                    cnt = keys.stop - keys.start
                    if not may_keep(tag_range(qtag), tag_range(kt[b, keys])):
                        seen["masked"] += 1
                        mn = torch.clamp(m, min=MASKED)
                        corr, e = torch.exp(m - mn), torch.exp(MASKED - mn)
                        l = l * corr + cnt * e
                        acc = acc * corr[:, None] + e[:, None] * v[b, keys].sum(0)[None]
                    else:
                        seen["mixed"] += 1
                        keep = (qtag[:, None] > 0) & (qtag[:, None] == kt[b, keys][None])
                        a = torch.where(keep, q[b, rows] @ k[b, keys].T, MASKED)
                        mn = torch.maximum(m, a.max(1).values)
                        corr = torch.exp(m - mn)
                        p = torch.exp(a - mn[:, None])
                        l = l * corr + p.sum(1)
                        acc = acc * corr[:, None] + p @ v[b, keys]
                    m = mn
                parts.append((m, l, acc))
            mx = torch.stack([p[0] for p in parts]).max(0).values
            l, acc = q.new_zeros(R), q.new_zeros(R, v.shape[2])
            for pm, pl, pacc in parts:                         # split order
                w = torch.exp(pm - mx)
                l = l + pl * w
                acc = acc + pacc * w[:, None]
            o[b, rows] = acc / l[:, None]
            lse[b, rows] = mx + torch.log(l)
    return o, lse


def dkv_tiles(q, k, v, qt, kt, lse, do, delta, tile, splits, seen):
    """(dk, dv) by the dK/dV kernel's decomposition."""
    B, N, D = q.shape
    M, Dv = k.shape[1], v.shape[2]
    dk, dv = q.new_empty(B, M, D), q.new_empty(B, M, Dv)
    for b in range(B):
        for m0 in range(0, M, tile):
            keys = slice(m0, min(m0 + tile, M))
            ktag, R = kt[b, keys], keys.stop - keys.start
            part_k, part_v = [], []
            for run in runs(-(-N // tile), splits):
                acc_k, acc_v, u = q.new_zeros(R, D), q.new_zeros(R, Dv), q.new_zeros(Dv)
                for qt_i in run:
                    rows = slice(qt_i * tile, min(qt_i * tile + tile, N))
                    if not may_keep(tag_range(qt[b, rows]), tag_range(ktag)):
                        seen["masked"] += 1
                        u = u + torch.exp(MASKED - lse[b, rows]) @ do[b, rows]
                    else:
                        seen["mixed"] += 1
                        qtag = qt[b, rows][None]
                        keep = (qtag > 0) & (qtag == ktag[:, None])      # [key, query]
                        s = torch.where(keep, k[b, keys] @ q[b, rows].T, MASKED)
                        w = torch.exp(s - lse[b, rows][None])
                        dp = v[b, keys] @ do[b, rows].T
                        ds = torch.where(keep, w * (dp - delta[b, rows][None]), 0.0)
                        acc_v = acc_v + w @ do[b, rows]
                        acc_k = acc_k + ds @ q[b, rows]
                part_k.append(acc_k)
                part_v.append(acc_v + u[None])
            dk[b, keys] = sum(part_k[1:], part_k[0])                # split order
            dv[b, keys] = sum(part_v[1:], part_v[0])
    return dk, dv


def key_turns(tiles, splits):
    """The dQ kernel's cut: the key tiles dealt to `splits` splits in turn."""
    assert splits <= tiles, "an empty split"
    return [range(s, tiles, splits) for s in range(splits)]


def dq_tiles(q, k, v, qt, kt, lse, do, delta, tile, splits, seen):
    """dq by the dQ kernel's decomposition."""
    B, N, D = q.shape
    M = k.shape[1]
    dq = q.new_empty(B, N, D)
    for b in range(B):
        for n0 in range(0, N, tile):
            rows = slice(n0, min(n0 + tile, N))
            qtag, R = qt[b, rows], rows.stop - rows.start
            parts = []
            for run in key_turns(-(-M // tile), splits):
                acc = q.new_zeros(R, D)
                for kt_i in run:
                    keys = slice(kt_i * tile, min(kt_i * tile + tile, M))
                    if not may_keep(tag_range(qtag), tag_range(kt[b, keys])):
                        seen["skipped"] += 1            # ds = 0: nothing to add
                        continue
                    seen["mixed"] += 1
                    keep = (qtag[:, None] > 0) & (qtag[:, None] == kt[b, keys][None])
                    w = torch.exp(q[b, rows] @ k[b, keys].T - lse[b, rows][:, None])
                    dp = do[b, rows] @ v[b, keys].T
                    ds = torch.where(keep, w * (dp - delta[b, rows][:, None]), 0.0)
                    acc = acc + ds @ k[b, keys]
                parts.append(acc)
            dq[b, rows] = sum(parts[1:], parts[0])                # split order
    return dq


def _case(name, rng):
    """(q, k, v, q_tag, k_tag, do) as float32 numpy arrays."""
    B, N, M, D, scale = {"training": (3, 40, 40, 16, 0.5), "ragged": (2, 37, 45, 8, 0.5),
                         "m548": (1, 50, 548, 8, 0.3), "m1000": (1, 20, 1000, 8, 0.3),
                         "layer0": (2, 24, 33, 69, 0.3), "padded_complex": (2, 30, 28, 8, 0.5),
                         "no_match": (1, 24, 40, 8, 0.5), "below_896": (1, 24, 512, 64, 1.0),
                         "packed": (2, 36, 44, 8, 0.5), "m512": (1, 24, 512, 8, 0.3)}[name]
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    q, k, v, do = f(B, N, D), f(B, M, D), f(B, M, D), f(B, N, D)
    qt, kt = np.zeros((B, N), np.float32), np.zeros((B, M), np.float32)
    for b in range(B):              # valid prefixes of random length, as batches pad
        qt[b, :rng.integers(N // 4, N)] = 1
        kt[b, :rng.integers(M // 4, M)] = 1
    if name == "padded_complex":
        qt[1] = 0                    # every query row of a complex padded
    if name == "no_match":           # tags 2 and 3 a side; rows tagged 5 keep no key
        qt[0, :20] = 1
        qt *= rng.integers(2, 4, qt.shape)
        kt *= rng.integers(2, 4, kt.shape)
        qt[0, :5] = 5
    if name in ("m512", "below_896"):    # whole key tiles of padding
        kt[0, 300:] = 0
    if name == "below_896":          # kept logits q.k = -1024: the -1000s dominate
        qt[0, :12] = 1
        q[0, :12] = 4.0
        k[0, :] = -4.0
    if name == "packed":             # (segment id + 1) * mask
        qt *= rng.integers(1, 4, qt.shape)
        kt *= rng.integers(1, 4, kt.shape)
    return q, k, v, qt, kt, do


CASES = ["training", "ragged", "m548", "m1000", "layer0", "padded_complex", "no_match",
         "below_896", "packed", "m512"]


def _tile_and_splits(name):
    return {"m548": (64, 3), "m1000": (64, 16), "m512": (64, 8), "below_896": (64, 4)}.get(
        name, (8, 2))


def f64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float64))


def _pallas(q, k, v, qt, kt):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax_fused(*map(jnp.asarray, (q, k, v, qt, kt)), True))


@pytest.mark.parametrize("name", CASES)
def test_forward_tiles_match_plain_and_pallas(name):
    rng = np.random.default_rng(CASES.index(name))
    q, k, v, qt, kt, _ = _case(name, rng)
    tile, splits = _tile_and_splits(name)
    seen = {"masked": 0, "mixed": 0}
    o, lse = fwd_tiles(*map(f64, (q, k, v, qt, kt)), tile, splits, seen)
    assert seen["masked"] > 0 and seen["mixed"] > 0, seen
    po, plse = tca.cross_attention_plain(t(q), t(k), t(v), t(qt), t(kt))
    np.testing.assert_allclose(o.numpy(), po.numpy(), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), plse.numpy(), **FWD_TOL)
    keeps = ((qt[:, :, None] > 0) & (qt[:, :, None] == kt[:, None, :])).any(-1)
    empty = ~keeps
    if empty.any():                  # rows that keep no key: lse = -1000 + log M
        np.testing.assert_allclose(lse.numpy()[empty], MASKED + math.log(k.shape[1]),
                                   rtol=1e-6)
    if name == "below_896":
        kept = keeps[0, :12]
        assert kept.all() and (lse.numpy()[0, :12] < -990).all()
    rows = np.ones_like(keeps) if k.shape[1] % 512 == 0 else keeps
    want = _pallas(q, k, v, qt, kt)
    np.testing.assert_allclose(o.numpy()[rows], want[rows], **FWD_TOL)


def _rel(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("name", CASES)
def test_dkv_tiles_match_plain(name):
    rng = np.random.default_rng(100 + CASES.index(name))
    arrays = _case(name, rng)
    q, k, v, qt, kt, do = map(f64, arrays)
    tile, splits = _tile_and_splits(name)
    o, lse = fwd_tiles(q, k, v, qt, kt, tile, splits, {"masked": 0, "mixed": 0})
    seen = {"masked": 0, "mixed": 0}
    dk, dv = dkv_tiles(q, k, v, qt, kt, lse, do, (do * o).sum(-1), tile,
                       min(splits, -(-q.shape[1] // tile)), seen)
    assert seen["masked"] > 0 and seen["mixed"] > 0, seen
    _, pdk, pdv = tca.cross_attention_bwd_plain(*map(t, arrays))
    assert _rel(dk, pdk.double()) <= DKV_REL and _rel(dv, pdv.double()) <= DKV_REL


@pytest.mark.parametrize("tagged", [False, True])
def test_dkv_tiles_match_pallas_vjp_at_m512(tagged):
    rng = np.random.default_rng(7)
    q, k, v, qt, kt, do = _case("m512", rng)
    if tagged:
        qt *= rng.integers(1, 4, qt.shape).astype(np.float32)
        kt *= rng.integers(1, 4, kt.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda a, b, c: _fused_core(a, b, c, jnp.asarray(qt), jnp.asarray(kt),
                                                     True), q, k, v)
        _, jdk, jdv = vjp(jnp.asarray(do))
    T = [f64(x) for x in (q, k, v, qt, kt, do)]
    o, lse = fwd_tiles(*T[:5], 64, 8, {"masked": 0, "mixed": 0})
    lse = lse.float().double()       # rounded to f32, as the Pallas kernel reads it
    dk, dv = dkv_tiles(*T[:5], lse, T[5], (T[5] * o).sum(-1), 64, 1,
                       {"masked": 0, "mixed": 0})
    assert _rel(dk, f64(jdk)) <= DKV_REL and _rel(dv, f64(jdv)) <= DKV_REL


def _pallas_dq(q, k, v, qt, kt, do):
    """dq of the JAX package's Pallas backward (vjp of the fused core) in
    interpret mode."""
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda a: _fused_core(a, jnp.asarray(k), jnp.asarray(v),
                                               jnp.asarray(qt), jnp.asarray(kt), True), q)
        return f64(vjp(jnp.asarray(do))[0])


def _dq_by_tiles(arrays, tile, splits, lse_f32=False):
    """(dq, seen) of the dQ decomposition in float64 on the forward
    decomposition's lse (rounded to f32, as the Pallas kernel reads it,
    when `lse_f32`)."""
    q, k, v, qt, kt, do = map(f64, arrays)
    o, lse = fwd_tiles(q, k, v, qt, kt, tile, 1, {"masked": 0, "mixed": 0})
    if lse_f32:
        lse = lse.float().double()
    seen = {"skipped": 0, "mixed": 0}
    dq = dq_tiles(q, k, v, qt, kt, lse, do, (do * o).sum(-1), tile,
                  min(splits, -(-k.shape[1] // tile)), seen)
    return dq, seen


def _dq_case(name, rng):
    """`_case` for dQ. Where every key row is the same vector (below_896),
    sum_m ds = 0 on a row whose kept weights sum to one, so dQ = sum_m ds k
    is zero in exact arithmetic there and any f32 result is rounding noise;
    each key row gets noise of zero sum over its channels instead, which
    keeps the kept logits of the constant query rows at -1024."""
    arrays = _case(name, rng)
    if name == "below_896":
        z = rng.standard_normal(arrays[1].shape[1:]).astype(np.float32)
        arrays[1][0] += z - z.mean(-1, keepdims=True)
    return arrays


@pytest.mark.parametrize("name", CASES)
def test_dq_tiles_match_plain_and_pallas(name):
    rng = np.random.default_rng(200 + CASES.index(name))
    arrays = _dq_case(name, rng)
    tile, splits = _tile_and_splits(name)
    dq, seen = _dq_by_tiles(arrays, tile, splits)
    assert seen["skipped"] > 0 and seen["mixed"] > 0, seen
    pdq = tca.cross_attention_bwd_plain(*map(t, arrays))[0].double()
    assert _rel(dq, pdq) <= DKV_REL
    dq32, _ = _dq_by_tiles(arrays, tile, splits, lse_f32=True)
    assert _rel(dq32, _pallas_dq(*arrays)) <= DKV_REL


def test_dq_c3_cannot_reach_dq():
    """ROADMAP C3 at M = 576: the Pallas path's padded keys carry mask 0, so
    their ds is 0 and the padding cannot reach dQ; rows that keep no key
    have dQ = 0 exactly in both packages, and dQ agrees on every row."""
    rng = np.random.default_rng(3)
    B, N, M, D = 2, 20, 576, 8
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, N, D), (B, M, D), (B, M, D), (B, N, D)))
    qm, km = np.zeros((B, N), np.float32), np.zeros((B, M), np.float32)
    qm[0, :13] = 1
    qm[1, :6] = 1
    km[0, :400] = 1
    km[1, :570] = 1
    arrays = (q, k, v, qm, km, do)
    pallas = _pallas_dq(*arrays)
    plain = tca.cross_attention_bwd_plain(*map(t, arrays))[0].double()
    tiles, _ = _dq_by_tiles(arrays, 64, 3, lse_f32=True)
    empty = torch.from_numpy(qm == 0)
    assert empty.any() and (~empty).any()
    for dq in (pallas, plain, tiles):
        assert torch.equal(dq[empty], torch.zeros_like(dq[empty]))
    assert _rel(tiles, pallas) <= DKV_REL and _rel(plain, pallas) <= DKV_REL


def test_combines_take_their_plain_versions_on_the_cpu():
    """The combine passes on CPU tensors take their plain versions, which
    merge per-split partials into the whole: the forward's (m, l, acc) of
    each key split by the rescaled sums, dQ's and dK/dV's by a sum over the
    splits."""
    rng = np.random.default_rng(11)
    B, S, N, M, Dv = 2, 3, 5, 21, 4
    a, v = f64(rng.standard_normal((B, N, M)) * 3), f64(rng.standard_normal((B, M, Dv)))
    cuts = [slice(0, 4), slice(4, 15), slice(15, M)]
    m = torch.stack([a[..., c].max(-1).values for c in cuts], 1)
    e = [torch.exp(a[..., c] - m[:, i, :, None]) for i, c in enumerate(cuts)]
    part_l = torch.stack([x.sum(-1) for x in e], 1)
    part_acc = torch.stack([x @ v[:, c] for x, c in zip(e, cuts)], 1)
    o, lse = tca.fwd_combine(m, part_l, part_acc)
    torch.testing.assert_close(o, torch.softmax(a, -1) @ v)
    torch.testing.assert_close(lse, torch.logsumexp(a, -1))
    part = f64(rng.standard_normal((B, S, N, 7)))
    torch.testing.assert_close(tca.dq_combine(part), part[:, 0] + part[:, 1] + part[:, 2])
    dk, dv = tca.dkv_combine(part, part_acc)
    torch.testing.assert_close(dk, part.sum(1))
    torch.testing.assert_close(dv, part_acc.sum(1))


def test_keys_past_m_c3_pallas_pads_the_port_does_not():
    """ROADMAP C3 at M = 576: the Pallas path pads keys to 1024 with mask 0."""
    rng = np.random.default_rng(3)
    B, N, M, D = 2, 20, 576, 8
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, N, D), (B, M, D), (B, M, D)))
    qm, km = np.zeros((B, N), np.float32), np.zeros((B, M), np.float32)
    qm[0, :13] = 1
    qm[1, :6] = 1
    km[0, :400] = 1
    km[1, :570] = 1
    port = tca.cross_attention_fused(t(q), t(k), t(v), t(qm), t(km)).numpy()
    pallas = _pallas(q, k, v, qm, km)
    keeps = qm > 0
    np.testing.assert_allclose(port[keeps], pallas[keeps], rtol=1e-5, atol=1e-5)
    padded = M // 512 * 512 + 512
    np.testing.assert_allclose(pallas[~keeps], port[~keeps] * M / padded, rtol=1e-5, atol=1e-6)
    assert not np.allclose(pallas[~keeps], port[~keeps], rtol=1e-3, atol=1e-4)
    with jax.default_matmul_precision("highest"):
        oracle = np.asarray(jax_oracle(q, k, v, qm, km))
    np.testing.assert_allclose(port, oracle, rtol=1e-5, atol=1e-5)
