"""The port's device-resident epochs (`train/resident.py`) on the CPU,
against the JAX package's (`equidock_public_tpu/train/resident.py`):

* `_schedule` / `_group_chunks` bit-equal for one numpy seed, trimmed and
  not; the stores of `build_resident_split` field for field;
* `assemble_batch` with the same `rigid` / `swap_flag` gives the JAX
  package's batch (1e-6; the centring and the rotation in f32), and with no
  swap the port's own `collate` of the same poses (1e-5);
* `random_rotations` gives rotations (1e-5), the draws of a generator
  depend on the purpose and the epoch only;
* one resident train epoch and one eval pass at tiny width, JAX against
  the port with the JAX package's draws replayed: averages within 1e-4
  relative, parameters within 1e-5;
* port only: a trimmed step equals the padded one (2e-5), the streamed
  runner equals the whole one (1e-6), and streamed epochs hold at most the
  LRU window's shards and free every group they uploaded;
* full width: `fit` with `device_resident` and `trim_remainder` on the
  split chains against `assets/db5_resident_fit.golden.json` with its
  draws replayed, at the file's tolerances.

The JAX side runs its products at "highest" precision."""

import dataclasses
import gc
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.config import Config as JConfig
from equidock_public_tpu.config import DataConfig as JData
from equidock_public_tpu.config import ModelConfig as JModel
from equidock_public_tpu.config import TrainConfig as JTrain
from equidock_public_tpu.data import synth as jsynth
from equidock_public_tpu.data.dataset import DockingDataset as JDataset
from equidock_public_tpu.models.iegmn import init_docking_model
from equidock_public_tpu.train import resident as jr
from equidock_public_tpu.train import step as js
from equidock_public_tpu_torch.data.dataset import DockingDataset
from equidock_public_tpu_torch.graph import collate
from equidock_public_tpu_torch.params import flatten, params_from_numpy
from equidock_public_tpu_torch.train import resident as tr
from equidock_public_tpu_torch.train import step as ts

from . import torch_golden as tg
from .torch_utils import f32_default, port_config  # noqa: F401

SIZES = [(10, 14), (12, 15), (9, 11), (13, 8), (11, 12), (8, 10), (9, 9), (18, 20), (20, 17)]
CPU = "cpu"


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, no contention with the other
    test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jcfg(**train_kw):
    tk = dict(bs=3, sinkhorn_iters=20)
    tk.update(train_kw)
    return JConfig(model=JModel(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=2,
                                num_att_heads=4),
                   train=JTrain(**tk),
                   data=JData(node_buckets=(16, 32), pocket_buckets=(8, 16)))


def _datasets(tmp_path, jcfg, swap=True):
    cache = jsynth.write_synth_split(str(tmp_path / "train.npz"), SIZES, seed=5, k=4)
    pcfg = port_config(jcfg)
    return (JDataset(jcfg, "train", swap=swap, cache_path=cache),
            DockingDataset.from_cache(pcfg, "train", swap=swap, cache_path=cache), pcfg)


def _params(jcfg, seed=1):
    tree = jax.tree.map(np.asarray, init_docking_model(jax.random.PRNGKey(seed), jcfg.model))
    return tree, params_from_numpy(tree, port_config(jcfg).model)


@pytest.mark.parametrize("n,bs,frac", [(7, 3, 0.1), (2, 3, 0.1), (9, 3, 0.5), (25, 10, 0.1),
                                       (1, 10, 0.1), (30, 4, 0.3)])
@pytest.mark.parametrize("trim", [False, True])
def test_group_chunks_are_bit_equal_to_jax(n, bs, frac, trim):
    want, S_want = jr._group_chunks(n, bs, np.random.default_rng(3), np.random.default_rng(4),
                                    frac, trim)
    got, S_got = tr._group_chunks(n, bs, np.random.default_rng(3), np.random.default_rng(4),
                                  frac, trim)
    assert S_got == S_want == -(-n // bs)
    assert len(got) == len(want)
    for (gi, gv, ge), (wi, wv, we) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
        assert gi.dtype == wi.dtype and gv.dtype == wv.dtype and ge == we
    seen = np.concatenate([c[0][c[1] > 0] for c in got])
    assert sorted(seen.tolist()) == list(range(n))


@pytest.mark.parametrize("n,bs", [(7, 3), (10, 5), (1, 4)])
def test_schedule_is_bit_equal_to_jax(n, bs):
    for rng in (None, 11):
        mk = lambda: None if rng is None else np.random.default_rng(rng)
        for g, w in zip(tr._schedule(n, bs, mk()), jr._schedule(n, bs, mk())):
            np.testing.assert_array_equal(g, w)
    assert tr._eval_parts(7, 3, True)[1][0].shape == (1, 1)


def test_resident_store_matches_jax(tmp_path):
    jcfg = _jcfg()
    jds, pds, pcfg = _datasets(tmp_path, jcfg)
    want = jr.build_resident_split(jds, jcfg)
    got = tr.build_resident_split(pds, pcfg, CPU)
    assert list(got.groups) == sorted(want.groups) == [16, 32]
    for b, g in got.groups.items():
        w = want.groups[b]
        for side in ("lig", "rec"):
            for f in tr._SIDE_FIELDS:
                np.testing.assert_array_equal(getattr(getattr(g, side), f).numpy(),
                                              np.asarray(getattr(getattr(w, side), f)),
                                              err_msg=f"{b} {side}.{f}")
        for f in ("gt_lig", "gt_rec", "pocket", "pocket_mask"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)))
        assert got.metas[b].n_lig == want.metas[b].n_lig
        assert got.nbytes() > 0


def test_random_rotations_are_rotations():
    R = tr.random_rotations(torch.Generator().manual_seed(0), 64).numpy()
    np.testing.assert_allclose(np.einsum("bij,bkj->bik", R, R),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_draws_depend_on_purpose_and_epoch_only():
    draw = lambda purpose, epoch: tr.draw_augmentations(
        tr.make_generator(8, purpose, epoch, CPU), 6, True, 5.0)
    a, b = draw("train", 0), draw("train", 0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for other in (draw("train", 1), draw("val", 0), draw("test", 0)):
        assert not torch.equal(a[1], other[1])
    swap, rot, t = a
    assert swap.dtype == torch.bool and rot.shape == (6, 3, 3)
    assert bool((torch.linalg.norm(t, dim=-1) <= 5.0).all())
    assert not tr.draw_augmentations(tr.make_generator(8, "val", 0, CPU), 6, False, 5.0)[0].any()


def _rigid(rng, w):
    from equidock_public_tpu_torch.data.featurize import uniform_rotation_translation

    rots, trs = zip(*(uniform_rotation_translation(rng, 5.0) for _ in range(w)))
    return np.stack(rots).astype(np.float32), np.stack([t[0] for t in trs]).astype(np.float32)


@pytest.mark.parametrize("swap", [[0, 0, 0], [1, 0, 1], [1, 1, 1]])
def test_assemble_batch_matches_jax(tmp_path, swap):
    jcfg = _jcfg()
    jds, pds, pcfg = _datasets(tmp_path, jcfg)
    jstore = jr.build_resident_split(jds, jcfg).groups[16]
    pstore = tr.build_resident_split(pds, pcfg, CPU).groups[16]
    rot, t = _rigid(np.random.default_rng(2), 3)
    idx, valid = np.array([0, 2, 2], np.int32), np.array([1.0, 1.0, 0.0], np.float32)
    want, _ = jr.assemble_batch(jstore, jnp.asarray(idx), jnp.asarray(valid),
                                jax.random.PRNGKey(0), True, 5.0,
                                rigid=(jnp.asarray(rot), jnp.asarray(t)),
                                swap_flag=jnp.asarray(np.array(swap, bool)))
    got = tr.assemble_batch(pstore, torch.from_numpy(idx.astype(np.int64)),
                            torch.from_numpy(valid), torch.tensor(swap, dtype=torch.bool),
                            (torch.from_numpy(rot), torch.from_numpy(t)))
    for side in ("lig", "rec"):
        for f in tr._SIDE_FIELDS:
            np.testing.assert_allclose(getattr(getattr(got, side), f).numpy(),
                                       np.asarray(getattr(getattr(want, side), f)),
                                       atol=1e-6, err_msg=f"{side}.{f}")
    for f in ("gt_lig", "pocket_lig", "pocket_rec", "pocket_mask", "pair_mask"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-6, err_msg=f)


def test_assemble_without_swap_matches_collate(tmp_path):
    """The port's version of the JAX package's test_assemble_matches_collate:
    pinned poses, no swap, against `graph.collate` of the same poses."""
    jcfg = _jcfg()
    _, pds, pcfg = _datasets(tmp_path, jcfg)
    store = tr.build_resident_split(pds, pcfg, CPU).groups[16]
    rot, t = _rigid(np.random.default_rng(5), 2)
    items = []
    for i in (0, 1):
        s = pds.samples[i]
        mean = s.lig.x.mean(axis=0, keepdims=True)
        items.append((s.lig, s.rec, ((rot[i] @ (s.lig.x - mean).T).T + t[i]).astype(np.float32),
                      s.gt_lig, ((rot[i] @ (s.pocket - mean).T).T + t[i]).astype(np.float32),
                      s.pocket.astype(np.float32)))
    ref = collate(*zip(*items), pcfg.data.node_buckets, pcfg.data.pocket_buckets,
                  torch.device(CPU), batch_size=2)
    got = tr.assemble_batch(store, torch.tensor([0, 1]), torch.ones(2),
                            torch.zeros(2, dtype=torch.bool),
                            (torch.from_numpy(rot), torch.from_numpy(t)))
    for side in ("lig", "rec"):
        for f in tr._SIDE_FIELDS:
            np.testing.assert_allclose(getattr(getattr(got, side), f).numpy(),
                                       getattr(getattr(ref, side), f).numpy(), atol=1e-5,
                                       err_msg=f"{side}.{f}")
    for f in ("gt_lig", "pocket_lig", "pocket_rec", "pocket_mask", "pair_mask"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f).numpy(),
                                   atol=1e-5, err_msg=f)


def test_a_resident_epoch_matches_jax_with_replayed_draws(tmp_path):
    """One trimmed resident train epoch (two bucket groups, a narrow
    remainder step) and one eval pass with 2 repeats, JAX and the port from
    the same weights and seeds, the port replaying the JAX package's draws."""
    jcfg = _jcfg(trim_remainder=True, use_fused_intersection=True)
    jds, pds, pcfg = _datasets(tmp_path, jcfg)
    tree, params = _params(jcfg)
    with tg.ResidentRecorder() as rec:
        jrs = jr.build_resident_split(jds, jcfg)
        jst = js.create_train_state(jax.tree.map(jnp.array, tree), jcfg)
        jst, want = jr.run_train_epoch_resident(jst, jrs, jcfg, np.random.default_rng(7),
                                                jax.random.PRNGKey(5), 0, do_swap=True)
        want = (jst, want)
        va_want = jr.run_eval_epoch_resident(jst.params, jrs, jcfg, jax.random.PRNGKey(9),
                                             repeats=2)
    draws = rec.draws(jcfg.graph.translation_interval)
    prs = tr.build_resident_split(pds, pcfg, CPU)
    pst, got = tr.run_train_epoch_resident(ts.create_train_state(params, pcfg, CPU), prs, pcfg,
                                           np.random.default_rng(7),
                                           tr.ReplayDraws(draws[0], CPU), 0, do_swap=True)
    assert got["num_batches"] == want[1]["num_batches"] == 4
    assert got["num_clips"] == want[1]["num_clips"]
    for k in tr._SCALARS + ("complex_rmsd_median", "complex_rmsd_mean"):
        np.testing.assert_allclose(got[k], want[1][k], rtol=1e-4, err_msg=k)
    jflat = flatten(jax.tree.map(np.asarray, want[0].params))
    for k, v in flatten(pst.params).items():
        np.testing.assert_allclose(v.numpy(), jflat[k], atol=1e-5, err_msg=k)
    va = tr.run_eval_epoch_resident(pst.params, prs, pcfg, tr.ReplayDraws(draws[1], CPU),
                                    repeats=2)
    for k in va_want:
        np.testing.assert_allclose(va[k], va_want[k], rtol=1e-4, err_msg=k)


def test_trimmed_step_matches_padded(tmp_path):
    """A step over a trimmed batch of r pairs equals the same pairs in a
    bs-wide batch with dead slots, given the same poses."""
    jcfg = _jcfg(bs=3, trim_remainder=True)
    _, pds, pcfg = _datasets(tmp_path, jcfg)
    store = tr.build_resident_split(pds, pcfg, CPU).groups[16]
    _, params = _params(jcfg, seed=7)
    rot, t = torch.eye(3).expand(3, 3, 3), torch.zeros(3, 3)
    flag = torch.zeros(3, dtype=torch.bool)
    pad = tr.assemble_batch(store, torch.tensor([0, 1, 1]), torch.tensor([1.0, 1.0, 0.0]),
                            flag, (rot, t))
    trim = tr.assemble_batch(store, torch.tensor([0, 1]), torch.ones(2), flag[:2],
                             (rot[:2], t[:2]))
    a, ma = ts.train_step(ts.create_train_state(params, pcfg, CPU), pad, pcfg)
    b, mb = ts.train_step(ts.create_train_state(params, pcfg, CPU), trim, pcfg)
    np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]), rtol=1e-5)
    fb = flatten(b.params)
    for k, v in flatten(a.params).items():
        np.testing.assert_allclose(v.numpy(), fb[k].numpy(), atol=2e-5, err_msg=k)


@pytest.mark.parametrize("trim", [False, True])
def test_streamed_matches_resident(tmp_path, trim):
    """The streamed runner reproduces the whole runner under the same seeds
    and generator (two bucket groups)."""
    jcfg = _jcfg(trim_remainder=trim)
    _, pds, pcfg = _datasets(tmp_path, jcfg)
    _, params = _params(jcfg)
    srs = tr.StreamedResidentSplit.build(pds, pcfg)
    assert sorted(srs.by_bucket) == [16, 32]
    draws = lambda: tr.draws_factory(pcfg, CPU)("train", 0)
    a, ta = tr.run_train_epoch_resident(ts.create_train_state(params, pcfg, CPU),
                                        tr.build_resident_split(pds, pcfg, CPU), pcfg,
                                        np.random.default_rng(7), draws(), 0, do_swap=True)
    b, tb = tr.run_train_epoch_resident_streamed(ts.create_train_state(params, pcfg, CPU), srs,
                                                 pcfg, np.random.default_rng(7), draws(), 0,
                                                 do_swap=True)
    assert ta["num_batches"] == tb["num_batches"]
    np.testing.assert_allclose(ta["loss"], tb["loss"], rtol=1e-6)
    fb = flatten(b.params)
    for k, v in flatten(a.params).items():
        np.testing.assert_allclose(v.numpy(), fb[k].numpy(), atol=1e-6, err_msg=k)


def test_streamed_epoch_bounds_residency(tmp_path, monkeypatch):
    """Streamed DIPS shards (stream_window 1) through the streamed resident
    runner: at most one shard held at the end, every uploaded group's
    tensors released by the epoch's end (held by weak references), one
    step per ceil(group / bs)."""
    from equidock_public_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from equidock_public_tpu_torch.data.synth import write_synth_shards

    cfg = Config(model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=2,
                                   num_att_heads=4),
                 train=TrainConfig(bs=2, sinkhorn_iters=20),
                 data=DataConfig(data="dips", stream_dips=True, stream_window=1,
                                 device_resident=True, cache_dir=str(tmp_path / "cache"),
                                 node_buckets=(16, 32), pocket_buckets=(8, 16)))
    write_synth_shards(cfg.cache_path(), n_shards=6, per_shard=8, seed=0)
    ds = DockingDataset.from_cache(cfg, "train")
    assert ds.samples is None and len(ds) == 48
    srs = tr.StreamedResidentSplit.build(ds, cfg)
    uploaded, upload = [], tr._upload

    def recording_upload(group, *a):
        out = upload(group, *a)
        uploaded.append([weakref.ref(t) for t in out[0].tensors()])
        return out

    monkeypatch.setattr(tr, "_upload", recording_upload)
    state = ts.create_train_state(_params(_jcfg())[1], cfg, CPU)
    state, out = tr.run_train_epoch_resident_streamed(
        state, srs, cfg, np.random.default_rng(0), tr.draws_factory(cfg, CPU)("train", 0), 0)
    assert np.isfinite(out["loss"])
    assert out["num_batches"] == sum(-(-len(v) // 2) for v in srs.by_bucket.values())
    assert ds._lru.resident() <= 1
    assert len(uploaded) == len(srs.by_bucket)
    gc.collect()
    assert not [r for refs in uploaded for r in refs if r() is not None]


def test_dp_resident_raises_by_name():
    """The dp twin is ported (its runs: tests/test_torch_dist_resident.py,
    dropout: tests/test_torch_dist_options.py); what it does not take
    raises by name: a batch that does not split into the data ranks, and
    BatchNorm, the JAX package's own refusal, in its words."""
    from equidock_public_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from equidock_public_tpu_torch.parallel.mesh import ParallelMesh
    from equidock_public_tpu_torch.train.loop import check_fit_supported

    with pytest.raises(ValueError, match="bs 5 does not split into dp=2"):
        tr.build_resident_split_dp(None, Config(train=TrainConfig(bs=5)),
                                   ParallelMesh(2, 1, "cpu"))
    bn = Config(model=ModelConfig(layer_norm="BN"))
    with pytest.raises(ValueError, match="dp-resident path does not track per-device BN"):
        tr.run_train_epoch_resident_dp(None, None, bn, ParallelMesh(2, 1, "cpu"), None, None, 0)
    with pytest.raises(ValueError, match="dp-resident path does not track per-device BN"):
        check_fit_supported(dataclasses.replace(bn, data=DataConfig(device_resident=True),
                                                parallel=dataclasses.replace(bn.parallel, dp=2)))


def test_full_width_resident_fit_matches_the_golden_file(tmp_path):
    """`fit` of the DB5 paper model from its committed weights with
    device-resident epochs and trimmed remainders, 2 epochs on the tracked
    chains cut in two, replaying the JAX package's draws, against
    `assets/db5_resident_fit.golden.json` at the file's tolerances (the
    same check chip_smoke's `resident` phase makes on the card)."""
    from equidock_public_tpu_torch.data.dataset import split_chain_complex, write_cache
    from equidock_public_tpu_torch.data.featurize import filter_residues
    from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb
    from equidock_public_tpu_torch.params import load_checkpoint
    from equidock_public_tpu_torch.train import loop

    with open(tg.RESIDENT_FIT_GOLDEN) as f:
        golden = json.load(f)
    params, cfg = load_checkpoint(os.path.join(tg.ASSETS, "db5_model_best.pt.xz"))
    cfg = tg.resident_fit_config(tg.fit_config(cfg, str(tmp_path)))
    train = dataclasses.asdict(cfg.train)
    assert train == {k: golden["train_config"][k] for k in train}
    for split, codes in golden["partition"].items():
        samples = [split_chain_complex(filter_residues(group_residues(read_pdb(
            os.path.join(tg.REPO, tg.pdb_path(c))))), cfg.graph) for c in codes]
        write_cache(os.path.join(cfg.cache_path(), f"{split}.npz"), codes, samples)
    history = []
    torch.set_num_threads(4)        # full width: the ops are large
    loop.fit(cfg, ts.create_train_state(params, cfg, CPU), max_epochs=golden["epochs"],
             log=lambda *a: None, device=CPU, history=history,
             draws=tg.replay_sources(golden))
    tol = golden["tolerance"]
    got = [dict(train=h["train"], val=h["val"]) for h in history[:-1]] + [
        dict(test=history[-1]["test"])]
    want = golden["history"] + [dict(test=golden["test"])]
    for g, w in zip(got, want):
        for part in w:
            for key, value in w[part].items():
                rtol, atol = ((0, tol["median_atol"]) if key.endswith("median")
                              else (tol["loss_rtol"], 0))
                np.testing.assert_allclose(g[part][key], value, rtol=rtol, atol=atol,
                                           err_msg=f"{part} {key}")
    assert history[-1]["best_epoch"] == golden["best_epoch"]
