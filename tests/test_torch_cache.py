"""The port's npz split cache against the JAX package's: `write_synth_split`
writes the same arrays under one seed, and `DockingDataset.from_cache`
yields, under one numpy seed, exactly the batches the JAX
`DockingDataset(cfg, split)` yields from the same cache: shuffled with swap
(train) and in order without swap but with a fresh pose per complex (eval).
A cache the port writes (`write_cache`) reads back in the JAX package."""

import dataclasses
import os

import numpy as np
import pytest

from equidock_public_tpu.config import Config as JaxConfig
from equidock_public_tpu.config import DataConfig as JaxDataConfig
from equidock_public_tpu.config import TrainConfig as JaxTrainConfig
from equidock_public_tpu.data import dataset as jds
from equidock_public_tpu.data import synth as jsynth
from equidock_public_tpu_torch.data import dataset as tds
from equidock_public_tpu_torch.data import synth as tsynth

from .torch_utils import f32_default, port_batch, port_config  # noqa: F401

SIZES = [(10, 14), (12, 20), (9, 11), (20, 25), (15, 18)]
FIELDS = ("res_id", "x", "mu_r_norm", "nbr", "nbr_mask", "edge_feat", "node_mask")


def _jcfg(tmp_path, bs=2, **data):
    return JaxConfig(train=JaxTrainConfig(bs=bs),
                     data=JaxDataConfig(node_buckets=(16, 32), pocket_buckets=(8, 16),
                                        cache_dir=str(tmp_path / "cache"), **data))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = port_batch(w)
        for side in ("lig", "rec"):
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(getattr(g, side), f).numpy(),
                                              getattr(getattr(w, side), f).numpy(),
                                              err_msg=f"{side}.{f}")
        for f in ("gt_lig", "pocket_lig", "pocket_rec", "pocket_mask", "pair_mask"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), getattr(w, f).numpy(),
                                          err_msg=f)


def test_write_synth_split_writes_the_jax_arrays(tmp_path):
    jp = jsynth.write_synth_split(str(tmp_path / "j" / "train.npz"), SIZES, seed=3, k=4)
    tp = tsynth.write_synth_split(str(tmp_path / "t" / "train.npz"), SIZES, seed=3, k=4)
    with np.load(jp) as j, np.load(tp) as t:
        assert sorted(j.files) == sorted(t.files)
        for key in j.files:
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)


@pytest.mark.parametrize("split,shuffle", [("train", True), ("val", False)])
@pytest.mark.parametrize("seed", [0, 5])
def test_cached_batches_equal_the_jax_ones(tmp_path, split, shuffle, seed):
    jcfg = _jcfg(tmp_path)
    pcfg = port_config(jcfg)
    assert pcfg.cache_path() == jcfg.cache_path()
    jsynth.write_synth_split(os.path.join(jcfg.cache_path(), f"{split}.npz"), SIZES,
                             seed=7, k=4)
    swap = None if split == "train" else False
    jd = jds.DockingDataset(jcfg, split, swap=swap)
    pd = tds.DockingDataset.from_cache(pcfg, split, swap=swap)
    assert pd.codes == [str(c) for c in jd.codes] and pd.swap == jd.swap == (split == "train")
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):        # two epochs from one generator
        want = list(jd.batches(rj, shuffle=shuffle))
        got = list(pd.batches(rp, device="cpu", shuffle=shuffle))
        _assert_batches_equal(got, want)
    assert rj.uniform() == rp.uniform()     # both consumed the same draws


def test_data_fraction_keeps_the_leading_train_complexes(tmp_path):
    jcfg = _jcfg(tmp_path, data_fraction=0.5)
    for split in ("train", "test"):
        jsynth.write_synth_split(os.path.join(jcfg.cache_path(), f"{split}.npz"), SIZES,
                                 seed=7, k=4)
    pcfg = port_config(jcfg)
    for split in ("train", "test"):
        assert (tds.DockingDataset.from_cache(pcfg, split).codes
                == [str(c) for c in jds.DockingDataset(jcfg, split).codes])
    assert len(tds.DockingDataset.from_cache(pcfg, "train")) == 2


def test_a_cache_the_port_writes_reads_in_the_jax_package(tmp_path):
    jcfg = _jcfg(tmp_path, bs=3)
    path = jsynth.write_synth_split(str(tmp_path / "src.npz"), SIZES, seed=1, k=4)
    codes, samples = tds.read_cache(path)
    tds.write_cache(os.path.join(jcfg.cache_path(), "train.npz"), codes, samples)
    want = list(jds.DockingDataset(jcfg, "train").batches(np.random.default_rng(2)))
    got = list(tds.DockingDataset(port_config(jcfg), samples).batches(
        np.random.default_rng(2), device="cpu"))
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("data,field,value", [
    ("dips", "data", "dips"), ("db5", "distill_dir", "teacher"), ("db5", "pack", True)])
def test_unported_data_options_raise(tmp_path, data, field, value):
    """DIPS without shards raises. Packing is ported
    (`tests/test_torch_packing.py`): the split's batches come packed. So is
    pose distillation (`tests/test_torch_distill.py`): a teacher file for
    one code of the cache blends that complex's target exactly as the JAX
    dataset does, and leaves the others."""
    pcfg = port_config(_jcfg(tmp_path))
    pcfg = dataclasses.replace(pcfg, data=dataclasses.replace(pcfg.data, **{field: value}))
    tsynth.write_synth_split(os.path.join(pcfg.cache_path(), "train.npz"), SIZES, k=4)
    if field == "distill_dir":
        teacher = tmp_path / value
        teacher.mkdir()
        plain = tds.DockingDataset.from_cache(dataclasses.replace(pcfg, data=dataclasses.replace(
            pcfg.data, distill_dir="")), "train")
        code, gt = plain.codes[1], plain.samples[1].gt_lig
        with open(teacher / f"{code}_l_b_TEACHER.pdb", "w") as f:
            for i, xyz in enumerate(gt + 1.5):
                f.write(f"ATOM  {i + 1:5d}  CA  ALA A{i + 1:4d}    "
                        f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00           C\n")
        pcfg = dataclasses.replace(pcfg, data=dataclasses.replace(pcfg.data,
                                                                  distill_dir=str(teacher)))
        ds = tds.DockingDataset.from_cache(pcfg, "train")
        jds_ = jds.DockingDataset(_jcfg(tmp_path, distill_dir=str(teacher)), "train")
        for i, (g, p) in enumerate(zip(ds.samples, plain.samples)):
            np.testing.assert_array_equal(g.gt_lig, jds_.samples[i].gt_lig)
            assert np.array_equal(g.gt_lig, p.gt_lig) == (i != 1)
        return
    if field == "pack":
        ds = tds.DockingDataset.from_cache(pcfg, "train")
        batches = list(ds.batches(np.random.default_rng(0), device="cpu"))
        assert all(b.n_segs == pcfg.data.pack_max_per_slot for b in batches)
        assert sum(int(b.seg_mask.sum()) for b in batches) == len(SIZES)
        return
    with pytest.raises(NotImplementedError, match=field):
        tds.DockingDataset.from_cache(pcfg, "train")
