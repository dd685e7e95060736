"""The port's sharded DIPS caches (`data/dips.py`, `data/dataset.py` with
`data='dips'`) against the JAX package's, on synthetic shards (the recipe of
`tests/test_dips_stream.py`, which `data/synth.py::write_synth_shards`
copies):

* the shard writer writes the JAX test's arrays under one seed;
* `DipsShardIndex` gives the JAX package's codes, shards and sizes, writes
  its `.index.json` sidecars and reads them back without loading a shard; a
  truncated sidecar is derived again, a read-only directory gets none;
* `ShardLRU` holds at most its capacity and loads no shard twice;
* streamed and materialized DIPS batches equal the JAX package's under one
  numpy seed, field for field (shuffled with swap, and in order);
* a streamed epoch covers every complex once, loads each shard once and
  holds at most 2 windows;
* `data_fraction` keeps the leading shards; a split with no shards raises.
"""

import dataclasses
import os

import numpy as np
import pytest

from equidock_public_tpu.config import Config as JConfig
from equidock_public_tpu.config import DataConfig as JData
from equidock_public_tpu.config import TrainConfig as JTrain
from equidock_public_tpu.data import dips as jdips
from equidock_public_tpu.data.dataset import DockingDataset as JDataset
from equidock_public_tpu_torch.data import dips as tdips
from equidock_public_tpu_torch.data.dataset import DockingDataset
from equidock_public_tpu_torch.data.synth import write_synth_shards

from .test_dips_stream import _write_shards
from .test_torch_cache import _assert_batches_equal
from .torch_utils import f32_default, port_config  # noqa: F401

N_SHARDS, PER_SHARD, BS, WINDOW = 12, 24, 4, 2


def _jcfg(tmp_path, stream, **data_kw):
    return JConfig(train=JTrain(bs=BS),
                   data=JData(data="dips", cache_dir=str(tmp_path / "cache"),
                              node_buckets=(16, 32), pocket_buckets=(8,),
                              stream_dips=stream, stream_window=WINDOW, **data_kw))


def _corpus(tmp_path, stream=True, **data_kw):
    jcfg = _jcfg(tmp_path, stream, **data_kw)
    write_synth_shards(jcfg.cache_path(), n_shards=N_SHARDS, per_shard=PER_SHARD, seed=0)
    return jcfg, port_config(jcfg)


def test_shard_writer_writes_the_jax_recipe(tmp_path):
    _write_shards(str(tmp_path / "j"), n_shards=3, per_shard=5, seed=4)
    paths = write_synth_shards(str(tmp_path / "t"), n_shards=3, per_shard=5, seed=4)
    assert [os.path.basename(p) for p in paths] == sorted(os.listdir(tmp_path / "j"))
    for p in paths:
        with np.load(p) as t, np.load(tmp_path / "j" / os.path.basename(p)) as j:
            assert sorted(t.files) == sorted(j.files)
            for key in j.files:
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        assert os.path.exists(p + ".index.json")


def test_shard_index_matches_jax_and_reads_its_sidecars(tmp_path, monkeypatch):
    jcfg, pcfg = _corpus(tmp_path)
    os.remove(tdips.shard_files(pcfg.cache_path(), "train")[0] + ".index.json")
    got = tdips.DipsShardIndex(pcfg.cache_path(), "train")     # derives shard 0's
    want = jdips.DipsShardIndex(jcfg.cache_path(), "train")
    assert len(got) == len(want) == N_SHARDS * PER_SHARD
    for f in ("codes", "shard_of", "index_in_shard", "n_lig", "n_rec", "n_pocket"):
        assert [str(x) for x in getattr(got, f)] == [str(x) for x in getattr(want, f)], f
    dense = DockingDataset.from_cache(dataclasses.replace(
        pcfg, data=dataclasses.replace(pcfg.data, stream_dips=False)), "train")
    for i in range(0, len(got), 37):
        s = dense.samples[i]
        assert (got.n_lig[i], got.n_rec[i], got.n_pocket[i]) == (
            s.lig.num_nodes, s.rec.num_nodes, s.pocket.shape[0])
    assert all(os.path.exists(p + ".index.json") for p in got.shard_paths)
    calls = []
    monkeypatch.setattr(tdips, "load_shard_samples", lambda p: calls.append(p))
    tdips.DipsShardIndex(pcfg.cache_path(), "train")
    assert calls == []


def test_a_truncated_sidecar_is_derived_again(tmp_path):
    _, pcfg = _corpus(tmp_path)
    path = tdips.shard_files(pcfg.cache_path(), "train")[1]
    with open(path + ".index.json", "w") as f:
        f.write('{"codes": ["s1c0", ')                      # a writer killed mid-way
    idx = tdips.DipsShardIndex(pcfg.cache_path(), "train")
    assert idx.codes[PER_SHARD] == "s1c0" and len(idx) == N_SHARDS * PER_SHARD
    assert not os.path.exists(path + ".index.json.tmp")


def test_a_read_only_cache_gets_no_sidecar(tmp_path, monkeypatch):
    _, pcfg = _corpus(tmp_path)
    for p in tdips.shard_files(pcfg.cache_path(), "train"):
        os.remove(p + ".index.json")

    def refuse(*a, **kw):
        raise PermissionError("read-only")

    monkeypatch.setattr(tdips.os, "replace", refuse)
    idx = tdips.DipsShardIndex(pcfg.cache_path(), "train")
    assert len(idx) == N_SHARDS * PER_SHARD
    assert not any(os.path.exists(p + ".index.json") for p in idx.shard_paths)


def test_shard_lru_bounded_and_counts(tmp_path):
    _, pcfg = _corpus(tmp_path)
    idx = tdips.DipsShardIndex(pcfg.cache_path(), "train")
    lru = tdips.ShardLRU(idx.shard_paths, capacity=3)
    for s in range(N_SHARDS):
        lru.prefetch((s + 1) % N_SHARDS)
        assert len(lru.get(s)) == PER_SHARD
        assert lru.resident() <= 3
    assert lru.loads <= N_SHARDS + 1      # the wrap-around prefetch of shard 0


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("shuffle,seed", [(True, 3), (True, 11), (False, 7)])
def test_dips_batches_equal_the_jax_ones(tmp_path, stream, shuffle, seed):
    jcfg, pcfg = _corpus(tmp_path, stream)
    swap = None if shuffle else False
    want = list(JDataset(jcfg, "train", swap=swap).batches(np.random.default_rng(seed),
                                                           shuffle=shuffle))
    ds = DockingDataset.from_cache(pcfg, "train", swap=swap)
    assert (ds.index is not None) == stream and (ds.samples is None) == stream
    got = list(ds.batches(np.random.default_rng(seed), device="cpu", shuffle=shuffle))
    _assert_batches_equal(got, want)


def test_streamed_epoch_covers_every_sample_once_with_bounded_residency(tmp_path):
    _, pcfg = _corpus(tmp_path)
    ds = DockingDataset.from_cache(pcfg, "train")
    seen = []
    orig = ds.sample
    ds.sample = lambda i, rng: (seen.append(int(i)), orig(i, rng))[1]
    n_batches = sum(1 for _ in ds.batches(np.random.default_rng(3), device="cpu"))
    n = N_SHARDS * PER_SHARD
    assert n_batches == n // BS and sorted(seen) == list(range(n))
    assert ds._lru.loads == N_SHARDS
    assert ds._lru.resident() <= 2 * WINDOW


def test_data_fraction_keeps_the_leading_shards(tmp_path):
    _, pcfg = _corpus(tmp_path, data_fraction=0.5)
    ds = DockingDataset.from_cache(pcfg, "train")
    assert len(ds) == N_SHARDS * PER_SHARD // 2
    seen = []
    orig = ds.sample
    ds.sample = lambda i, rng: (seen.append(int(i)), orig(i, rng))[1]
    list(ds.batches(np.random.default_rng(5), device="cpu"))
    assert sorted(seen) == list(range(len(ds)))
    assert ds._lru.loads == N_SHARDS // 2


def test_a_split_without_shards_raises(tmp_path):
    _, pcfg = _corpus(tmp_path)
    with pytest.raises(NotImplementedError, match="no DIPS shards of split 'val'"):
        DockingDataset.from_cache(pcfg, "val")
