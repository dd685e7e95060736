"""The port's interface crops (`data/crops.py`, `cli/crop_corpus.py`)
against the JAX package's on a raw tree of tracked chains cut in two:
parents, single crops from one seed and whole crop corpora bit-equal, and
the CLI under EQUIDOCK_REFERENCE_ROOT (the JAX package's own crop tests
need the reference checkout and skip without it)."""

import os

import numpy as np
import pytest

from equidock_public_tpu.config import Config as JConfig, DataConfig as JData
from equidock_public_tpu.data import crops as jcrops
from equidock_public_tpu.data.synth import dips_testset_sizes as jax_sizes
from equidock_public_tpu_torch.cli import crop_corpus
from equidock_public_tpu_torch.config import Config, DataConfig
from equidock_public_tpu_torch.data import crops
from equidock_public_tpu_torch.data.dips import shard_files
from equidock_public_tpu_torch.data.synth import dips_testset_sizes

from .torch_utils import assert_npz_equal, f32_default, write_small_tree  # noqa: F401

QUIET = lambda *a: None
SIZES = [(30, 40), (50, 26), (80, 90)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("crop_raw")
    raw, cv = write_small_tree(root / "ref")
    return root, raw, cv


def _paths(raw, code):
    return os.path.join(raw, f"{code}_l_b.pdb"), os.path.join(raw, f"{code}_r_b.pdb")


def test_parents_and_crops_are_bit_equal_to_jax(tree):
    _, raw, _ = tree
    got, want = crops.load_parent("1NW9", *_paths(raw, "1NW9")), jcrops.load_parent(
        "1NW9", *_paths(raw, "1NW9"))
    for key in ("lig_ca", "rec_ca", "iface"):
        assert np.array_equal(getattr(got, key), getattr(want, key))
    assert [k for k, _ in got.lig_res] == [k for k, _ in want.lig_res]
    assert crops.load_parent("2VDB", *_paths(raw, "2VDB"), pocket_cutoff=0.5) is None
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    n = 0
    for _ in range(6):
        g = crops.sample_crop(got, r1, SIZES, max_side=64)
        w = jcrops.sample_crop(want, r2, SIZES, max_side=64)
        assert (g is None) == (w is None)
        if g is None:
            continue
        n += 1
        for side in ("lig", "rec"):
            for key in ("res_id", "x", "mu_r_norm", "nbr", "nbr_mask", "edge_feat"):
                a, b = getattr(getattr(g, side), key), getattr(getattr(w, side), key)
                assert a.dtype == b.dtype and np.array_equal(a, b), (side, key)
        for key in ("gt_lig", "gt_rec", "pocket"):
            assert np.array_equal(getattr(g, key), getattr(w, key))
    assert n >= 4


@pytest.mark.parametrize("n_jobs", [1, 2])
def test_crop_shards_are_bit_equal_to_jax(tree, tmp_path, n_jobs):
    _, raw, _ = tree
    codes = ["2AYO", "2SNI", "6B0S", "1NW9"]
    want = jcrops.generate_crop_shards(JConfig(data=JData(data="dips", cache_dir=str(
        tmp_path / "j"))), "train", codes, raw, 10, 3, SIZES, 64, n_jobs=1, log=QUIET)
    cfg = Config(data=DataConfig(data="dips", cache_dir=str(tmp_path / "p")))
    got = crops.generate_crop_shards(cfg, "train", codes, raw, 10, 3, SIZES, 64,
                                     n_jobs=n_jobs, log=QUIET)
    assert len(got) == len(want) == 1
    assert_npz_equal(got[0], want[0])
    logged = []
    assert crops.generate_crop_shards(cfg, "train", codes, raw, 10, 3, SIZES, 64,
                                      log=logged.append) == got
    assert logged[0].startswith("crop cache exists")
    with pytest.raises(ValueError, match="dips"):
        crops.generate_crop_shards(Config(), "train", codes, raw, 10, 3, SIZES)


def test_the_cli_crops_the_reference_tree(tree, tmp_path, monkeypatch):
    """`cli.crop_corpus` with its parents and size sample under
    EQUIDOCK_REFERENCE_ROOT: train, val and test shards as JAX's
    `generate_crop_shards` makes them from the same parents and seeds."""
    root, raw, cv = tree
    sizes_dir = tmp_path / "sizes"
    os.makedirs(sizes_dir / "random_transformed")
    for code in ("2VDB", "1QA9"):
        for side in "lr":
            os.link(os.path.join(raw, f"{code}_{side}_b.pdb"),
                    sizes_dir / "random_transformed" / f"{code}_{side}_b.pdb")
    sizes = dips_testset_sizes(str(sizes_dir))
    assert sizes == jax_sizes(str(sizes_dir)) and len(sizes) == 2
    monkeypatch.setenv("EQUIDOCK_REFERENCE_ROOT", str(root / "ref"))
    assert crop_corpus.main(["-n_pairs", "6", "-n_val_pairs", "4", "-max_side", "48",
                             "-crop_seed", "1", "-n_jobs", "1", "-dips_sizes_dir",
                             str(sizes_dir), "-cache_dir", str(tmp_path / "p")]) == 0
    jcfg = JConfig(data=JData(data="dips", cache_dir=str(tmp_path / "j")))
    pcfg = Config(data=DataConfig(data="dips", cache_dir=str(tmp_path / "p")))
    for split, parents, n, seed in (("train", ["2AYO", "2SNI", "2VDB", "6B0S"], 6, 1),
                                    ("val", ["1NW9"], 4, 2), ("test", ["1NW9"], 64, 3)):
        want = jcrops.generate_crop_shards(jcfg, split, parents, raw, n, seed, sizes, 48,
                                           n_jobs=1, log=QUIET)
        got = shard_files(pcfg.cache_path(), split)
        assert len(got) == len(want) == 1
        assert_npz_equal(got[0], want[0])
