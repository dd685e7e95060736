"""The port's cache builders (`data/dataset.py::build_cache`, `cli/
preprocess.py`, `data/dips.py::build_dips_frozen_cache`) against the JAX
package's on a raw tree of tracked chains cut in two: the same codes kept
and dropped, every array bit-equal; `-n_jobs`, `-raw_data_path` and
`-split_files_path` accepted by the port's CLIs; `reference_root` moving
the defaults."""

import os
import shutil

import pytest

from equidock_public_tpu.config import Config as JConfig, DataConfig as JData
from equidock_public_tpu.data.dataset import build_cache as jax_build_cache
from equidock_public_tpu.data.dips import build_dips_frozen_cache as jax_frozen
from equidock_public_tpu_torch.cli import preprocess
from equidock_public_tpu_torch.config import Config, DataConfig, reference_root
from equidock_public_tpu_torch.data.dataset import DockingDataset, build_cache
from equidock_public_tpu_torch.data.dips import shard_files

from .torch_utils import assert_npz_equal, f32_default, write_small_tree  # noqa: F401

QUIET = lambda *a: None
SPLITS = ("train", "val", "test")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    raw, cv = write_small_tree(root)
    jcfg = JConfig(data=JData(raw_data_path=raw, split_files_path=cv, n_jobs=1,
                              cache_dir=str(root / "jax_cache")))
    want = {s: jax_build_cache(jcfg, s, log=QUIET) for s in SPLITS}
    return root, raw, cv, want


@pytest.mark.parametrize("n_jobs", [1, 2])
def test_build_cache_is_bit_equal_to_jax(tree, tmp_path, n_jobs):
    _, raw, cv, want = tree
    cfg = Config(data=DataConfig(raw_data_path=raw, split_files_path=cv, n_jobs=n_jobs,
                                 cache_dir=str(tmp_path)))
    logged = []
    for s in SPLITS:
        assert_npz_equal(build_cache(cfg, s, log=logged.append), want[s])
    ds = DockingDataset.from_cache(cfg, "train")
    assert ds.codes == ["2AYO", "2SNI", "2VDB", "6B0S"]           # sorted, none dropped
    # an existing cache is kept as it is
    before = os.path.getmtime(os.path.join(cfg.cache_path(), "train.npz"))
    build_cache(cfg, "train", log=logged.append)
    assert os.path.getmtime(os.path.join(cfg.cache_path(), "train.npz")) == before
    assert logged[-1].startswith("cache exists")


def test_dropped_complexes_and_missing_files_follow_jax(tree, tmp_path):
    """A complex whose halves have no pocket is dropped, a listed code
    without both files is skipped, as in the JAX package."""
    root, raw, cv, _ = tree
    raw2, cv2 = tmp_path / "raw", tmp_path / "cv"
    shutil.copytree(raw, raw2)
    os.makedirs(cv2)
    # 2VDB's receptor moved 100 A away: no pocket pair left
    lines = open(raw2 / "2VDB_r_b.pdb").read().splitlines(True)
    with open(raw2 / "2VDB_r_b.pdb", "w") as f:
        f.writelines(ln[:30] + f"{float(ln[30:38]) + 100.0:8.3f}" + ln[38:] for ln in lines)
    os.remove(raw2 / "2SNI_r_b.pdb")
    (cv2 / "train.txt").write_text("2VDB\n2SNI\n6B0S\n\n6B0S\nNONE\n")
    jcfg = JConfig(data=JData(raw_data_path=str(raw2), split_files_path=str(cv2), n_jobs=1,
                              cache_dir=str(tmp_path / "jax")))
    cfg = Config(data=DataConfig(raw_data_path=str(raw2), split_files_path=str(cv2), n_jobs=1,
                                 cache_dir=str(tmp_path / "port")))
    logged = []
    assert_npz_equal(build_cache(cfg, "train", log=logged.append),
                     jax_build_cache(jcfg, "train", log=QUIET))
    assert DockingDataset.from_cache(cfg, "train").codes == ["6B0S"]
    assert any("dropped 2VDB" in line for line in logged)


def test_the_cli_builds_the_splits_as_jax(tree, tmp_path):
    _, raw, cv, want = tree
    assert preprocess.main(["-raw_data_path", raw, "-split_files_path", cv, "-n_jobs", "2",
                            "-cache_dir", str(tmp_path)]) == 0
    path = Config(data=DataConfig(cache_dir=str(tmp_path))).cache_path()
    for s in SPLITS:
        assert_npz_equal(os.path.join(path, f"{s}.npz"), want[s])


def test_dips_frozen_complexes_as_jax(tree, tmp_path):
    """`-dips_frozen_complexes`: bound pairs `*_{l,r}_b_COMPLEX.pdb` as DIPS
    shards (8 : 1 : 1 by sorted index), bit-equal to JAX's."""
    _, raw, _, _ = tree
    frozen = tmp_path / "complexes"
    os.makedirs(frozen)
    for f in os.listdir(raw):
        shutil.copy(os.path.join(raw, f), frozen / f.replace("_b.pdb", "_b_COMPLEX.pdb"))
    want = jax_frozen(JConfig(data=JData(data="dips", n_jobs=1, cache_dir=str(tmp_path / "j"))),
                      str(frozen), log=QUIET)
    assert preprocess.main(["-data", "dips", "-dips_frozen_complexes", str(frozen),
                            "-n_jobs", "2", "-cache_dir", str(tmp_path / "p")]) == 0
    cfg = Config(data=DataConfig(data="dips", cache_dir=str(tmp_path / "p")))
    got = {s: shard_files(cfg.cache_path(), s) for s in SPLITS}
    assert [os.path.basename(p) for s in SPLITS for p in got[s]] == [os.path.basename(p)
                                                                     for p in want]
    for p, w in zip([p for s in SPLITS for p in got[s]], want):
        assert_npz_equal(p, w)
    assert len(DockingDataset.from_cache(cfg, "train")) == 6


@pytest.mark.parametrize("cli", ["preprocess", "crop_corpus", "padding_report", "hyper_search",
                                 "train", "inference"])
def test_the_cache_flags_are_accepted_and_the_rest_refused(cli, tmp_path):
    import argparse
    import importlib

    from equidock_public_tpu_torch.cli._common import (REFUSED, add_config_args,
                                                       config_from_args, refuse_unported)

    mod = importlib.import_module(f"equidock_public_tpu_torch.cli.{cli}")
    assert not {"n_jobs", "raw_data_path", "split_files_path"} & set(REFUSED)
    assert {"compile_cache", "dp", "gp", "pad_cache_gb"} <= set(REFUSED)
    assert "add_config_args" in vars(mod)
    p = argparse.ArgumentParser()
    add_config_args(p)
    a = p.parse_args(["-n_jobs", "3", "-raw_data_path", "R", "-split_files_path", "S"])
    refuse_unported(a)
    d = config_from_args(a).data
    assert (d.n_jobs, d.raw_data_path, d.split_files_path) == (3, "R", "S")
    with pytest.raises(NotImplementedError, match="-compile_cache"):
        refuse_unported(p.parse_args(["-compile_cache", "x"]))


def test_reference_root_moves_the_defaults(monkeypatch, tmp_path):
    import argparse

    from equidock_public_tpu_torch.cli._common import add_config_args

    monkeypatch.setenv("EQUIDOCK_REFERENCE_ROOT", str(tmp_path))
    assert reference_root("a", "b") == os.path.join(str(tmp_path), "a", "b")
    d = DataConfig()
    assert d.raw_data_path == os.path.join(str(tmp_path), "data/benchmark5.5/structures")
    assert d.split_files_path == os.path.join(str(tmp_path), "data/benchmark5.5/cv/cv_0")
    p = argparse.ArgumentParser()
    add_config_args(p)
    assert p.parse_args([]).raw_data_path == d.raw_data_path
    with pytest.raises(FileNotFoundError, match="EQUIDOCK_REFERENCE_ROOT"):
        reference_root("missing", must_exist=True)
    monkeypatch.delenv("EQUIDOCK_REFERENCE_ROOT")
    assert DataConfig().raw_data_path == os.path.join(os.path.expanduser("~"), "reference",
                                                      "data/benchmark5.5/structures")
