"""The port's host tools against the JAX package's on the same inputs:
`cli/testset_gen.py` (DB5 and DIPS, byte-equal files), `cli/
align_receptor.py` (byte-equal output), `cli/surface_analysis.py` (equal
rhos), `utils/padding.py` and `cli/padding_report.py` (equal reports),
`cli/hyper_search.py` (equal draws, its trial command, one trial run), and
`utils/profiling.py` (a Chrome trace with a named span, the timer's
warm-up)."""

import argparse
import json
import os
import random
import subprocess
import sys
import types

import numpy as np
import pandas as pd
import pytest

from equidock_public_tpu.cli import align_receptor as jax_align
from equidock_public_tpu.cli import hyper_search as jax_hyper
from equidock_public_tpu.cli import padding_report as jax_padding_report
from equidock_public_tpu.cli import surface_analysis as jax_surface
from equidock_public_tpu.cli import testset_gen as jax_testset
from equidock_public_tpu.utils import padding as jax_padding
from equidock_public_tpu_torch.cli import (align_receptor, hyper_search, padding_report,
                                           surface_analysis, testset_gen)
from equidock_public_tpu_torch.cli._common import REFUSED, add_config_args, config_from_args
from equidock_public_tpu_torch.utils import padding, profiling

from .test_torch_dips_build import ATOM3, write_pair
from .torch_utils import REPO, chain_file, f32_default, write_small_tree  # noqa: F401


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    raw, cv = write_small_tree(root / "ref", splits=(("train", 3), ("val", 1), ("test", 2)))
    return root, raw, cv


def same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as f, open(os.path.join(b, n), "rb") as g:
            assert f.read() == g.read(), n


def test_testset_db5_files_are_byte_equal(tree, tmp_path):
    _, raw, cv = tree
    split = os.path.join(cv, "test.txt")
    testset_gen.main(["-dataset", "db5", "-raw_data_path", raw, "-split_file", split,
                      "-out_dir", str(tmp_path / "p"), "-seed", "4"])
    jax_testset.main_db5(raw, split, str(tmp_path / "j"), np.random.default_rng(4))
    same_files(tmp_path / "p", tmp_path / "j")
    assert len(os.listdir(tmp_path / "p")) == 8


def test_testset_dips_files_are_byte_equal(tmp_path):
    data = tmp_path / "pairs"
    names = []
    for i, code in enumerate(("2VDB", "2SNI", "6B0S")):
        os.makedirs(data / f"fam{i % 2}", exist_ok=True)
        write_pair(data / f"fam{i % 2}" / f"{code}.dill", code, ATOM3)
        names.append(f"fam{i % 2}/{code}.dill")
    split = tmp_path / "pairs-postprocessed-test.txt"
    split.write_text("\n".join(names) + "\n")
    testset_gen.main(["-dataset", "dips", "-raw_data_path", str(data), "-split_file",
                      str(split), "-out_dir", str(tmp_path / "p"), "-num_complexes", "2",
                      "-seed", "1"])
    jax_testset.main_dips(str(data), str(split), str(tmp_path / "j"),
                          np.random.default_rng(1), num_complexes=2, seed=1)
    same_files(tmp_path / "p", tmp_path / "j")
    got = testset_gen.sample_dips_round_robin(str(split), 5, random.Random(0).shuffle)
    assert got == jax_testset.sample_dips_round_robin(str(split), 5, random.Random(0).shuffle)
    assert sorted(got) == sorted(names)


def test_align_receptor_output_is_byte_equal(tree, tmp_path, monkeypatch):
    _, raw, cv = tree
    d = tmp_path / "set"
    testset_gen.main(["-raw_data_path", raw, "-split_file", os.path.join(cv, "test.txt"),
                      "-out_dir", str(d)])
    code = sorted(os.listdir(d))[0].split("_")[0]
    args = ["-ligand", str(d / f"{code}_l_b.pdb"), "-receptor", str(d / f"{code}_r_b.pdb"),
            "-receptor_gt", str(d / f"{code}_r_b_COMPLEX.pdb")]
    assert align_receptor.main(args + ["-out", str(tmp_path / "p.pdb")]) == 0
    monkeypatch.setattr(sys, "argv", ["x"] + args + ["-out", str(tmp_path / "j.pdb")])
    jax_align.main()
    assert (tmp_path / "p.pdb").read_bytes() == (tmp_path / "j.pdb").read_bytes()
    # a receptor that does not move rigidly onto its ground truth
    from equidock_public_tpu_torch.data.pdb import read_pdb, write_pdb

    rec = read_pdb(args[3])
    jitter = np.random.default_rng(0).normal(0.0, 1.0, rec.coords.shape)
    write_pdb(str(tmp_path / "bent.pdb"), rec, (rec.coords + jitter).astype(np.float32))
    with pytest.raises(ValueError, match="residual"):
        align_receptor.main(args[:3] + [str(tmp_path / "bent.pdb")] + args[4:]
                            + ["-out", str(tmp_path / "x.pdb")])


@pytest.mark.parametrize("depth", ["sas", "hull"])
def test_surface_rhos_equal_jax(depth):
    path = chain_file("2VDB")
    got = surface_analysis.analyze(path, depth_method=depth)
    assert got == jax_surface.analyze(path, depth_method=depth)
    assert len(got) == 5 and got[4] < 0


def test_padding_reports_equal_jax():
    rng = np.random.default_rng(2)
    sizes = [tuple(int(v) for v in rng.integers(20, 700, 2)) for _ in range(37)]
    buckets = (64, 128, 256, 512, 768)
    assert padding.simulate_chunks(sizes, 10) == jax_padding.simulate_chunks(sizes, 10)
    assert padding.waste_report(sizes, buckets, 10) == jax_padding.waste_report(sizes, buckets,
                                                                                10)
    pol = {"a": buckets, "b": (1536,)}
    assert padding.compare_policies(sizes, 4, pol) == jax_padding.compare_policies(sizes, 4, pol)
    for c in (2, 4):
        assert (padding.waste_report_packed(sizes, buckets, 10, c)
                == jax_padding.waste_report_packed(sizes, buckets, 10, c))


def test_padding_report_cli_equals_jax(tree, tmp_path, monkeypatch, capsys):
    """The report on a built DB5 train cache and a test-set directory."""
    from equidock_public_tpu_torch.cli import preprocess

    _, raw, cv = tree
    cache = str(tmp_path / "cache")
    preprocess.main(["-raw_data_path", raw, "-split_files_path", cv, "-n_jobs", "1",
                     "-cache_dir", cache, "train"])
    testset_gen.main(["-raw_data_path", raw, "-split_file", os.path.join(cv, "train.txt"),
                      "-out_dir", str(tmp_path / "dips" / "random_transformed")])
    args = ["-cache_dir", cache, "-dips_dir", str(tmp_path / "dips"), "-bs", "2"]
    capsys.readouterr()
    assert padding_report.main(args) == 0
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["x"] + args)
    jax_padding_report.main()
    assert json.loads(got) == json.loads(capsys.readouterr().out)
    assert set(json.loads(got)) == {"bs", "db5_train", "dips_test"}


def _base(args=()):
    p = argparse.ArgumentParser()
    add_config_args(p)
    return p.parse_args(list(args))


def test_hyper_search_draws_equal_jax():
    from equidock_public_tpu.cli._common import add_config_args as jax_args
    from equidock_public_tpu.cli._common import config_from_args as jax_config

    jp = argparse.ArgumentParser()
    jax_args(jp)
    jbase, base = jax_config(jp.parse_args([])), config_from_args(_base())
    r1, r2 = random.Random(8), random.Random(8)
    for _ in range(20):
        got, want = hyper_search.sample_config(base, r1), jax_hyper.sample_config(jbase, r2)
        for sec in ("model", "train"):
            g, w = getattr(got, sec), getattr(want, sec)
            for f in ("dropout", "iegmn_n_lays", "shared_layers", "skip_weight_h",
                      "x_connection_init", "iegmn_lay_hid_dim", "num_att_heads", "w_decay",
                      "intersection_loss_weight", "pocket_ot_loss_weight", "clip"):
                if hasattr(w, f):
                    assert getattr(g, f) == getattr(w, f), f
        assert got.banner() == want.banner()


def test_the_trial_command_names_the_port():
    a = _base(["-cache_dir", "C", "-node_buckets", "64,128"])
    a.max_epochs, a.max_seconds, a.device = 1, None, "cpu"
    cmd = hyper_search._trial_cmd(a, config_from_args(a))
    assert cmd[1:3] == ["-m", "equidock_public_tpu_torch.cli.train"]
    assert not {f"-{f}" for f in REFUSED} & set(cmd)
    assert cmd[cmd.index("-device") + 1] == "cpu" and "-toy" in cmd
    assert cmd[cmd.index("-node_buckets") + 1] == "64,128"


@pytest.mark.parametrize("in_process", [False, True])
def test_one_trial_trains_in_a_subprocess(tmp_path, in_process):
    """One trial of the search on the CPU (the search fixes the width at
    64) on a small synthetic cache, in a process of its own or, with
    -in_process, in the search's; its log file is the skip rule's."""
    from equidock_public_tpu_torch.config import Config, DataConfig
    from equidock_public_tpu_torch.data.synth import write_synth_split

    cache = Config(data=DataConfig(cache_dir=str(tmp_path / "cache"))).cache_path()
    for i, split in enumerate(("train", "val", "test")):
        write_synth_split(os.path.join(cache, f"{split}.npz"), [(10, 12), (14, 11)], seed=i)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "equidock_public_tpu_torch.cli.hyper_search", "-num_trials", "1",
         "-max_epochs", "1", "-device", "cpu", "-bs", "2", "-node_buckets", "16",
         "-pocket_buckets", "8", "-cache_dir", str(tmp_path / "cache"), "-checkpoint_dir",
         str(tmp_path / "ckpt")] + ["-in_process"] * in_process, capture_output=True, text=True,
        timeout=120, cwd=tmp_path, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert in_process or "=== trial 0 exit=0" in proc.stdout
    first = hyper_search.sample_config(config_from_args(_base()), random.Random(8))
    log = (tmp_path / "stdouterr" / (first.banner() + ".txt")).read_text()
    assert "=== hyper-search trial 0" in log if in_process else "Model name" in log
    assert os.path.exists(tmp_path / "ckpt" / first.banner() / "db5_model_best")


def test_profiling_trace_and_timer(tmp_path):
    import torch

    with profiling.trace(str(tmp_path)):
        with profiling.named_scope("slice9_span"):
            torch.ones(8).sum()
    trace = json.load(open(tmp_path / profiling.TRACE_FILE))
    assert any(e.get("name") == "slice9_span" for e in trace["traceEvents"])
    from equidock_public_tpu.utils.profiling import StepTimer as JaxTimer

    got, want = profiling.StepTimer(warmup=2), JaxTimer(warmup=2)
    for _ in range(5):
        for timer in (got, want):
            with timer:
                pass
    assert len(got.times) == len(want.times) == 3 and got.mean() >= 0.0
    assert profiling.StepTimer(warmup=1).mean() == 0.0
