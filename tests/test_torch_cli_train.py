"""The port's training CLI (`cli/train.py`) on the CPU: a run on a
synthetic cache writes the best checkpoint with its whole-config sidecar,
`-continue_train_model` resumes from it, and every flag of the JAX CLI that
the port does not honour raises with its name."""

import json
import os

import pytest

from equidock_public_tpu_torch.cli import train as cli
from equidock_public_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from equidock_public_tpu_torch.data.synth import write_synth_split
from equidock_public_tpu_torch.train.checkpoint import load_checkpoint

from .torch_utils import f32_default  # noqa: F401

SIZES = [(10, 14), (12, 20), (9, 11), (20, 25)]
TINY = ["-residue_emb_dim", "8", "-iegmn_lay_hid_dim", "8", "-iegmn_n_lays", "2",
        "-num_att_heads", "4", "-bs", "2", "-node_buckets", "32", "-pocket_buckets", "16",
        "-use_fused_intersection", "-device", "cpu"]


def _args(tmp_path):
    cache, ckpt = str(tmp_path / "cache"), str(tmp_path / "ckpt")
    cfg = Config(data=DataConfig(cache_dir=cache))
    for i, split in enumerate(("train", "val", "test")):
        write_synth_split(os.path.join(cfg.cache_path(), f"{split}.npz"), SIZES, seed=i, k=4)
    return TINY + ["-cache_dir", cache, "-checkpoint_dir", ckpt]


def test_train_writes_a_checkpoint_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)                       # the text log goes to ./stdouterr
    args = _args(tmp_path)
    assert cli.main(args + ["-toy", "-max_epochs", "1"]) == 0
    cfg = cli.config_from_args(cli._parser().parse_args(args))
    path = os.path.join(cfg.checkpoint_dir, cfg.banner(), "db5_model_best")
    state, saved_cfg, epoch = load_checkpoint(path, "cpu")
    assert epoch == 0 and state.step == 2 and saved_cfg == cfg
    with open(path + ".config.json") as f:
        assert set(json.load(f)) == {"model", "graph", "data", "train", "parallel", "debug",
                                     "checkpoint_dir", "log_dir"}
    assert cli.main(args + ["-max_epochs", "1", "-continue_train_model", path]) == 0
    assert load_checkpoint(path, "cpu")[0].step == 4      # two more steps from step 2
    log = open(os.path.join("stdouterr", cfg.banner() + ".txt")).read()
    assert "Kernel paths ===>  none: the plain PyTorch versions on cpu" in log


def test_the_kernel_path_report_names_the_kernels():
    import torch

    cfg = Config(model=ModelConfig(), train=TrainConfig(use_fused_intersection=True))
    report = cli.kernel_path_report(cfg, torch.device("cuda"))
    assert report.startswith("7 of 7") and "softmin_field_bwd" in report


# flags that were refused before packing and two-stage fine-tuning were
# ported: parsed into the config now (their runs: tests/test_torch_finetune.py,
# tests/test_torch_packing.py)
PORTED = {"pack": ([], lambda a, c: c.data.pack),
          "pack_max_per_slot": (["3"], lambda a, c: c.data.pack_max_per_slot == 3),
          "freeze_original": ([], lambda a, c: c.train.freeze_original),
          "fine_tune_from": (["stage1"], lambda a, c: a.fine_tune_from == "stage1"),
          "fine_tune_init": (["copy"], lambda a, c: a.fine_tune_init == "copy"),
          # pose distillation (its targets: tests/test_torch_distill.py)
          "distill_dir": (["teacher"], lambda a, c: c.data.distill_dir == "teacher"),
          "distill_alpha": (["0.25"], lambda a, c: c.data.distill_alpha == 0.25),
          # the cache builders' flags (their runs: tests/test_torch_preprocess.py)
          "n_jobs": (["2"], lambda a, c: c.data.n_jobs == 2),
          "raw_data_path": (["raw"], lambda a, c: c.data.raw_data_path == "raw"),
          "split_files_path": (["cv"], lambda a, c: c.data.split_files_path == "cv"),
          # the mesh and the last JAX-only flags (their runs: tests/test_torch_dist_fit.py,
          # tests/test_torch_debug_padcache.py)
          "dp": (["2"], lambda a, c: c.parallel.dp == 2),
          "gp": (["2"], lambda a, c: c.parallel.gp == 2),
          "pallas_ring_halo": ([], lambda a, c: c.parallel.pallas_ring_halo),
          "pad_cache_gb": (["1.5"], lambda a, c: c.data.pad_cache_gb == 1.5),
          "compile_cache": (["jax_cache"], lambda a, c: a.compile_cache == "jax_cache"),
          "debug": ([], lambda a, c: c.debug)}


@pytest.mark.parametrize("flag", sorted(cli.REFUSED) + sorted(PORTED))
def test_unported_flags_raise_with_their_name(tmp_path, flag):
    if flag in PORTED:
        value, honoured = PORTED[flag]
        assert flag not in cli.REFUSED
        a = cli._parser().parse_args(TINY + [f"-{flag}"] + value)
        cli.refuse_unported(a)
        assert honoured(a, cli.config_from_args(a))
        return
    with pytest.raises(NotImplementedError, match=f"-{flag}"):
        cli.main(TINY + ["-toy", "-max_epochs", "1", f"-{flag}", "1"])


@pytest.mark.parametrize("extra,match", [
    ([], "DIPS stage"), (["-toy", "-node_buckets", "auto:4"], "auto"),
    (["-toy", "-layer_norm", "BN"], "layer_norm"), (["-toy", "-fine_tune"], "fine_tune"),
    (["-toy", "-ot_solver", "exact"], "ot_solver")])
def test_runs_outside_the_port_raise(tmp_path, monkeypatch, extra, match):
    """A run without -toy starts the curriculum's DIPS stage, which raises
    when no DIPS shards exist (the port does not build them). Auto buckets,
    BatchNorm, a fine-tune stage and the exact OT solver are ported: their
    runs train an epoch and say which path the layers take; an auto run
    saves the ladder it resolved from the splits (`config.auto_node_buckets`
    of each pair's larger side; tests/test_torch_auto_buckets.py holds it
    to the JAX package's)."""
    monkeypatch.chdir(tmp_path)
    if match == "DIPS stage":
        with pytest.raises(NotImplementedError, match=match):
            cli.main(TINY + extra)
        return
    args = _args(tmp_path) + extra + ["-max_epochs", "1"]
    assert cli.main(args) == 0
    cfg = cli.config_from_args(cli._parser().parse_args(args))
    state, saved, _ = load_checkpoint(os.path.join(cfg.checkpoint_dir, cfg.banner(),
                                                   "db5_model_best"), "cpu")
    if match == "auto":
        from equidock_public_tpu_torch.config import auto_node_buckets

        assert cfg.data.auto_buckets_max == 4 and saved.data.auto_buckets_max == 0
        assert saved.data.node_buckets == auto_node_buckets([max(s) for s in SIZES] * 3, 4)
        assert "auto node buckets" in open(os.path.join("stdouterr",
                                                        cfg.banner() + ".txt")).read()
        return
    assert getattr(saved.model, match, None) or getattr(saved.train, match, None)
    assert bool(state.bn_state) == (match == "layer_norm")
    assert ("finetune" in state.params) == (match == "fine_tune")
    log = open(os.path.join("stdouterr", cfg.banner() + ".txt")).read()
    assert "edge-message: plain PyTorch layer body" in log if match == "layer_norm" \
        else "edge-message: CUDA rows 1-2" in log


def test_the_resident_and_streaming_flags_are_honoured():
    a = cli._parser().parse_args(TINY + ["-device_resident", "-trim_remainder", "-stream_dips",
                                         "-stream_window", "2", "-data", "dips"])
    cli.refuse_unported(a)
    cfg = cli.config_from_args(a)
    assert cfg.data.device_resident and cfg.train.trim_remainder
    assert (cfg.data.stream_dips, cfg.data.stream_window, cfg.data.data) == (True, 2, "dips")
    d = cli.config_from_args(cli._parser().parse_args(TINY))
    assert not (d.data.device_resident or d.train.trim_remainder or d.data.stream_dips)
    assert d.data.stream_window == 4
    for flag in ("device_resident", "trim_remainder", "stream_dips", "stream_window"):
        assert flag not in cli.REFUSED


@pytest.mark.parametrize("flag", [["-dp", "2"], ["-pack"]])
def test_dp_and_pack_with_device_resident_raise_by_name(flag):
    """-pack does not compose with -device_resident; -dp does (dp-resident
    epochs: tests/test_torch_dist_resident.py) but not with the streamed
    store, which runs on one rank (the JAX package's rule)."""
    extra = ["-data", "dips", "-stream_dips"] if flag[0] == "-dp" else []
    with pytest.raises((NotImplementedError, ValueError), match=flag[0]):
        cli.main(TINY + ["-toy", "-max_epochs", "1", "-device_resident"] + flag + extra)


def test_pack_with_dp_raises_by_name(tmp_path, monkeypatch):
    """Packed batches train on a dp mesh (here stacked in one process: the
    slot-count buckets rounded up to multiples of dp, as the JAX package's
    mesh path does) and with graph shards (-gp: the halo path plans a
    packed slot as one graph; tests/test_torch_dist_options.py holds its
    step to JAX's). What still raises by name is packing with 'GN', the
    JAX package's own refusal."""
    monkeypatch.chdir(tmp_path)
    args = _args(tmp_path) + ["-toy", "-max_epochs", "1", "-pack"]
    with pytest.raises(ValueError, match="-pack with final_h_layer_norm='GN'"):
        cli.main(args + ["-gp", "2", "-final_h_layer_norm", "GN"])
    for mesh, want in ((["-dp", "2"], "mesh training: dp=2 x gp=1 stacked in one process"),
                       (["-gp", "2"], "mesh training: dp=1 x gp=2 stacked in one process")):
        assert cli.main(args + mesh) == 0
        cfg = cli.config_from_args(cli._parser().parse_args(args + mesh))
        log = open(os.path.join("stdouterr", cfg.banner() + ".txt")).read()
        assert want in log
        if mesh[0] == "-dp":
            assert "packed mesh training: slot-count buckets -> (2, 4, 6, 8, 10)" in log


def test_a_resident_run_writes_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = _args(tmp_path)
    assert cli.main(args + ["-toy", "-max_epochs", "1", "-device_resident",
                            "-trim_remainder"]) == 0
    cfg = cli.config_from_args(cli._parser().parse_args(args + ["-device_resident"]))
    state, saved, _ = load_checkpoint(os.path.join(cfg.checkpoint_dir, cfg.banner(),
                                                   "db5_model_best"), "cpu")
    assert saved.data.device_resident and state.step == 2     # 4 pairs: 2 + 2 (trimmed)
    log = open(os.path.join("stdouterr", cfg.banner() + ".txt")).read()
    assert "device-resident epochs:" in log and " MB on cpu" in log


def test_the_default_run_reaches_the_dips_stage(tmp_path, monkeypatch):
    """No -toy, no -max_epochs: the curriculum, its DIPS stage on
    synthetic shards (streamed, resident), then the DB5 stage."""
    from equidock_public_tpu_torch.data.synth import write_synth_shards

    monkeypatch.chdir(tmp_path)
    args = _args(tmp_path) + ["-num_epochs", "1", "-device_resident", "-stream_dips",
                              "-stream_window", "1"]
    cfg = cli.config_from_args(cli._parser().parse_args(args))
    dips = Config(data=DataConfig(data="dips", cache_dir=cfg.data.cache_dir))
    for i, split in enumerate(("train", "val", "test")):
        write_synth_shards(dips.cache_path(), split, n_shards=2, per_shard=3, seed=i)
    assert cli.main(args) == 0
    ckpt = os.path.join(cfg.checkpoint_dir, cfg.banner())
    assert os.path.exists(os.path.join(ckpt, "dips_model_best"))
    assert os.path.exists(os.path.join(ckpt, "db5_model_best"))
    log = open(os.path.join("stdouterr", cfg.banner() + ".txt")).read()
    assert "streamed-resident epochs" in log and "[FINAL TEST dips]" in log
    assert "[FINAL TEST db5]" in log
