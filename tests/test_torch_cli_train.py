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
        assert set(json.load(f)) == {"model", "graph", "data", "train", "checkpoint_dir",
                                     "log_dir"}
    assert cli.main(args + ["-max_epochs", "1", "-continue_train_model", path]) == 0
    assert load_checkpoint(path, "cpu")[0].step == 4      # two more steps from step 2
    log = open(os.path.join("stdouterr", cfg.banner() + ".txt")).read()
    assert "Kernel paths ===>  none: the plain PyTorch versions on cpu" in log


def test_the_kernel_path_report_names_the_kernels():
    import torch

    cfg = Config(model=ModelConfig(), train=TrainConfig(use_fused_intersection=True))
    report = cli.kernel_path_report(cfg, torch.device("cuda"))
    assert report.startswith("7 of 7") and "softmin_field_bwd" in report


@pytest.mark.parametrize("flag", sorted(cli.REFUSED))
def test_unported_flags_raise_with_their_name(tmp_path, flag):
    with pytest.raises(NotImplementedError, match=f"-{flag}"):
        cli.main(TINY + ["-toy", "-max_epochs", "1", f"-{flag}", "1"])


@pytest.mark.parametrize("extra,match", [
    ([], "DIPS stage"), (["-toy", "-node_buckets", "auto:4"], "auto"),
    (["-toy", "-layer_norm", "BN"], "layer_norm"), (["-toy", "-fine_tune"], "fine_tune"),
    (["-toy", "-ot_solver", "exact"], "ot_solver")])
def test_runs_outside_the_port_raise(tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(TINY + (["-max_seconds", "1"] if "-toy" in extra else []) + extra)
