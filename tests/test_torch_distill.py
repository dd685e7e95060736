"""Pose distillation (`-distill_dir`, `-distill_alpha`) of the port against
the JAX package on the CPU.

The teacher poses are written by the port's own directory inference
(`eval/inference.py::run_inference_dir`, the committed 16-wide
`db5_model_small`) on tracked chains cut in two, each ligand half moved
by a seeded rigid motion; the train split's cache holds the same chains
(codes = the stems). The blended targets of the train split,
(1 - alpha) gt + alpha teacher where a teacher file `<code>_l_b_*.pdb`
with as many CA atoms exists, are bit-equal to the JAX dataset's
(`_blend_teacher_poses`), the count printed is the same, the other splits
are not blended, and a device-resident store holds the blended targets.
A streamed DIPS split with `distill_dir` raises in both packages (it holds
no samples to blend). The training CLI runs a distilled epoch."""

import dataclasses
import os

import numpy as np
import pytest

from equidock_public_tpu.config import Config as JaxConfig
from equidock_public_tpu.config import DataConfig as JaxDataConfig
from equidock_public_tpu.data import dataset as jds
from equidock_public_tpu_torch.cli import train as train_cli
from equidock_public_tpu_torch.data import dataset as tds
from equidock_public_tpu_torch.data.featurize import filter_residues
from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb, write_pdb
from equidock_public_tpu_torch.data.synth import write_synth_shards
from equidock_public_tpu_torch.eval.inference import run_inference_dir
from equidock_public_tpu_torch.params import load_checkpoint, model_checkpoint
from equidock_public_tpu_torch.train.checkpoint import load_checkpoint as load_state
from equidock_public_tpu_torch.train.resident import build_resident_split

from .test_torch_eval import _rotation, _split_chain
from .torch_utils import f32_default, port_config  # noqa: F401

# small tracked chains; the last has no teacher pose
CODES = ("2VDB", "2SNI", "6B0S", "1NW9")
ALPHA = 0.3


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """(root, JAX config): the split caches of the chains cut in two under
    root/cache, the teacher poses under root/teacher."""
    root = tmp_path_factory.mktemp("distill")
    for d in ("in", "gt", "teacher"):
        (root / d).mkdir()
    jcfg = JaxConfig(data=JaxDataConfig(cache_dir=str(root / "cache"), distill_dir=str(
        root / "teacher"), distill_alpha=ALPHA))
    pcfg = port_config(jcfg)
    rng = np.random.default_rng(2)
    samples = []
    for code in CODES:
        gt_l = root / "gt" / f"{code}_l_b_COMPLEX.pdb"
        gt_r = root / "gt" / f"{code}_r_b_COMPLEX.pdb"
        _split_chain(code, gt_l, gt_r)
        table = read_pdb(str(gt_l))
        c = table.coords.mean(axis=0)
        moved = (table.coords - c) @ _rotation(rng).T + c + rng.normal(0, 5.0, 3)
        if code != CODES[-1]:
            write_pdb(str(root / "in" / f"{code}_l_b.pdb"), table, moved.astype(np.float32))
        samples.append(tds.complex_from_residues(
            filter_residues(group_residues(table)),
            filter_residues(group_residues(read_pdb(str(gt_r)))), pcfg.graph))
    for split in ("train", "val", "test"):
        tds.write_cache(os.path.join(pcfg.cache_path(), f"{split}.npz"), CODES, samples)
    params, cfg = load_checkpoint(model_checkpoint("db5_model_small"))
    run_inference_dir(params, cfg, str(root / "in"), str(root / "gt"), str(root / "teacher"),
                      log=lambda *a: None, device="cpu")
    assert sorted(os.listdir(root / "teacher")) == [f"{c}_l_b_EQUIDOCK_TPU.pdb"
                                                    for c in sorted(CODES[:-1])]
    return root, jcfg


def test_blended_targets_are_bit_equal_to_the_jax_datasets(teacher, capsys):
    root, jcfg = teacher
    pcfg = port_config(jcfg)
    assert pcfg.data.distill_dir == str(root / "teacher") and pcfg.data.distill_alpha == ALPHA
    plain = tds.DockingDataset.from_cache(
        dataclasses.replace(pcfg, data=dataclasses.replace(pcfg.data, distill_dir="")), "train")
    capsys.readouterr()
    got = tds.DockingDataset.from_cache(pcfg, "train")
    port_line = capsys.readouterr().out
    want = jds.DockingDataset(jcfg, "train")
    jax_line = capsys.readouterr().out
    assert port_line == jax_line == (f"distill: blended teacher poses into {len(CODES) - 1}/"
                                     f"{len(CODES)} train targets (alpha={ALPHA})\n")
    assert got.codes == list(want.codes) == list(CODES)
    for i, (g, w, p) in enumerate(zip(got.samples, want.samples, plain.samples)):
        assert g.gt_lig.dtype == w.gt_lig.dtype == np.float32
        np.testing.assert_array_equal(g.gt_lig, w.gt_lig)
        assert np.array_equal(g.gt_lig, p.gt_lig) == (i == len(CODES) - 1)
    teacher_ca = read_pdb(str(root / "teacher" / f"{CODES[0]}_l_b_EQUIDOCK_TPU.pdb"))
    ca = teacher_ca.coords[teacher_ca.atom_name == "CA"].astype(np.float32)
    blend = ((1.0 - ALPHA) * plain.samples[0].gt_lig + ALPHA * ca).astype(np.float32)
    np.testing.assert_array_equal(got.samples[0].gt_lig, blend)
    # only the train split is blended; a resident store holds the blended targets
    val = tds.DockingDataset.from_cache(pcfg, "val")
    assert all(np.array_equal(v.gt_lig, p.gt_lig) for v, p in zip(val.samples, plain.samples))
    rs = build_resident_split(got, pcfg, "cpu")
    held = [gt for meta in rs.metas.values() for gt in meta.gt_lig]
    assert sorted(float(h.sum()) for h in held) == sorted(float(s.gt_lig.sum())
                                                          for s in got.samples)


def test_a_streamed_dips_split_with_distillation_raises_in_both(tmp_path):
    jcfg = JaxConfig(data=JaxDataConfig(data="dips", stream_dips=True,
                                        cache_dir=str(tmp_path / "cache"),
                                        distill_dir=str(tmp_path / "teacher")))
    pcfg = port_config(jcfg)
    write_synth_shards(pcfg.cache_path(), "train", n_shards=2, per_shard=3)
    with pytest.raises(AssertionError, match="stream_dips"):
        jds.DockingDataset(jcfg, "train")
    with pytest.raises(ValueError, match="stream_dips"):
        tds.DockingDataset.from_cache(pcfg, "train")


def test_the_training_cli_runs_a_distilled_epoch(teacher, tmp_path, monkeypatch):
    root, jcfg = teacher
    monkeypatch.chdir(tmp_path)
    args = ["-residue_emb_dim", "8", "-iegmn_lay_hid_dim", "8", "-iegmn_n_lays", "2",
            "-num_att_heads", "4", "-bs", "2", "-pocket_buckets", "auto:2",
            "-cache_dir", str(root / "cache"), "-checkpoint_dir", str(tmp_path / "ckpt"),
            "-distill_dir", str(root / "teacher"), "-distill_alpha", str(ALPHA),
            "-device", "cpu", "-toy", "-max_epochs", "1"]
    assert train_cli.main(args) == 0
    cfg = train_cli.config_from_args(train_cli._parser().parse_args(args))
    log = open(os.path.join("stdouterr", cfg.banner() + ".txt")).read()
    assert "auto pocket buckets" in log
    _, saved, _ = load_state(os.path.join(cfg.checkpoint_dir, cfg.banner(), "db5_model_best"),
                             "cpu")
    assert saved.data.distill_dir == str(root / "teacher") and saved.data.distill_alpha == ALPHA
