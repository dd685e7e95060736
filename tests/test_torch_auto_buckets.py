"""Auto buckets (`-node_buckets auto:G`, `-pocket_buckets auto:G`) of the
port against the JAX package on the CPU, and hazard C3 decided at the
first key count they reach that is not a multiple of 512.

* `config.auto_node_buckets` equals the JAX package's on the tracked
  chains' residue counts and on seeded size lists, for node buckets (align
  64, quad_at 640) and pocket buckets (align 32, quad_at 256), at several
  G;
* the ladders that `train/loop.py::fit` resolves from a split cache
  (`resolve_auto_buckets`) and that `cli.inference` derives from a
  directory (`input_ladder`) equal the JAX package's (its `fit`'s and its
  CLI's computation, on the JAX package's own datasets and PDB reader);
* C3: the tracked chains resolve to the ladder (128, 192, 256, 576) at
  G 4. Served on it, 5HGG -> 1N2C pads to 256 x 576: the ligand's queries
  meet M = 576 keys, the receptor's M = 256. JAX's Pallas attention pads
  keys to 1024 and 512 with mask 0, so a padded query row (which keeps no
  key) averages over the padded count there and over M in the port
  (`tests/test_torch_attention_tiles.py::test_keys_past_m_c3_pallas_pads_the_port_does_not`).
  Those rows are padded nodes: no valid node reads them (their neighbour
  entries carry mask 0, their keys are masked, the keypoint head masks
  them). The whole forward of the paper model's committed weights on that
  request matches JAX's fused path (Pallas in interpret mode) and its XLA
  path in R (1e-3), t and CA (1e-2 A) and the keypoints (1e-3 A): the
  difference reaches no output, so the port keeps its behaviour."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from equidock_public_tpu import config as jconfig
from equidock_public_tpu.data import dataset as jds
from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu_torch import config as tc
from equidock_public_tpu_torch.cli import inference as inference_cli
from equidock_public_tpu_torch.data import dataset as tds
from equidock_public_tpu_torch.data.synth import write_synth_split
from equidock_public_tpu_torch.eval import inference
from equidock_public_tpu_torch.params import default_checkpoint, load_checkpoint
from equidock_public_tpu_torch.train.loop import resolve_auto_buckets

from . import torch_golden as tg
from .torch_utils import f32_default, jax_batch, port_config  # noqa: F401

GATE = {"R": 1e-3, "t": 1e-2, "ca": 1e-2, "keypts_lig": 1e-3, "keypts_rec": 1e-3}


def _tracked_sizes():
    from equidock_public_tpu.data.featurize import filter_residues
    from equidock_public_tpu.data.pdb import group_residues, read_pdb

    d = os.path.join(tg.REPO, tg.PDB_DIR)
    return [len(filter_residues(group_residues(read_pdb(os.path.join(d, f)))))
            for f in sorted(os.listdir(d)) if f.endswith(".pdb")]


@pytest.mark.parametrize("source", ["tracked", "seed0", "seed1"])
@pytest.mark.parametrize("groups", [1, 2, 4, 12])
@pytest.mark.parametrize("align,quad_at", [(64, 640), (32, 256)])
def test_auto_node_buckets_is_the_jax_packages(source, groups, align, quad_at):
    if source == "tracked":
        sizes = _tracked_sizes()
    else:
        rng = np.random.default_rng(int(source[-1]))
        sizes = rng.integers(20, 3000, 200).tolist()
    want = jconfig.auto_node_buckets(sizes, groups, align=align, quad_at=quad_at)
    got = tc.auto_node_buckets(sizes, groups, align=align, quad_at=quad_at)
    assert got == want and all(isinstance(b, int) for b in got)
    assert len(got) <= groups and got[-1] >= max(sizes)
    with pytest.raises(ValueError, match="empty"):
        tc.auto_node_buckets([], groups)


def test_fit_resolves_the_jax_ladders(tmp_path):
    jcfg = jconfig.Config(data=jconfig.DataConfig(cache_dir=str(tmp_path / "cache"),
                                                  auto_buckets_max=3, auto_pocket_max=2))
    pcfg = port_config(jcfg)
    assert pcfg.data.auto_buckets_max == 3 and pcfg.data.auto_pocket_max == 2
    rng = np.random.default_rng(4)
    for i, split in enumerate(("train", "val", "test")):
        sizes = [tuple(int(x) for x in rng.integers(20, 700, 2)) for _ in range(6)]
        write_synth_split(os.path.join(pcfg.cache_path(), f"{split}.npz"), sizes, seed=i, k=4)
    # the JAX package's fit: every split's pair sizes and pocket sizes
    jsets = [jds.DockingDataset(jcfg, s) for s in ("train", "val", "test")]
    want_nodes = jconfig.auto_node_buckets(
        [d.pair_max_nodes(i) for d in jsets for i in range(len(d.codes))], 3)
    want_pockets = jconfig.auto_node_buckets(
        [d.pocket_size(i) for d in jsets for i in range(len(d.codes))], 2, align=32,
        quad_at=256)
    psets = [tds.DockingDataset.from_cache(pcfg, s) for s in ("train", "val", "test")]
    logged = []
    cfg = resolve_auto_buckets(pcfg, psets, logged.append)
    assert cfg.data.node_buckets == want_nodes and cfg.data.pocket_buckets == want_pockets
    assert cfg.data.auto_buckets_max == 0 and cfg.data.auto_pocket_max == 0
    assert all(d.cfg is cfg for d in psets)
    assert logged == [f"auto node buckets ({len(want_nodes)} steps): {want_nodes}",
                      f"auto pocket buckets ({len(want_pockets)} steps): {want_pockets}"]
    assert resolve_auto_buckets(cfg, psets, logged.append) is cfg and len(logged) == 2


def test_the_inference_cli_derives_the_jax_ladder(tmp_path):
    """The JAX CLI's prescan: every ligand of the input directory and its
    receptor in the ground-truth directory (a missing receptor skipped)."""
    import shutil

    from equidock_public_tpu.data.featurize import filter_residues
    from equidock_public_tpu.data.pdb import group_residues, read_pdb

    (tmp_path / "in").mkdir()
    (tmp_path / "gt").mkdir()
    for i, (lig, rec) in enumerate(tg.PAIRS):
        shutil.copy(os.path.join(tg.REPO, tg.pdb_path(lig)), tmp_path / "in" / f"C{i}_l_b.pdb")
        if i != 1:
            shutil.copy(os.path.join(tg.REPO, tg.pdb_path(rec)),
                        tmp_path / "gt" / f"C{i}_r_b_COMPLEX.pdb")
    sizes = []
    for f in sorted(os.listdir(tmp_path / "in")):
        rec = tmp_path / "gt" / f.replace("_l_b.pdb", "_r_b_COMPLEX.pdb")
        for path in (tmp_path / "in" / f, rec):
            if os.path.exists(path):
                sizes.append(len(filter_residues(group_residues(read_pdb(str(path))))))
    assert len(sizes) == 2 * len(tg.PAIRS) - 1
    for groups in (2, 4):
        assert inference_cli.input_ladder(str(tmp_path / "in"), str(tmp_path / "gt"),
                                          groups) == jconfig.auto_node_buckets(sizes, groups)


@pytest.fixture(scope="module")
def c3_request():
    """5HGG -> 1N2C served on the tracked chains' auto ladder at G 4."""
    params, cfg = load_checkpoint(default_checkpoint())
    ladder = tc.auto_node_buckets(_tracked_sizes(), 4)
    assert ladder == (128, 192, 256, 576)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, node_buckets=ladder))
    req = inference.featurize_request(cfg, os.path.join(tg.REPO, tg.pdb_path("5HGG")),
                                      os.path.join(tg.REPO, tg.pdb_path("1N2C")), "cpu")
    assert (req.batch.lig.x.shape[1], req.batch.rec.x.shape[1]) == (256, 576)
    return params, cfg, req


@pytest.mark.parametrize("path", ["fused", "xla"])
def test_c3_the_whole_forward_at_m_576_matches_jax(c3_request, path):
    from equidock_public_tpu.train.checkpoint import load_checkpoint as jax_load

    params, cfg, req = c3_request
    out = inference.make_forward(params, cfg)(req.batch)
    payload, jcfg, _ = jax_load(tg.CHECKPOINT)
    mcfg = jcfg.model if path == "xla" else dataclasses.replace(jcfg.model, **tg.FUSED)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, b: jm.docking_forward(p, mcfg, b))(payload["params"],
                                                                     jax_batch(req.batch))
    got = {"R": out["R"][0], "t": out["t"][0, 0], "ca": out["ligand_coords"][0, :req.num_lig_res],
           "keypts_lig": out["keypts_lig"][0], "keypts_rec": out["keypts_rec"][0]}
    ref = {"R": want["R"][0], "t": want["t"][0, 0],
           "ca": want["ligand_coords"][0, :req.num_lig_res],
           "keypts_lig": want["keypts_lig"][0], "keypts_rec": want["keypts_rec"][0]}
    for k, atol in GATE.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=atol,
                                   err_msg=k)
    # the padded query rows do differ inside: a layer's cross-attention on
    # the ligand's padded rows averages over 576 keys here, over 1024 in
    # the Pallas kernel (the attention test pins that); the outputs above
    # do not see them
    assert torch.isfinite(out["ligand_coords"]).all()
