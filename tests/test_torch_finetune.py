"""Two-stage fine-tuning in the port (the port's versions of
`tests/test_finetune_from.py`'s cases, against the JAX package):

* `freeze_original`: three train steps leave the original stage bit for bit
  where it was, move the fine-tune stage, and give the original stage the
  JAX package's Adam moments (weight decay reaches the moments through the
  zeroed gradient, never the weights); the fine-tune stage's parameters and
  moments follow the JAX package's;
* without freezing, a step moves both stages;
* the composed (R, t) maps the original input ligand onto ligand_coords,
  the stage-1 subtree still runs alone, and the two-stage forward is the
  JAX package's;
* the training CLI: `-fine_tune_from` a stage-1 checkpoint of the port with
  `-fine_tune_init copy` and `-freeze_original` (the copied leaves are
  distinct tensors equal to stage 1's, the ft_att_* leaves the port's
  `init_params`; after an epoch the original stage is stage 1's bit for
  bit), and `-continue_train_model` with `-fine_tune_from` raises.

Tolerances: as `tests/test_torch_train_step.py` (loss terms rtol 1e-5, the
Sinkhorn term and the total 1e-4; parameters 2 lr a step); the original
stage's moments rtol 1e-5 (they are w_decay x the same weights)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.train import step as js
from equidock_public_tpu_torch.cli import train as cli
from equidock_public_tpu_torch.config import Config, DataConfig
from equidock_public_tpu_torch.data.synth import write_synth_split
from equidock_public_tpu_torch.models import iegmn as tm
from equidock_public_tpu_torch.params import flatten, init_params, params_from_numpy
from equidock_public_tpu_torch.train import step as ts
from equidock_public_tpu_torch.train.checkpoint import load_checkpoint

from .torch_utils import f32_default, port_batch, port_config  # noqa: F401
from .utils import synth_batch, tiny_config

LOSS_KEYS = ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (small ops: no contention with the other
    workers), and float32 as the default dtype for the module's fixtures
    too (another test module sets float64 at import)."""
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)


def _setup(freeze):
    """The JAX test's surgery: a stage-1 trunk and a fresh fine-tune stage."""
    jcfg = tiny_config(iegmn_n_lays=2, fine_tune=True)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train,
                                                               freeze_original=freeze))
    batch = synth_batch(np.random.default_rng(0), B=2, N_l=12, N_r=12, n_l=10, n_r=10,
                        coord_scale=30.0)
    stage1 = jm.init_docking_model(jax.random.PRNGKey(1),
                                   dataclasses.replace(jcfg.model, fine_tune=False))
    fresh = jm.init_docking_model(jax.random.PRNGKey(2), jcfg.model)
    jp = jax.tree.map(np.asarray, {"original": stage1["original"],
                                   "finetune": fresh["finetune"]})
    pcfg = port_config(jcfg)
    return jcfg, batch, jp, pcfg, params_from_numpy(jp, pcfg.model), port_batch(batch)


def _adam(opt_state):
    return next(s for s in opt_state if hasattr(s, "mu") and hasattr(s, "nu"))


def test_a_frozen_original_stage_is_bit_stable_and_as_the_jax_packages():
    jcfg, batch, jp, pcfg, pp, pb = _setup(freeze=True)
    jstate = js.create_train_state(jax.tree.map(jnp.array, jp), jcfg)
    pstate = ts.create_train_state(pp, pcfg, "cpu")
    snap = {k: v.clone() for k, v in flatten(pstate.params).items()}
    for i in range(3):
        jstate, jmet = js.train_step(jstate, batch, jax.random.PRNGKey(i), jcfg, 1.0)
        pstate, pmet = ts.train_step(pstate, pb, pcfg)
        for k in LOSS_KEYS + ("grad_norm",):
            rtol = 1e-4 if k in ("ot_loss", "loss") else 1e-5
            np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=rtol,
                                       err_msg=f"step {i + 1} {k}")
    after = flatten(pstate.params)
    jafter = flatten(jax.tree.map(np.asarray, jstate.params))
    adam = _adam(jax.tree.map(np.asarray, jstate.opt_state))
    jmu, jnu = flatten(adam.mu), flatten(adam.nu)
    moved = decayed = False
    for k, v in after.items():
        if k.startswith("original/"):
            assert torch.equal(v, snap[k]), k                  # bit for bit
            np.testing.assert_array_equal(jafter[k], flatten(jp)[k])
            decayed |= float(pstate.mu[k].abs().max()) > 0    # weight decay reached it
            np.testing.assert_allclose(pstate.mu[k].numpy(), jmu[k], rtol=1e-5, atol=1e-12)
            np.testing.assert_allclose(pstate.nu[k].numpy(), jnu[k], rtol=1e-5, atol=1e-20)
        else:
            moved |= not torch.equal(v, snap[k])
            np.testing.assert_allclose(v.numpy(), jafter[k], atol=6 * jcfg.train.lr, err_msg=k)
    assert moved and decayed


def test_unfrozen_fine_tuning_trains_both_stages():
    _, _, _, pcfg, pp, pb = _setup(freeze=False)
    state = ts.create_train_state(pp, pcfg, "cpu")
    before = {k: v.clone() for k, v in flatten(state.params).items()}
    state, m = ts.train_step(state, pb, pcfg)
    assert np.isfinite(float(m["loss"]))
    for stage in ("original/", "finetune/"):
        assert any(not torch.equal(v, before[k]) for k, v in flatten(state.params).items()
                   if k.startswith(stage)), stage


def test_the_composed_transform_maps_the_original_ligand():
    jcfg, batch, jp, pcfg, pp, pb = _setup(freeze=True)
    cfg1 = dataclasses.replace(pcfg.model, fine_tune=False)
    out1 = tm.docking_forward({"original": pp["original"]}, cfg1, pb)
    out2 = tm.docking_forward(pp, pcfg.model, pb)
    x = pb.lig.x
    lig = torch.einsum("bij,bnj->bni", out2["R"], x) + out2["t"]
    np.testing.assert_allclose(lig.numpy(), out2["ligand_coords"].numpy(), rtol=1e-4, atol=1e-4)
    assert torch.isfinite(out1["ligand_coords"]).all()
    want = jax.jit(lambda b: jm.docking_forward(jp, jcfg.model, b))(batch)
    m = np.asarray(batch.lig.node_mask)[..., None]
    np.testing.assert_allclose(out2["ligand_coords"].numpy() * m,
                               np.asarray(want["ligand_coords"]) * m, atol=2e-3)
    np.testing.assert_allclose(out2["R"].numpy(), np.asarray(want["R"]), atol=1e-4)


SIZES = [(10, 14), (12, 20), (9, 11), (20, 25)]
TINY = ["-residue_emb_dim", "8", "-iegmn_lay_hid_dim", "8", "-iegmn_n_lays", "2",
        "-num_att_heads", "4", "-bs", "2", "-node_buckets", "32", "-pocket_buckets", "16",
        "-device", "cpu", "-max_epochs", "1", "-toy"]


@pytest.fixture
def stage1(tmp_path, monkeypatch):
    """(CLI flags, path of a stage-1 checkpoint of the port after one epoch)."""
    monkeypatch.chdir(tmp_path)
    cache = str(tmp_path / "cache")
    cfg = Config(data=DataConfig(cache_dir=cache))
    for i, split in enumerate(("train", "val", "test")):
        write_synth_split(os.path.join(cfg.cache_path(), f"{split}.npz"), SIZES, seed=i, k=4)
    args = TINY + ["-cache_dir", cache, "-checkpoint_dir", str(tmp_path / "ckpt1")]
    assert cli.main(args) == 0
    c = cli.config_from_args(cli._parser().parse_args(args))
    return TINY + ["-cache_dir", cache], os.path.join(c.checkpoint_dir, c.banner(),
                                                      "db5_model_best")


def test_fine_tune_init_copy_and_a_frozen_cli_epoch(stage1, tmp_path):
    args, path = stage1
    s1, _, _ = load_checkpoint(path, "cpu")
    cfg = cli.config_from_args(cli._parser().parse_args(args + ["-freeze_original"]))
    state, ft_cfg, _ = cli.fine_tune_state(path, cfg, "copy", "cpu")
    assert ft_cfg.model.fine_tune and ft_cfg.train.freeze_original
    orig, ft = flatten(s1.params["original"]), flatten(state.params["finetune"])
    fresh = flatten(init_params(ft_cfg.model, ft_cfg.train.random_seed)["finetune"])
    copied = 0
    for k, v in ft.items():
        if k in orig and orig[k].shape == v.shape:
            assert torch.equal(v, orig[k]) and v.data_ptr() != orig[k].data_ptr(), k
            copied += 1
        else:
            assert torch.equal(v, fresh[k]), k
    assert copied and any(k.startswith("layer0/ft_att_") for k in ft)
    # a frozen epoch from the CLI: the original stage is stage 1's bit for bit
    out = str(tmp_path / "ckpt2")
    assert cli.main(args + ["-fine_tune_from", path, "-freeze_original", "-fine_tune_init",
                            "copy", "-checkpoint_dir", out]) == 0
    done, saved, _ = load_checkpoint(os.path.join(out, ft_cfg.banner(), "db5_model_best"), "cpu")
    assert saved.model.fine_tune and saved.train.freeze_original
    for k, v in flatten(done.params["original"]).items():
        assert torch.equal(v, orig[k]), k
    assert any(not torch.equal(v, ft[k]) for k, v in flatten(done.params["finetune"]).items())
    with pytest.raises(ValueError, match="mutually exclusive"):
        cli.main(args + ["-fine_tune_from", path, "-continue_train_model", path])
