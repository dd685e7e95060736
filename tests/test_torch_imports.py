"""Import guard for the PyTorch port: neither `equidock_public_tpu_torch/`
nor `chip_smoke.py` may import JAX, flax, optax, orbax or anything of the
JAX package `equidock_public_tpu`, because the machine with the card has
none of them. Checked statically (ast) and by running the port's serving
path, one training step and one halo forward and step in a process where
those modules cannot be imported; likewise the inference surface (native
builder, clash removal, directory, batched and ensemble inference, the
evaluator, batched serving), and a resident epoch, the curriculum on
streamed DIPS shards and the shipped models' weight files, and a packed
training step with BatchNorm, dropout, remat and the exact OT solver. The
host builders and tools import pandas and dill (absent there too) inside
the DIPS pickle readers only: no module imports them at module level, and
the card-side builders and tools run where neither can be imported."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "equidock_public_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "equidock_public_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def _forbidden(name):
    """JAX and its libraries, the JAX package, and tensorboard (absent on the
    card's machine; the port logs scalars as JSON lines)."""
    parts = name.split(".")
    return parts[0] in FORBIDDEN or "tensorboard" in parts


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_the_guard_catches_what_it_should(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import jax.numpy as jnp\nfrom equidock_public_tpu.config import Config\n"
                 "from orbax import checkpoint\nimport equidock_public_tpu_torch\n")
    assert [m for m in _imported_modules(str(p)) if _forbidden(m)] == [
        "jax.numpy", "equidock_public_tpu.config", "orbax"]


def test_no_cpp_extension_builds():
    """The kernels build with plain nvcc; nothing reaches for PyTorch's
    extension builder (which needs ninja and compiles for minutes)."""
    for path in _port_files():
        tree = ast.parse(open(path).read(), filename=path)
        names = set(_imported_modules(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.Name):
                names.add(node.id)
        bad = [n for n in names if n and ("cpp_extension" in n or n == "load_inline")]
        assert not bad, f"{os.path.relpath(path, REPO)} uses {bad}"


BLOCKED_RUN = r'''
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint",
             "equidock_public_tpu"):
    sys.modules[name] = None          # any import of these now raises
import importlib, io, json, pkgutil, tempfile, os
import equidock_public_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
sys.path.insert(0, REPO)
import chip_smoke                      # its main runs only under __main__
from equidock_public_tpu_torch.cli.serve import DockingServer
from equidock_public_tpu_torch.params import default_checkpoint
server = DockingServer.from_checkpoint(default_checkpoint(), "cpu")
pdb = os.path.join(REPO, "artifacts", "db5_test_outputs", "{}_l_b_EQUIDOCK_TPU.pdb")
out = os.path.join(tempfile.mkdtemp(), "o.pdb")
buf = io.StringIO()
server.serve_lines([json.dumps({"ligand": pdb.format("2VDB"),
                                "receptor": pdb.format("7CEI"), "output": out})], buf)
resp = json.loads(buf.getvalue())
assert resp["ok"] is True, resp
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "flax", "optax", "orbax", "equidock_public_tpu")]
assert not loaded, loaded
print("IMPORTED", len(names))
'''


def test_serving_runs_with_jax_and_the_jax_package_unimportable():
    code = f"REPO = {REPO!r}\n" + BLOCKED_RUN
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


TRAINING_MODULES = ("train/__init__.py", "train/losses.py", "train/optim.py",
                    "train/step.py", "data/dataset.py", "ops/sinkhorn.py",
                    "ops/intersection.py", "ops/softmin_field.py",
                    "ops/cuda/softmin_field.py", "train/meter.py", "train/checkpoint.py",
                    "train/loop.py", "data/synth.py", "cli/train.py")

BLOCKED_TRAIN = r'''
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint",
             "equidock_public_tpu"):
    sys.modules[name] = None
import os
import numpy as np
from equidock_public_tpu_torch.config import Config, ModelConfig, TrainConfig
from equidock_public_tpu_torch.data.dataset import DockingDataset, split_chain_complex
from equidock_public_tpu_torch.data.featurize import filter_residues
from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb
from equidock_public_tpu_torch.params import init_params
from equidock_public_tpu_torch.train.step import create_train_state, train_step
cfg = Config(model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=2,
                               num_att_heads=4), train=TrainConfig(sinkhorn_iters=10, bs=2))
pdb = os.path.join(REPO, "artifacts", "db5_test_outputs", "{}_l_b_EQUIDOCK_TPU.pdb")
samples = [split_chain_complex(filter_residues(group_residues(read_pdb(pdb.format(c)))),
                               cfg.graph) for c in ("2SNI", "1QA9")]
batch = next(DockingDataset(cfg, samples).batches(np.random.default_rng(0), device="cpu"))
state, m = train_step(create_train_state(init_params(cfg.model), cfg, "cpu"), batch, cfg)
assert np.isfinite(float(m["loss"])) and state.step == 1
# an epoch of the training CLI on a synthetic cache, fused intersection on
import tempfile
from equidock_public_tpu_torch.cli.train import main
from equidock_public_tpu_torch.config import DataConfig
from equidock_public_tpu_torch.data.synth import write_synth_split
tmp = tempfile.mkdtemp()
os.chdir(tmp)
cache_cfg = Config(data=DataConfig(cache_dir=os.path.join(tmp, "cache")))
for split in ("train", "val", "test"):
    write_synth_split(os.path.join(cache_cfg.cache_path(), split + ".npz"), [(9, 12)] * 3, k=4)
assert main(["-residue_emb_dim", "8", "-iegmn_lay_hid_dim", "8", "-iegmn_n_lays", "2",
             "-num_att_heads", "4", "-bs", "2", "-node_buckets", "16", "-pocket_buckets", "8",
             "-use_fused_intersection", "-toy", "-max_epochs", "1", "-device", "cpu",
             "-cache_dir", os.path.join(tmp, "cache"),
             "-checkpoint_dir", os.path.join(tmp, "ckpt")]) == 0
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "flax", "optax", "orbax", "equidock_public_tpu")]
assert not loaded, loaded
print("TRAINED")
'''


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_are_under_the_guard(module):
    path = os.path.join(PKG, module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{module} imports {bad}"


def test_a_training_step_runs_with_jax_and_the_jax_package_unimportable():
    code = f"REPO = {REPO!r}\n" + BLOCKED_TRAIN
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TRAINED" in proc.stdout


HALO_MODULES = ("parallel/__init__.py", "parallel/halo.py", "parallel/mesh.py",
                "parallel/ring_attention.py", "ops/cuda/halo_ring.py")

BLOCKED_HALO = r'''
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint",
             "equidock_public_tpu"):
    sys.modules[name] = None
import numpy as np
from equidock_public_tpu_torch.cli.serve import warmup_batch
from equidock_public_tpu_torch.config import Config, ModelConfig, TrainConfig
from equidock_public_tpu_torch.params import init_params
from equidock_public_tpu_torch.parallel.halo import (build_halo_batch, make_halo_forward,
                                                     make_halo_train_step)
from equidock_public_tpu_torch.parallel.mesh import ParallelMesh
from equidock_public_tpu_torch.train.step import create_train_state
cfg = Config(model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=2,
                               num_att_heads=4), train=TrainConfig(sinkhorn_iters=10))
params = init_params(cfg.model)
hb, stats, perm_l, _ = build_halo_batch(warmup_batch(cfg, 32, 48, "cpu"), gp=2)
mesh = ParallelMesh(1, 2, "cpu")
out = make_halo_forward(cfg, mesh)(params, hb)
assert out["ligand_coords"].shape == (1, 32, 3) and np.isfinite(out["R"].numpy()).all()
state, m = make_halo_train_step(cfg, mesh)(create_train_state(params, cfg, "cpu"), hb)
assert np.isfinite(float(m["loss"])) and state.step == 1
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "flax", "optax", "orbax", "equidock_public_tpu")]
assert not loaded, loaded
print("HALO")
'''


@pytest.mark.parametrize("module", HALO_MODULES)
def test_halo_modules_are_under_the_guard(module):
    path = os.path.join(PKG, module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{module} imports {bad}"


def test_a_halo_forward_and_step_run_with_jax_and_the_jax_package_unimportable():
    code = f"REPO = {REPO!r}\n" + BLOCKED_HALO
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "HALO" in proc.stdout


INFERENCE_MODULES = ("native/__init__.py", "data/pdb.py", "data/featurize.py",
                     "eval/inference.py", "eval/batch_inference.py", "eval/ensemble.py",
                     "eval/rmsd.py", "cli/_common.py", "cli/serve.py", "cli/inference.py",
                     "cli/ensemble_inference.py", "cli/eval_outputs.py")

BLOCKED_INFERENCE = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint",
             "equidock_public_tpu"):
    sys.modules[name] = None
import dataclasses, io, json, os, shutil, tempfile
import torch
torch.set_num_threads(1)     # small ops: no contention with the other test workers
from equidock_public_tpu_torch.cli.serve import DockingServer
from equidock_public_tpu_torch.config import Config, ModelConfig
from equidock_public_tpu_torch.eval.batch_inference import run_batched_inference
from equidock_public_tpu_torch.eval.ensemble import Member, run_ensemble_dir
from equidock_public_tpu_torch.eval.inference import run_inference_dir
from equidock_public_tpu_torch.eval.rmsd import evaluate_output_dir
from equidock_public_tpu_torch.params import init_params, save_params
tmp = tempfile.mkdtemp()
cfg = Config(model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=2,
                               num_att_heads=4))
params = init_params(cfg.model)
weights = os.path.join(tmp, "tiny.pt.xz")
save_params(weights, params)
json.dump(dataclasses.asdict(cfg), open(os.path.join(tmp, "tiny.config.json"), "w"))
lines = [l for l in open(os.path.join(REPO, "artifacts", "db5_test_outputs",
                                      "2VDB_l_b_EQUIDOCK_TPU.pdb")) if l.startswith("ATOM")]
keys = list(dict.fromkeys(l[21:27] for l in lines))
for d in ("in", "gt"):
    os.makedirs(os.path.join(tmp, d))
half = set(keys[:len(keys) // 2])
for name, keep in (("gt/X_l_b_COMPLEX.pdb", True), ("gt/X_r_b_COMPLEX.pdb", False),
                   ("in/X_l_b.pdb", True)):
    open(os.path.join(tmp, name), "w").writelines(l for l in lines if (l[21:27] in half) == keep)
inp, gt = os.path.join(tmp, "in"), os.path.join(tmp, "gt")
run_inference_dir(params, cfg, inp, gt, os.path.join(tmp, "a"), remove_clashes=True,
                  log=lambda *a: None, device="cpu")
run_batched_inference(params, cfg, inp, gt, os.path.join(tmp, "a"), method_name="b",
                      log=lambda *a: None, device="cpu")
run_ensemble_dir([Member(weights, cfg, "cpu")] * 2, inp, gt, os.path.join(tmp, "a"),
                 method_name="e", log=lambda *a: None)
for m in ("equidock_tpu", "b", "e"):
    assert evaluate_output_dir(os.path.join(tmp, "a"), gt, m)["num_files"] == 1
buf = io.StringIO()
req = {"ligand": os.path.join(inp, "X_l_b.pdb"), "receptor": os.path.join(gt, "X_r_b_COMPLEX.pdb"),
       "output": os.path.join(tmp, "s.pdb"), "remove_clashes": True}
assert DockingServer(params, cfg, "cpu").serve_batched([json.dumps(req)] * 2, buf, 2) == 2
assert all(json.loads(x)["ok"] for x in buf.getvalue().splitlines())
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "flax", "optax", "orbax", "equidock_public_tpu")]
assert not loaded, loaded
print("INFERRED")
"""


@pytest.mark.parametrize("module", INFERENCE_MODULES)
def test_inference_modules_are_under_the_guard(module):
    path = os.path.join(PKG, module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{module} imports {bad}"


def test_the_inference_surface_runs_with_jax_and_the_jax_package_unimportable():
    code = f"REPO = {REPO!r}\n" + BLOCKED_INFERENCE
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "INFERRED" in proc.stdout


RESIDENT_MODULES = ("data/dips.py", "data/dataset.py", "data/synth.py", "train/resident.py",
                    "train/loop.py", "cli/train.py", "cli/_common.py", "params.py")

BLOCKED_RESIDENT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint",
             "equidock_public_tpu"):
    sys.modules[name] = None
import dataclasses, os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from equidock_public_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from equidock_public_tpu_torch.data.dataset import DockingDataset
from equidock_public_tpu_torch.data.synth import write_synth_shards, write_synth_split
from equidock_public_tpu_torch.params import TRACKED_MODELS, init_params, load_checkpoint, model_checkpoint
from equidock_public_tpu_torch.train import resident
from equidock_public_tpu_torch.train.loop import curriculum
from equidock_public_tpu_torch.train.step import create_train_state
tmp = tempfile.mkdtemp()
cfg = Config(model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=2,
                               num_att_heads=4),
             train=TrainConfig(sinkhorn_iters=10, bs=2, num_epochs=1, trim_remainder=True),
             data=DataConfig(node_buckets=(16, 32), pocket_buckets=(8, 16), device_resident=True,
                             stream_dips=True, stream_window=1,
                             cache_dir=os.path.join(tmp, "cache")),
             checkpoint_dir=os.path.join(tmp, "ckpt"), log_dir=os.path.join(tmp, "logs"))
for i, split in enumerate(("train", "val", "test")):
    write_synth_split(os.path.join(cfg.cache_path(), split + ".npz"), [(9, 12), (14, 20)] * 2,
                      seed=i, k=4)
# one resident epoch
ds = DockingDataset.from_cache(cfg, "train")
rs = resident.build_resident_split(ds, cfg, "cpu")
state = create_train_state(init_params(cfg.model), cfg, "cpu")
state, avg = resident.run_train_epoch_resident(state, rs, cfg, np.random.default_rng(0),
                                               resident.draws_factory(cfg, "cpu")("train", 0), 0)
assert np.isfinite(avg["loss"]) and avg["num_batches"] == 2
# the curriculum: streamed resident DIPS shards, then DB5
dips = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data="dips"))
for i, split in enumerate(("train", "val", "test")):
    write_synth_shards(dips.cache_path(), split, n_shards=2, per_shard=3, seed=i)
history = []
curriculum(cfg, device="cpu", history=history, log=lambda *a: None)
assert [h["stage"] for h in history if "stage" in h] == ["dips", "db5"]
for name in TRACKED_MODELS:
    load_checkpoint(model_checkpoint(name))
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "flax", "optax", "orbax", "equidock_public_tpu")]
assert not loaded, loaded
print("RESIDENT")
"""


@pytest.mark.parametrize("module", RESIDENT_MODULES)
def test_resident_modules_are_under_the_guard(module):
    path = os.path.join(PKG, module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{module} imports {bad}"


def test_a_resident_epoch_and_the_curriculum_run_with_jax_and_the_jax_package_unimportable():
    code = f"REPO = {REPO!r}\n" + BLOCKED_RESIDENT
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RESIDENT" in proc.stdout


OPTIONS_MODULES = ("graph.py", "models/layers.py", "models/iegmn.py", "ops/kabsch.py",
                   "ops/intersection.py", "ops/sinkhorn.py", "train/losses.py",
                   "train/meter.py", "train/step.py", "train/checkpoint.py")

BLOCKED_OPTIONS = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint",
             "equidock_public_tpu"):
    sys.modules[name] = None
import os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from equidock_public_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from equidock_public_tpu_torch.data.dataset import DockingDataset
from equidock_public_tpu_torch.data.synth import write_synth_split
from equidock_public_tpu_torch.models.layers import Dropout
from equidock_public_tpu_torch.params import init_params
from equidock_public_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from equidock_public_tpu_torch.train.step import create_train_state, train_step
tmp = tempfile.mkdtemp()
cfg = Config(model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=3,
                               num_att_heads=4, shared_layers=True, layer_norm="BN",
                               final_h_layer_norm="BN", dropout=0.1, remat=True),
             train=TrainConfig(sinkhorn_iters=10, bs=4, ot_solver="exact"),
             data=DataConfig(node_buckets=(32, 64), pocket_buckets=(8, 16), pack=True,
                             pack_max_per_slot=3))
path = write_synth_split(os.path.join(tmp, "train.npz"), [(9, 12), (14, 20), (7, 9), (11, 8)],
                         k=4)
batch = next(DockingDataset.from_cache(cfg, "train", cache_path=path).batches(
    np.random.default_rng(0), device="cpu"))
assert batch.n_segs == 3
state = create_train_state(init_params(cfg.model), cfg, "cpu")
drop = Dropout(0.1, torch.Generator().manual_seed(0))
state, m = train_step(state, batch, cfg, drop=drop)
assert np.isfinite(float(m["loss"])) and state.step == 1 and drop.drawn > 0
save_checkpoint(os.path.join(tmp, "ckpt"), state, cfg, 0)
back = load_checkpoint(os.path.join(tmp, "ckpt"), "cpu")[0]
assert set(back.bn_state) == set(state.bn_state) == {
    "original/layer0/edge_mlp", "original/layer0/node_mlp", "original/layer0/final_h",
    "original/rest/edge_mlp", "original/rest/node_mlp", "original/rest/final_h"}
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "flax", "optax", "orbax", "equidock_public_tpu")]
assert not loaded, loaded
print("OPTIONS")
"""


@pytest.mark.parametrize("module", OPTIONS_MODULES)
def test_options_modules_are_under_the_guard(module):
    path = os.path.join(PKG, module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{module} imports {bad}"


def test_a_packed_bn_step_runs_with_jax_and_the_jax_package_unimportable():
    """Packing, BatchNorm, dropout, remat and the exact OT solver in one
    training step, and the statistics through a checkpoint."""
    code = f"REPO = {REPO!r}\n" + BLOCKED_OPTIONS
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OPTIONS" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_nvcc_missing_raises_with_a_reason(monkeypatch, tmp_path):
    from equidock_public_tpu_torch.ops.cuda import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc at the default location")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_source_hash_tracks_the_sources():
    from equidock_public_tpu_torch.ops.cuda import _build

    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    assert all(os.path.exists(p) for p in _build._source_paths())
    assert _build.BUILD_DIR == os.path.join(PKG, "_build")


SLICE8_MODULES = ("params.py", "config.py", "cli/_common.py", "cli/serve.py",
                  "cli/inference.py", "cli/ensemble_inference.py", "eval/inference.py",
                  "eval/batch_inference.py", "eval/ensemble.py", "data/dataset.py",
                  "train/loop.py")

BLOCKED_SLICE8 = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint",
             "equidock_public_tpu"):
    sys.modules[name] = None
import io, json, os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from equidock_public_tpu_torch.cli.serve import DockingServer
from equidock_public_tpu_torch.config import (Config, DataConfig, ModelConfig, TrainConfig,
                                              auto_node_buckets)
from equidock_public_tpu_torch.data.dataset import DockingDataset, blend_teacher_poses
from equidock_public_tpu_torch.data.synth import write_synth_split
from equidock_public_tpu_torch.params import init_params, load_model
from equidock_public_tpu_torch.train.checkpoint import save_checkpoint
from equidock_public_tpu_torch.train.step import create_train_state, train_step
tmp = tempfile.mkdtemp()
cfg = Config(model=ModelConfig(residue_emb_dim=8, iegmn_lay_hid_dim=8, iegmn_n_lays=2,
                               num_att_heads=4, layer_norm="BN", dtype="bfloat16"),
             train=TrainConfig(sinkhorn_iters=10, bs=2),
             data=DataConfig(node_buckets=auto_node_buckets([9, 14, 20, 70], 2),
                             pocket_buckets=(8, 16)))
assert cfg.data.node_buckets == (64, 128)
path = write_synth_split(os.path.join(tmp, "train.npz"), [(9, 12), (14, 20)], k=4)
ds = DockingDataset.from_cache(cfg, "train", cache_path=path)
same = blend_teacher_poses(ds.samples, ds.codes, tmp, 0.5, log=lambda *a: None)
assert all(a is b for a, b in zip(same, ds.samples))
batch = next(ds.batches(np.random.default_rng(0), device="cpu"))
state, m = train_step(create_train_state(init_params(cfg.model), cfg, "cpu"), batch, cfg)
assert np.isfinite(float(m["loss"])) and state.step == 1
save_checkpoint(os.path.join(tmp, "ckpt"), state, cfg, 0)
params, back, bn_state = load_model(os.path.join(tmp, "ckpt"), "cpu")
assert back.model.dtype == "bfloat16" and set(bn_state) == set(state.bn_state)
server = DockingServer.from_checkpoint(os.path.join(tmp, "ckpt"), "cpu")
pdb = os.path.join(REPO, "artifacts", "db5_test_outputs", "{}_l_b_EQUIDOCK_TPU.pdb")
buf = io.StringIO()
server.serve_lines([json.dumps({"ligand": pdb.format("2VDB"), "receptor": pdb.format("2SNI"),
                                "output": os.path.join(tmp, "out.pdb")})], buf)
assert json.loads(buf.getvalue())["ok"], buf.getvalue()
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "flax", "optax", "orbax", "equidock_public_tpu")]
assert not loaded, loaded
print("SLICE8")
"""


@pytest.mark.parametrize("module", SLICE8_MODULES)
def test_slice8_modules_are_under_the_guard(module):
    path = os.path.join(PKG, module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{module} imports {bad}"


def test_a_bf16_bn_checkpoint_is_served_with_jax_and_the_jax_package_unimportable():
    """A bf16 'BN' model on an auto ladder trained a step, its training
    checkpoint loaded (`load_model`) and served, the distillation blend
    with no teacher file."""
    code = f"REPO = {REPO!r}\n" + BLOCKED_SLICE8
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SLICE8" in proc.stdout


SLICE9_MODULES = ("data/dataset.py", "data/dips.py", "data/pdb.py", "data/synth.py",
                  "data/crops.py", "cli/preprocess.py", "cli/partition_dips.py",
                  "cli/crop_corpus.py", "cli/testset_gen.py", "cli/align_receptor.py",
                  "cli/padding_report.py", "cli/surface_analysis.py", "cli/hyper_search.py",
                  "utils/padding.py", "utils/profiling.py")
HOST_ONLY = ("pandas", "dill")


def _module_level_imports(path):
    """Modules imported by statements outside every function body."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                yield node.module
            yield from walk(ast.iter_child_nodes(node))

    yield from walk(ast.parse(open(path).read(), filename=path).body)


@pytest.mark.parametrize("module", SLICE9_MODULES)
def test_slice9_modules_are_under_the_guard(module):
    path = os.path.join(PKG, module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{module} imports {bad}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_module_level_pandas_or_dill(path):
    bad = [m for m in _module_level_imports(path) if m.split(".")[0] in HOST_ONLY]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad} at module level"


def test_the_module_level_check_sees_through_classes_but_not_functions(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import os\ntry:\n    import pandas\nexcept ImportError:\n    pass\n"
                 "class A:\n    import dill\ndef f():\n    import pandas as pd\n")
    assert list(_module_level_imports(str(p))) == ["os", "pandas", "dill"]


BLOCKED_SLICE9 = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint",
             "equidock_public_tpu", "pandas", "dill"):
    sys.modules[name] = None
import contextlib, io, json, os, tempfile
import numpy as np
from equidock_public_tpu_torch.cli import (align_receptor, crop_corpus, padding_report,
                                           preprocess, surface_analysis, testset_gen)
from equidock_public_tpu_torch.config import Config, DataConfig
from equidock_public_tpu_torch.data.dataset import DockingDataset, build_cache
from equidock_public_tpu_torch.data.synth import write_db5_raw_tree
from equidock_public_tpu_torch.utils import profiling
tmp = tempfile.mkdtemp()
pdb = os.path.join(REPO, "artifacts", "db5_test_outputs", "{}_l_b_EQUIDOCK_TPU.pdb")
codes = ("2VDB", "2SNI", "6B0S", "2AYO")
raw, cv = write_db5_raw_tree(os.path.join(tmp, "ref"), {c: pdb.format(c) for c in codes},
                             (("train", 2), ("val", 1), ("test", 1)))
os.environ["EQUIDOCK_REFERENCE_ROOT"] = os.path.join(tmp, "ref")
cfg = Config(data=DataConfig(n_jobs=2, cache_dir=os.path.join(tmp, "cache")))
build_cache(cfg, "train", log=lambda *a: None)
assert preprocess.main(["-n_jobs", "1", "-cache_dir", os.path.join(tmp, "cache")]) == 0
assert len(DockingDataset.from_cache(cfg, "val")) == 1
sets = os.path.join(tmp, "sets", "random_transformed")
with contextlib.redirect_stdout(io.StringIO()):
    testset_gen.main(["-out_dir", sets])
    assert crop_corpus.main(["-n_pairs", "4", "-n_val_pairs", "2", "-max_side", "32",
                             "-n_jobs", "1", "-dips_sizes_dir", os.path.dirname(sets),
                             "-cache_dir", os.path.join(tmp, "cache")]) == 0
    assert preprocess.main(["-data", "dips", "-dips_frozen_complexes", sets,
                            "-cache_dir", os.path.join(tmp, "frozen")]) == 0
    assert align_receptor.main(["-ligand", os.path.join(sets, "2AYO_l_b.pdb"),
                                "-receptor", os.path.join(sets, "2AYO_r_b.pdb"),
                                "-receptor_gt", os.path.join(sets, "2AYO_r_b_COMPLEX.pdb"),
                                "-out", os.path.join(tmp, "aligned.pdb")]) == 0
    assert surface_analysis.main(["-pdb", pdb.format("2VDB"), "-depth", "hull"]) == 0
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert padding_report.main(["-cache_dir", os.path.join(tmp, "cache"), "-dips_dir",
                                os.path.dirname(sets)]) == 0
assert set(json.loads(buf.getvalue())) == {"bs", "db5_train", "dips_test"}
with profiling.trace(os.path.join(tmp, "prof")):
    with profiling.named_scope("span"):
        np.ones(3)
assert os.path.exists(os.path.join(tmp, "prof", profiling.TRACE_FILE))
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "flax", "optax", "orbax", "equidock_public_tpu",
                                  "pandas", "dill")]
assert not loaded, loaded
print("SLICE9")
"""


def test_the_host_builders_and_tools_run_without_jax_pandas_or_dill():
    """The raw tree through build_cache (2 processes) and cli.preprocess,
    the test set, the crop corpus, -dips_frozen_complexes, the aligner, the
    surface check, the padding report and a profiled span, in a process
    where jax, the JAX package, pandas and dill cannot be imported."""
    code = f"REPO = {REPO!r}\n" + BLOCKED_SLICE9
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SLICE9" in proc.stdout


SLICE10_MODULES = ("parallel/dist.py", "parallel/launch.py", "parallel/train.py",
                   "parallel/input_pipeline.py", "parallel/mesh.py", "parallel/halo.py",
                   "parallel/ring_attention.py", "ops/cuda/halo_ring.py", "train/resident.py")

BLOCKED_RANKS = r'''
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint",
             "equidock_public_tpu"):
    sys.modules[name] = None
import torch
from equidock_public_tpu_torch.parallel.launch import run_ranks
got = run_ranks("tests.torch_dist_bodies:ring_attention", 2,
                dict(gp=2, args=tuple(torch.ones(1, 4, d) for d in (2, 2, 2)) +
                     (torch.ones(1, 4), torch.ones(1, 4))), device="cpu", timeout_s=120)
assert len(got) == 2 and torch.equal(got[0], got[1])
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "flax", "optax", "orbax", "equidock_public_tpu")]
assert not loaded, loaded
print("RANKS")
'''


@pytest.mark.parametrize("module", SLICE10_MODULES)
def test_slice10_modules_are_under_the_guard(module):
    path = os.path.join(PKG, module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{module} imports {bad}"


def test_ranks_start_from_a_module_of_the_port_without_jax():
    """The launcher starts each rank from `parallel/launch.py` with an
    explicit environment; a rank checks that neither JAX nor the JAX
    package was imported (`launch.forbidden_modules`) and fails otherwise,
    and the parent here runs with both unimportable."""
    from equidock_public_tpu_torch.parallel import launch

    code = f"REPO = {REPO!r}\n" + BLOCKED_RANKS
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RANKS" in proc.stdout
    assert "jax" in launch.FORBIDDEN and "equidock_public_tpu" in launch.FORBIDDEN
    assert "jax" in [m.split(".")[0] for m in launch.forbidden_modules()]  # this process


def test_the_entry_points_take_the_card_unless_asked_for_the_cpu():
    """Every entry point of the port defaults to the card (`device.
    resolve_device`): the CLIs' -device, `fit`, the mesh, the ranks and
    their launcher; without a card each raises instead of running on the
    CPU."""
    import importlib
    import inspect
    import re

    import torch

    from equidock_public_tpu_torch.parallel import dist, launch, mesh
    from equidock_public_tpu_torch.train import loop

    for cli in ("train", "serve", "inference", "ensemble_inference", "hyper_search"):
        mod = importlib.import_module(f"equidock_public_tpu_torch.cli.{cli}")
        # None is resolve_device's default: the card
        assert re.search(r'"-device", default=(None|"cuda")', inspect.getsource(mod)), cli
    assert inspect.signature(launch.run_ranks).parameters["device"].default == "cuda"
    for fn in (loop.fit, dist.init_from_env, mesh.ParallelMesh.__init__):
        assert inspect.signature(fn).parameters["device"].default is None, fn
    if not torch.cuda.is_available():
        for call in (lambda: mesh.ParallelMesh(1, 2), lambda: dist.init_from_env(env={})):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
