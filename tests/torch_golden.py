"""The JAX package's CPU outputs that the port is held to:
`equidock_public_tpu_torch/assets/db5_model_best.golden.json` (the served
smoke requests), `db5_train_step.golden.json` (three training steps of
the DB5 paper model from its trained weights on a batch of ten split
chains), `db5_train_step_packed.golden.json` (the same three steps on the
same complexes packed four a slot), `db5_fit.golden.json` (two epochs of `fit` on the tracked
split chains, with the fused intersection loss) and `db5_clashes.golden.json`
(a served request docked and then through the clash-removal descent, at
full atom count). Shared by the tests and the command that writes the files:

    JAX_PLATFORMS=cpu python -m tests.torch_golden           # all of them
    JAX_PLATFORMS=cpu python -m tests.torch_golden fit       # the fit file only
    JAX_PLATFORMS=cpu python -m tests.torch_golden clashes   # the clash file only
    JAX_PLATFORMS=cpu python -m tests.torch_golden packed    # the packed steps only
    JAX_PLATFORMS=cpu python -m tests.torch_golden models    # the six other models
    JAX_PLATFORMS=cpu python -m tests.torch_golden resident  # the resident fit file
    JAX_PLATFORMS=cpu python -m tests.torch_golden bf16      # the bf16 serving file
    JAX_PLATFORMS=cpu python -m tests.torch_golden slice9    # the host builders' file

`models` converts the six other tracked checkpoints (`MODELS`) into the
port's weight files with golden values of their served requests;
`resident` writes `db5_resident_fit.golden.json`, the fit golden's run with
device-resident epochs and trimmed remainders, with the augmentation draws
the JAX package made, which the port replays; `bf16` writes
`db5_model_best_bf16.golden.json`, the served requests through the JAX
package's fused path (the Pallas edge and attention kernels in interpret
mode, which the port's kernel path matches) at `dtype='bfloat16'`, and
the same path at float32 beside it; `slice9` writes `slice9.golden.json`,
what the JAX package's host builders and tools make of a raw DB5 tree of
tracked chains cut in two (`SLICE9_RECIPE`, kept in the file): the split
caches' digests, the frozen test set, its DIPS shards, an aligned ligand,
the crop corpus, the padding report, surface rhos and hyper-search draws.
"""

import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "equidock_public_tpu_torch", "assets")
GOLDEN = os.path.join(ASSETS, "db5_model_best.golden.json")
CHECKPOINT = os.path.join(REPO, "artifacts", "db5_model_best")
PDB_DIR = "artifacts/db5_test_outputs"
# (ligand, receptor) stems: buckets (512, 1024), (1024, 512), (512, 512) x 2
PAIRS = (("1AVX", "1N2C"), ("1N2C", "5JMO"), ("2VDB", "1H1V"), ("5HGG", "7CEI"))
N_CA = 8


def pdb_path(stem: str) -> str:
    return f"{PDB_DIR}/{stem}_l_b_EQUIDOCK_TPU.pdb"


def jax_outputs(pairs=PAIRS):
    """R, t and the first N_CA moved CA coordinates per pair, from the JAX
    package's own featurization and forward on the CPU."""
    import jax

    from equidock_public_tpu.data.featurize import (alpha_carbon_array,
                                                    build_protein_graph,
                                                    filter_residues)
    from equidock_public_tpu.data.pdb import group_residues, read_pdb
    from equidock_public_tpu.graph import collate
    from equidock_public_tpu.models.iegmn import docking_forward
    from equidock_public_tpu.train.checkpoint import load_checkpoint

    payload, cfg, _ = load_checkpoint(CHECKPOINT)
    fwd = jax.jit(lambda p, b: docking_forward(p, cfg.model, b))
    out = []
    for lig, rec in pairs:
        lres = filter_residues(group_residues(read_pdb(os.path.join(REPO, pdb_path(lig)))))
        rres = filter_residues(group_residues(read_pdb(os.path.join(REPO, pdb_path(rec)))))
        gc = cfg.graph
        lg = build_protein_graph(lres, gc.graph_cutoff, gc.graph_max_neighbor)
        rg = build_protein_graph(rres, gc.graph_cutoff, gc.graph_max_neighbor)
        z = np.zeros((4, 3), np.float32)
        b = collate([lg], [rg], [lg.x], [alpha_carbon_array(lres)], [z], [z],
                    cfg.data.node_buckets, cfg.data.pocket_buckets)
        o = fwd(payload["params"], b)
        out.append({"ligand": pdb_path(lig), "receptor": pdb_path(rec),
                    "R": np.asarray(o["R"][0]).tolist(),
                    "t": np.asarray(o["t"][0, 0]).tolist(),
                    "ca": np.asarray(o["ligand_coords"][0, :N_CA]).tolist()})
    return out


TRAIN_GOLDEN = os.path.join(ASSETS, "db5_train_step.golden.json")
TRAIN_SEED = 0          # numpy seed of the batch (shuffle, swap, random pose)
TRAIN_STEPS = 3
TRAIN_CHAINS = 10
MAX_POCKET = 1024       # the largest pocket bucket of the DB5 config
# The port against these values (f32 on both sides, other summation orders;
# the Sinkhorn fixed point and the SVD amplify rounding over the steps). A
# leaf's ||params - params0|| may also differ by an element that Adam moved
# the other way (its gradient within rounding of 0): at most 2 lr a step,
# 2 sqrt(3) lr < 3.5 lr over three steps.
TRAIN_TOL = {"loss_rtol_step1": 1e-4, "loss_rtol_later": 1e-3, "loss_atol": 1e-4,
             "grad_norm_rtol": 1e-3, "leaf_grad_norm_rtol": 1e-3,
             "delta_norm_rtol": 1e-3, "delta_norm_atol_lr": 3.5}
METRIC_KEYS = ("loss", "ligand_coors_loss", "receptor_coors_loss", "ot_loss",
               "intersection_loss", "grad_norm", "clipped")


def chains_by_size():
    """(code, residue count) of the tracked DB5 chains, largest first."""
    from equidock_public_tpu_torch.data.featurize import filter_residues
    from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb

    out = []
    for name in sorted(os.listdir(os.path.join(REPO, PDB_DIR))):
        code = name[:4]
        out.append((code, len(filter_residues(group_residues(read_pdb(
            os.path.join(REPO, pdb_path(code))))))))
    return sorted(out, key=lambda cn: (-cn[1], cn[0]))


def jax_split_chain(code, gc):
    """The JAX package's bound complex from one tracked chain cut at residue
    n // 2 (ligand: the first half), or None as `_process_one` drops it; the
    port's `data/dataset.py::split_chain_complex` with JAX's featurizer."""
    from equidock_public_tpu.data.dataset import ComplexSample
    from equidock_public_tpu.data.featurize import (alpha_carbon_array,
                                                    build_protein_graph,
                                                    extract_pocket, filter_residues)
    from equidock_public_tpu.data.pdb import group_residues, read_pdb

    res = filter_residues(group_residues(read_pdb(os.path.join(REPO, pdb_path(code)))))
    lig_res, rec_res = res[:len(res) // 2], res[len(res) // 2:]
    lig_ca, rec_ca = alpha_carbon_array(lig_res), alpha_carbon_array(rec_res)
    pocket = extract_pocket(lig_ca, rec_ca, gc.pocket_cutoff)
    if pocket is None or pocket[0].shape[0] > MAX_POCKET:
        return None
    return ComplexSample(
        lig=build_protein_graph(lig_res, gc.graph_cutoff, gc.graph_max_neighbor),
        rec=build_protein_graph(rec_res, gc.graph_cutoff, gc.graph_max_neighbor),
        gt_lig=lig_ca, gt_rec=rec_ca, pocket=pocket[0])


def jax_train_batch(cfg):
    """(codes, JAX PairBatch): the TRAIN_CHAINS largest chains that give a
    pocket of at most MAX_POCKET pairs, through the JAX package's
    DockingDataset (train split: swap on) under TRAIN_SEED."""
    import tempfile

    from equidock_public_tpu.data.dataset import DockingDataset, _graph_to_npz

    codes, samples = [], []
    for code, _ in chains_by_size():
        s = jax_split_chain(code, cfg.graph)
        if s is not None:
            codes.append(code)
            samples.append(s)
        if len(codes) == TRAIN_CHAINS:
            break
    out = {"codes": np.array(codes)}
    for i, s in enumerate(samples):
        _graph_to_npz(f"c{i}/lig/", s.lig, out)
        _graph_to_npz(f"c{i}/rec/", s.rec, out)
        out[f"c{i}/gt_lig"], out[f"c{i}/gt_rec"] = s.gt_lig, s.gt_rec
        out[f"c{i}/pocket"] = s.pocket
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "train.npz")
        np.savez(path, **out)
        ds = DockingDataset(cfg, "train", cache_path=path)
        batch = next(ds.batches(np.random.default_rng(TRAIN_SEED),
                                batch_size=cfg.train.bs))
    return codes, batch


def jax_train_golden():
    """The JAX package's three training steps (XLA path) from the trained
    weights: per step the metrics, the per-leaf gradient norms of step 1 and
    the per-leaf norms of params - params0 after the last step."""
    import dataclasses

    import jax

    from equidock_public_tpu.train.checkpoint import load_checkpoint
    from equidock_public_tpu.train.step import create_train_state, loss_fn, train_step
    from equidock_public_tpu_torch.graph import batch_digest
    from equidock_public_tpu_torch.params import flatten

    from .torch_utils import port_batch

    payload, cfg, _ = load_checkpoint(CHECKPOINT)
    tree0 = jax.tree.map(np.asarray, payload["params"])   # train_step donates its state
    codes, batch = jax_train_batch(cfg)
    grads = jax.grad(lambda p: loss_fn(p, cfg, batch, None, True)[0])(tree0)
    state = create_train_state(jax.tree.map(jax.numpy.array, tree0), cfg)
    steps = []
    for i in range(TRAIN_STEPS):
        state, m = train_step(state, batch, jax.random.PRNGKey(i), cfg, 1.0)
        steps.append({k: float(m[k]) for k in METRIC_KEYS})
    norm = lambda a: float(np.linalg.norm(np.asarray(a, np.float64)))
    p0 = flatten(tree0)
    p3 = flatten(jax.tree.map(np.asarray, state.params))
    return {
        "source": "equidock_public_tpu on the CPU (XLA path), artifacts/db5_model_best",
        "codes": codes, "split": "each chain cut at residue n // 2; ligand = first half",
        "seed": TRAIN_SEED, "lr_scale": 1.0,
        "train": dataclasses.asdict(cfg.train),
        "batch_digest": batch_digest(port_batch(batch)),
        "tolerance": TRAIN_TOL,
        "steps": steps,
        "grad_norms_step1": {k: norm(v) for k, v in
                             flatten(jax.tree.map(np.asarray, grads)).items()},
        "delta_norms_last": {k: norm(p3[k] - p0[k]) for k in p0},
    }


PACKED_GOLDEN = os.path.join(ASSETS, "db5_train_step_packed.golden.json")
PACK_MAX = 4            # complexes a slot


def jax_packed_train_golden():
    """The JAX package's three training steps of `jax_train_golden` on the
    same complexes packed (`pack`, PACK_MAX a slot): per step the metrics,
    the per-leaf norms of params - params0 after the last step."""
    import dataclasses

    import jax

    from equidock_public_tpu.train.checkpoint import load_checkpoint
    from equidock_public_tpu.train.step import create_train_state, train_step
    from equidock_public_tpu_torch.graph import batch_digest
    from equidock_public_tpu_torch.params import flatten

    from .torch_utils import port_batch

    payload, cfg, _ = load_checkpoint(CHECKPOINT)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, pack=True,
                                                            pack_max_per_slot=PACK_MAX))
    tree0 = jax.tree.map(np.asarray, payload["params"])
    codes, batch = jax_train_batch(cfg)
    assert batch.n_segs == PACK_MAX
    state = create_train_state(jax.tree.map(jax.numpy.array, tree0), cfg)
    steps = []
    for i in range(TRAIN_STEPS):
        state, m = train_step(state, batch, jax.random.PRNGKey(i), cfg, 1.0)
        steps.append({k: float(m[k]) for k in METRIC_KEYS})
    norm = lambda a: float(np.linalg.norm(np.asarray(a, np.float64)))
    p0 = flatten(tree0)
    p3 = flatten(jax.tree.map(np.asarray, state.params))
    return {
        "source": "equidock_public_tpu on the CPU (XLA path), artifacts/db5_model_best, "
                  "packed batches",
        "codes": codes, "split": "each chain cut at residue n // 2; ligand = first half",
        "seed": TRAIN_SEED, "lr_scale": 1.0, "pack_max_per_slot": PACK_MAX,
        "slots": int(batch.pair_mask.shape[0]),
        "node_buckets": [int(batch.lig.x.shape[1]), int(batch.rec.x.shape[1])],
        "train": dataclasses.asdict(cfg.train),
        "batch_digest": batch_digest(port_batch(batch)),
        "tolerance": TRAIN_TOL,
        "steps": steps,
        "delta_norms_last": {k: norm(p3[k] - p0[k]) for k in p0},
    }


FIT_GOLDEN = os.path.join(ASSETS, "db5_fit.golden.json")
FIT_SEED = 0            # cfg.train.random_seed: batches, poses, metering
FIT_EPOCHS = 2
# The port on the card against these values: loss terms per epoch (relative),
# RMSD medians (A). Four Adam steps of f32 in other orders.
FIT_TOL = {"loss_rtol": 1e-3, "median_atol": 1e-2}
FIT_LOSS_KEYS = ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss")
FIT_MEDIAN_KEYS = ("complex_rmsd_median", "interface_rmsd_median")


def fit_partition():
    """{split: codes} of the tracked chains: by residue count, largest first,
    rank i goes to val when i % 5 == 2, to test when i % 5 == 4, else to
    train (15 / 5 / 5)."""
    parts = {"train": [], "val": [], "test": []}
    for i, (code, _) in enumerate(chains_by_size()):
        parts["val" if i % 5 == 2 else "test" if i % 5 == 4 else "train"].append(code)
    return parts


def fit_config(cfg, root):
    """The DB5 paper model's config for the fit golden: fused intersection,
    FIT_SEED, bs 10, val_repeats 1; caches, checkpoints and logs under root.
    Works on either package's Config (same field names)."""
    import dataclasses

    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, use_fused_intersection=True,
                                       random_seed=FIT_SEED, bs=10, val_repeats=1),
        data=dataclasses.replace(cfg.data, cache_dir=os.path.join(root, "cache")),
        checkpoint_dir=os.path.join(root, "ckpt"), log_dir=os.path.join(root, "logs"))


def jax_fit_golden():
    """The JAX package's `fit` for FIT_EPOCHS epochs from the trained weights
    on caches of the split chains written by its own featurizer: per epoch
    the train and val averages, the best epoch, and the test averages of the
    best checkpoint reloaded. Products at "highest" precision (the Pallas
    soft-min kernel's cross term in f32)."""
    import dataclasses
    import tempfile

    import jax

    from equidock_public_tpu.data.dataset import _graph_to_npz
    from equidock_public_tpu.train import loop
    from equidock_public_tpu.train.checkpoint import load_checkpoint
    from equidock_public_tpu.train.step import create_train_state

    payload, cfg, _ = load_checkpoint(CHECKPOINT)
    parts = fit_partition()
    rec = {"train": [], "eval": [], "best": []}
    with tempfile.TemporaryDirectory() as root:
        cfg = fit_config(cfg, root)
        for split, codes in parts.items():
            out = {"codes": np.array(codes)}
            for i, code in enumerate(codes):
                smp = jax_split_chain(code, cfg.graph)
                _graph_to_npz(f"c{i}/lig/", smp.lig, out)
                _graph_to_npz(f"c{i}/rec/", smp.rec, out)
                out[f"c{i}/gt_lig"], out[f"c{i}/gt_rec"] = smp.gt_lig, smp.gt_rec
                out[f"c{i}/pocket"] = smp.pocket
            os.makedirs(cfg.cache_path(), exist_ok=True)
            np.savez(os.path.join(cfg.cache_path(), f"{split}.npz"), **out)
        run_train, run_eval, save = loop.run_train_epoch, loop.run_eval_epoch, loop.save_checkpoint

        def train_epoch(*a, **kw):
            state, tr = run_train(*a, **kw)
            rec["train"].append(tr)
            return state, tr

        def eval_epoch(*a, **kw):
            rec["eval"].append(run_eval(*a, **kw))
            return rec["eval"][-1]

        def save_best(path, state, cfg_, epoch):
            rec["best"].append(epoch)
            save(path, state, cfg_, epoch)

        loop.run_train_epoch, loop.run_eval_epoch, loop.save_checkpoint = \
            train_epoch, eval_epoch, save_best
        cwd = os.getcwd()
        os.chdir(root)                     # the JAX loop writes ./tb_logs
        try:
            with jax.default_matmul_precision("highest"):
                loop.fit(cfg, create_train_state(payload["params"], cfg),
                         max_epochs=FIT_EPOCHS, log=lambda *a: None)
        finally:
            os.chdir(cwd)
            loop.run_train_epoch, loop.run_eval_epoch, loop.save_checkpoint = \
                run_train, run_eval, save
    keep = lambda d, keys: {k: float(d[k]) for k in keys}
    return {
        "source": "equidock_public_tpu on the CPU (fit, Pallas soft-min kernel in "
                  "interpret mode), artifacts/db5_model_best",
        "partition": parts,
        "split": "each chain cut at residue n // 2; ligand = first half; chains ranked "
                 "by residue count, largest first: rank % 5 == 2 val, == 4 test, else train",
        "epochs": FIT_EPOCHS, "train_config": dataclasses.asdict(cfg.train),
        "tolerance": FIT_TOL,
        "history": [{"train": dict(keep(tr, FIT_LOSS_KEYS + ("complex_rmsd_median",)),
                                   num_batches=int(tr["num_batches"]),
                                   num_clips=int(tr["num_clips"])),
                     "val": keep(va, FIT_LOSS_KEYS + FIT_MEDIAN_KEYS)}
                    for tr, va in zip(rec["train"], rec["eval"])],
        "best_epoch": rec["best"][-1],
        "test": keep(rec["eval"][-1], FIT_LOSS_KEYS + FIT_MEDIAN_KEYS),
    }


CLASH_GOLDEN = os.path.join(ASSETS, "db5_clashes.golden.json")
CLASH_PAIR = PAIRS[1]           # 1N2C -> 5JMO: 4132 x 3591 atoms
CLASH_ATOMS = 64                # moved ligand atoms recorded, evenly spaced
# The descent rotates the ligand about the origin, so its speed depends on
# where the complex lies: from the served pose it stops after 57 steps.
# The "shifted" case moves both proteins by -CLASH_SHIFT_FRACTION x the
# receptor's atom centroid first (the same complex, the rotation's centre
# half way to the receptor), and runs 519 steps.
CLASH_SHIFT_FRACTION = 0.5
# The port against these values: the same number of steps, the loss at the
# stop within 2e-3, the recorded atoms within 2e-2 A. f32 sums in another
# order move each step's rotation about the origin (the atoms lie some 80 A
# from it); the port's CPU path read 4.4e-4 and 4.7e-3 A on the served case.
CLASH_TOL = {"value_atol": 2e-3, "coords_atol": 2e-2}


class DescentRecorder:
    """Stands in for the `jax` module inside `equidock_public_tpu.eval.inference`
    while it runs: every call of a jitted (value, grad) function records the
    value, so the JAX descent's own loop reports its steps."""

    def __init__(self):
        import jax

        self._jax = jax
        self.values = []

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def jit(self, f):
        g = self._jax.jit(f)

        def recorded(*a):
            out = g(*a)
            if isinstance(out, tuple):
                self.values.append(float(out[0]))
            return out
        return recorded


def jax_descent(lig_atoms, rec_atoms, **kw):
    """(moved atoms, loss values read, one per evaluation) of the JAX
    package's `remove_clashes_descent`, products at "highest" precision."""
    import jax

    from equidock_public_tpu.eval import inference

    rec = DescentRecorder()
    saved, inference.jax = inference.jax, rec
    try:
        with jax.default_matmul_precision("highest"):
            moved = inference.remove_clashes_descent(lig_atoms, rec_atoms, **kw)
    finally:
        inference.jax = saved
    return np.asarray(moved), rec.values


def descent_steps(values):
    """(gradient steps taken, stopped) from the values one descent read."""
    stopped = bool(values) and values[-1] <= 0.5
    return (len(values) - 1 if stopped else len(values)), stopped


def clash_atoms(n_atoms):
    return np.linspace(0, n_atoms - 1, CLASH_ATOMS).astype(int)


def jax_clashes_golden():
    """The JAX package's forward of CLASH_PAIR (as `jax_outputs`), the moved
    ligand of `dock_one`, then its descent against every receptor atom from
    that pose ("served") and from the shifted pose ("shifted")."""
    from equidock_public_tpu.data.pdb import read_pdb

    lig_path, rec_path = (pdb_path(c) for c in CLASH_PAIR)
    (req,) = jax_outputs((CLASH_PAIR,))
    R, t = np.asarray(req["R"], np.float32), np.asarray(req["t"], np.float32)
    lig = read_pdb(os.path.join(REPO, lig_path)).coords
    rec = read_pdb(os.path.join(REPO, rec_path)).coords.astype(np.float32)
    moved = ((R @ lig.T).T + t).astype(np.float32)        # as dock_one moves it
    shift = (CLASH_SHIFT_FRACTION * rec.mean(axis=0)).astype(np.float32)
    idx = clash_atoms(lig.shape[0])
    out = {"source": "equidock_public_tpu on the CPU (remove_clashes_descent, products "
                     "at highest precision), artifacts/db5_model_best",
           "ligand": lig_path, "receptor": rec_path, "R": R.tolist(), "t": t.tolist(),
           "start": "R @ ligand atoms + t in float32 (numpy), as dock_one moves them",
           "atoms": idx.tolist(), "tolerance": CLASH_TOL,
           "shift_fraction": CLASH_SHIFT_FRACTION, "shift": shift.tolist(), "cases": {}}
    for name, lig0, rec0 in (("served", moved, rec),
                             ("shifted", moved - shift, rec - shift)):
        coords, values = jax_descent(lig0, rec0)
        steps, stopped = descent_steps(values)
        out["cases"][name] = {"steps": steps, "stopped": stopped, "value": values[-1],
                              "values_head": values[:3], "values_tail": values[-3:],
                              "coords": coords[idx].tolist()}
    return out


def orbax_params_numpy(checkpoint=CHECKPOINT):
    """A tracked orbax checkpoint's params pytree (nested dicts of numpy
    arrays) and its JAX config: `artifacts/db5_model_best` unless another
    checkpoint directory is named."""
    import jax

    from equidock_public_tpu.train.checkpoint import load_checkpoint

    payload, cfg, _ = load_checkpoint(checkpoint)
    return jax.tree.map(np.asarray, payload["params"]), cfg


# The other tracked models (artifacts/<name>), each converted to
# assets/<name>.pt.xz + .config.json with a golden file <name>.golden.json of
# the serving requests whose buckets its config has.
MODELS = ("db5_model_curriculum", "dips_model_pretrained", "db5_model_small",
          "db5_model_small_s2", "db5_model_small_l3", "db5_model_finetuned")


def model_golden_path(name):
    return os.path.join(ASSETS, f"{name}.golden.json")


def residue_count(stem):
    from equidock_public_tpu_torch.data.featurize import filter_residues
    from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb

    return len(filter_residues(group_residues(read_pdb(os.path.join(REPO, pdb_path(stem))))))


def pairs_that_fit(node_buckets, pairs=PAIRS):
    """(kept, dropped) of the serving pairs: a pair is kept when both sides
    fit the config's largest node bucket."""
    kept, dropped = [], []
    for lig, rec in pairs:
        fits = max(residue_count(lig), residue_count(rec)) <= max(node_buckets)
        (kept if fits else dropped).append((lig, rec))
    return kept, dropped


BF16_GOLDEN = os.path.join(ASSETS, "db5_model_best_bf16.golden.json")
FUSED = dict(use_fused_attention=True, fused_edge_message=True)


def jax_outputs_fused(dtype, pairs=PAIRS):
    """R, t, the first N_CA moved CA coordinates and the keypoints per pair
    of the DB5 paper model through the JAX package's fused path (Pallas in
    interpret mode on the CPU) at compute dtype `dtype`, on the port's
    featurization of the pair (bit-equal to the JAX package's,
    tests/test_torch_featurize.py)."""
    import dataclasses

    from equidock_public_tpu.models.iegmn import docking_forward
    from equidock_public_tpu.train.checkpoint import load_checkpoint
    from equidock_public_tpu_torch.config import Config as PortConfig
    from equidock_public_tpu_torch.eval.inference import featurize_request

    from .torch_utils import jax_batch

    import jax

    payload, cfg, _ = load_checkpoint(CHECKPOINT)
    mcfg = dataclasses.replace(cfg.model, dtype=dtype, **FUSED)
    fwd = jax.jit(lambda p, b: docking_forward(p, mcfg, b))
    pcfg = PortConfig(data=dataclasses.replace(PortConfig().data,
                                               node_buckets=tuple(cfg.data.node_buckets)))
    out = []
    for lig, rec in pairs:
        req = featurize_request(pcfg, os.path.join(REPO, pdb_path(lig)),
                                os.path.join(REPO, pdb_path(rec)), "cpu")
        o = fwd(payload["params"], jax_batch(req.batch))
        out.append({"ligand": pdb_path(lig), "receptor": pdb_path(rec),
                    "R": np.asarray(o["R"][0]).tolist(),
                    "t": np.asarray(o["t"][0, 0]).tolist(),
                    "ca": np.asarray(o["ligand_coords"][0, :N_CA]).tolist(),
                    "keypts_lig": np.asarray(o["keypts_lig"][0]).tolist(),
                    "keypts_rec": np.asarray(o["keypts_rec"][0]).tolist()})
    return out


def jax_bf16_golden():
    return {"source": "equidock_public_tpu on the CPU, artifacts/db5_model_best, "
                      "use_fused_attention and fused_edge_message (Pallas in interpret mode)",
            "dtype": "bfloat16", "requests": jax_outputs_fused("bfloat16"),
            "float32": jax_outputs_fused("float32")}


def jax_dock_outputs(checkpoint, pairs):
    """R, t, the first N_CA moved CA coordinates and the keypoints per pair
    from the JAX
    package's `dock_one` on the CPU (its own featurization and forward; the
    forward's outputs recorded as `dock_one` computes them)."""
    import tempfile

    import jax

    from equidock_public_tpu.eval.inference import dock_one
    from equidock_public_tpu.models.iegmn import docking_forward
    from equidock_public_tpu.train.checkpoint import load_checkpoint

    payload, cfg, _ = load_checkpoint(checkpoint)
    fwd = jax.jit(lambda p, b: docking_forward(p, cfg.model, b))
    seen = []

    def recording(p, b):
        seen.append(fwd(p, b))
        return seen[-1]

    out = []
    with tempfile.TemporaryDirectory() as d:
        for lig, rec in pairs:
            dock_one(payload["params"], cfg, os.path.join(REPO, pdb_path(lig)),
                     os.path.join(REPO, pdb_path(rec)), os.path.join(d, "out.pdb"),
                     forward_fn=recording)
            o = seen[-1]
            out.append({"ligand": pdb_path(lig), "receptor": pdb_path(rec),
                        "R": np.asarray(o["R"][0]).tolist(),
                        "t": np.asarray(o["t"][0, 0]).tolist(),
                        "ca": np.asarray(o["ligand_coords"][0, :N_CA]).tolist(),
                        "keypts_lig": np.asarray(o["keypts_lig"][0]).tolist(),
                        "keypts_rec": np.asarray(o["keypts_rec"][0]).tolist()})
    return out


def write_model(name):
    """assets/<name>.pt.xz, its whole-config sidecar and <name>.golden.json
    from the tracked checkpoint artifacts/<name>."""
    import dataclasses

    from equidock_public_tpu_torch.config import load_config
    from equidock_public_tpu_torch.params import params_from_numpy, save_params

    checkpoint = os.path.join(REPO, "artifacts", name)
    cfg = load_config(checkpoint + ".config.json")
    with open(os.path.join(ASSETS, f"{name}.config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    tree, _ = orbax_params_numpy(checkpoint)
    save_params(os.path.join(ASSETS, f"{name}.pt.xz"), params_from_numpy(tree, cfg.model))
    kept, dropped = pairs_that_fit(cfg.data.node_buckets)
    with open(model_golden_path(name), "w") as f:
        json.dump({"source": f"equidock_public_tpu on the CPU (dock_one), artifacts/{name}",
                   "node_buckets": list(cfg.data.node_buckets),
                   "dropped": [list(p) for p in dropped],
                   "requests": jax_dock_outputs(checkpoint, kept)}, f, indent=1)


RESIDENT_FIT_GOLDEN = os.path.join(ASSETS, "db5_resident_fit.golden.json")


class ResidentRecorder:
    """Records, while the JAX package's resident `fit` runs, each pass's
    averages (train epochs, val and test evaluations, in call order) and the
    augmentation draws its scans make: the keys that reach
    `train_epoch_scan` / `eval_epoch_scan` are expanded outside the scan
    with the scan's own splits (`draws_of_*`), step by step in order."""

    def __init__(self):
        from equidock_public_tpu.train import resident

        self.resident = resident
        self.passes = []          # [{"kind", "averages", "scans": [...]}]

    def __enter__(self):
        r = self.resident
        self.saved = (r.train_epoch_scan, r.eval_epoch_scan, r.run_train_epoch_resident,
                      r.run_eval_epoch_resident)
        scan_t, scan_e, run_t, run_e = self.saved

        def train_scan(state, store, idx, valid, key, scale, cfg, do_swap, emit_coords=True):
            self.passes[-1]["scans"].append(("train", np.asarray(key), idx.shape, do_swap))
            return scan_t(state, store, idx, valid, key, scale, cfg, do_swap,
                          emit_coords=emit_coords)

        def eval_scan(params, store, idx, valid, keys, bn_state, cfg):
            self.passes[-1]["scans"].append(("eval", np.asarray(keys), idx.shape, False))
            return scan_e(params, store, idx, valid, keys, bn_state, cfg)

        def run(kind, fn):
            def wrapped(*a, **kw):
                self.passes.append({"kind": kind, "scans": []})
                out = fn(*a, **kw)
                self.passes[-1]["averages"] = out[1] if kind == "train" else out
                return out
            return wrapped

        r.train_epoch_scan, r.eval_epoch_scan = train_scan, eval_scan
        r.run_train_epoch_resident = run("train", run_t)
        r.run_eval_epoch_resident = run("eval", run_e)
        return self

    def __exit__(self, *exc):
        r = self.resident
        (r.train_epoch_scan, r.eval_epoch_scan, r.run_train_epoch_resident,
         r.run_eval_epoch_resident) = self.saved

    def draws(self, translation_interval):
        """Per pass, the (swap, rot, tr) of every step in order."""
        import jax

        out = []
        for p in self.passes:
            steps = []
            for kind, key, shape, do_swap in p["scans"]:
                if kind == "train":
                    k = key
                    for _ in range(shape[0]):
                        k, k_aug, _ = jax.random.split(k, 3)
                        steps.append(self.resident.draw_augmentations(
                            k_aug, shape[1], do_swap, translation_interval))
                else:
                    for row in range(shape[0]):
                        steps.append(self.resident.draw_augmentations(
                            key[row], shape[1], False, translation_interval))
            out.append([tuple(np.asarray(x) for x in d) for d in steps])
        return out


def jax_resident_fit_golden():
    """The JAX package's `fit` with `device_resident` and `trim_remainder`,
    FIT_EPOCHS epochs from the trained weights on the fit golden's
    partition (its own featurizer's caches): per epoch the train and val
    averages, the best epoch, the test averages, and the draws of every
    pass. Products at "highest" precision."""
    import dataclasses
    import tempfile

    import jax

    from equidock_public_tpu.data.dataset import _graph_to_npz
    from equidock_public_tpu.train import loop
    from equidock_public_tpu.train.checkpoint import load_checkpoint
    from equidock_public_tpu.train.step import create_train_state

    payload, cfg, _ = load_checkpoint(CHECKPOINT)
    parts = fit_partition()
    best = []
    with tempfile.TemporaryDirectory() as root:
        cfg = resident_fit_config(fit_config(cfg, root))
        for split, codes in parts.items():
            out = {"codes": np.array(codes)}
            for i, code in enumerate(codes):
                smp = jax_split_chain(code, cfg.graph)
                _graph_to_npz(f"c{i}/lig/", smp.lig, out)
                _graph_to_npz(f"c{i}/rec/", smp.rec, out)
                out[f"c{i}/gt_lig"], out[f"c{i}/gt_rec"] = smp.gt_lig, smp.gt_rec
                out[f"c{i}/pocket"] = smp.pocket
            os.makedirs(cfg.cache_path(), exist_ok=True)
            np.savez(os.path.join(cfg.cache_path(), f"{split}.npz"), **out)
        save = loop.save_checkpoint

        def save_best(path, state, cfg_, epoch):
            best.append(epoch)
            save(path, state, cfg_, epoch)

        loop.save_checkpoint = save_best
        cwd = os.getcwd()
        os.chdir(root)                     # the JAX loop writes ./tb_logs
        try:
            with ResidentRecorder() as rec, jax.default_matmul_precision("highest"):
                loop.fit(cfg, create_train_state(payload["params"], cfg),
                         max_epochs=FIT_EPOCHS, log=lambda *a: None)
        finally:
            os.chdir(cwd)
            loop.save_checkpoint = save
    draws = rec.draws(cfg.graph.translation_interval)
    keep = lambda d, keys: {k: float(d[k]) for k in keys}
    trains = [p["averages"] for p in rec.passes if p["kind"] == "train"]
    evals = [p["averages"] for p in rec.passes if p["kind"] == "eval"]
    return {
        "source": "equidock_public_tpu on the CPU (fit with device_resident and "
                  "trim_remainder, Pallas soft-min kernel in interpret mode), "
                  "artifacts/db5_model_best",
        "partition": parts,
        "split": "as db5_fit.golden.json",
        "epochs": FIT_EPOCHS, "train_config": dataclasses.asdict(cfg.train),
        "tolerance": FIT_TOL,
        "history": [{"train": dict(keep(tr, FIT_LOSS_KEYS + ("complex_rmsd_median",)),
                                   num_batches=int(tr["num_batches"]),
                                   num_clips=int(tr["num_clips"])),
                     "val": keep(va, FIT_LOSS_KEYS + FIT_MEDIAN_KEYS)}
                    for tr, va in zip(trains, evals)],
        "best_epoch": best[-1],
        "test": keep(evals[-1], FIT_LOSS_KEYS + FIT_MEDIAN_KEYS),
        "passes": [p["kind"] for p in rec.passes],
        "draws": [[{"swap": d[0].astype(int).tolist(), "rot": d[1].tolist(),
                    "tr": d[2].tolist()} for d in steps] for steps in draws],
    }


def resident_fit_config(cfg):
    """The fit golden's config with device-resident epochs and trimmed
    remainders (either package's Config)."""
    import dataclasses

    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, device_resident=True),
        train=dataclasses.replace(cfg.train, trim_remainder=True))


def replay_sources(golden, device="cpu"):
    """(purpose, epoch) -> a ReplayDraws of the golden file's draws for the
    port's `fit(draws=...)`: the passes run train, val per epoch, then test."""
    from equidock_public_tpu_torch.train.resident import ReplayDraws

    triples = [[(d["swap"], d["rot"], d["tr"]) for d in steps] for steps in golden["draws"]]
    order = {}
    for e in range(golden["epochs"]):
        order[("train", e)], order[("val", e)] = 2 * e, 2 * e + 1
    order[("test", 0)] = 2 * golden["epochs"]
    return lambda purpose, epoch: ReplayDraws(triples[order[(purpose, epoch)]], device)


SLICE9_GOLDEN = os.path.join(ASSETS, "slice9.golden.json")
# The raw tree of the slice-9 checks: 16 tracked chains cut in two (the
# 16 smallest but 2SIC), the first 10 the train split, then 3 val, 3 test.
SLICE9_RECIPE = {
    "chain_file": PDB_DIR + "/{}_l_b_EQUIDOCK_TPU.pdb",
    "codes": ["2VDB", "2SNI", "6B0S", "1NW9", "1HCF", "2AYO", "1QA9", "1JIW", "5C7X",
              "4POU", "1ZHI", "7CEI", "1MLC", "1VFB", "3SZK", "1IRA"],
    "splits": [["train", 10], ["val", 3], ["test", 3]],
    "layout": {"reference_root": "ref", "cache_dir": "cache", "frozen_cache_dir": "frozen",
               "testset": "testset/random_transformed", "dips_sizes_dir": "testset"},
    "testset_seed": 0,
    "crops": {"n_pairs": 32, "n_val_pairs": 8, "max_side": 256, "crop_seed": 0},
    "surface_chains": ["2VDB", "2SNI"],
    "hyper": {"random_seed": 8, "num_trials": 2},
}
HYPER_FIELDS = (("model", "dropout"), ("model", "iegmn_n_lays"), ("model", "shared_layers"),
                ("model", "skip_weight_h"), ("model", "x_connection_init"),
                ("train", "w_decay"), ("train", "intersection_loss_weight"),
                ("train", "pocket_ot_loss_weight"))


def array_digest(a: np.ndarray) -> dict:
    """shape, dtype and sha256 of an array's bytes; for floats also the
    float64 sum and sum of absolute values."""
    import hashlib

    d = {"shape": list(a.shape), "dtype": str(a.dtype),
         "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}
    if a.dtype.kind == "f":
        d["sum"] = float(a.astype(np.float64).sum())
        d["abs_sum"] = float(np.abs(a.astype(np.float64)).sum())
    return d


def npz_digest(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {"codes": [str(c) for c in z["codes"]],
                "arrays": {k: array_digest(z[k]) for k in sorted(z.files)}}


def pdb_record(path: str) -> dict:
    """sha256 of a written PDB and its coordinates as the text gives them."""
    import hashlib

    from equidock_public_tpu_torch.data.pdb import read_pdb

    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return {"sha256": digest,
            "coords": [round(float(v), 3) for v in read_pdb(path).coords.ravel()]}


def slice9_tree(root: str, recipe=SLICE9_RECIPE) -> dict:
    """Write the recipe's raw tree under `root`; the layout's absolute paths."""
    from equidock_public_tpu_torch.data.synth import write_db5_raw_tree

    paths = {k: os.path.join(root, v) for k, v in recipe["layout"].items()}
    chains = {c: os.path.join(REPO, recipe["chain_file"].format(c)) for c in recipe["codes"]}
    paths["raw"], paths["cv"] = write_db5_raw_tree(paths["reference_root"], chains,
                                                   [tuple(s) for s in recipe["splits"]])
    return paths


def jax_slice9_golden(root: str, recipe=SLICE9_RECIPE) -> dict:
    """The JAX package's host builders and tools on the recipe's tree, on
    the CPU, one process each (n_jobs 1)."""
    import contextlib
    import io
    import random
    import sys

    from equidock_public_tpu.cli import align_receptor, padding_report
    from equidock_public_tpu.cli._common import add_config_args, config_from_args
    from equidock_public_tpu.cli.hyper_search import sample_config
    from equidock_public_tpu.cli.surface_analysis import analyze
    from equidock_public_tpu.cli.testset_gen import main_db5
    from equidock_public_tpu.config import Config, DataConfig
    from equidock_public_tpu.data.crops import generate_crop_shards
    from equidock_public_tpu.data.dataset import build_cache
    from equidock_public_tpu.data.dips import build_dips_frozen_cache
    from equidock_public_tpu.data.synth import dips_testset_sizes

    paths = slice9_tree(root, recipe)
    quiet = lambda *a: None
    raw, cv = paths["raw"], paths["cv"]
    cfg = Config(data=DataConfig(raw_data_path=raw, split_files_path=cv, n_jobs=1,
                                 cache_dir=paths["cache_dir"]))
    out = {"source": "equidock_public_tpu on the CPU (tests/torch_golden.py slice9)",
           "recipe": recipe, "db5_cache": {}}
    for split, _ in recipe["splits"]:
        d = npz_digest(build_cache(cfg, split, log=quiet))
        with open(os.path.join(cv, split + ".txt")) as f:
            listed = [line.strip() for line in f if line.strip()]
        d["dropped"] = sorted(set(listed) - set(d["codes"]))
        out["db5_cache"][split] = d
    test_dir = paths["testset"]
    main_db5(raw, os.path.join(cv, "test.txt"), test_dir,
             np.random.default_rng(recipe["testset_seed"]))
    out["testset"] = {f: pdb_record(os.path.join(test_dir, f))
                      for f in sorted(os.listdir(test_dir))}
    frozen = Config(data=DataConfig(data="dips", n_jobs=1, cache_dir=paths["frozen_cache_dir"]))
    out["dips_frozen"] = {os.path.basename(p): npz_digest(p)
                          for p in build_dips_frozen_cache(frozen, test_dir, log=quiet)}
    code = sorted({f.split("_")[0] for f in os.listdir(test_dir)})[0]
    aligned = os.path.join(root, "aligned.pdb")
    argv = ["align_receptor", "-ligand", os.path.join(test_dir, f"{code}_l_b.pdb"),
            "-receptor", os.path.join(test_dir, f"{code}_r_b.pdb"),
            "-receptor_gt", os.path.join(test_dir, f"{code}_r_b_COMPLEX.pdb"), "-out", aligned]
    saved = sys.argv
    try:
        sys.argv = argv
        with contextlib.redirect_stdout(io.StringIO()):
            align_receptor.main()
        sys.argv = ["padding_report", "-cache_dir", paths["cache_dir"], "-dips_dir",
                    paths["dips_sizes_dir"]]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            padding_report.main()
    finally:
        sys.argv = saved
    out["align_receptor"] = {"code": code, **pdb_record(aligned)}
    out["padding_report"] = json.loads(buf.getvalue())
    c = recipe["crops"]
    sizes = dips_testset_sizes(paths["dips_sizes_dir"])
    dips = Config(data=DataConfig(data="dips", cache_dir=paths["cache_dir"]))
    split_codes = {s: out["db5_cache"][s]["codes"] + out["db5_cache"][s]["dropped"]
                   for s in ("train", "val")}
    out["crop_sizes"] = [list(s) for s in sizes]
    out["crops"] = {}
    for split, parents, n, seed in (
            ("train", "train", c["n_pairs"], c["crop_seed"]),
            ("val", "val", c["n_val_pairs"], c["crop_seed"] + 1),
            ("test", "val", max(64, c["n_val_pairs"] // 4), c["crop_seed"] + 2)):
        for p in generate_crop_shards(dips, split, sorted(split_codes[parents]), raw, n, seed,
                                      sizes, c["max_side"], n_jobs=1, log=quiet):
            out["crops"][os.path.basename(p)] = npz_digest(p)
    out["surface_rhos"] = {
        f"{chain}/{depth}": analyze(os.path.join(REPO, recipe["chain_file"].format(chain)),
                                    depth_method=depth)
        for chain in recipe["surface_chains"] for depth in ("sas", "hull")}
    import argparse

    p = argparse.ArgumentParser()
    add_config_args(p)
    base = config_from_args(p.parse_args([]))
    rng = random.Random(recipe["hyper"]["random_seed"])
    draws = [sample_config(base, rng) for _ in range(recipe["hyper"]["num_trials"])]
    out["hyper_search"] = [dict({f"{sec}.{k}": getattr(getattr(d, sec), k)
                                 for sec, k in HYPER_FIELDS}, banner=d.banner())
                           for d in draws]
    return out


if __name__ == "__main__":
    import dataclasses
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    from equidock_public_tpu_torch.config import load_config
    from equidock_public_tpu_torch.params import params_from_numpy, save_params

    os.makedirs(ASSETS, exist_ok=True)
    if sys.argv[1:] == ["fit"]:
        with open(FIT_GOLDEN, "w") as f:
            json.dump(jax_fit_golden(), f, indent=1)
        sys.exit(0)
    if sys.argv[1:] == ["packed"]:
        with open(PACKED_GOLDEN, "w") as f:
            json.dump(jax_packed_train_golden(), f, indent=1)
        sys.exit(0)
    if sys.argv[1:] == ["clashes"]:
        with open(CLASH_GOLDEN, "w") as f:
            json.dump(jax_clashes_golden(), f, indent=1)
        sys.exit(0)
    if sys.argv[1:] == ["models"]:
        for name in MODELS:
            write_model(name)
        sys.exit(0)
    if sys.argv[1:] == ["resident"]:
        with open(RESIDENT_FIT_GOLDEN, "w") as f:
            json.dump(jax_resident_fit_golden(), f, indent=1)
        sys.exit(0)
    if sys.argv[1:] == ["bf16"]:
        with open(BF16_GOLDEN, "w") as f:
            json.dump(jax_bf16_golden(), f, indent=1)
        sys.exit(0)
    if sys.argv[1:] == ["slice9"]:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp, open(SLICE9_GOLDEN, "w") as f:
            json.dump(jax_slice9_golden(tmp), f)
        sys.exit(0)
    sidecar = os.path.join(ASSETS, "db5_model_best.config.json")
    with open(sidecar, "w") as f:     # the whole config, as the port reads it
        cfg = load_config(CHECKPOINT + ".config.json")
        json.dump(dataclasses.asdict(cfg), f)
    tree, _ = orbax_params_numpy()
    save_params(os.path.join(ASSETS, "db5_model_best.pt.xz"),
                params_from_numpy(tree, cfg.model))
    requests = jax_outputs()
    with open(GOLDEN, "w") as f:
        json.dump({"source": "equidock_public_tpu on the CPU, artifacts/db5_model_best",
                   "requests": requests}, f, indent=1)
    train_golden = jax_train_golden()
    with open(TRAIN_GOLDEN, "w") as f:
        json.dump(train_golden, f, indent=1)
    with open(PACKED_GOLDEN, "w") as f:
        json.dump(jax_packed_train_golden(), f, indent=1)
    with open(FIT_GOLDEN, "w") as f:
        json.dump(jax_fit_golden(), f, indent=1)
    with open(CLASH_GOLDEN, "w") as f:
        json.dump(jax_clashes_golden(), f, indent=1)
    for name in MODELS:
        write_model(name)
    with open(RESIDENT_FIT_GOLDEN, "w") as f:
        json.dump(jax_resident_fit_golden(), f, indent=1)
    with open(BF16_GOLDEN, "w") as f:
        json.dump(jax_bf16_golden(), f, indent=1)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp, open(SLICE9_GOLDEN, "w") as f:
        json.dump(jax_slice9_golden(tmp), f)
