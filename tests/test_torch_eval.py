"""The port's evaluator and ensembles on the CPU against the JAX package:
`eval/rmsd.py::evaluate_output_dir` under its three method conventions,
`eval/ensemble.py` (`chordal_mean_rotation`, `ensemble_rigid`,
`run_ensemble_dir` with a port weight-file `Member` per JAX checkpoint),
and the CLIs `inference`, `ensemble_inference` and `eval_outputs`, on
temporary directories built from tracked chains.

Tolerances. The evaluator and the rigid means are the same numpy on both
sides: 1e-9 relative. Docked outputs: the serving gate (1e-2 A), PDB files
holding 3 decimals."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

from equidock_public_tpu_torch.cli import ensemble_inference, eval_outputs
from equidock_public_tpu_torch.cli import inference as inference_cli
from equidock_public_tpu_torch.config import load_config
from equidock_public_tpu_torch.data.pdb import read_pdb, write_pdb
from equidock_public_tpu_torch.data.synth import write_chain_halves
from equidock_public_tpu_torch.eval import ensemble
from equidock_public_tpu_torch.eval.rmsd import evaluate_output_dir
from equidock_public_tpu_torch.params import default_checkpoint, params_from_numpy, save_params

from . import torch_golden
from .torch_utils import f32_default  # noqa: F401

REPO = torch_golden.REPO
SMALL = os.path.join(REPO, "artifacts", "db5_model_small")
# (stem, the tracked chain cut in two)
COMPLEXES = (("AAAA", "2VDB"), ("BBBB", "2SNI"), ("CCCC", "1NW9"))


def _abs(p):
    return os.path.join(REPO, p)


def _rotation(rng, angle=None):
    """A uniform random rotation, or one by `angle` radians about a random axis."""
    from scipy.spatial.transform import Rotation

    if angle is None:
        return Rotation.random(random_state=rng).as_matrix().astype(np.float32)
    axis = rng.standard_normal(3)
    return Rotation.from_rotvec(angle * axis / np.linalg.norm(axis)).as_matrix().astype(
        np.float32)


def _split_chain(code, out_l, out_r):
    """Write the first half of a tracked chain's residues (file order) as
    the ligand and the rest as the receptor: a complex with an interface."""
    write_chain_halves(_abs(torch_golden.pdb_path(code)), out_l, out_r)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """gt/X_{l,r}_b_COMPLEX.pdb: tracked chains cut in two; in/X_l_b.pdb the
    ligand half; pred/ seeded predictions of every method convention: the
    ground truth moved by a small random rigid motion plus noise
    (X_l_b_EQUIDOCK.pdb, _ATTRACT, _HDOCK; for attract and hdock a moved
    receptor too)."""
    root = tmp_path_factory.mktemp("eval")
    for d in ("in", "gt", "pred"):
        (root / d).mkdir()
    rng = np.random.default_rng(5)
    for stem, code in COMPLEXES:
        gt_l = root / "gt" / f"{stem}_l_b_COMPLEX.pdb"
        gt_r = root / "gt" / f"{stem}_r_b_COMPLEX.pdb"
        _split_chain(code, gt_l, gt_r)
        shutil.copy(gt_l, root / "in" / f"{stem}_l_b.pdb")
        for method in ("EQUIDOCK", "ATTRACT", "HDOCK"):
            for side, src in (("l", gt_l), ("r", gt_r)):
                if side == "r" and method == "EQUIDOCK":
                    continue
                table = read_pdb(str(src))
                c = table.coords.mean(axis=0)
                moved = ((table.coords - c) @ _rotation(rng, 0.2).T + c
                         + rng.normal(0, 2.0, 3) + rng.normal(0, 0.5, table.coords.shape))
                write_pdb(str(root / "pred" / f"{stem}_{side}_b_{method}.pdb"), table,
                          moved.astype(np.float32))
    return {k: str(root / k) for k in ("in", "gt", "pred")}


@pytest.mark.parametrize("method", ["equidock", "attract", "hdock"])
def test_evaluate_output_dir_matches_jax(dirs, method):
    from equidock_public_tpu.eval.rmsd import evaluate_output_dir as jax_eval

    got = evaluate_output_dir(dirs["pred"], dirs["gt"], method)
    want = jax_eval(dirs["pred"], dirs["gt"], method)
    assert got.keys() == want.keys() and got["num_files"] == len(COMPLEXES)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    assert got["crmsd_median"] > 0 and got["irmsd_median"] > 0


def test_evaluate_output_dir_refuses_what_it_cannot_score(dirs, tmp_path):
    with pytest.raises(FileNotFoundError, match="-method"):
        evaluate_output_dir(dirs["pred"], dirs["gt"], "nothing")
    shutil.copy(os.path.join(dirs["gt"], "BBBB_l_b_COMPLEX.pdb"),
                tmp_path / "AAAA_l_b_EQUIDOCK.pdb")           # another ligand's atoms
    with pytest.raises(ValueError, match="AAAA"):
        evaluate_output_dir(str(tmp_path), dirs["gt"])


@pytest.mark.parametrize("seed,weighted", [(0, False), (1, False), (2, True), (3, True)])
def test_rigid_means_match_jax(seed, weighted):
    from equidock_public_tpu.eval import ensemble as jax_ens

    rng = np.random.default_rng(seed)
    n = 2 + seed
    Rs = [_rotation(rng) for _ in range(n)]
    ts = [rng.normal(0, 10, (1, 3)).astype(np.float32) for _ in range(n)]
    center = rng.normal(0, 20, 3).astype(np.float32)
    w = rng.uniform(0.2, 1.0, n).tolist() if weighted else None
    R = ensemble.chordal_mean_rotation(Rs, w)
    np.testing.assert_allclose(R, jax_ens.chordal_mean_rotation(Rs, w), rtol=1e-9, atol=1e-7)
    assert R.dtype == np.float32 and abs(np.linalg.det(R) - 1) < 1e-5
    got = ensemble.ensemble_rigid(Rs, ts, center, w)
    for g, v in zip(got, jax_ens.ensemble_rigid(Rs, ts, center, w)):
        assert g.dtype == v.dtype and g.shape == v.shape
        np.testing.assert_allclose(g, v, rtol=1e-9, atol=1e-6)


def test_an_ensemble_of_one_motion_is_that_motion():
    rng = np.random.default_rng(4)
    R, t = _rotation(rng), rng.normal(0, 5, (1, 3)).astype(np.float32)
    Rm, tm = ensemble.ensemble_rigid([R, R], [t, t], rng.normal(0, 9, 3))
    np.testing.assert_allclose(Rm, R, atol=1e-6)
    np.testing.assert_allclose(tm, t, atol=1e-4)


@pytest.fixture(scope="module")
def small_weights(tmp_path_factory):
    """artifacts/db5_model_small (orbax) as a port weight file + sidecar."""
    from equidock_public_tpu.train.checkpoint import load_checkpoint as jax_load

    import jax

    payload, _, _ = jax_load(SMALL)
    root = tmp_path_factory.mktemp("weights")
    shutil.copy(SMALL + ".config.json", root / "db5_model_small.config.json")
    cfg = load_config(str(root / "db5_model_small.config.json"))
    path = str(root / "db5_model_small.pt.xz")
    save_params(path, params_from_numpy(jax.tree.map(np.asarray, payload["params"]), cfg.model))
    return path


def test_run_ensemble_dir_matches_jax(dirs, small_weights, tmp_path):
    import jax

    from equidock_public_tpu.config import Config as JaxConfig
    from equidock_public_tpu.eval import ensemble as jax_ens
    from equidock_public_tpu_torch.config import Config

    weights = [0.7, 0.3]
    members = [ensemble.Member(p, Config(), "cpu") for p in (default_checkpoint(), small_weights)]
    assert members[1].cfg.model.iegmn_lay_hid_dim == 16
    logs = []
    ensemble.run_ensemble_dir(members, dirs["in"], dirs["gt"], str(tmp_path / "port"),
                              weights=weights, log=logs.append)
    with jax.default_matmul_precision("highest"):
        jm = [jax_ens.Member(p, JaxConfig()) for p in (torch_golden.CHECKPOINT, SMALL)]
        jax_ens.run_ensemble_dir(jm, dirs["in"], dirs["gt"], str(tmp_path / "jax"),
                                 weights=weights, log=lambda *a: None)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == len(COMPLEXES)
    assert names[0] == "AAAA_l_b_EQUIDOCK_TPU_ENS.pdb" and len(logs) == len(COMPLEXES) + 1
    for n in names:
        np.testing.assert_allclose(read_pdb(str(tmp_path / "port" / n)).coords,
                                   read_pdb(str(tmp_path / "jax" / n)).coords, atol=1e-2)


def test_a_member_with_other_graph_settings_is_refused():
    from equidock_public_tpu_torch.config import Config, GraphConfig

    with pytest.raises(ValueError, match="graph_max_neighbor=10"):
        ensemble.Member(default_checkpoint(), Config(graph=GraphConfig(graph_max_neighbor=8)),
                        "cpu")


def test_the_clis_dock_and_score_a_directory(dirs, small_weights, tmp_path, capsys):
    common = ["-input_dir", dirs["in"], "-ground_truth_dir", dirs["gt"], "-device", "cpu"]
    inference_cli.main(common + ["-checkpoint", small_weights,
                                 "-output_dir", str(tmp_path / "one")])
    inference_cli.main(common + ["-checkpoint", small_weights, "-batched", "-batch_size", "2",
                                 "-output_dir", str(tmp_path / "batched")])
    ensemble_inference.main(common + ["-checkpoints", f"{small_weights},{small_weights}",
                                      "-output_dir", str(tmp_path / "ens")])
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == [f"{c[0]}_l_b_EQUIDOCK_TPU.pdb" for c in COMPLEXES]
    for n in names:       # one member twice is that member; batches change nothing
        want = read_pdb(str(tmp_path / "one" / n)).coords
        np.testing.assert_allclose(read_pdb(str(tmp_path / "batched" / n)).coords, want,
                                   atol=2e-3)
        np.testing.assert_allclose(
            read_pdb(str(tmp_path / "ens" / n.replace("TPU", "TPU_ENS"))).coords, want,
            atol=2e-3)
    capsys.readouterr()
    eval_outputs.main(["-input_dir", str(tmp_path / "one"), "-ground_truth_dir", dirs["gt"],
                       "-method", "equidock_tpu"])
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    want = evaluate_output_dir(str(tmp_path / "one"), dirs["gt"], "equidock_tpu")
    assert line == {k: round(float(v), 4) for k, v in want.items()}


@pytest.mark.parametrize("argv,error,match", [
    (["-batched", "-remove_clashes"], ValueError, "-batched"),
    (["-node_buckets", "auto:4"], None, "auto node buckets"),
    (["-pocket_buckets", "auto"], None, None),
    (["-pack"], NotImplementedError, "-pack"),
    (["-dp", "2"], None, None)],
    ids=["argv0-ValueError--batched", "argv1-NotImplementedError-auto",
         "argv2-NotImplementedError-auto", "argv3-NotImplementedError--pack",
         "argv4-NotImplementedError--dp"])
def test_the_inference_cli_refuses_what_the_port_does_not_run(dirs, small_weights, tmp_path,
                                                               capsys, argv, error, match):
    """Batched clash removal and packing raise. Auto buckets are ported:
    `-node_buckets auto:4` docks the directory on the ladder of its sizes
    and prints it (tests/test_torch_auto_buckets.py holds it to the JAX
    CLI's); `-pocket_buckets auto` is parsed and, as in the JAX CLI,
    changes nothing at inference; so are the mesh flags (`-dp`), which the
    JAX CLI reads into its config and docks on one device with."""
    if error is None:
        inference_cli.main(["-input_dir", dirs["in"], "-ground_truth_dir", dirs["gt"],
                            "-output_dir", str(tmp_path), "-device", "cpu",
                            "-checkpoint", small_weights] + argv)
        out = capsys.readouterr().out
        assert ("auto node buckets" in out) == (match is not None)
        assert sorted(os.listdir(tmp_path)) == [f"{c[0]}_l_b_EQUIDOCK_TPU.pdb"
                                                for c in COMPLEXES]
        return
    with pytest.raises(error, match=match):
        inference_cli.main(["-input_dir", dirs["in"], "-ground_truth_dir", dirs["gt"],
                            "-output_dir", str(tmp_path), "-device", "cpu"] + argv)


def test_the_ensemble_cli_checks_its_weights(dirs, tmp_path):
    with pytest.raises(ValueError, match="3 weights for 1 members"):
        ensemble_inference.main(["-checkpoints", default_checkpoint(), "-weights", "1,1,1",
                                 "-input_dir", dirs["in"], "-ground_truth_dir", dirs["gt"],
                                 "-output_dir", str(tmp_path), "-device", "cpu"])


def test_member_keeps_the_ensemble_config_and_its_own_model(small_weights):
    from equidock_public_tpu_torch.config import Config, DataConfig

    base = Config(data=DataConfig(node_buckets=(256, 512)))
    m = ensemble.Member(small_weights, base, "cpu")
    assert m.cfg == dataclasses.replace(base, model=m.cfg.model)
    assert m.cfg.model.num_att_heads == 8
