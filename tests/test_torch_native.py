"""The port's C++ graph builder (`equidock_public_tpu_torch/native/`) on the
CPU: on every tracked DB5 chain its distance matrix and kNN tables are
bit-equal to the port's numpy versions and to the JAX package's builder,
and `build_protein_graph` equals the JAX package's field for field. The
library is built by one g++ call into `_build/`; a missing compiler or a
failed build raises with the reason, and processes that race to build it
all load one whole library."""

import os
import subprocess
import sys

import numpy as np
import pytest

from equidock_public_tpu.data import featurize as jf
from equidock_public_tpu_torch import native
from equidock_public_tpu_torch.data import featurize as tf
from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb
from equidock_public_tpu_torch.ops.cuda import _build

from . import torch_golden

REPO = torch_golden.REPO
CHAINS = sorted(f[:4] for f in os.listdir(os.path.join(REPO, torch_golden.PDB_DIR)))


def _residues(code):
    return tf.filter_residues(group_residues(read_pdb(
        os.path.join(REPO, torch_golden.pdb_path(code)))))


def _jax_distances(atoms):
    """The JAX package's matrix: its native library where it loads, else
    its numpy fallback (what its `build_protein_graph` uses either way)."""
    from equidock_public_tpu import native as jn

    got = jn.residue_mean_dist(atoms)
    return got if got is not None else jf.residue_mean_distance_matrix(atoms).astype(np.float32)


def test_there_are_25_tracked_chains():
    assert len(CHAINS) == 25


@pytest.mark.parametrize("code", CHAINS)
def test_distances_and_knn_tables_are_bit_equal(code):
    atoms = tf.local_frames(_residues(code))[-1]
    dist = native.residue_mean_dist(atoms)
    assert dist.dtype == np.float32 and np.isinf(np.diag(dist)).all()
    np.testing.assert_array_equal(dist, tf.residue_mean_distance_matrix(atoms))
    np.testing.assert_array_equal(dist, _jax_distances(atoms))
    for got, want in zip(native.knn_edges(dist, 30.0, 10), tf.knn_tables(dist, 30.0, 10)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("code", ["2VDB", "1AVX", "1N2C"])
def test_graph_equals_the_jax_package(code):
    res = _residues(code)
    got = tf.build_protein_graph(res, 30.0, 10)
    want = jf.build_protein_graph(res, 30.0, 10)
    for field in ("res_id", "x", "mu_r_norm", "nbr", "nbr_mask", "edge_feat"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def test_knn_tables_take_all_within_the_cutoff_or_the_nearest():
    rng = np.random.default_rng(3)
    d = rng.uniform(1, 50, (40, 40)).astype(np.float32)
    d = (d + d.T) / 2
    np.fill_diagonal(d, np.inf)
    d[5, :] = 100.0                      # a node with no neighbour in reach
    d[5, 5] = np.inf
    for got, want in zip(native.knn_edges(d, 20.0, 6), tf.knn_tables(d, 20.0, 6)):
        np.testing.assert_array_equal(got, want)
    nbr, mask, _ = native.knn_edges(d, 20.0, 6)
    assert not mask[5].any() and (nbr[5] == 5).all()


def test_the_library_lands_in_the_build_dir_under_its_hash():
    r = native.build()
    assert os.path.dirname(r.path) == os.path.join(_build.BUILD_DIR,
                                                   "native-" + native.source_hash())
    assert os.path.basename(r.path) == native.LIB_NAME and os.path.exists(r.path)
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert not any(f.startswith("-march") for f in native.CXX_FLAGS)


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="no residues"):
        native.residue_mean_dist([])
    with pytest.raises(ValueError, match="at least one"):
        native.residue_mean_dist([np.zeros((0, 3), np.float32)])
    with pytest.raises(ValueError, match="square"):
        native.knn_edges(np.zeros((3, 4), np.float32), 30.0, 10)


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.find_cxx()


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "graph_builder.cc"
    bad.write_text('extern "C" void residue_mean_dist( { }\n')
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build()
    assert "error" in str(e.value)
    assert not any(f.endswith(".so") for _, _, fs in os.walk(tmp_path / "build") for f in fs)


RACE = r'''
import sys
from equidock_public_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
import numpy as np
native.load_library.cache_clear()
d = native.residue_mean_dist([np.zeros((2, 3), np.float32), np.ones((3, 3), np.float32)])
print("OK", float(d[0, 1]))
'''


def test_processes_racing_to_build_each_load_a_whole_library(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", RACE, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["OK", str(float(np.float32(np.sqrt(3.0))))]
    libs = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert libs == [native.LIB_NAME]
