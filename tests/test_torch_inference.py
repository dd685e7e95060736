"""The port's inference surface on the CPU against the JAX package: the
clash-removal descent (`eval/inference.py::remove_clashes_descent`) live
against JAX's on seeded point clouds, `run_inference_dir` and
`run_batched_inference` on a temporary directory of tracked chains, and
batched serving (`DockingServer.serve_batched`) against the serving golden
file, at the DB5 paper model's full width.

Tolerances. The descent: the same number of steps, coordinates within 1e-3
A and the last loss within 1e-4 (f32 sums in another order; measured up
to 1.2e-5 A on these clouds). Past step 1500 the step is 1e-2, and the
descent turns sensitive: on other seeds of the same clouds a 7e-6 A
difference at step 1500 grows to 0.06 A and moves the stop by one or two
steps, so the cases below are ones whose stop lies clear of that noise.
Docked outputs: the serving gates (R 1e-3; t, CA and written coordinates
1e-2 A), PDB files holding 3 decimals."""

import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from equidock_public_tpu_torch.cli import serve
from equidock_public_tpu_torch.eval import inference
from equidock_public_tpu_torch.eval.batch_inference import run_batched_inference
from equidock_public_tpu_torch.params import default_checkpoint

from . import torch_golden
from .torch_utils import f32_default  # noqa: F401

REPO = torch_golden.REPO
CPU = torch.device("cpu")
DESCENT_TOL = {"coords_atol": 1e-3, "value_atol": 1e-4}
SERVE_ATOL = {"R": 1e-3, "t": 1e-2, "ca": 1e-2}


def _abs(p):
    return os.path.join(REPO, p)


def _clouds(seed, spread, offset, center, n=60):
    """Two seeded clouds of n points: the ligand around `center`, the
    receptor `offset` A further along x."""
    rng = np.random.default_rng(seed)
    c = np.array([center, center / 2, -center / 3])
    lig = rng.standard_normal((n, 3)) * spread + c
    rec = rng.standard_normal((n, 3)) * spread + c + np.array([offset, 0.0, 0.0])
    return lig.astype(np.float32), rec.astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The descents run thousands of small ops: one intra-op thread keeps
    them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server():
    return serve.DockingServer.from_checkpoint(default_checkpoint(), "cpu")


@pytest.fixture(scope="module")
def golden():
    with open(torch_golden.GOLDEN) as f:
        return json.load(f)["requests"]


@pytest.fixture(scope="module")
def jax_model():
    from equidock_public_tpu.train.checkpoint import load_checkpoint

    payload, cfg, _ = load_checkpoint(torch_golden.CHECKPOINT)
    return payload["params"], cfg


@pytest.mark.parametrize("seed", range(4))
def test_euler_to_rotmat_matches_jax(seed):
    import jax.numpy as jnp

    from equidock_public_tpu.eval.inference import euler_to_rotmat as jax_euler

    a = np.random.default_rng(seed).uniform(-np.pi, np.pi, 3).astype(np.float32)
    got = inference.euler_to_rotmat(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_euler(jnp.asarray(a))), atol=1e-6)
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-6)


# (name, cloud seed, spread, receptor offset, centre, max_iters, what it reaches)
DESCENT_CASES = [
    ("apart", 0, 3.0, 40.0, 0.0, 2000, "the stop at the first evaluation"),
    ("short", 9, 3.0, 2.0, 10.0, 2000, "eta 1e-3 and 1e-4, then the stop"),
    ("medium", 10, 3.0, 2.0, 10.0, 2000, "eta 1e-3 and 1e-4, then the stop"),
    ("long", 7, 3.0, 2.0, 0.0, 2000, "eta 1e-3, 1e-4 and 1e-2, then the stop"),
    ("unfinished", 8, 3.0, 2.0, 0.0, 400, "max_iters before the stop"),
]


@pytest.mark.parametrize("case", DESCENT_CASES, ids=[c[0] for c in DESCENT_CASES])
def test_descent_matches_jax(case):
    name, seed, spread, offset, center, max_iters, _ = case
    lig, rec = _clouds(seed, spread, offset, center)
    want, values = torch_golden.jax_descent(lig, rec, max_iters=max_iters)
    steps, stopped = torch_golden.descent_steps(values)
    got = inference.remove_clashes_descent(lig, rec, max_iters=max_iters, device="cpu")
    assert (got.iterations, got.stopped) == (steps, stopped)
    assert got.coords.dtype == np.float32
    np.testing.assert_allclose(got.coords, want, atol=DESCENT_TOL["coords_atol"])
    assert abs(got.value - values[-1]) <= DESCENT_TOL["value_atol"]
    # the branches each case is there for
    if name == "apart":
        assert steps == 0 and np.array_equal(got.coords, lig)
    if name in ("short", "medium", "long"):
        assert stopped and values[0] >= 2.0 and min(values) < 2.0
    if name == "long":
        assert steps > 1501
    if name == "unfinished":
        assert not stopped and steps == max_iters


def test_descent_takes_float32_inputs():
    lig, rec = _clouds(9, 3.0, 2.0, 10.0)
    a = inference.remove_clashes_descent(lig, rec, max_iters=5, device="cpu")
    b = inference.remove_clashes_descent(lig.astype(np.float64), rec.astype(np.float64),
                                         max_iters=5, device="cpu")
    assert np.array_equal(a.coords, b.coords) and a.coords.dtype == np.float32


def test_full_size_descent_starts_as_the_clash_golden():
    """The 4132 x 3591-atom request of db5_clashes.golden.json from its
    docked pose: the port's first loss is JAX's (the whole descent runs on
    the card, in chip_smoke.py)."""
    with open(torch_golden.CLASH_GOLDEN) as f:
        g = json.load(f)
    from equidock_public_tpu_torch.data.pdb import read_pdb

    lig = read_pdb(_abs(g["ligand"])).coords
    rec = read_pdb(_abs(g["receptor"])).coords
    R, t = np.asarray(g["R"], np.float32), np.asarray(g["t"], np.float32)
    d = inference.remove_clashes_descent((R @ lig.T).T + t, rec, max_iters=1, device="cpu")
    want = g["cases"]["served"]["values_head"]
    assert d.iterations == 1 and abs(d.value - want[0]) <= g["tolerance"]["value_atol"]
    served = json.load(open(torch_golden.GOLDEN))["requests"][1]
    assert (g["ligand"], g["receptor"]) == (served["ligand"], served["receptor"])
    np.testing.assert_allclose(g["R"], served["R"], atol=1e-4)
    np.testing.assert_allclose(g["t"], served["t"], atol=1e-3)


# complexes of tracked chains: (stem, ligand chain, receptor chain)
COMPLEXES = (("AAAA", "2VDB", "6B0S"), ("BBBB", "2SNI", "2AYO"), ("CCCC", "1NW9", "2VDB"))


@pytest.fixture(scope="module")
def complex_dirs(tmp_path_factory):
    """input_dir with X_l_b.pdb, ground-truth dir with X_r_b_COMPLEX.pdb and
    X_l_b_COMPLEX.pdb (the ligand chain itself), from tracked chains."""
    root = tmp_path_factory.mktemp("complexes")
    inp, gt = root / "in", root / "gt"
    inp.mkdir()
    gt.mkdir()
    for stem, lig, rec in COMPLEXES:
        shutil.copy(_abs(torch_golden.pdb_path(lig)), inp / f"{stem}_l_b.pdb")
        shutil.copy(_abs(torch_golden.pdb_path(lig)), gt / f"{stem}_l_b_COMPLEX.pdb")
        shutil.copy(_abs(torch_golden.pdb_path(rec)), gt / f"{stem}_r_b_COMPLEX.pdb")
    return str(inp), str(gt)


def _coords(path):
    from equidock_public_tpu_torch.data.pdb import read_pdb

    return read_pdb(path).coords


@pytest.mark.parametrize("remove_clashes", [False, True])
def test_run_inference_dir_matches_jax(server, jax_model, complex_dirs, tmp_path,
                                       remove_clashes):
    import jax

    from equidock_public_tpu.eval.inference import run_inference_dir as jax_run

    inp, gt = complex_dirs
    stems = [c[0] for c in COMPLEXES[:2]]
    sub = tmp_path / "in"
    sub.mkdir()
    for s in stems:
        shutil.copy(os.path.join(inp, f"{s}_l_b.pdb"), sub)
    logs = []
    got = inference.run_inference_dir(server.params, server.cfg, str(sub), gt,
                                      str(tmp_path / "port"), remove_clashes=remove_clashes,
                                      log=logs.append, device="cpu")
    with jax.default_matmul_precision("highest"):
        jax_run(*jax_model, str(sub), gt, str(tmp_path / "jax"),
                remove_clashes=remove_clashes, log=lambda *a: None)
    assert [os.path.basename(r.out_path) for r in got] == \
        [f"{s}_l_b_EQUIDOCK_TPU.pdb" for s in stems]
    assert len(logs) == 3 and logs[-1].startswith("Mean runtime")
    for r in got:
        want = _coords(str(tmp_path / "jax" / os.path.basename(r.out_path)))
        np.testing.assert_allclose(_coords(r.out_path), want, atol=SERVE_ATOL["t"])


def test_run_batched_inference_matches_jax(server, jax_model, complex_dirs, tmp_path):
    import jax

    from equidock_public_tpu.eval.batch_inference import run_batched_inference as jax_run

    inp, gt = complex_dirs
    seconds = run_batched_inference(server.params, server.cfg, inp, gt, str(tmp_path / "port"),
                                    batch_size=2, log=lambda *a: None, device="cpu")
    with jax.default_matmul_precision("highest"):
        jax_run(*jax_model, inp, gt, str(tmp_path / "jax"), batch_size=2, log=lambda *a: None)
    assert seconds > 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == len(COMPLEXES)
    for n in names:
        np.testing.assert_allclose(_coords(str(tmp_path / "port" / n)),
                                   _coords(str(tmp_path / "jax" / n)), atol=SERVE_ATOL["t"])


def _requests(golden, tmp_path, **extra):
    return [json.dumps({"ligand": _abs(g["ligand"]), "receptor": _abs(g["receptor"]),
                        "output": str(tmp_path / f"o{i}.pdb"), **extra})
            for i, g in enumerate(golden)]


def test_batched_serving_matches_the_golden_file(server, golden, tmp_path):
    seen, groups = [], []

    def forward(batch):
        out = inner(batch)
        seen.append(out)
        return out

    inner, server.forward = server.forward, forward
    try:
        lines = _requests(golden, tmp_path)
        lines.insert(2, "not json")
        buf = io.StringIO()
        assert server.serve_batched(lines, buf, max_batch=4, on_group=groups.append) == 5
    finally:
        server.forward = inner
    resp = [json.loads(x) for x in buf.getvalue().splitlines()]
    # two co-arrivals of at most 4: the bad line answers alone, in its place
    assert resp[2]["ok"] is False and "JSONDecodeError" in resp[2]["error"]
    ok = resp[:2] + resp[3:]
    assert [r["output"] for r in ok] == [json.loads(x)["output"] for x in lines if x[0] == "{"]
    assert [r["batched"] for r in ok] == [3, 3, 3, 1]
    assert set(ok[0]) == {"output", "seconds", "batch_seconds", "num_lig_res",
                          "num_rec_res", "batched", "ok"}
    # groups by bucket pair, each collated at 4 slots
    assert [(g["buckets"], g["requests"], g["dead_slots"]) for g in groups] == [
        ([512, 1024], 1, 3), ([1024, 512], 1, 3), ([512, 512], 1, 3), ([512, 512], 1, 3)]
    assert all(o["R"].shape[0] == 4 for o in seen)
    for i, g in enumerate(golden):          # one group each, in slot 0
        o, j = seen[i], 0
        np.testing.assert_allclose(o["R"][j].numpy(), g["R"], atol=SERVE_ATOL["R"])
        np.testing.assert_allclose(o["t"][j, 0].numpy(), g["t"], atol=SERVE_ATOL["t"])
        np.testing.assert_allclose(o["ligand_coords"][j, :8].numpy(), g["ca"],
                                   atol=SERVE_ATOL["ca"])
        R, t = o["R"][j].numpy(), o["t"][j, 0].numpy()
        table = _coords(_abs(g["ligand"]))
        np.testing.assert_allclose(_coords(str(tmp_path / f"o{i}.pdb")), table @ R.T + t,
                                   atol=1e-3)


def test_batched_groups_share_a_forward(server, golden, tmp_path):
    """The two 512 x 512 requests arrive together: one forward, 2 of 4 slots."""
    groups = []
    lines = _requests([golden[2], golden[3]], tmp_path)
    resp = server.handle_batch(lines, 4, on_group=groups.append)
    assert [r["batched"] for r in resp] == [2, 2] and all(r["ok"] for r in resp)
    assert len(groups) == 1 and groups[0]["requests"] == 2 and groups[0]["dead_slots"] == 2
    assert 0 < groups[0]["dead_node_share"] < 1


def test_batched_clash_removal_matches_per_request(server, tmp_path):
    req = {"ligand": _abs(torch_golden.pdb_path("2VDB")),      # a 62-step descent
           "receptor": _abs(torch_golden.pdb_path("6B0S")), "remove_clashes": True}
    one = server.handle(json.dumps(dict(req, output=str(tmp_path / "a.pdb"))))
    many = server.handle_batch([json.dumps(dict(req, output=str(tmp_path / "b.pdb"))),
                                json.dumps({"ligand": "/missing.pdb",
                                            "receptor": req["receptor"],
                                            "output": str(tmp_path / "c.pdb")})], 2)
    assert one["ok"] and many[0]["ok"] and many[0]["batched"] == 1
    assert many[1]["ok"] is False and "FileNotFoundError" in many[1]["error"]
    np.testing.assert_allclose(_coords(str(tmp_path / "b.pdb")),
                               _coords(str(tmp_path / "a.pdb")), atol=SERVE_ATOL["t"])


def test_main_batched_mode_reads_co_arrivals(monkeypatch, capsys, golden, tmp_path):
    lines = _requests([golden[2], golden[3]], tmp_path)
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines + ["", "{}"]) + "\n"))
    serve.main(["-device", "cpu", "-max_batch", "2", "-batch_window_ms", "50"])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert out[0] == {"ready": True}
    assert [r["ok"] for r in out[1:]] == [True, True, False]
    assert "KeyError" in out[3]["error"]
    assert all(os.path.exists(json.loads(x)["output"]) for x in lines)


def test_arrivals_split_at_max_batch():
    stream = io.StringIO("a\n\nb\nc\nd\ne\n")
    assert list(serve.arrivals(stream, 2, 1000.0)) == [["a", "b"], ["c", "d"], ["e"]]


def test_handle_batch_refuses_more_than_max_batch(server):
    with pytest.raises(ValueError, match="3 requests for a batch of 2"):
        server.handle_batch(["{}", "{}", "{}"], 2)


def test_warmup_at_the_batch_size(server):
    b = serve.warmup_batch(server.cfg, 64, 128, CPU, batch_size=3)
    assert b.lig.x.shape == (3, 64, 3) and b.pair_mask.tolist() == [1, 0, 0]
