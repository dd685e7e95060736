"""The port's serving path (`serve_lines`, `dock_one`) on the CPU at the DB5
paper model's full width with the committed weights; the committed weights
and golden values pinned to the orbax checkpoint and the JAX package; a
request with `remove_clashes` against the JAX package's `dock_one`.

Tolerances. Golden values regenerated by JAX on the CPU: atol 1e-4 on R and
1e-3 on t and CA coordinates (same code, different thread counts). The
port against the golden values: atol 1e-3 on R, 1e-2 A on t and CA
(f32 through 5 layers with other summation orders, then an SVD);
chip_smoke.py holds the card to the same numbers."""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from equidock_public_tpu_torch.cli import serve
from equidock_public_tpu_torch.data.featurize import filter_residues
from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb
from equidock_public_tpu_torch.eval import inference
from equidock_public_tpu_torch.params import default_checkpoint, flatten, load_checkpoint

from . import torch_golden
from .torch_utils import f32_default  # noqa: F401

REPO = torch_golden.REPO
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def golden():
    with open(torch_golden.GOLDEN) as f:
        return json.load(f)["requests"]


@pytest.fixture(scope="module")
def server():
    return serve.DockingServer.from_checkpoint(default_checkpoint(), "cpu")


def _abs(p):
    return os.path.join(REPO, p)


def _jax_dock_one(g, out_path, remove_clashes):
    """The JAX package's `dock_one` on a golden request: the written ligand
    coordinates (products at "highest" precision)."""
    import jax

    from equidock_public_tpu.eval.inference import dock_one as jax_dock_one
    from equidock_public_tpu.train.checkpoint import load_checkpoint as jax_load

    payload, cfg, _ = jax_load(torch_golden.CHECKPOINT)
    with jax.default_matmul_precision("highest"):
        jax_dock_one(payload["params"], cfg, _abs(g["ligand"]), _abs(g["receptor"]), out_path,
                     remove_clashes=remove_clashes)
    return read_pdb(out_path).coords


def test_weights_file_matches_the_orbax_checkpoint():
    tree, _ = torch_golden.orbax_params_numpy()
    want = flatten(tree)
    got = flatten(load_checkpoint(default_checkpoint())[0])
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_golden_file_matches_jax(golden):
    fresh = torch_golden.jax_outputs()
    assert [(g["ligand"], g["receptor"]) for g in golden] == \
        [(f["ligand"], f["receptor"]) for f in fresh]
    for g, f in zip(golden, fresh):
        np.testing.assert_allclose(g["R"], f["R"], atol=1e-4)
        np.testing.assert_allclose(g["t"], f["t"], atol=1e-3)
        np.testing.assert_allclose(g["ca"], f["ca"], atol=1e-3)


def test_dock_one_matches_golden(server, golden, tmp_path):
    seen = []

    def forward(batch):
        out = server.forward(batch)
        seen.append(out)
        return out

    for i, g in enumerate(golden):
        out_path = str(tmp_path / f"o{i}.pdb")
        r = inference.dock_one(server.params, server.cfg, _abs(g["ligand"]),
                               _abs(g["receptor"]), out_path, forward_fn=forward,
                               device="cpu")
        o = seen[-1]
        np.testing.assert_allclose(o["R"][0].numpy(), g["R"], atol=1e-3)
        np.testing.assert_allclose(o["t"][0, 0].numpy(), g["t"], atol=1e-2)
        np.testing.assert_allclose(o["ligand_coords"][0, :8].numpy(), g["ca"], atol=1e-2)
        # every ligand atom moved by (R, t), written with 3 decimals
        table = read_pdb(_abs(g["ligand"]))
        R, t = o["R"][0].double().numpy(), o["t"][0, 0].double().numpy()
        np.testing.assert_allclose(read_pdb(out_path).coords,
                                   table.coords @ R.T + t, atol=1e-3)
        assert r.num_lig_res == len(filter_residues(group_residues(table)))


def test_serve_lines_answers_every_line(server, golden, tmp_path):
    g = golden[2]
    reqs = [json.dumps({"ligand": _abs(g["ligand"]), "receptor": _abs(g["receptor"]),
                        "output": str(tmp_path / "a" / "out.pdb")}),
            "",
            json.dumps({"ligand": "/missing.pdb", "receptor": _abs(g["receptor"]),
                        "output": str(tmp_path / "x.pdb")}),
            "not json",
            json.dumps({"ligand": _abs(g["ligand"]), "receptor": _abs(g["receptor"]),
                        "output": str(tmp_path / "y.pdb"), "remove_clashes": True})]
    buf = io.StringIO()
    assert server.serve_lines(reqs, buf) == 4
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert lines[0]["ok"] is True and os.path.exists(lines[0]["output"])
    assert lines[0]["num_lig_res"] == 55 and lines[0]["num_rec_res"] == 327
    assert "FileNotFoundError" in lines[1]["error"] and lines[1]["ok"] is False
    assert "JSONDecodeError" in lines[2]["error"]
    # clash removal is served, and its output is the JAX package's
    assert lines[3]["ok"] is True and lines[3]["output"] == str(tmp_path / "y.pdb")
    want = _jax_dock_one(g, str(tmp_path / "jax.pdb"), remove_clashes=True)
    np.testing.assert_allclose(read_pdb(lines[3]["output"]).coords, want, atol=1e-2)


def test_main_per_request_mode(monkeypatch, capsys, golden, tmp_path):
    g = golden[3]
    req = json.dumps({"ligand": _abs(g["ligand"]), "receptor": _abs(g["receptor"]),
                      "output": str(tmp_path / "o.pdb")})
    monkeypatch.setattr(sys, "stdin", io.StringIO(req + "\n"))
    serve.main(["-device", "cpu", "-warmup_buckets", "512"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"warmed": 1, "seconds": lines[0]["seconds"]}
    assert lines[1] == {"ready": True}
    assert lines[2]["ok"] is True and os.path.exists(lines[2]["output"])


def test_warmup_batches_have_the_bucket_shapes(server):
    b = serve.warmup_batch(server.cfg, 512, 1024, CPU)
    assert b.lig.x.shape == (1, 512, 3) and b.rec.nbr.shape == (1, 1024, 10)
    assert b.lig.node_mask.sum() == 512


def test_entry_points_raise_without_a_card(monkeypatch, golden, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = golden[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.DockingServer.from_checkpoint(default_checkpoint())
    params, cfg = load_checkpoint(default_checkpoint())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.dock_one(params, cfg, _abs(g["ligand"]), _abs(g["receptor"]),
                           str(tmp_path / "o.pdb"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["-checkpoint", default_checkpoint()])
