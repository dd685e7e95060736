"""The six other tracked models (`artifacts/<name>`) as the port's weight
files (`equidock_public_tpu_torch/assets/<name>.pt.xz` + `.config.json`):

* the weights are the orbax checkpoint's, bit for bit, and the sidecar is
  the tracked config read by the port;
* every config passes `models/iegmn.py::check_supported` unchanged (the
  16-wide models: 8 heads, 2-3 layers, unshared but `_l3`; the 64-wide
  pair: 50 heads, shared layers; all LN, LeakyReLU, no BN, f32);
* `params.model_checkpoint` finds each by name;
* the port's server on the CPU answers the golden requests of
  `<name>.golden.json` (the JAX package's `dock_one` on the CPU): the
  keypoints within 1e-3 A and R within 1e-3, the serving gates of
  `db5_model_best`; t and CA within its 1e-2 A plus the measured R
  error's spectral norm times their lever arm (`served_atol`: t = m_rec -
  R m_lig, so an R off by dR moves t by up to ||dR||_2 |m_lig|, for
  ligands 100-240 A from the origin). The keypoints are the network's
  output; R and t are the Kabsch fit of them, whose conditioning varies:
  on db5_model_small's 1N2C -> 5JMO request (nearly collinear keypoints,
  both packages' fits in their jitter branch) keypoints 4.6e-5 A apart
  give R 3.2e-4 and t 0.028 A apart on the CPU, each package's R the
  float64 fit of its own keypoints to 1.5e-5;
* for one 16-wide model the golden file matches a fresh JAX run (R 1e-4,
  t and CA 1e-3 A, as `test_torch_serve.py` holds `db5_model_best`'s)."""

import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from equidock_public_tpu_torch.cli.serve import DockingServer
from equidock_public_tpu_torch.config import load_config
from equidock_public_tpu_torch.models.iegmn import check_supported
from equidock_public_tpu_torch.params import (TRACKED_MODELS, default_checkpoint, flatten,
                                              load_checkpoint, model_checkpoint)

from . import torch_golden as tg
from .torch_utils import f32_default  # noqa: F401

GOLDEN_ATOL = {"R": 1e-3, "t": 1e-2, "ca": 1e-2}


@pytest.fixture(autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _golden(name):
    with open(tg.model_golden_path(name)) as f:
        return json.load(f)


def test_every_tracked_model_is_shipped():
    assert TRACKED_MODELS == ("db5_model_best",) + tg.MODELS
    assert model_checkpoint("db5_model_best") == default_checkpoint()
    with pytest.raises(KeyError):
        model_checkpoint("no_such_model")
    total = sum(os.path.getsize(model_checkpoint(n)) for n in TRACKED_MODELS)
    assert total < 8e6          # the chip copy stays small


@pytest.mark.parametrize("name", tg.MODELS)
def test_weights_match_the_orbax_checkpoint(name):
    tree, _ = tg.orbax_params_numpy(os.path.join(tg.REPO, "artifacts", name))
    want = flatten(tree)
    got = flatten(load_checkpoint(model_checkpoint(name))[0])
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("name", tg.MODELS)
def test_sidecar_is_the_tracked_config_and_supported(name):
    _, cfg = load_checkpoint(model_checkpoint(name))
    assert cfg == load_config(os.path.join(tg.REPO, "artifacts", name + ".config.json"))
    check_supported(cfg.model)
    m = cfg.model
    assert (m.layer_norm, m.nonlin, m.dtype) == ("LN", "lkyrelu", "float32")
    wide = m.iegmn_lay_hid_dim == 64
    assert m.num_att_heads == (50 if wide else 8)
    assert m.shared_layers == (wide or name.endswith("_l3"))


@pytest.mark.parametrize("name", tg.MODELS)
def test_golden_requests_fit_the_buckets(name):
    g = _golden(name)
    _, cfg = load_checkpoint(model_checkpoint(name))
    kept, dropped = tg.pairs_that_fit(cfg.data.node_buckets)
    assert g["dropped"] == [list(p) for p in dropped]
    assert [(r["ligand"], r["receptor"]) for r in g["requests"]] == \
        [(tg.pdb_path(a), tg.pdb_path(b)) for a, b in kept]
    assert g["node_buckets"] == list(cfg.data.node_buckets)


def serve_golden(server, requests, out_dir):
    """(responses, forward outputs) of the golden requests through
    `serve_lines`."""
    outputs, inner = [], server.forward

    def recording(batch):
        out = inner(batch)
        outputs.append({"R": out["R"][0].cpu().numpy(), "t": out["t"][0, 0].cpu().numpy(),
                        "ca": out["ligand_coords"][0, :tg.N_CA].cpu().numpy(),
                        "keypts_lig": out["keypts_lig"][0].cpu().numpy(),
                        "keypts_rec": out["keypts_rec"][0].cpu().numpy()})
        return out

    server.forward = recording
    lines = [json.dumps({"ligand": os.path.join(tg.REPO, g["ligand"]),
                         "receptor": os.path.join(tg.REPO, g["receptor"]),
                         "output": os.path.join(out_dir, f"req{i}.pdb")})
             for i, g in enumerate(requests)]
    buf = io.StringIO()
    assert server.serve_lines(lines, buf) == len(requests)
    return [json.loads(x) for x in buf.getvalue().splitlines()], outputs


def served_atol(g, R) -> dict:
    """One golden request's tolerances, given the port's rotation R: the
    keypoints 1e-3 A, R 1e-3, t and CA 1e-2 A plus the measured rotation
    error's spectral norm times their lever arm. With t = m_rec - R m_lig
    and CA - m_rec = R (x - m_lig), |dR m_lig| and |dR (x - m_lig)| are at
    most ||dR||_2 |m_lig| and ||dR||_2 |CA - m_rec|; the keypoints' own
    error (the centroids' shift) stays inside the 1e-2 A."""
    d_r = np.linalg.norm(np.asarray(R, np.float64) - np.asarray(g["R"], np.float64), 2)
    lever_t = np.linalg.norm(np.mean(g["keypts_lig"], axis=0))
    lever_ca = np.linalg.norm(np.asarray(g["ca"]) - np.mean(g["keypts_rec"], axis=0),
                              axis=-1).max()
    return dict(GOLDEN_ATOL, keypts=1e-3, t=GOLDEN_ATOL["t"] + d_r * lever_t,
                ca=GOLDEN_ATOL["ca"] + d_r * lever_ca)


@pytest.mark.parametrize("name", tg.MODELS)
def test_serving_matches_the_golden_file(name, tmp_path):
    requests = _golden(name)["requests"]
    server = DockingServer.from_checkpoint(model_checkpoint(name), "cpu")
    responses, outputs = serve_golden(server, requests, str(tmp_path))
    assert all(r["ok"] for r in responses)
    assert len(outputs) == len(requests)
    for o, g in zip(outputs, requests):
        for k, atol in served_atol(g, o["R"]).items():
            if k == "keypts":
                for side in ("keypts_lig", "keypts_rec"):
                    np.testing.assert_allclose(o[side], g[side], atol=atol,
                                               err_msg=f"{g['ligand']} {side}")
            else:
                np.testing.assert_allclose(o[k], g[k], atol=atol, err_msg=f"{g['ligand']} {k}")


def test_a_golden_file_matches_jax():
    name = "db5_model_small"
    g = _golden(name)
    kept = [(r["ligand"][len(tg.PDB_DIR) + 1:][:4], r["receptor"][len(tg.PDB_DIR) + 1:][:4])
            for r in g["requests"]][:2]
    fresh = tg.jax_dock_outputs(os.path.join(tg.REPO, "artifacts", name), kept)
    for w, f in zip(g["requests"], fresh):
        np.testing.assert_allclose(w["R"], f["R"], atol=1e-4)
        np.testing.assert_allclose(w["t"], f["t"], atol=1e-3)
        np.testing.assert_allclose(w["ca"], f["ca"], atol=1e-3)


def test_sidecars_of_both_packages_load_the_new_fields(tmp_path):
    """The JAX package's sidecar of a resident, streamed run and the port's
    own round trip keep trim_remainder, stream_dips, stream_window and
    device_resident."""
    from equidock_public_tpu.config import Config as JConfig
    from equidock_public_tpu.config import DataConfig as JData
    from equidock_public_tpu.config import TrainConfig as JTrain

    jcfg = JConfig(train=JTrain(trim_remainder=True),
                   data=JData(stream_dips=True, stream_window=2, device_resident=True))
    path = tmp_path / "jax.config.json"
    path.write_text(json.dumps(dataclasses.asdict(jcfg)))
    cfg = load_config(str(path))
    assert cfg.train.trim_remainder and cfg.data.device_resident
    assert (cfg.data.stream_dips, cfg.data.stream_window) == (True, 2)
    path2 = tmp_path / "port.config.json"
    path2.write_text(json.dumps(dataclasses.asdict(cfg)))
    assert load_config(str(path2)) == cfg
