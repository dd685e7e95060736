"""The port's `fit` at full width against the JAX package's golden file
(`assets/db5_fit.golden.json`): the DB5 paper model from its committed
weights, 2 epochs on the tracked chains cut in two. A file of its own, so
that a test runner that gives each worker whole files can run it beside
the rest of `test_torch_loop.py`."""

import dataclasses
import os

import jax
import numpy as np
import pytest

from equidock_public_tpu_torch.train import loop as tloop
from equidock_public_tpu_torch.train import step as ts

from .torch_utils import f32_default  # noqa: F401


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def test_full_width_fit_matches_the_golden_file(tmp_path):
    """`fit` of the DB5 paper model from its committed weights, 2 epochs on
    the tracked chains cut in two (the port's featurizer writes the
    caches), against `assets/db5_fit.golden.json` at the file's tolerances
    (the same check chip_smoke's `epoch` phase makes on the card)."""
    import json

    from equidock_public_tpu_torch.data.dataset import split_chain_complex, write_cache
    from equidock_public_tpu_torch.data.featurize import filter_residues
    from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb
    from equidock_public_tpu_torch.params import load_checkpoint

    from . import torch_golden as tg

    with open(tg.FIT_GOLDEN) as f:
        golden = json.load(f)
    params, cfg = load_checkpoint(os.path.join(tg.ASSETS, "db5_model_best.pt.xz"))
    cfg = tg.fit_config(cfg, str(tmp_path))
    train = dataclasses.asdict(cfg.train)
    assert train == {k: golden["train_config"][k] for k in train}
    for split, codes in golden["partition"].items():
        samples = [split_chain_complex(filter_residues(group_residues(read_pdb(
            os.path.join(tg.REPO, tg.pdb_path(c))))), cfg.graph) for c in codes]
        write_cache(os.path.join(cfg.cache_path(), f"{split}.npz"), codes, samples)
    history = []
    tloop.fit(cfg, ts.create_train_state(params, cfg, "cpu"), max_epochs=golden["epochs"],
              log=lambda *a: None, device="cpu", history=history)
    tol = golden["tolerance"]
    got = [dict(train=h["train"], val=h["val"]) for h in history[:-1]] + [
        dict(test=history[-1]["test"])]
    want = golden["history"] + [dict(test=golden["test"])]
    for g, w in zip(got, want):
        for part in w:
            for key, value in w[part].items():
                rtol, atol = ((0, tol["median_atol"]) if key.endswith("median")
                              else (tol["loss_rtol"], 0))
                np.testing.assert_allclose(g[part][key], value, rtol=rtol, atol=atol,
                                           err_msg=f"{part} {key}")
    assert history[-1]["best_epoch"] == golden["best_epoch"]
