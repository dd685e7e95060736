#!/usr/bin/env python3
"""How far the port's bf16 forward moves when every f32 weight moves by a
seeded relative 1e-6 that keeps the weight's bf16 rounding, against d0,
the distance between the model's own forwards at bf16 and at f32, on the
four serving requests of `assets/db5_model_best.golden.json`. Such a move
changes the f32 values inside the forward far below a bf16 rounding, as
another order of f32 sums (another device's) does, so the ratio says how
closely two devices' bf16 forwards of one model can agree. Runs the port
alone, on the card unless `cpu` is given:

    python3 scripts/bf16_sensitivity.py [cuda|cpu] [paper|small|trained]

`paper` (the default): the DB5 paper model's committed weights, also
against the JAX package's fused-path bf16 forward of
`assets/db5_model_best_bf16.golden.json` over JAX's own d0; `small`: the
16-wide `db5_model_small`; `trained`: the paper model's config at bf16
trained 2 steps through the training CLI from its committed weights on
chip_smoke.py's slice-8 split, on the same device. Prints one JSON line a
request (R, t, the first 8 CA and both keypoint sets: d0 and the moved
forward's distance over d0 for each of 4 seeds) and one line of the same
over the four requests together.
"""

import contextlib
import dataclasses
import glob
import io
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from equidock_public_tpu_torch.device import resolve_device  # noqa: E402
from equidock_public_tpu_torch.eval import inference  # noqa: E402
from equidock_public_tpu_torch.params import (flatten, load_model,  # noqa: E402
                                              model_checkpoint, unflatten)

KEYS = ("R", "t", "ca", "keypts_lig", "keypts_rec")
SEEDS = 4


def outputs(out):
    return {"R": out["R"][0], "t": out["t"][0, 0], "ca": out["ligand_coords"][0, :8],
            "keypts_lig": out["keypts_lig"][0], "keypts_rec": out["keypts_rec"][0]}


def moved_keeping_bf16(params, seed: int):
    """Every leaf times (1 + 1e-6 N(0, 1)), seeded, where that keeps the
    element's bf16 rounding; the element as it was elsewhere."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in flatten(params).items():
        m = v * (1 + 1e-6 * torch.randn(v.shape, generator=gen).to(v.device))
        out[k] = torch.where(m.bfloat16() == v.bfloat16(), m, v)
    return unflatten(out)


def trained_checkpoint(dev, root: str) -> str:
    """The paper model's config at bf16 trained 2 CLI steps from its
    committed weights on chip_smoke.py's slice-8 split, on `dev`."""
    import chip_smoke as cs
    from equidock_public_tpu_torch.cli import train as cli

    cs.write_small_split(root)
    start = cs.start_checkpoint(os.path.join(root, "start"), dict(dtype="bfloat16"))
    argv = cs.small_argv(root, "trained") + ["-continue_train_model", start]
    argv[argv.index("-device") + 1] = dev.type
    here = os.getcwd()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            if cli.main(argv) != 0:
                raise SystemExit("the training CLI failed")
    finally:
        os.chdir(here)
    return glob.glob(os.path.join(root, "ckpt", "trained", "*", "db5_model_best"))[0]


def main(device: str = "cuda", which: str = "paper") -> None:
    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="equidock_bf16_")
    try:
        path = {"paper": lambda: model_checkpoint("db5_model_best"),
                "small": lambda: model_checkpoint("db5_model_small"),
                "trained": lambda: trained_checkpoint(dev, root)}[which]()
        params, cfg, bn_state = load_model(path, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg16, cfg32 = (dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dt))
                    for dt in ("bfloat16", "float32"))
    with open(os.path.join(REPO, "equidock_public_tpu_torch", "assets",
                           "db5_model_best_bf16.golden.json")) as f:
        golden = json.load(f)
    moved = [moved_keeping_bf16(params, s) for s in range(SEEDS)]
    sq = lambda a, b: float(((torch.as_tensor(a).cpu().double()
                              - torch.as_tensor(b).cpu().double()) ** 2).sum())
    sums = {k: {"d0": 0.0, "moved": [0.0] * SEEDS, "jax_d0": 0.0, "port_vs_jax": 0.0}
            for k in KEYS}
    for g16, g32 in zip(golden["requests"], golden["float32"]):
        req = inference.featurize_request(cfg16, os.path.join(REPO, g16["ligand"]),
                                          os.path.join(REPO, g16["receptor"]), dev)
        fwd = lambda p, c: outputs(inference.make_forward(p, c, bn_state)(req.batch))
        a, b = fwd(params, cfg16), fwd(params, cfg32)
        m = [fwd(p, cfg16) for p in moved]
        line = {"request": g16["ligand"]}
        for k in KEYS:
            s = sums[k]
            d0 = sq(a[k], b[k])
            s["d0"] += d0
            mv = [sq(x[k], a[k]) for x in m]
            s["moved"] = [u + v for u, v in zip(s["moved"], mv)]
            line[k] = {"d0": d0 ** 0.5, "moved_over_d0": [(v / d0) ** 0.5 for v in mv]}
            if which == "paper":
                jd0, pj = sq(g16[k], g32[k]), sq(a[k], np.asarray(g16[k]))
                s["jax_d0"] += jd0
                s["port_vs_jax"] += pj
                line[k]["port_vs_jax_over_jax_d0"] = (pj / jd0) ** 0.5
        print(json.dumps(line), flush=True)
    total = {}
    for k, s in sums.items():
        total[k] = {"d0": s["d0"] ** 0.5,
                    "moved_over_d0": [(v / s["d0"]) ** 0.5 for v in s["moved"]]}
        if which == "paper":
            total[k]["port_vs_jax_over_jax_d0"] = (s["port_vs_jax"] / s["jax_d0"]) ** 0.5
    print(json.dumps({"all_requests": total, "model": which, "device": str(dev)}), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
