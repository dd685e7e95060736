#!/usr/bin/env python3
"""Whether two correct forms of chip_smoke's `slice11` steps part by their
masks' cut or by rounding, on the CPU:

    python3 scripts/slice11_rounding.py [--threads 4]

For each of the phase's models (the 'BN' and the dropout model, the swish /
coordinate-LN model, the packed model on its packed batch), at the phase's
shapes and from the committed weights: the loss terms and the gradient
norm of the one-process dense step and of the stacked dp-2 x gp-2 halo
step (each shard its part of the whole batch's masks), both with the same
dropout masks (drawn in float32 from one seed), in float32 and in float64.
A fault of the masks' cut or of a shard's sums parts the two forms in
float64 as in float32; rounding parts them in float32 alone. One JSON line
a model: each form's numbers, the float32 and float64 distances between
the forms, and each float32 form's distance from the float64 dense step
(relative). No card is used.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

KEYS = ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss", "grad_norm")


class Masks:
    """Keep-masks drawn in float32 from one seed whatever the default dtype,
    so that both dtypes' steps apply the same masks."""

    def __init__(self, rate: float):
        self.rate = rate
        self.gen = torch.Generator().manual_seed(cs.SLICE11_DROP_SEED)

    def mask(self, shape, device, side):
        return torch.rand(shape, generator=self.gen, dtype=torch.float32) < 1.0 - self.rate


def to_dtype(obj, dtype):
    """Every floating tensor of a batch, its nested dataclasses and dicts, at
    `dtype`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: to_dtype(getattr(obj, f.name), dtype)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: to_dtype(v, dtype) for k, v in obj.items()}
    return obj


def forms(cfg, flat, batch, dtype) -> dict:
    """The dense and the stacked halo step's loss terms and gradient norm
    at `dtype`."""
    from equidock_public_tpu_torch.models.iegmn import docking_forward, init_bn_state
    from equidock_public_tpu_torch.params import unflatten
    from equidock_public_tpu_torch.parallel.halo import build_halo_batch, make_halo_loss
    from equidock_public_tpu_torch.parallel.mesh import ParallelMesh
    from equidock_public_tpu_torch.train.losses import total_loss
    from equidock_public_tpu_torch.train.step import loss_and_grads

    torch.set_default_dtype(dtype)
    try:
        batch = to_dtype(batch, dtype)
        params = unflatten({k: v.to(dtype) for k, v in flat.items()})
        bn = to_dtype(init_bn_state(cfg.model), dtype) or None
        masks = lambda: Masks(cfg.model.dropout) if cfg.model.dropout else None

        def dense(p, cfg_, b):
            out = docking_forward(p, cfg_.model, b, train=True, drop=masks(), bn_state=bn)
            loss, metrics = total_loss(out, b, cfg_.train)
            return loss, (metrics, out)

        out = {}
        for name, loss_fn, b in (
                ("dense", dense, batch),
                ("halo", make_halo_loss(cfg, ParallelMesh(2, 2, "cpu"), masks(), bn),
                 build_halo_batch(batch, 2)[0])):
            grads, metrics, _ = loss_and_grads(params, cfg, b, loss_fn)
            row = {k: float(metrics[k]) for k in KEYS[:-1]}
            row["grad_norm"] = float(torch.sqrt(sum((g.double() ** 2).sum()
                                                    for g in grads.values())))
            out[name] = row
        return out
    finally:
        torch.set_default_dtype(torch.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    from equidock_public_tpu_torch.parallel.input_pipeline import slice_rows

    train_golden = cs.training_golden("cpu")
    batch = slice_rows(train_golden[3], slice(0, cs.SLICE11_ROWS))
    models = [(name, *cs.slice11_model(train_golden, kw), batch)
              for name, kw in cs.SLICE11_MODELS]
    models.append(("halo_options", *cs.slice11_model(train_golden, cs.SLICE11_HALO_MODEL),
                   batch))
    with tempfile.TemporaryDirectory(prefix="slice11_rounding_") as root:
        packed_cfg, packed = cs.slice11_packed_batch(train_golden, root)
    models.append(("packed", packed_cfg, cs.slice11_model(train_golden, {})[1], packed))
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    for name, cfg, flat, b in models:
        got = {str(dt).replace("torch.", ""): forms(cfg, flat, b, dt)
               for dt in (torch.float32, torch.float64)}
        f32, f64 = got["float32"], got["float64"]
        print(json.dumps({
            "model": name, "forms": got,
            "dense_vs_halo": {dt: {k: rel(v["halo"][k], v["dense"][k]) for k in KEYS}
                              for dt, v in got.items()},
            "float32_vs_float64_dense": {form: {k: rel(f32[form][k], f64["dense"][k])
                                                for k in KEYS} for form in f32}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
