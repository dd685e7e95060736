#!/usr/bin/env python3
"""Rows 8 and 9 of PERF.md's kernel table on one CUDA card: the halo
exchange forward and backward (`csrc/halo_ring.cu`) of
`equidock_public_tpu_torch`, a gather by a fixed table over both sides of a
layer in one launch each way.

    python3 scripts/halo_tiles_check.py                # build, check, times
    python3 scripts/halo_tiles_check.py --checks-only  # build and check
    python3 scripts/halo_tiles_check.py --times-only [--root DIR]

The full run wipes the kernel build and prints ptxas' lines for the
exchange kernels; runs chip_smoke.py's halo exchange checks
(chip_smoke.check_halo_case: the served 512 x 1024 request at padded gp=2,
ragged gp=4 and a forced residual tier at gp=4, the training batch at
padded gp=2 with dp 1 and 2 and ragged gp=2 at dp=2 with D = 16; guarded
outputs, row 8 bit-equal to the table's index_select and to the ring
composition, row 9 bit-equal to the CPU's sequential index_add_ and within
1e-6 of autograd through the composition, two launches bit-equal), with
each case's longest slot list; then the times. `--times-only` times only,
with the package and chip_smoke.py of the checkout at DIR (an unpacked
commit, to compare two versions in one call). Times, at the served
request and at the training batch, both gp=2: the per-layer exchange of
both sides as the trunk runs it, forward and forward + backward (device ms
from CUDA-graph replays, chip_smoke.device_ms; the backward with random
cotangents), and a device profile (device ms, device ops, idle share) of
one halo forward at 512 x 1024 and one halo training step; on this
checkout also each kernel alone beside its bound and the library calls
(`index_select` forward, `index_add_` backward). One JSON line a phase.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def halo_ptxas(log: str):
    """ptxas' lines of the exchange kernels: each entry and what follows it."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = "exchange" in ln or "ring" in ln
        if keep and ("Compiling entry" in ln or "Used" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def layer_exchange(pair, dev, seed=0):
    """(label, forward(leaves), leaves, cotangents, halo batch) of one layer's
    exchange of both sides at gp=2 as this checkout's trunk runs it: one
    call of `halo_exchange_pair` where the package has it, else two calls of
    `halo_exchange`; x the side's folded coordinates, h random 64-wide."""
    from equidock_public_tpu_torch.ops.cuda import halo_ring as hr
    from equidock_public_tpu_torch.parallel import halo as H
    from equidock_public_tpu_torch.parallel.mesh import ParallelMesh

    hb, _, _, _ = H.build_halo_batch(pair, gp=2)
    mesh = ParallelMesh(1, 2, dev)
    gen = torch.Generator().manual_seed(seed)
    plans, leaves, grads = [], [], []
    for side in ("lig", "rec"):
        prot = mesh.shard_protein(getattr(hb.pair, side))
        if hasattr(H, "mesh_table"):
            plan = H.mesh_table(getattr(hb, "table_" + side), mesh)
        else:
            plan = H.shard_plan(getattr(hb, "plan_" + side), mesh)
        h = torch.randn(prot.x.shape[:2] + (64,), generator=gen).to(dev)
        plans.append(plan)
        leaves += [prot.x.contiguous().requires_grad_(True), h.requires_grad_(True)]
        srcs = H.halo_exchange(leaves[-2], leaves[-1], plan, mesh)
        grads += [torch.randn(s.shape, generator=gen).to(dev) for s in srcs]
    if hasattr(hr, "halo_exchange_pair"):
        return ("halo_exchange_pair (one call)",
                lambda l: hr.halo_exchange_pair(*l, plans[0], plans[1]), leaves, grads, hb)
    return ("halo_exchange x 2",
            lambda l: (*H.halo_exchange(l[0], l[1], plans[0], mesh),
                       *H.halo_exchange(l[2], l[3], plans[1], mesh)),
            leaves, grads, hb)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--checks-only", action="store_true")
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    from equidock_public_tpu_torch.ops.cuda import _build
    from equidock_public_tpu_torch.params import default_checkpoint, load_checkpoint

    emit = lambda phase, **kw: print(json.dumps({"phase": phase, **kw}), flush=True)
    dev = torch.device("cuda")
    emit("device", root=os.path.abspath(args.root), card=cs.nvidia_smi_name_power())
    if not args.times_only:
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    res = _build.build()
    emit("build", seconds=round(res.seconds, 2), ptxas=halo_ptxas(res.log))

    params, cfg = load_checkpoint(default_checkpoint(), dev)
    requests = cs.served_requests(cfg, dev)
    golden = cs.training_golden(dev)
    batch = golden[3]
    if not args.times_only:
        import numpy as np

        cases, _ = cs.halo_kernel_cases(params, requests, batch, dev)
        for c in cases:
            longest = [int(np.diff(t.offsets.cpu().numpy()).max()) for *_, t in c["sides"]]
            emit("check", **cs.check_halo_case(c), longest_slot_list_lig_rec=longest)
        if args.checks_only:
            return 0

    times = {}
    for name, pair in (("512x1024 request, gp=2", requests[0][1].batch),
                       ("training batch B=10 512x512, gp=2", batch)):
        label, fwd, leaves, grads, _ = layer_exchange(pair, dev)
        with torch.inference_mode():
            f_ms = cs.device_ms(lambda: fwd([a.detach() for a in leaves]))
        try:
            fb_ms = cs.device_ms(lambda: torch.autograd.grad(fwd(leaves), leaves, grads))
        except RuntimeError as e:        # a yardstick: report it, time the rest
            times[name] = {"path": label, "forward_ms": f_ms, "backward_error": str(e)[:300]}
            continue
        times[name] = {"path": label, "forward_ms": f_ms, "forward_backward_ms": fb_ms,
                       "backward_ms": fb_ms - f_ms}
    if not args.times_only:
        times.update(kernel_times(cs, requests, batch, dev))
    emit("times", card=cs.nvidia_smi_name_power(), ms=times,
         timing="device ms per call from CUDA-graph replays between CUDA events; "
                "forward_backward_ms: forward and torch.autograd.grad in one graph")

    from equidock_public_tpu_torch.parallel.halo import (build_halo_batch, make_halo_forward,
                                                         make_halo_train_step)
    from equidock_public_tpu_torch.parallel.mesh import ParallelMesh
    from equidock_public_tpu_torch.train.step import create_train_state

    mesh = ParallelMesh(1, 2, dev)
    hbr, _, _, _ = build_halo_batch(requests[0][1].batch, gp=2)
    fwd = make_halo_forward(cfg, mesh)
    with torch.inference_mode():
        f_prof = cs.device_profile(lambda: fwd(params, hbr)["R"].cpu(), reps=3)
    hb, _, _, _ = build_halo_batch(batch, gp=2)
    step = make_halo_train_step(golden[2], mesh)
    state0 = create_train_state(params, golden[2], dev)
    s_prof = cs.device_profile(lambda: step(state0, hb), reps=2)
    emit("profiles", card=cs.nvidia_smi_name_power(), halo_forward_512x1024_gp2=f_prof,
         halo_step_train_gp2=s_prof)
    return 0


def kernel_times(cs, requests, batch, dev) -> dict:
    """Each kernel alone on both sides of a layer (the tables of a padded
    gp=2 plan) beside its bound, the plain versions and the library calls
    (chip_smoke.library_gathers), at the request and the training batch."""
    from equidock_public_tpu_torch.ops.cuda import halo_ring as hr

    out = {}
    for name, pair in (("512x1024 request, gp=2", requests[0][1].batch),
                       ("training batch B=10 512x512, gp=2", batch)):
        _, _, _, sides = cs.halo_sides(pair, dict(gp=2), 1, 2, dev)
        gen = torch.Generator().manual_seed(5)
        grads = [tuple(torch.randn(x.shape[0], t.dims[3], w, generator=gen).to(dev)
                       for w in (3, h.shape[-1])) + (t,) for x, h, t in sides]
        lib_f, lib_b = cs.library_gathers(sides, grads)
        for kname, a, kern, plain, lib, bwd in (
                ("row 8", sides, hr.exchange_kernel, hr.exchange_plain, lib_f, False),
                ("row 9", grads, hr.exchange_bwd_kernel, hr.exchange_bwd_plain, lib_b, True)):
            b_ms, b_by = cs.bound(cs.exchange_nbytes(a, kern(a), bwd), 0)
            out[f"{kname}, {name}"] = {
                "ms": cs.device_ms(lambda: kern(a)),
                "plain_ms": cs.device_ms(lambda: [plain(*s) for s in a]),
                "library_ms": cs.device_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    return out


if __name__ == "__main__":
    sys.exit(main())
