#!/usr/bin/env python3
"""Rows 1 and 2 of PERF.md's kernel table on one CUDA card: the edge-message
forward (`csrc/edge_message.cu`) and backward (`csrc/edge_message_bwd.cu`)
of `equidock_public_tpu_torch`, on tiles of whole destination nodes.

    python3 scripts/edge_tiles_check.py              # build, check, sweep, times
    python3 scripts/edge_tiles_check.py --times-only [--root DIR]

The full run wipes the kernel build and prints ptxas' lines for the edge
kernels; holds both kernels against their plain versions on chip_smoke.py's
edge cases (the serving shapes, the training batch at D 64 and 16, the
edges of the tiles: N = 300, an all-padded graph, Nsrc != N), with guarded
outputs and two launches bit-equal (chip_smoke.check_edge_case); sweeps the
nodes a tile (1-6 at K = 10) for the forward at the serving shape and both
kernels at the training batch, D 64 and 16, the forward's grid cap (1, 2,
4 blocks an SM) and the backward's grid (1-4 blocks an SM, run in waves
where they do not fit); then times. `--times-only`
times only, with the package and chip_smoke.py of the checkout at DIR (an
unpacked commit, to compare two versions in one call). Times, as device ms
from CUDA-graph replays (chip_smoke.device_ms): the forward at N = 1024
(serving) and at B = 10, N = 512, D 64 and 16 (the step); the backward
kernel alone, the d_src scatter alone, the inverse list's build, and the
whole backward as the training path calls it. One JSON line a phase.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import shutil
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split(c):
    """(the kernel's inputs, the output cotangents or None) of a case: older
    trees keep the cotangents at the end of `args`."""
    a = c["args"]
    return a[:6], c.get("grads") or (a[6:] or None)


def edge_ptxas(log: str):
    """ptxas' lines of the edge kernels: each entry and what follows it."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = "edge" in ln
        if keep and ("Compiling entry" in ln or "Used" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    from equidock_public_tpu_torch.ops.cuda import _build
    from equidock_public_tpu_torch.ops.cuda import edge_message as em
    from equidock_public_tpu_torch.params import default_checkpoint, load_checkpoint

    dev = torch.device("cuda")
    emit = lambda phase, **kw: print(json.dumps({"phase": phase, **kw}), flush=True)
    emit("device", root=os.path.abspath(args.root), card=cs.nvidia_smi_name_power())
    if not args.times_only:
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    res = _build.build()
    emit("build", seconds=round(res.seconds, 2), ptxas=edge_ptxas(res.log))

    params, cfg = load_checkpoint(default_checkpoint(), dev)
    slope = cfg.model.leakyrelu_neg_slope
    serve = cs.edge_cases(params, dev)[1]
    train, d16 = cs.edge_bwd_case(params, dev), cs.edge16_case(dev)

    if not args.times_only:
        for c in cs.edge_cases(params, dev) + [train, d16] + cs.edge_tile_cases(dev):
            emit("check", **cs.check_edge_case(c, slope))

    times = {}
    for name, c in (("N=1024 D64 (serving)", serve), ("B=10 N=512 D64", train),
                    ("B=10 N=512 D16", d16)):
        a, g = split(c)
        out = em.edge_message_aggregate(*a, slope=slope)
        b_ms, b_by = cs.bound(*cs.edge_cost(*a, out))
        t = {"forward": cs.device_ms(lambda: em.edge_message_aggregate(*a, slope=slope)),
             "forward_bound": [b_ms, b_by]}
        if g is not None:
            nbr, nsrc = a[3], a[0].shape[1]
            raw = em.edge_message_bwd_kernel(*a, *g, slope=slope)
            t["bwd_kernel"] = cs.device_ms(lambda: em.edge_message_bwd_kernel(*a, *g, slope=slope))
            t["inverse_build"] = cs.device_ms(lambda: em.inverse_neighbors(nbr, nsrc))
            if "inverse" in inspect.signature(em.launch_scatter).parameters:
                inv = em.inverse_neighbors(nbr, nsrc)
                t["scatter"] = cs.device_ms(lambda: em.launch_scatter(nbr, nsrc, *raw[:2], inv))
                t["bwd_path"] = cs.device_ms(
                    lambda: em.edge_message_bwd(*a, *g, slope=slope, inverse=inv))
                builds = 2 / 10          # 2 builds a step for 10 backwards
            else:                         # every backward sorts
                t["scatter_with_sort"] = cs.device_ms(
                    lambda: em.launch_scatter(nbr, nsrc, *raw[:2]))
                t["bwd_path"] = cs.device_ms(lambda: em.edge_message_bwd(*a, *g, slope=slope))
                builds = 0.0              # inside bwd_path already
            t["bwd_per_launch_in_a_step"] = t["bwd_path"] + builds * t["inverse_build"]
            t["bwd_bound"] = list(cs.bound(*cs.edge_bwd_cost(*a, *g)))
        if not args.times_only:     # forward grid caps, nodes a tile
            cap = em.FWD_MAX_BLOCKS
            for blocks in (em.SMS, 2 * em.SMS, 4 * em.SMS):
                em.FWD_MAX_BLOCKS = blocks
                t[f"forward blocks<={blocks}"] = cs.device_ms(
                    lambda: em.edge_message_aggregate(*a, slope=slope))
            em.FWD_MAX_BLOCKS = cap
            if g is not None:            # backward grid: blocks an SM, in waves
                for n in (1, 2, 3, 4):
                    em.BWD_MAX_BLOCKS = n * em.SMS
                    t[f"bwd_path blocks={n}/SM"] = cs.device_ms(
                        lambda: em.edge_message_bwd(*a, *g, slope=slope, inverse=inv))
                em.BWD_MAX_BLOCKS = em.SMS
            K, D = a[3].shape[2], a[0].shape[2] - 3
            for tn in range(1, em.TILE_ROWS // K + 1):
                t[f"forward tn={tn}"] = cs.device_ms(
                    lambda tn=tn: em._launch_fwd(*a, slope, True, True, tile_nodes=tn))
                if g is not None:
                    t[f"bwd_kernel tn={tn}"] = cs.device_ms(
                        lambda tn=tn: em.edge_message_bwd_kernel(*a, *g, slope=slope,
                                                                 tile_nodes=tn))
        times[name] = t
    emit("times", ms=times)
    return 0


if __name__ == "__main__":
    sys.exit(main())
