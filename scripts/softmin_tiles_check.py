#!/usr/bin/env python3
"""Rows 6 and 7 of PERF.md's kernel table on one CUDA card: the soft-min
field forward and backward (`csrc/softmin_field.cu`) of
`equidock_public_tpu_torch`, on own tiles owned by clusters of key ranges.

    python3 scripts/softmin_tiles_check.py                # build, check, sweep, times
    python3 scripts/softmin_tiles_check.py --checks-only  # build and check
    python3 scripts/softmin_tiles_check.py --times-only [--root DIR]

The full run wipes the kernel build and prints ptxas' lines for the
soft-min kernels; holds both kernels against their plain versions on
chip_smoke.py's soft-min cases (the training batch, 70 x 130, 3072 x 3072,
masks with holes, a complex whose keys are all masked, a cotangent all 0,
M = 1, N below one key tile), with guarded outputs and two launches
bit-equal (chip_smoke.check_softmin_case), and reads the kernel and the f32
plain version against the plain version in float64; then times both
kernels at the training batch (B = 10, 512 x 512, split-chain masks) and at
3072 x 3072 (B = 2, 80% / 90% valid) with their bounds, and sweeps the own
points a lane (own tiles of 32, 64, 128 points), the key ranges a block (4,
8, 16 warps) and the blocks a cluster (1, 2, 3, 4, 6, 8) at both shapes.
`--times-only` times only, with the package and chip_smoke.py of the
checkout at DIR (an unpacked commit, to compare two versions in one call).
Times are device ms from CUDA-graph replays (chip_smoke.device_ms). One
JSON line a phase.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def softmin_ptxas(log: str):
    """ptxas' lines of the soft-min kernels: each entry and what follows it."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = "softmin" in ln
        if keep and ("Compiling entry" in ln or "Used" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


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
    from equidock_public_tpu_torch.ops.cuda import softmin_field as ksf

    emit = lambda phase, **kw: print(json.dumps({"phase": phase, **kw}), flush=True)
    emit("device", root=os.path.abspath(args.root), card=cs.nvidia_smi_name_power())
    if not args.times_only:
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    res = _build.build()
    emit("build", seconds=round(res.seconds, 2), ptxas=softmin_ptxas(res.log))

    cases = cs.softmin_cases(torch.device("cuda"))
    if not args.times_only:
        from equidock_public_tpu_torch.ops import softmin_field as sf

        rel = lambda g, w: float((g.double() - w).norm()) / max(float(w.norm()), 1e-30)
        for c in cases:
            cs.check_softmin_case(c)
            # the kernel and the plain version (f32), each against the plain
            # version in float64: which side the f32 gaps come from
            (x, a, am), g = c["args"], c["c"]
            ref = (sf.softmin_field_sums_plain(x.double(), a.double(), am.double(), cs.SIGMA),
                   *sf.softmin_field_bwd_plain(x.double(), a.double(), am.double(),
                                               g.double(), cs.SIGMA))
            kern = (ksf.softmin_field_fwd(x, a, am, cs.SIGMA),
                    *ksf.softmin_field_bwd(x, a, am, g, cs.SIGMA))
            plain = (sf.softmin_field_sums_plain(x, a, am, cs.SIGMA),
                     *sf.softmin_field_bwd_plain(x, a, am, g, cs.SIGMA))
            emit("check", shape=c["shape"], max_abs_err=c["err"], bwd=c["check"],
                 vs_float64_S_dx_dA={"kernel": [rel(k, r) for k, r in zip(kern, ref)],
                                     "plain_f32": [rel(p, r) for p, r in zip(plain, ref)]})
            del ref
        if args.checks_only:
            return 0

    times = {}
    for name, c in (("B=10 512x512 (split-chain)", cases[0]),
                    ("B=2 3072x3072 (80% / 90% valid)", cases[2])):
        (x, a, am), g = c["args"], c["c"]
        B, M, N = x.shape[0], x.shape[1], a.shape[1]
        t = {"fwd": cs.device_ms(lambda: ksf.softmin_field_fwd(x, a, am, cs.SIGMA)),
             "bwd": cs.device_ms(lambda: ksf.softmin_field_bwd(x, a, am, g, cs.SIGMA)),
             "fwd_bound": list(cs.bound(*cs.softmin_cost(x, a, am))),
             "bwd_bound": list(cs.bound(*cs.softmin_cost(x, a, am, g)))}
        if hasattr(ksf, "softmin_tile_plan"):
            t["plan_fwd"] = ksf.softmin_tile_plan(B, M, N)._asdict()
            t["plan_bwd"] = ksf.softmin_tile_plan(B, M, N, backward=True)._asdict()
            if not args.times_only:
                sweep = {}
                for lp, w in ksf.BUILT:
                    for s in (1, 2, 3, 4, 6, 8):
                        fwd = ksf.softmin_tile_plan(B, M, N, False, lp, w, s)
                        bwd = ksf.softmin_tile_plan(B, M, N, True, lp, w, s)
                        sweep[f"lp{lp} w{w} s{s}"] = [
                            cs.device_ms(lambda: ksf.softmin_field_fwd(x, a, am, cs.SIGMA,
                                                                       plan=fwd), trials=5),
                            cs.device_ms(lambda: ksf.softmin_field_bwd(x, a, am, g, cs.SIGMA,
                                                                       plan=bwd), trials=5)]
                t["sweep [fwd, bwd]"] = sweep
        times[name] = t
    emit("times", ms=times)
    return 0


if __name__ == "__main__":
    sys.exit(main())
