#!/usr/bin/env python3
"""Rows 3-5 of PERF.md's kernel table on one CUDA card: the attention
forward (`csrc/cross_attention.cu`) and its dQ and dK/dV backward
(`csrc/cross_attention_bwd.cu`) of `equidock_public_tpu_torch`.

    python3 scripts/attention_tiles_check.py              # build, check, sweep
    python3 scripts/attention_tiles_check.py --times-only [--root DIR]

The full run wipes the kernel build, prints ptxas' lines for the attention
kernels, holds the forward, dQ and dK/dV against their plain versions on
chip_smoke.py's attention cases (two launches bit-equal), then times the
forward at the serving shape (512x1024, D 64) and the training shape
(B=10, 512x512, D 64), and dQ and dK/dV at the training shape (D 64 and
69), each for several numbers of splits, beside SDPA's forward, and each
kernel and combine pass apart. `--times-only` times the default launches
and SDPA only, with the package and chip_smoke.py of the checkout at DIR
(an unpacked commit, to compare two versions in one call). One JSON line a
phase; device ms from CUDA-graph replays (chip_smoke.device_ms).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parts_ms(cs, ca, serve, train, bwd) -> dict:
    """Device ms of each attention kernel and each combine pass apart, at
    the default split counts."""
    out = {}
    for name, a in (("512x1024", serve), ("B=10 512x512", train)):
        parts = ca.fwd_partials(*a)
        S = parts[0].shape[1]
        out[f"forward kernel {name} (splits {S})"] = cs.device_ms(lambda: ca.fwd_partials(*a))
        out[f"forward combine {name}"] = cs.device_ms(lambda: ca.fwd_combine(*parts))
    for c in bwd:
        q, k, v, qt, kt, o, lse, do = c["args"]
        dargs = (q, k, v, qt, kt, lse, do, c["delta"])
        D = q.shape[-1]
        part = ca.dq_partials(*dargs)
        out[f"dq kernel D{D} (splits {part.shape[1]})"] = cs.device_ms(
            lambda: ca.dq_partials(*dargs))
        out[f"dq combine D{D}"] = cs.device_ms(lambda: ca.dq_combine(part))
        parts = ca.dkv_partials(*dargs)
        out[f"dkv kernel D{D} (splits {parts[0].shape[1]})"] = cs.device_ms(
            lambda: ca.dkv_partials(*dargs))
        out[f"dkv combine D{D}"] = cs.device_ms(lambda: ca.dkv_combine(*parts))
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
    from equidock_public_tpu_torch.ops.cuda import cross_attention as ca

    dev = torch.device("cuda")
    emit = lambda phase, **kw: print(json.dumps({"phase": phase, **kw}), flush=True)
    emit("device", root=os.path.abspath(args.root), card=cs.nvidia_smi_name_power())
    if not args.times_only:
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    res = _build.build()
    emit("build", seconds=round(res.seconds, 2),
         ptxas=[ln.strip() for ln in res.log.splitlines() if "cross_attention" in ln
                or "Used" in ln or "spill" in ln])

    serve = cs.attention_cases(dev)[1]["args"]
    gen = torch.Generator().manual_seed(1)
    import numpy as np
    rng = np.random.default_rng(1)
    train = tuple(x.to(dev).contiguous() for x in (
        torch.randn(10, 512, 64, generator=gen) * 0.3, torch.randn(10, 512, 64, generator=gen) * 0.3,
        torch.randn(10, 512, 64, generator=gen), cs.training_tags(rng, 10, 512),
        cs.training_tags(rng, 10, 512)))
    bwd = cs.attention_bwd_cases(dev)

    if not args.times_only:
        for c in cs.attention_cases(dev):
            got = ca.cross_attention_fwd(*c["args"])
            want = ca.cross_attention_plain(*c["args"])
            torch.cuda.synchronize()
            err = cs.check_close("cross_attention " + c["shape"], got, want, cs.ATT_TOL)
            empty = cs.check_empty_rows(c["shape"], c["args"], got)
            again = ca.cross_attention_fwd(*c["args"])
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            emit("forward", shape=c["shape"], max_abs_err=err, bit_equal=same, **empty)
        for c in bwd:
            got = ca.cross_attention_bwd(*c["args"])
            want = ca.cross_attention_bwd_plain(*c["args"][:5], c["args"][7])
            torch.cuda.synchronize()
            chk = {part: cs.check_grads(f"cross_attention_{part}", c["shape"], g, w)
                   for part, g, w in (("dq", got[:1], want[:1]), ("dkv", got[1:], want[1:]))}
            again = ca.cross_attention_bwd(*c["args"])
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            emit("backward", shape=c["shape"], bit_equal=same, **chk)
        for c in cs.attention_dq_cases(dev, cs.attention_cases(dev)):
            q, k, v, qt, kt, o, lse, do = c["args"]
            dargs = (q, k, v, qt, kt, lse, do, (do * o).sum(-1).contiguous())
            got = ca.cross_attention_dq(*dargs)
            want = ca.cross_attention_bwd_plain(q, k, v, qt, kt, do)[0]
            torch.cuda.synchronize()
            chk = cs.check_grads("cross_attention_dq", c["shape"], [got], [want])
            same = torch.equal(got, ca.cross_attention_dq(*dargs))
            emit("dq", shape=c["shape"], bit_equal=same, **chk)

    def sdpa(q, k, v, qt, kt):
        keep = (qt[:, :, None] > 0) & (qt[:, :, None] == kt[:, None, :])
        mask = torch.where(keep, 0.0, -1000.0)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)

    times = {}
    for name, a in (("forward 512x1024 D64", serve), ("forward B=10 512x512 D64", train)):
        times[name] = {"default": cs.device_ms(lambda: ca.cross_attention_fwd(*a)),
                       "sdpa": cs.device_ms(sdpa(*a))}
        if not args.times_only:
            tiles = -(-a[0].shape[1] // 64), -(-a[1].shape[1] // 64)
            for s in (1, 2, 4, 8, 16):
                if s <= tiles[1] and ca.tile_splits(1, tiles[1], s) == s:
                    times[name][f"splits={s}"] = cs.device_ms(
                        lambda s=s: ca._launch_fwd(*a, splits=s))
    for c in bwd:
        q, k, v, qt, kt, o, lse, do = c["args"]
        dargs = (q, k, v, qt, kt, lse, do, c["delta"])
        name = "backward " + c["shape"]
        times[name] = {"dq": cs.device_ms(lambda: ca.cross_attention_dq(*dargs)),
                       "dkv": cs.device_ms(lambda: ca.cross_attention_dkv(*dargs))}
        if not args.times_only:
            tiles = -(-k.shape[1] // 64)
            for s in (1, 2, 3, 4, 8):
                if ca.tile_splits(1, tiles, s) != s:
                    continue
                times[name][f"dq splits={s}"] = cs.device_ms(
                    lambda s=s: ca.cross_attention_dq(*dargs, splits=s))
                times[name][f"dkv splits={s}"] = cs.device_ms(
                    lambda s=s: ca.cross_attention_dkv(*dargs, splits=s))
        if hasattr(cs, "graph_backward_ms"):     # the whole backward as device time
            times[name]["whole_backward"] = {
                "port": cs.graph_backward_ms(lambda l: ca.cross_attention_fwd(*l, qt, kt)[0],
                                             (q, k, v), do),
                "plain": cs.graph_backward_ms(
                    lambda l: ca.cross_attention_plain(*l, qt, kt)[0], (q, k, v), do),
                "sdpa": cs.sdpa_graph_bwd_ms(q, k, v, qt, kt, do)}
    if not args.times_only:                  # each kernel of a row apart
        times["parts"] = parts_ms(cs, ca, serve, train, bwd)
    emit("times", ms=times)
    return 0


if __name__ == "__main__":
    sys.exit(main())
