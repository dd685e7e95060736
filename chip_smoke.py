#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`equidock_public_tpu_torch`) on one
NVIDIA card:

    python3 chip_smoke.py

Each phase prints one JSON line; any failure raises and the script exits
non-zero without printing a result.
  device   the card (exit 1 when there is none), torch and CUDA versions,
           the power limit; TF32 stays off
  build    wipes equidock_public_tpu_torch/_build and builds the six
           sources with one nvcc call; prints ptxas' register/shared-memory
           lines
  kernels  each CUDA kernel against its plain PyTorch version on the card:
           the forwards at the serving shapes, the backwards (edge message,
           attention dQ and dK/dV) against autograd through the plain
           forwards at the training shapes, the edge kernels also at D = 16,
           with a source wider than the destinations (the halo layer
           body's Nsrc = S + 2 Hr + gp Hres) and at the edges of their
           tiles (N = 300, a graph whose nodes are all padded, Nsrc != N,
           D 64 and 16), each edge and soft-min launch writing into outputs
           inside NaN guard regions that must stay untouched, the attention
           forward also at the training batch and at the edges of its 64-row
           tiles (300 x 1000, a complex of padded query rows, tags that meet no key,
           kept logits below -896; rows that keep no key must average all
           M values with lse = -1000 + log M), attention dQ also at all
           those shapes and at D 16, 32 and 96, the combine passes of the
           attention rows at their main-path shapes, the soft-min field
           sums and their backward at the training, a ragged and the
           largest bucket's shapes and at the edges of their tiles (masks
           with holes, a complex whose keys are all masked, a cotangent all
           0, M = 1, N below one key tile), with the stated tolerances; the
           halo exchange kernels (rows 8, 9), both sides a launch, at the
           served request's three plans and at the training batch (dp 1
           and 2, D 64 and 16): row 8 bit-equal to the table's index_select
           and to the ring composition, row 9 bit-equal to the sequential
           index_add_ of the table on the CPU and within 1e-6 of autograd
           through the composition, both into guarded outputs; and two
           launches of each backward, halo, edge, attention and soft-min
           kernel on the same inputs give the same bits.
           Each kernel's first launch is synchronised at once, so a fault
           names its kernel
  serve    the DB5 paper model (committed weights) warms up buckets 512 and
           1024, then answers 4 requests through DockingServer.serve_lines;
           R, t and CA coordinates must match the JAX package's CPU values
           in the golden file, and every forward must launch each forward
           kernel exactly 10 times (5 layers x 2 sides) and build no
           inverse neighbour list (only the backward reads one: 2 a step,
           one a side, on every path)
  train    the same model trains on a batch of 10 tracked DB5 chains, each
           cut in two (the port's featurizer and DockingDataset, the golden
           file's seed): every parameter gets a finite gradient whose norm
           matches the JAX package's; 3 train_steps match its loss terms,
           gradient norms and parameter moves per step; each of the five
           kernels launches exactly 10 times a step. Then step time after
           warm-up, pairs/s, and a profile of one step (device busy and idle
           share, top device ops, the Sinkhorn loop's and the SVD's share,
           the host synchronizations of a step). One more step with
           `use_fused_intersection` (the soft-min field kernels) from the
           same state matches the unfused one; so do a forward and a step of
           a random 16-wide model (the db5_model_small config) on the
           kernels against the plain versions on the card
  epoch    (a) `fit`, 2 epochs, from the committed weights with the fused
           intersection loss, on caches of the tracked chains cut in two
           that the port's featurizer writes: per-epoch loss terms, RMSD
           medians, the best epoch and the test numbers against the JAX
           package's (assets/db5_fit.golden.json), and every kernel's
           launches; (b) the training CLI for 2 epochs of a random full-width
           model on a synthetic DB5-sized split (152 / 25 / 25 complexes,
           sizes drawn from the tracked chains): epoch seconds, pairs/s,
           step median, val-epoch and checkpoint seconds, launches per step,
           and the device idle share of one profiled epoch
  halo     the halo graph-parallel path (shards stacked on the card): the
           4 served requests through `make_halo_forward` at padded gp=2,
           ragged gp=4 and gp=4 with a forced residual tier, each against
           the serving golden file through the node permutation, row 8
           launching exactly 5 times a forward (both sides of a layer in
           one launch, every plan), row 9 never and the edge forward 10
           times; 3 `make_halo_train_step` steps at gp=2 on the training
           batch against the training golden file, rows 8 and 9 launching
           5 times a step each, 2 inverse neighbour lists a step and no
           exchange table built (they are built once a batch), two steps
           from one state bit-equal; the halo forward's and step's times
           beside the dense ones in turns, a device profile of each, and the
           halo bytes a layer against a full gather
  times    each kernel's device time (CUDA-graph replays between CUDA
           events) beside its plain version, its bound and a PyTorch library
           call where one exists, and its eager per-call time (the attention
           forward at the serving and the training shapes, and each
           attention combine pass apart as a row of its own; the attention
           backward also as a whole, port, plain and SDPA alike: forward and
           backward in one CUDA graph less the forward); the
           per-request latency after warm-up; a profiler breakdown of one
           forward (device busy and idle share, top kernels)
Then one line with the kernel table, the card's name and power limit as
nvidia-smi gives them, and the result line. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
WARMUP_BUCKETS = (512, 1024)
LAYERS, SIDES = 5, 2
# Kernel vs plain version, both f32 FMA on the card, other summation order.
EDGE_TOL = dict(rtol=1e-4, atol=1e-4)
ATT_TOL = dict(rtol=1e-4, atol=1e-4)
# Backward kernels vs autograd through the plain forwards, per gradient
# tensor: ||kernel - plain|| <= tol ||plain||. Attention is smooth: f32
# rounding in another order gives about 1e-6. The edge step is not: an edge
# whose pre-activation lies within rounding of 0 takes the other branch of
# LeakyReLU's derivative in one of the two, which moves that edge's
# cotangents by up to 99%; at 51 200 edges with trained weights a few do.
# Readings on an H100: 1.0e-4 and 3.0e-4 in two sound runs; 1.2e-2 (d_src)
# for a kernel that leaves out the distance term of dgx. So 1e-3, norm-wise.
BWD_REL_TOL = {"edge_message_bwd": 1e-3, "cross_attention_dq": 1e-5,
               "cross_attention_dkv": 1e-5, "softmin_field_bwd": 1e-5}
# Soft-min field sums, kernel (direct x - a, sequential sums per tile) vs
# plain (cuBLAS-free elementwise, pairwise sums): f32 rounding only.
SOFTMIN_TOL = dict(rtol=1e-5, atol=1e-4)
SIGMA = 25.0            # the DB5 model's intersection_sigma
# The fused-intersection step against the unfused one on the card: loss
# terms and gradient norms, relative.
FUSED_RTOL = 1e-4
TRAIN_STEPS = 3         # checked against the training golden file
TIMED_STEPS = 10        # after 2 warm-up steps
# Row 9 against autograd through the ring composition on the card (its
# gather transposes add with atomics): f32 sums of a few terms in another
# order, norm-wise per tensor.
HALO_BWD_REL_TOL = 1e-6
# Served outputs vs the JAX package on the CPU (tests/test_torch_serve.py
# holds the port's CPU path to the same numbers): R unitless, t and CA in A.
GOLDEN_ATOL = {"R": 1e-3, "t": 1e-2, "ca": 1e-2}
# H100 SXM peaks (data sheet, 700 W): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=20, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20, trials: int = 15) -> float:
    """Median device time of one call, in ms: `reps` calls captured in a CUDA
    graph and replayed between CUDA events, so host overhead is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def call_ms(fn, iters: int = 50) -> float:
    """Time per eager call, in ms, over back-to-back calls: host overhead
    included, as the serving path pays it."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(run, reps: int, top: int = 8) -> dict:
    """Device busy time of `reps` warm calls of `run` (torch.profiler,
    CUPTI) against their wall time, the device ops that take the most of
    it, and the time of the batched SVD kernels (by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:90]
            ms, n = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + e.time_range.elapsed_us() / 1e3 / reps, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    svd = sum(ms for k, (ms, _) in by_name.items()
              if any(w in k.lower() for w in ("svd", "gesvd", "jacobi")))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if by_name else None,
            "device_ops_per_call": sum(n for _, n in by_name.values()) / reps,
            "svd_device_ms": svd, "svd_device_share": svd / busy if busy else None,
            "top_device_ms": [[k, round(ms, 4), n // reps] for k, (ms, n) in ranked]}


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def check_close(name, got, want, tol) -> float:
    for g, w in zip(got, want):
        require(torch.isfinite(g).all().item(), f"{name}: non-finite kernel output")
        require(torch.allclose(g, w, **tol),
                f"{name}: kernel vs plain max abs err {max_err(got, want):.3g} "
                f"outside {tol}")
    return max_err(got, want)


def synced(name: str) -> None:
    """Synchronise right after a launch: a fault the card reports names the
    kernel that ran last."""
    try:
        torch.cuda.synchronize()
    except RuntimeError as e:
        raise SmokeFailure(f"{name}: the card reported a fault after its launch: {e}") from e


GUARD = 1024    # NaN floats before and after each guarded output


def guarded(shapes, dev):
    """(buffers, views): each view a contiguous tensor of its shape inside a
    buffer with GUARD NaN floats before and after it."""
    bufs = [torch.full((2 * GUARD + int(np.prod(s)),), float("nan"), device=dev)
            for s in shapes]
    return bufs, [b[GUARD:GUARD + int(np.prod(s))].view(s) for b, s in zip(bufs, shapes)]


def require_guards(name: str, bufs) -> None:
    """After a synchronised launch: no float outside its outputs written."""
    for i, b in enumerate(bufs):
        require(bool(torch.isnan(b[:GUARD]).all()) and bool(torch.isnan(b[-GUARD:]).all()),
                f"{name}: the launch wrote outside output {i}")


# --------------------------------------------------------------------------- #
# Kernel cases at the serving shapes
# --------------------------------------------------------------------------- #

def edge_cases(params, dev):
    """Edge-message inputs as the main path builds them (trained weights of
    the shared layer, a kNN graph padded to its bucket, masked edges)."""
    from equidock_public_tpu_torch.data.featurize import ProteinGraph
    from equidock_public_tpu_torch.data.synth import synth_graph
    from equidock_public_tpu_torch.graph import pad_protein
    from equidock_public_tpu_torch.models.iegmn import edge_kernel_inputs

    cases = []
    for n_valid, N in ((431, 512), (548, 1024)):
        rng = np.random.default_rng(N)
        d = synth_graph(rng, n_valid, 10)
        d["nbr_mask"] = (rng.uniform(size=d["nbr_mask"].shape) > 0.2).astype(np.float32)
        g = pad_protein(ProteinGraph(res_id=d["res_id"], x=d["x"], mu_r_norm=d["mu_r_norm"],
                                     nbr=d["nbr"], nbr_mask=d["nbr_mask"],
                                     edge_feat=d["edge_feat"] * d["nbr_mask"][..., None]), N)
        T = lambda a: torch.from_numpy(a)[None].to(dev).contiguous()
        h = torch.from_numpy(rng.standard_normal((1, N, 64)).astype(np.float32)).to(dev)
        src, dst, kp = edge_kernel_inputs(params["original"]["rest"], T(g["x"]), h,
                                          T(g["edge_feat"]))
        cases.append(dict(shape=f"B=1 N={N} ({n_valid} valid) K=10 D=64 E=27",
                          args=(src, dst, T(g["edge_feat"]), T(g["nbr"]), T(g["nbr_mask"]), kp)))
    return cases


def attention_cases(dev):
    """Forward cases (shape, args = (q, k, v, q_tag, k_tag), timed): unpadded
    172x548 with masked rows, the bucketed 512x1024 at the layer widths (69
    in layer 0, 64 after), packed-segment tags, the training batch (B=10,
    512x512, 70-274 valid nodes a side) at both widths, and the edges of the
    kernel's 64-row tiles: N and M not multiples of 64 (300 x 1000), a
    complex whose query rows are all padded, query rows whose tag meets no
    key, and rows whose kept logits all lie below -896."""
    gen = torch.Generator().manual_seed(0)
    cases = []

    def add(shape, q, k, v, qt, kt, timed):
        cases.append(dict(shape=shape, timed=timed,
                          args=tuple(x.to(dev).contiguous() for x in (q, k, v, qt, kt))))

    for N, M, nq, nk, D, tags in ((172, 548, 160, 530, 64, False),
                                  (512, 1024, 172, 548, 64, False),
                                  (512, 1024, 172, 548, 69, False),
                                  (172, 548, 172, 548, 64, True)):
        q, k, v = (torch.randn(1, n, D, generator=gen) for n in (N, M, M))
        qt = torch.zeros(1, N)
        kt = torch.zeros(1, M)
        qt[:, :nq] = 1
        kt[:, :nk] = 1
        if tags:
            qt *= torch.randint(1, 4, (1, N), generator=gen)
            kt *= torch.randint(1, 4, (1, M), generator=gen)
        add(f"B=1 N={N} ({nq} valid) M={M} ({nk} valid) D=Dv={D}" + (" tagged" if tags else ""),
            q, k, v, qt, kt, True)
    for D in (64, 69):      # the training batch, layers 1-4 and layer 0
        rng = np.random.default_rng(D)
        q, k = (torch.randn(10, 512, D, generator=gen) * 0.3 for _ in range(2))
        v = torch.randn(10, 512, D, generator=gen)
        add(f"B=10 N=M=512 D=Dv={D} (70-274 valid a side)", q, k, v,
            training_tags(rng, 10, 512), training_tags(rng, 10, 512), True)
    rand = lambda B, N, D=64: torch.randn(B, N, D, generator=gen)
    valid = lambda B, N, n: (torch.arange(N)[None] < n).float().expand(B, N).contiguous()
    add("B=2 N=300 (250 valid) M=1000 (900 valid) D=Dv=64", rand(2, 300), rand(2, 1000),
        rand(2, 1000), valid(2, 300, 250), valid(2, 1000, 900), False)
    qt = valid(2, 200, 150)
    qt[1] = 0
    add("B=2 N=200 M=548 (500 valid) D=Dv=64, complex 1 all query rows padded",
        rand(2, 200), rand(2, 548), rand(2, 548), qt, valid(2, 548, 500), False)
    qt = valid(1, 200, 150) * torch.randint(1, 4, (1, 200), generator=gen)
    qt[:, :50] = 4
    kt = valid(1, 548, 500) * torch.randint(1, 4, (1, 548), generator=gen)
    add("B=1 N=200 M=548 D=Dv=64 tagged, rows 0-49 tag 4 (no key has it)",
        rand(1, 200), rand(1, 548), rand(1, 548), qt, kt, False)
    q, k = rand(1, 200), rand(1, 548)
    q[:, :40] = 4.0
    k[:, :500] = -4.0
    add("B=1 N=200 (150 valid) M=548 (500 valid) D=Dv=64, rows 0-39 keep only q.k = -1024",
        q, k, rand(1, 548), valid(1, 200, 150), valid(1, 548, 500), False)
    return cases


def check_empty_rows(name, args, out) -> dict:
    """Rows that keep no key average all M values, with lse = -1000 + log M
    (M not a multiple of the 64-row tile included: keys past M are left
    out). lse within 1e-4 (f32 spacing near 1000 is 6.1e-5)."""
    q, k, v, qt, kt = args
    o, lse = out
    empty = ~((qt[:, :, None] > 0) & (qt[:, :, None] == kt[:, None, :])).any(-1)
    if not empty.any():
        return {"empty_rows": 0}
    M = k.shape[1]
    want_lse = -1000.0 + float(np.log(M))
    lse_err = float((lse[empty].double() - want_lse).abs().max())
    require(lse_err <= 1e-4, f"{name}: lse of rows that keep no key off by {lse_err:.3g}")
    mean = v.mean(1, keepdim=True).expand_as(o)[empty]
    require(torch.allclose(o[empty], mean, **ATT_TOL),
            f"{name}: rows that keep no key are not the mean of all {M} values")
    return {"empty_rows": int(empty.sum()), "empty_lse_max_abs_err": lse_err,
            "empty_o_max_abs_err": float((o[empty] - mean).abs().max())}


def edge_cost(src, dst, he, nbr, msk, kp, out):
    """Bytes each input read once and each output written once; f32
    operations of the products for the edges this data holds (masked edges
    contribute nothing and need no work)."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (src, dst, he, nbr, msk, *kp.values(), *out))
    D, E = src.shape[-1] - 3, he.shape[-1]
    per_edge = 2 * (E * D + 15 * D + 2 * D * D + D)
    return nbytes, float(msk.sum()) * per_edge


def attention_cost(q, k, v, qt, kt, out):
    """Bytes each input and output once; the two products over the
    (query, key) pairs the masks keep, plus the plain mean over all M values
    for rows that keep no key."""
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, qt, kt, *out))
    mask = (qt[:, :, None] > 0) & (qt[:, :, None] == kt[:, None, :])
    pairs = float(mask.sum())
    empty = float((~mask.any(-1)).sum())
    D, Dv, M = q.shape[-1], v.shape[-1], k.shape[1]
    return nbytes, 2 * pairs * (D + Dv) + empty * M * Dv


# (name, module under ops/cuda, launch-counter attribute, source, TPU kernel
# it replaces, the path whose launches the kernel table reports)
KERNELS = (
    ("edge_message", "edge_message", "launches", "csrc/edge_message.cu",
     "ops/pallas/edge_message.py:70", "serve"),
    ("edge_message_bwd", "edge_message", "bwd_launches", "csrc/edge_message_bwd.cu",
     "ops/pallas/edge_message.py:131", "train"),
    ("cross_attention", "cross_attention", "launches", "csrc/cross_attention.cu",
     "ops/pallas/cross_attention.py:43", "serve"),
    ("cross_attention_dq", "cross_attention", "dq_launches", "csrc/cross_attention_bwd.cu",
     "ops/pallas/cross_attention.py:84", "train"),
    ("cross_attention_dkv", "cross_attention", "dkv_launches", "csrc/cross_attention_bwd.cu",
     "ops/pallas/cross_attention.py:104", "train"),
    ("softmin_field", "softmin_field", "launches", "csrc/softmin_field.cu",
     "ops/pallas/softmin_field.py:26", "epoch"),
    ("softmin_field_bwd", "softmin_field", "bwd_launches", "csrc/softmin_field.cu",
     "ops/pallas/softmin_field.py:38", "epoch"),
    ("halo_exchange", "halo_ring", "launches", "csrc/halo_ring.cu",
     "parallel/pallas_halo.py:122", "halo_train"),
    ("halo_exchange_bwd", "halo_ring", "bwd_launches", "csrc/halo_ring.cu",
     "parallel/pallas_halo.py:133", "halo_train"),
)
# The edge backward's second kernel (d_src in a fixed order, csrc/
# edge_message_bwd.cu), launched once with each backward: counted apart and
# required to match row 2's launches on every path.
SCATTER = ("edge_message", "scatter_launches")
# Inverse neighbour lists built (ops/cuda/edge_message.py, any device): one
# per side per forward that records gradients, on every path (the model
# shares each across its layers and the backward's scatters), none in a
# forward without gradients. The halo exchange's own tables and their
# inverses are built on the host once per batch (`halo_tables`).
INVERSE = ("edge_message", "inverse_builds", "edge_inverse_builds")
HALO_TABLES = ("halo", "table_builds", "halo_tables")
PER_STEP_INVERSE = SIDES
# The second passes of rows 3-5 (csrc/cross_attention.cu,
# csrc/cross_attention_bwd.cu): the merges of their splits, launched once
# with each forward, each dQ and each dK/dV, counted apart and required to
# match (module, counter attribute, name, the row whose launches it
# matches). Each is a row of the kernel table too.
COMBINES = (("cross_attention", "combine_launches", "cross_attention_combine",
             "cross_attention"),
            ("cross_attention", "dq_combine_launches", "cross_attention_dq_combine",
             "cross_attention_dq"),
            ("cross_attention", "dkv_combine_launches", "cross_attention_dkv_combine",
             "cross_attention_dkv"))
# Launches a training step makes of each kernel (5 layers x 2 sides; the
# soft-min field kernels once a direction) and a forward without gradient.
PER_STEP = {"edge_message": 10, "edge_message_bwd": 10, "cross_attention": 10,
            "cross_attention_dq": 10, "cross_attention_dkv": 10}
PER_STEP_FUSED = dict(PER_STEP, softmin_field=2, softmin_field_bwd=2)
PER_EVAL_FUSED = {"edge_message": 10, "cross_attention": 10, "softmin_field": 2}


def kernel_counters():
    """(module, launch-counter attribute, kernel name) of every kernel, of
    the edge backward's scatter, of the inverse lists and halo tables built
    and of the attention kernels' combine passes."""
    mod = lambda name: importlib.import_module(f"equidock_public_tpu_torch.ops.cuda.{name}")
    halo = importlib.import_module("equidock_public_tpu_torch.parallel.halo")
    return (tuple((mod(m), attr, name) for name, m, attr, *_ in KERNELS)
            + ((mod(SCATTER[0]), SCATTER[1], "edge_message_scatter"),
               (mod(INVERSE[0]), INVERSE[1], INVERSE[2]),
               (halo, HALO_TABLES[1], HALO_TABLES[2]))
            + tuple((mod(m), attr, name) for m, attr, name, _ in COMBINES))


def expect_combines(what: str, counts: dict) -> None:
    """Each forward, dQ and dK/dV launched its combine pass once."""
    for _, _, name, row in COMBINES:
        require(counts[name] == counts[row],
                f"{what}: {name} launched {counts[name]} times for {counts[row]} {row}")


def reset_counts() -> None:
    for mod, attr, _ in kernel_counters():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for mod, attr, name in kernel_counters()}


def expect_counts(what: str, counts: dict, steps: int, evals: int, fused: bool) -> None:
    """Each kernel launched exactly as `steps` training steps and `evals`
    forwards without gradient make it, the scatter once per backward, and
    one inverse neighbour list built per side per step (none for the
    forwards without gradient)."""
    per_step = PER_STEP_FUSED if fused else PER_STEP
    per_eval = PER_EVAL_FUSED if fused else {"edge_message": 10, "cross_attention": 10}
    for name, *_ in KERNELS:
        want = per_step.get(name, 0) * steps + per_eval.get(name, 0) * evals
        require(counts[name] == want, f"{what}: {name} launched {counts[name]} times, "
                                      f"expected {want} ({steps} steps, {evals} forwards)")
    require(counts["edge_message_scatter"] == counts["edge_message_bwd"],
            f"{what}: the edge backward's scatter launched {counts['edge_message_scatter']} "
            f"times for {counts['edge_message_bwd']} backwards")
    require(counts[HALO_TABLES[2]] == 0, f"{what}: halo exchange tables built on a dense path")
    want = PER_STEP_INVERSE * steps
    require(counts[INVERSE[2]] == want, f"{what}: {counts[INVERSE[2]]} inverse neighbour "
                                        f"lists built, expected {want}")
    expect_combines(what, counts)


def rel_err(got, want) -> float:
    return float((got - want).norm()) / max(float(want.norm()), 1e-30)


def check_grads(kernel, shape, got, want) -> dict:
    """Norm-wise check of each gradient tensor; (max abs err, worst rel err)."""
    errs, tol = [], BWD_REL_TOL[kernel]
    for i, (g, w) in enumerate(zip(got, want)):
        require(torch.isfinite(g).all().item(), f"{kernel} {shape} [{i}]: non-finite gradient")
        errs.append(rel_err(g, w))
        require(errs[-1] <= tol, f"{kernel} {shape} [{i}]: relative error {errs[-1]:.3g} > {tol}")
    return {"max_abs_err": max_err(got, want), "rel_err": max(errs)}


def training_tags(rng, B, N):
    """0/1 node masks of B split-chain halves (70 to 274 valid nodes)."""
    tags = np.zeros((B, N), np.float32)
    for b in range(B):
        tags[b, :rng.integers(70, 275)] = 1
    return torch.from_numpy(tags)


def attention_bwd_cases(dev, B=10, N=512):
    """(q, k, v, q_tag, k_tag, o, lse, dout, delta) at the training shapes:
    bs 10, 512x512, widths 64 and 69 (layer 0)."""
    cases = []
    for D in (64, 69):
        rng = np.random.default_rng(D)
        gen = torch.Generator().manual_seed(D)
        q, k, v, do = (torch.randn(B, N, D, generator=gen) * s for s in (0.3, 0.3, 1, 1))
        qt, kt = training_tags(rng, B, N), training_tags(rng, B, N)
        q, k, v, qt, kt, do = (x.to(dev).contiguous() for x in (q, k, v, qt, kt, do))
        from equidock_public_tpu_torch.ops.cuda import cross_attention as ca
        o, lse = ca.cross_attention_plain(q, k, v, qt, kt)
        delta = (do * o).sum(-1).contiguous()
        cases.append(dict(shape=f"B={B} N=M={N} D=Dv={D} (70-274 valid a side)",
                          args=(q, k, v, qt, kt, o.contiguous(), lse.contiguous(), do),
                          delta=delta))
    return cases


def attention_dq_cases(dev, a_cases):
    """dQ inputs (q, k, v, q_tag, k_tag, o, lse, dout) at every forward case
    (the 64-row tiles' edges included) and at the card tests' other widths
    (D 16, D 32 with Dv 20, D 96 with Dv 3). Where every key row is the
    same vector (the kept logits below -896), sum_m ds = 0 on a row whose
    kept weights sum to one, so dQ = sum_m ds k is zero in exact arithmetic
    there and any f32 result is rounding noise: those key rows get noise of
    zero sum over the channels, which keeps q.k = -1024 on the constant
    query rows."""
    from equidock_public_tpu_torch.ops.cuda import cross_attention as ca

    gen = torch.Generator().manual_seed(5)
    inputs = [(c["shape"], c["args"]) for c in a_cases]
    for B, N, M, D, Dv in ((2, 9, 40, 16, 16), (2, 40, 100, 32, 20), (2, 33, 70, 96, 3)):
        qt, kt = torch.ones(B, N), torch.ones(B, M)
        qt[:, N // 3:] = 0
        kt[0, M // 2:] = 0
        inputs.append((f"B={B} N={N} M={M} D={D} Dv={Dv}",
                       tuple(x.to(dev) for x in (torch.randn(B, N, D, generator=gen) * 0.3,
                                                 torch.randn(B, M, D, generator=gen) * 0.3,
                                                 torch.randn(B, M, Dv, generator=gen), qt, kt))))
    cases = []
    for shape, (q, k, v, qt, kt) in inputs:
        if "-1024" in shape:
            z = torch.randn(k.shape, generator=gen).to(dev)
            k = (k + (z - z.mean(-1, keepdim=True)) * (k == -4.0).all(-1, keepdim=True))
        o, lse = ca.cross_attention_plain(q, k, v, qt, kt)
        do = torch.randn(o.shape, generator=gen).to(dev)
        cases.append(dict(shape=shape, args=tuple(x.contiguous() for x in
                                                  (q, k, v, qt, kt, o, lse, do))))
    return cases


def combine_case(name, ca, a_case, ab_case):
    """(shape, partials, kernel, plain version, library call or None) of a
    combine pass at its row's main-path shape: the partials its row's kernel
    writes there. A sum over the splits (dQ) is one PyTorch call."""
    if name == "cross_attention_combine":
        return (a_case["shape"], ca.fwd_partials(*a_case["args"]), ca.fwd_combine,
                ca.fwd_combine_plain, None)
    q, k, v, qt, kt, o, lse, do = ab_case["args"]
    args = (q, k, v, qt, kt, lse, do, ab_case["delta"])
    if name == "cross_attention_dq_combine":
        return (ab_case["shape"], (ca.dq_partials(*args),), ca.dq_combine, ca.split_sum_plain,
                lambda p: torch.sum(p, dim=1))
    return ab_case["shape"], ca.dkv_partials(*args), ca.dkv_combine, ca.split_sum_plain, None


def edge_bwd_case(params, dev, B=10, N=512):
    """Edge-message backward inputs at the training shape: B kNN graphs of
    70-274 valid nodes padded to 512, trained weights of the shared layer,
    random output cotangents."""
    from equidock_public_tpu_torch.data.featurize import ProteinGraph
    from equidock_public_tpu_torch.data.synth import synth_graph
    from equidock_public_tpu_torch.graph import pad_protein
    from equidock_public_tpu_torch.models.iegmn import edge_kernel_inputs

    rng = np.random.default_rng(5)
    sides = []
    for _ in range(B):
        d = synth_graph(rng, int(rng.integers(70, 275)), 10)
        sides.append(pad_protein(ProteinGraph(
            res_id=d["res_id"], x=d["x"], mu_r_norm=d["mu_r_norm"], nbr=d["nbr"],
            nbr_mask=d["nbr_mask"], edge_feat=d["edge_feat"]), N))
    T = lambda key: torch.from_numpy(np.stack([g[key] for g in sides])).to(dev).contiguous()
    h = torch.from_numpy(rng.standard_normal((B, N, 64)).astype(np.float32)).to(dev)
    he = T("edge_feat")
    src, dst, kp = edge_kernel_inputs(params["original"]["rest"], T("x"), h, he)
    ga = torch.from_numpy(rng.standard_normal((B, N, 64)).astype(np.float32)).to(dev)
    gx = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32)).to(dev)
    return dict(shape=f"B={B} N={N} (70-274 valid) K=10 D=64 E=27",
                args=(src, dst, he, T("nbr"), T("nbr_mask"), kp), grads=(ga, gx))


def edge_tile_cases(dev):
    """The edge kernels at the edges of their tiles of 64 // K nodes: N = 300
    (not a multiple of 6 nodes), graph 1 all padded (every tile of it has
    masks 0), graph 2 partly, a source wider than the destinations
    (Nsrc = 337), at D 64 and 16; random inputs and parameters, masks 0.2
    of a valid node's edges, random output cotangents."""
    from equidock_public_tpu_torch.ops.cuda import edge_message as em

    cases = []
    for D in (64, 16):
        rng = np.random.default_rng(300 + D)
        B, N, Nsrc, K, E = 3, 300, 337, 10, 27
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        src, dst = f(B, Nsrc, 3 + D), f(B, N, 3 + D)
        src[..., :3] *= 8
        dst[..., :3] *= 8
        msk = torch.from_numpy((rng.uniform(size=(B, N, K)) > 0.2).astype(np.float32))
        msk[0, 250:] = 0
        msk[1] = 0
        msk[2, 131:] = 0
        nbr = torch.from_numpy(rng.integers(0, Nsrc, (B, N, K)).astype(np.int32))
        he = f(B, N, K, E) * msk[..., None]
        kp = {k: (f(*s) * 0.3).to(dev) for k, s in em.param_shapes(D, E).items()}
        cases.append(dict(shape=f"B={B} N={N} (250, 0, 131 valid) Nsrc={Nsrc} K={K} D={D} E={E}",
                          args=tuple(x.to(dev).contiguous() for x in (src, dst, he, nbr, msk))
                          + (kp,), grads=(f(B, N, D).to(dev), f(B, N, 3).to(dev))))
    return cases


def check_edge_case(c, slope) -> dict:
    """Rows 1 and 2 at one case against their plain versions: the forward
    (EDGE_TOL, its tile flags bit-equal to tile_keep's) and, where the case
    has cotangents, the backward on those flags (norm-wise) and its d_src
    scatter (against index_add_); each kernel's launch into guarded outputs,
    and two launches bit-equal."""
    from equidock_public_tpu_torch.ops.cuda import edge_message as em

    a, name = c["args"], c["shape"]
    B, N, K = a[3].shape
    D, E = a[0].shape[-1] - 3, a[2].shape[-1]
    tn = em.edge_tile_plan(B, N, D, K)[0]
    bufs, views = guarded([(B, N, D), (B, N, 3)], a[0].device)
    kept = torch.full((em.n_tiles(B, N, tn),), 7, dtype=torch.uint8, device=a[0].device)
    got = em._launch_fwd(*a, slope, True, True, out=views, kept=kept)
    synced(f"edge_message {name}")
    require_guards(f"edge_message {name}", bufs)
    require(torch.equal(kept, em.tile_keep(a[4], tn)),
            f"edge_message {name}: the tile flags differ from tile_keep's")
    want = em.edge_message_plain(*a, slope=slope)
    out = {"shape": name, "max_abs_err": check_close(f"edge_message {name}", got, want, EDGE_TOL)}
    again = em.edge_message_aggregate(*a, slope=slope)
    require(all(torch.equal(x, y) for x, y in zip(got, again)),
            f"edge_message {name}: two launches on the same inputs differ")
    if "grads" not in c:
        return out
    flat = lambda r: [*r[:3], *(r[3][n] for n in em.PARAM_NAMES)]
    got = em.edge_message_bwd(*a, *c["grads"], slope=slope)
    synced(f"edge_message_bwd {name}")
    want = em.edge_message_bwd_plain(*a, *c["grads"], slope=slope)
    out["bwd"] = check_grads("edge_message_bwd", name, flat(got), flat(want))
    blocks = em.edge_tile_plan(B, N, D, K)[1]
    bufs, views = guarded(em.bwd_output_shapes(B, N, K, D, E, blocks), a[0].device)
    raw = em.edge_message_bwd_kernel(*a, *c["grads"], slope=slope, out=views, kept=kept)
    synced(f"edge_message_bwd {name}")
    require_guards(f"edge_message_bwd {name}", bufs)
    nbr, nsrc = a[3], a[0].shape[1]
    out["scatter_max_abs_err"] = check_close(
        f"edge_message scatter {name}", [em.scatter_src(nbr, nsrc, *raw[:2])],
        [em.scatter_src_plain(nbr, nsrc, *raw[:2])], EDGE_TOL)
    again = em.edge_message_bwd(*a, *c["grads"], slope=slope)
    require(all(torch.equal(x, y) for x, y in zip(flat(got), flat(again))),
            f"edge_message_bwd {name}: two launches on the same inputs differ")
    return out


def nbytes_of(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def exchange_nbytes(sides, outs, backward: bool) -> int:
    """Bytes one launch of row 8 or 9 must move over its sides, each output
    once and each input once. Forward: x, h and the table. Backward: the
    inverse (order, offsets) and only the cotangent rows some slot reads
    (one a listed slot; the chain ends' zero slots are never read)."""
    total = nbytes_of(*(a for o in outs for a in o))
    for a, b, t in sides:
        if backward:
            row = (a.shape[-1] + b.shape[-1]) * a.element_size()
            total += t.order.numel() * row + nbytes_of(t.order, t.offsets)
        else:
            total += nbytes_of(a, b, t.src_row)
    return total


def library_gathers(sides, grads):
    """The library yardsticks of rows 8 and 9 on the same inputs: (forward,
    backward) callables, `index_select` of each of the 4 tensors (x and h
    of both sides) over its rows with a zero row appended beforehand, and
    `torch.zeros` + `index_add_` (atomics) of the 4 cotangents, by the
    folded index of the tables."""
    from equidock_public_tpu_torch.ops.cuda import halo_ring as hr

    fwd, bwd = [], []
    for (x, h, t), (gx, gh, _) in zip(sides, grads):
        Bp, S, _, Ssrc, gp, _ = t.dims
        idx = hr._table_to_folded(hr.gather_index(t).reshape(Bp // gp, gp, Ssrc), t).reshape(-1)
        for a, g in ((x, gx), (h, gh)):
            ext = torch.cat([a.reshape(Bp * S, -1), a.new_zeros(1, a.shape[-1])])
            fwd.append((ext, idx))
            bwd.append((g.reshape(Bp * Ssrc, -1), idx, Bp * S + 1))
    return (lambda: [ext.index_select(0, idx) for ext, idx in fwd],
            lambda: [torch.zeros(n, g.shape[-1], device=g.device).index_add_(0, idx, g)
                     for g, idx, n in bwd])


def edge_bwd_cost(src, dst, he, nbr, msk, kp, ga, gx):
    """Bytes: each input once, and each output of the function (d_src, d_dst,
    d_he, the parameter gradients) once. Operations: the recompute and the
    walk back for each unmasked edge (masked edges have zero cotangents)."""
    D, E = src.shape[-1] - 3, he.shape[-1]
    params = nbytes_of(*kp.values())
    nbytes = (nbytes_of(src, dst, he, nbr, msk, ga, gx) + params
              + nbytes_of(src, dst, he) + params)
    recompute = 2 * (E * D + 15 * D + 2 * D * D + D)
    walk_back = 2 * (4 * D * D + 2 * E * D + 2 * 15 * D + 3 * D)
    return nbytes, float(msk.sum()) * (recompute + walk_back)


def attention_bwd_cost(part, q, k, v, qt, kt, o, lse, do):
    """dq: per kept (query, key) pair the logit, do . v and ds k. dkv: the
    logit, do . v, ds q and w do per kept pair, plus w do for every key of a
    query row that keeps none (w = 1/M there; elsewhere masked pairs have
    w = 0 in f32)."""
    mask = (qt[:, :, None] > 0) & (qt[:, :, None] == kt[:, None, :])
    pairs = float(mask.sum())
    empty = float((~mask.any(-1)).sum())
    D, Dv, M = q.shape[-1], v.shape[-1], k.shape[1]
    ins = nbytes_of(q, k, v, qt, kt, lse, do) + lse.numel() * 4     # + delta
    if part == "dq":
        return ins + q.numel() * 4, 2 * pairs * (2 * D + Dv)
    return ins + (k.numel() + v.numel()) * 4, 2 * pairs * (2 * D + 2 * Dv) + 2 * empty * M * Dv


def backward_ms(fn_out, inputs, grad_out) -> float:
    """Time of one backward through an autograd graph built once outside
    (retain_graph), over back-to-back eager calls between CUDA events:
    autograd launches a backward on its forward's stream, so it cannot be
    captured in a CUDA graph on another."""
    return call_ms(lambda: torch.autograd.grad(fn_out, inputs, grad_out, retain_graph=True),
                   iters=20)


def sdpa_bwd_ms(q, k, v, qt, kt, do):
    """The eager time of the library yardstick of rows 4 and 5: the backward
    of scaled_dot_product_attention (scale 1, additive mask) for dq, dk and
    dv together, host work included; (ms, None) or (None, reason)."""
    keep = (qt[:, :, None] > 0) & (qt[:, :, None] == kt[:, None, :])
    add_mask = torch.where(keep, 0.0, -1000.0)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    try:
        o = F.scaled_dot_product_attention(*leaves, attn_mask=add_mask, scale=1.0)
        return backward_ms(o, leaves, do), None
    except RuntimeError as e:   # a yardstick only: the port never calls SDPA
        return None, f"no f32 masked SDPA backward here: {str(e)[:120]}"


def graph_backward_ms(forward, inputs, grad_out) -> float:
    """Device time of one backward: `forward(leaves)` and its backward for
    dq, dk and dv captured together in a CUDA graph (device_ms), less the
    forward alone. Host work (autograd's engine, Python) is left out, as it
    is for the kernel rows. The leaves are made here: a leaf that an earlier
    autograd graph still holds keeps its gradient node on the stream that
    graph ran on, which a capture on another stream cannot wait for."""
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    both = device_ms(lambda: torch.autograd.grad(forward(leaves), leaves, grad_out))
    return both - device_ms(lambda: forward(leaves))


def sdpa_graph_bwd_ms(q, k, v, qt, kt, do):
    """graph_backward_ms of scaled_dot_product_attention (scale 1, additive
    mask): (ms, None) or (None, reason)."""
    keep = (qt[:, :, None] > 0) & (qt[:, :, None] == kt[:, None, :])
    add_mask = torch.where(keep, 0.0, -1000.0)
    try:
        return graph_backward_ms(lambda l: F.scaled_dot_product_attention(
            *l, attn_mask=add_mask, scale=1.0), (q, k, v), do), None
    except RuntimeError as e:   # a yardstick only: the port never calls SDPA
        return None, f"no f32 masked SDPA backward in a CUDA graph here: {str(e)[:120]}"


def edge16_case(dev, B=10, N=512):
    """Edge-message inputs at D = 16 (the small DB5 models' width): B kNN
    graphs of 70-274 valid nodes padded to N, random parameters of
    param_shapes(16, 27), random output cotangents."""
    from equidock_public_tpu_torch.data.synth import synth_graph
    from equidock_public_tpu_torch.graph import pad_protein
    from equidock_public_tpu_torch.data.featurize import ProteinGraph
    from equidock_public_tpu_torch.ops.cuda import edge_message as em

    rng = np.random.default_rng(16)
    sides = []
    for _ in range(B):
        d = synth_graph(rng, int(rng.integers(70, 275)), 10)
        sides.append(pad_protein(ProteinGraph(
            res_id=d["res_id"], x=d["x"], mu_r_norm=d["mu_r_norm"], nbr=d["nbr"],
            nbr_mask=d["nbr_mask"], edge_feat=d["edge_feat"]), N))
    T = lambda key: torch.from_numpy(np.stack([g[key] for g in sides])).to(dev).contiguous()
    R = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    x = T("x")
    src = torch.cat([x, R(B, N, 16)], dim=-1).contiguous()
    dst = torch.cat([x, R(B, N, 16)], dim=-1).contiguous()
    kp = {k: R(*shape) * 0.3 for k, shape in em.param_shapes(16, 27).items()}
    return dict(shape=f"B={B} N={N} (70-274 valid) K=10 D=16 E=27",
                args=(src, dst, T("edge_feat"), T("nbr"), T("nbr_mask"), kp),
                grads=(R(B, N, 16), R(B, N, 3)))


def softmin_masks(rng, B, n, keep=0.6):
    """0/1 masks with holes: whole 32-point tiles dropped at random, single
    points dropped inside the others."""
    tiles = rng.uniform(size=(B, -(-n // 32))) < keep
    return (np.repeat(tiles, 32, axis=1)[:, :n]
            & (rng.uniform(size=(B, n)) > 0.3)).astype(np.float32)


def softmin_cases(dev):
    """(x, a, a_mask) and a cotangent c of S: the training shape (bs 10,
    512 x 512, masks of split-chain halves), a ragged one (70 x 130, not a
    multiple of a tile), the largest node bucket (3072 x 3072); then the
    edges of the kernels' tiles: masks with holes (whole key tiles and single
    points) at M != N, with one complex whose keys are all masked and one
    whose cotangent is all 0; a cotangent all 0; M = 1; N below one key
    tile."""
    rng = np.random.default_rng(6)
    cases = []
    for B, M, N, kind in ((10, 512, 512, "split-chain halves"), (2, 70, 130, "80% / 90% valid"),
                          (2, 3072, 3072, "80% / 90% valid"),
                          (3, 300, 700, "holes; complex 1 all keys masked, 2 no cotangent"),
                          (2, 200, 90, "80% / 90% valid, cotangent all 0"),
                          (2, 1, 200, "80% / 90% valid"), (2, 100, 20, "80% / 90% valid")):
        x = rng.standard_normal((B, M, 3)).astype(np.float32) * 15
        a = rng.standard_normal((B, N, 3)).astype(np.float32) * 15 + 5
        if M == 512:
            qm, am = training_tags(rng, B, M), training_tags(rng, B, N)
        elif kind.startswith("holes"):
            qm, am = softmin_masks(rng, B, M), softmin_masks(rng, B, N)
            am[1], qm[2] = 0, 0
        else:
            qm, am = torch.ones(B, M), torch.ones(B, N)
            qm[:, max(1, int(0.8 * M)):] = 0
            am[:, max(1, int(0.9 * N)):] = 0
        c = torch.from_numpy(rng.standard_normal((B, M)).astype(np.float32)) * qm
        if "cotangent all 0" in kind:
            c.zero_()
        T = lambda v: (v if isinstance(v, torch.Tensor) else torch.from_numpy(v)).to(dev)
        cases.append(dict(shape=f"B={B} M={M} N={N} ({kind})",
                          args=(T(x).contiguous(), T(a).contiguous(), T(am).contiguous()),
                          c=T(c).contiguous()))
    return cases


def check_softmin_case(c) -> None:
    """Rows 6 and 7 at one case against their plain versions (S at
    SOFTMIN_TOL, dx and dA norm-wise); each kernel's launch into guarded
    outputs, and two launches bit-equal. Fills c["err"] and c["check"]."""
    from equidock_public_tpu_torch.ops import softmin_field as sf
    from equidock_public_tpu_torch.ops.cuda import softmin_field as ksf

    (x, a, am), name = c["args"], c["shape"]
    B, M, N = x.shape[0], x.shape[1], a.shape[1]
    bufs, views = guarded([(B, M)], x.device)
    got = ksf.softmin_field_fwd(x, a, am, SIGMA, out=views)
    synced(f"softmin_field {name}")
    require_guards(f"softmin_field {name}", bufs)
    want = sf.softmin_field_sums_plain(x, a, am, SIGMA)
    c["err"] = check_close(f"softmin_field {name}", [got], [want], SOFTMIN_TOL)
    require(torch.equal(got, ksf.softmin_field_fwd(x, a, am, SIGMA)),
            f"softmin_field {name}: two launches on the same inputs differ")
    bufs, views = guarded([(B, M, 3), (B, N, 3)], x.device)
    got = ksf.softmin_field_bwd(x, a, am, c["c"], SIGMA, out=views)
    synced(f"softmin_field_bwd {name}")
    require_guards(f"softmin_field_bwd {name}", bufs)
    want = sf.softmin_field_bwd_plain(x, a, am, c["c"], SIGMA)
    c["check"] = check_grads("softmin_field_bwd", name, got, want)
    again = ksf.softmin_field_bwd(x, a, am, c["c"], SIGMA)
    require(all(torch.equal(g, h) for g, h in zip(got, again)),
            f"softmin_field_bwd {name}: two launches on the same inputs differ")


def softmin_cost(x, a, am, c=None):
    """Bytes: inputs once, outputs once. Operations per (query, valid key)
    pair: forward 12 (3 differences, the squared norm, the scale, the
    exponential, the masked add); backward, for pairs whose query has a
    non-zero cotangent, 17 in each of its two passes (the recompute and
    three multiply-adds)."""
    keys = am.sum(dim=1)
    if c is None:
        pairs = float((x.shape[1] * keys).sum())
        return nbytes_of(x, a, am) + x.shape[0] * x.shape[1] * 4, 12 * pairs
    pairs = float(((c != 0).sum(dim=1).to(keys.dtype) * keys).sum())
    return nbytes_of(x, a, am, c) + nbytes_of(x, a), 2 * 17 * pairs


@contextlib.contextmanager
def plain_versions():
    """The model's and the loss's kernel wrappers swapped for their plain
    PyTorch versions, autograd through them, on CUDA tensors: the yardstick
    a whole forward and step on the kernels are held to. No kernel launches
    inside."""
    from equidock_public_tpu_torch.models import iegmn
    from equidock_public_tpu_torch.ops import softmin_field as sf
    from equidock_public_tpu_torch.ops.cuda import cross_attention as ca
    from equidock_public_tpu_torch.ops.cuda import edge_message as em

    saved = (iegmn.edge_message_aggregate, ca.cross_attention_fwd, sf.softmin_field_sums)
    iegmn.edge_message_aggregate = (lambda *a, inverse=None, **kw:
                                    em.edge_message_plain(*a, **kw))
    ca.cross_attention_fwd = ca.cross_attention_plain
    sf.softmin_field_sums = sf.softmin_field_sums_plain
    try:
        yield
    finally:
        iegmn.edge_message_aggregate, ca.cross_attention_fwd, sf.softmin_field_sums = saved


def small_model_check(dev, batch, tol) -> dict:
    """A random 16-wide model of the db5_model_small config (2 unshared
    layers, 8 heads): a forward and a train step on the kernels against the
    same calls on the plain versions, on the card, at the training gate's
    tolerances (loss terms 1e-4, gradient norms 1e-3, parameter moves
    1e-3 + 3.5 lr)."""
    from equidock_public_tpu_torch.config import load_config
    from equidock_public_tpu_torch.params import flatten, init_params
    from equidock_public_tpu_torch.train.step import (create_train_state, eval_step,
                                                      loss_and_grads, train_step)

    cfg = load_config(os.path.join(REPO, "artifacts", "db5_model_small.config.json"))
    require(cfg.model.iegmn_lay_hid_dim == 16, "db5_model_small is not 16 wide")
    params = init_params(cfg.model, 0, dev)
    runs = {}
    for name, ctx in (("kernels", contextlib.nullcontext()), ("plain", plain_versions())):
        reset_counts()
        with ctx:
            ev = eval_step(params, batch, cfg)
            grads, _, _ = loss_and_grads(params, cfg, batch)
            state, m = train_step(create_train_state(params, cfg, dev), batch, cfg)
        runs[name] = dict(ev=ev, grads=grads, m=m, state=state, counts=read_counts())
    k, p = runs["kernels"], runs["plain"]
    require(sum(v for n, v in p["counts"].items() if n != INVERSE[2]) == 0,
            f"the plain run launched kernels: {p['counts']}")
    layers_sides = cfg.model.iegmn_n_lays * SIDES
    require(k["counts"]["edge_message"] == 3 * layers_sides
            and k["counts"]["edge_message_bwd"] == 2 * layers_sides
            and k["counts"][INVERSE[2]] == 2 * PER_STEP_INVERSE,
            f"16-wide model: kernel launches {k['counts']}")
    expect_combines("16-wide model", k["counts"])
    err = {}
    loss_keys = ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss")
    for what, rtol in (("ev", tol["loss_rtol_step1"]), ("m", tol["loss_rtol_step1"])):
        for key in loss_keys + (("grad_norm",) if what == "m" else ()):
            r = tol["grad_norm_rtol"] if key == "grad_norm" else rtol
            got, want = float(k[what][key]), float(p[what][key])
            e = abs(got - want) / max(abs(want), 1e-12)
            err[f"{what}.{key}"] = e
            require(e <= r or abs(got - want) <= tol["loss_atol"],
                    f"16-wide model {what} {key}: kernels {got:.7g}, plain {want:.7g}")
    worst = 0.0
    for key, g in k["grads"].items():
        got, want = float(g.norm()), float(p["grads"][key].norm())
        e = abs(got - want) / max(want, 1e-12)
        worst = max(worst, e)
        require(e <= tol["leaf_grad_norm_rtol"] or abs(got - want) <= 1e-6,
                f"16-wide model {key}: gradient norm {got:.6g}, plain {want:.6g}")
    p0 = flatten(params)
    atol = tol["delta_norm_atol_lr"] * cfg.train.lr
    for key, v in flatten(k["state"].params).items():
        got = float((v - p0[key]).norm())
        want = float((flatten(p["state"].params)[key] - p0[key]).norm())
        require(abs(got - want) <= tol["delta_norm_rtol"] * want + atol,
                f"16-wide model {key}: moved {got:.6g}, plain {want:.6g}")
    return {"config": "artifacts/db5_model_small.config.json (random weights, seed 0)",
            "launches": k["counts"], "rel_err": dict(err, leaf_grad_norm=worst)}


def timed_parts(step) -> dict:
    """One step with the Sinkhorn solve and the Kabsch fit (both forwards)
    timed on the host around synchronizations, and the host syncs the step
    makes (torch's sync debug mode, by the line that made them)."""
    import warnings

    from equidock_public_tpu_torch.ops import kabsch
    from equidock_public_tpu_torch.train import losses

    parts = {"sinkhorn_ms": 0.0, "kabsch_ms": 0.0}

    def timed(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[key] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    ot, fit = losses.pocket_ot_loss, kabsch.kabsch_from_covariance
    losses.pocket_ot_loss = timed(ot, "sinkhorn_ms")
    kabsch.kabsch_from_covariance = timed(fit, "kabsch_ms")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        parts["step_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        losses.pocket_ot_loss, kabsch.kabsch_from_covariance = ot, fit
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    parts["host_syncs_per_step"] = where
    parts["sinkhorn_share_of_step"] = parts["sinkhorn_ms"] / parts["step_ms"]
    return parts


def training_golden(dev):
    """(golden file, committed weights, their config, the golden batch,
    featurize seconds): 10 tracked chains cut in two, through the port's
    featurizer and DockingDataset under the golden file's seed, checked
    against the golden batch digest."""
    from equidock_public_tpu_torch.data.dataset import DockingDataset, split_chain_complex
    from equidock_public_tpu_torch.data.featurize import filter_residues
    from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb
    from equidock_public_tpu_torch.graph import batch_digest, digests_agree
    from equidock_public_tpu_torch.params import default_checkpoint, load_checkpoint

    with open(os.path.join(REPO, "equidock_public_tpu_torch", "assets",
                           "db5_train_step.golden.json")) as f:
        golden = json.load(f)
    params, cfg = load_checkpoint(default_checkpoint(), dev)
    for key, value in dataclasses.asdict(cfg.train).items():
        require(golden["train"][key] == value, f"train.{key}: {value} in the weights' "
                                                f"sidecar, {golden['train'][key]} in the golden file")
    t0 = time.perf_counter()
    samples = []
    for code in golden["codes"]:
        path = os.path.join(REPO, "artifacts", "db5_test_outputs", f"{code}_l_b_EQUIDOCK_TPU.pdb")
        samples.append(split_chain_complex(filter_residues(group_residues(read_pdb(path))),
                                           cfg.graph))
    batch = next(DockingDataset(cfg, samples).batches(np.random.default_rng(golden["seed"]),
                                                      device=dev))
    featurize_s = time.perf_counter() - t0
    bad = digests_agree(batch_digest(batch), golden["batch_digest"])
    require(not bad, f"the training batch differs from the golden one in {bad}")
    return golden, params, cfg, batch, featurize_s


def check_step_golden(what, metrics, state, p0, golden, cfg) -> dict:
    """TRAIN_STEPS steps' loss terms, gradient norms and clip flags, and the
    parameters' moves, against the training golden file's gates; the worst
    relative errors."""
    from equidock_public_tpu_torch.params import flatten

    tol = golden["tolerance"]
    worst = {}
    for i, (m, want) in enumerate(zip(metrics, golden["steps"])):
        rtol = tol["loss_rtol_step1"] if i == 0 else tol["loss_rtol_later"]
        for key in ("loss", "ligand_coors_loss", "receptor_coors_loss", "ot_loss",
                    "intersection_loss", "grad_norm"):
            got = float(m[key])
            r = tol["grad_norm_rtol"] if key == "grad_norm" else rtol
            require(np.isfinite(got) and abs(got - want[key]) <= r * abs(want[key])
                    + tol["loss_atol"], f"{what} step {i + 1} {key}: {got:.7g}, "
                                        f"JAX {want[key]:.7g}")
            worst[key] = max(worst.get(key, 0.0), abs(got - want[key]) / max(abs(want[key]), 1e-12))
        require(float(m["clipped"]) == want["clipped"], f"{what} step {i + 1}: clipped differs")
    atol = tol["delta_norm_atol_lr"] * cfg.train.lr
    worst["delta_norm"] = 0.0
    for key, v in flatten(state.params).items():
        got, want = float((v - p0[key]).norm()), golden["delta_norms_last"][key]
        worst["delta_norm"] = max(worst["delta_norm"], abs(got - want) / max(want, 1e-12))
        require(abs(got - want) <= tol["delta_norm_rtol"] * want + atol,
                f"{what} {key}: moved {got:.6g} in {TRAIN_STEPS} steps, JAX {want:.6g}")
    return worst


def check_grad_norms(what, grads, golden) -> float:
    """Every leaf's gradient finite, its norm the JAX package's; the worst
    relative error."""
    tol = golden["tolerance"]
    worst = 0.0
    for key, want in golden["grad_norms_step1"].items():
        g = grads[key]
        require(torch.isfinite(g).all().item(), f"{what} {key}: non-finite gradient")
        err = abs(float(g.norm()) - want) / max(want, 1e-12)
        worst = max(worst, err)
        require(err <= tol["leaf_grad_norm_rtol"] or abs(float(g.norm()) - want) <= 1e-6,
                f"{what} {key}: gradient norm {float(g.norm()):.6g}, JAX {want:.6g}")
    return worst


def run_train(dev, train_golden) -> dict:
    """The train phase: the golden batch (`training_golden`), the gradient
    check, TRAIN_STEPS counted steps against the golden file, then timing
    and the profile."""
    from equidock_public_tpu_torch.params import flatten
    from equidock_public_tpu_torch.train.step import (create_train_state, loss_and_grads,
                                                      train_step)

    golden, params, cfg, batch, featurize_s = train_golden
    tol = golden["tolerance"]
    pairs = int(batch.pair_mask.sum().item())

    # every leaf gets a finite gradient whose norm is the JAX package's
    grads, _, _ = loss_and_grads(params, cfg, batch)
    worst_leaf = check_grad_norms("train", grads, golden)

    # the main path: TRAIN_STEPS train_steps, counts set to 0 just before
    state = create_train_state(params, cfg, dev)
    p0 = {k: v.clone() for k, v in flatten(state.params).items()}
    reset_counts()
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = train_step(state, batch, cfg)
        metrics.append(m)
    launches = read_counts()
    expect_counts("train", launches, TRAIN_STEPS, 0, fused=False)
    worst = check_step_golden("train", metrics, state, p0, golden, cfg)
    for m in metrics:
        lc = m["ligand_coords"]
        require(tuple(lc.shape) == tuple(batch.lig.x.shape) and torch.isfinite(lc).all().item(),
                "ligand_coords: wrong shape or non-finite")

    # the same first step with the soft-min field kernels: as the unfused one
    fcfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              use_fused_intersection=True))
    reset_counts()
    fgrads, fmetrics, _ = loss_and_grads(params, fcfg, batch)
    fused_launches = read_counts()
    expect_counts("train fused", fused_launches, 1, 0, fused=True)
    fused_err = {}
    for key in ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss"):
        got, want = float(fmetrics[key]), float(metrics[0][key])
        fused_err[key] = abs(got - want) / max(abs(want), 1e-12)
        require(fused_err[key] <= FUSED_RTOL, f"fused step {key}: {got:.7g}, unfused {want:.7g}")
    for key, g in fgrads.items():
        got, want = float(g.norm()), float(grads[key].norm())
        err = abs(got - want) / max(want, 1e-12)
        fused_err["leaf_grad_norm"] = max(fused_err.get("leaf_grad_norm", 0.0), err)
        require(err <= FUSED_RTOL or abs(got - want) <= 1e-6,
                f"fused step {key}: gradient norm {got:.7g}, unfused {want:.7g}")
    small = small_model_check(dev, batch, tol)

    # time: warm-up, then TIMED_STEPS steps, each ended by a synchronize
    holder = [state]

    def step():
        holder[0], _ = train_step(holder[0], batch, cfg)

    for _ in range(2):
        step()
    step_ms = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(step_ms)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    out = dict(codes=golden["codes"], pairs=pairs, batch=list(batch.lig.x.shape[:2])
               + [batch.rec.x.shape[1], batch.pocket_lig.shape[1]],
               featurize_seconds=round(featurize_s, 3),
               launches=launches, launches_per_step={k: n / TRAIN_STEPS for k, n in launches.items()},
               fused_step={"launches": fused_launches, "rel_err_vs_unfused": fused_err,
                           "rtol": FUSED_RTOL},
               small_model=small,
               golden_worst_rel_err=dict(worst, leaf_grad_norm=worst_leaf),
               losses=[{k: float(m[k]) for k in ("loss", "ot_loss", "grad_norm")}
                       for m in metrics],
               step_ms=step_ms, step_ms_median=med, pairs_per_s=pairs / (med / 1e3),
               peak_device_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
               parts=timed_parts(step), profile=device_profile(step, reps=2, top=10))
    emit("train", **out)
    return out


def split_chain_samples(codes, gc):
    """The port's bound complexes of tracked chains cut in two."""
    from equidock_public_tpu_torch.data.dataset import split_chain_complex
    from equidock_public_tpu_torch.data.featurize import filter_residues
    from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb

    return [split_chain_complex(filter_residues(group_residues(read_pdb(os.path.join(
        REPO, "artifacts", "db5_test_outputs", f"{code}_l_b_EQUIDOCK_TPU.pdb")))), gc)
        for code in codes]


def run_epoch_golden(dev, root) -> dict:
    """Epoch phase (a): `fit`, 2 epochs from the committed weights with the
    fused intersection loss, on caches of the tracked chains cut in two that
    the port writes, against assets/db5_fit.golden.json."""
    from equidock_public_tpu_torch.data.dataset import write_cache
    from equidock_public_tpu_torch.params import default_checkpoint, load_checkpoint
    from equidock_public_tpu_torch.train.loop import fit
    from equidock_public_tpu_torch.train.step import create_train_state

    with open(os.path.join(REPO, "equidock_public_tpu_torch", "assets",
                           "db5_fit.golden.json")) as f:
        golden = json.load(f)
    tol = golden["tolerance"]
    params, cfg = load_checkpoint(default_checkpoint(), dev)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, use_fused_intersection=True, random_seed=0,
                                       bs=10, val_repeats=1),
        data=dataclasses.replace(cfg.data, cache_dir=os.path.join(root, "cache")),
        checkpoint_dir=os.path.join(root, "ckpt"), log_dir=os.path.join(root, "logs"))
    train = dataclasses.asdict(cfg.train)
    require(train == {k: golden["train_config"][k] for k in train},
            "the epoch config differs from the golden file's")
    t0 = time.perf_counter()
    for split, codes in golden["partition"].items():
        write_cache(os.path.join(cfg.cache_path(), f"{split}.npz"), codes,
                    split_chain_samples(codes, cfg.graph))
    cache_s = time.perf_counter() - t0
    history = []
    reset_counts()
    t0 = time.perf_counter()
    fit(cfg, create_train_state(params, cfg, dev), max_epochs=golden["epochs"],
        log=lambda *a: None, device=dev, history=history)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    bs, parts = cfg.train.bs, golden["partition"]
    steps = sum(h["train"]["num_batches"] for h in history[:-1])
    evals = (golden["epochs"] * -(-len(parts["val"]) // bs) + -(-len(parts["test"]) // bs))
    expect_counts("epoch", counts, steps, evals, fused=True)
    got = [dict(train=h["train"], val=h["val"]) for h in history[:-1]]
    got.append(dict(test=history[-1]["test"]))
    want = golden["history"] + [dict(test=golden["test"])]
    worst = {"loss_rel": 0.0, "median_abs": 0.0}
    for i, (g, w) in enumerate(zip(got, want)):
        for part in w:
            for key, value in w[part].items():
                v = g[part][key]
                require(v is not None and np.isfinite(v), f"epoch {i} {part} {key}: {v}")
                if key.endswith("median"):
                    worst["median_abs"] = max(worst["median_abs"], abs(v - value))
                    require(abs(v - value) <= tol["median_atol"],
                            f"epoch {i} {part} {key}: {v:.5f}, JAX {value:.5f}")
                else:
                    e = abs(v - value) / max(abs(value), 1e-12)
                    worst["loss_rel"] = max(worst["loss_rel"], e)
                    require(e <= tol["loss_rtol"] or (key == "num_clips" and v == value),
                            f"epoch {i} {part} {key}: {v:.7g}, JAX {value:.7g}")
    require(history[-1]["best_epoch"] == golden["best_epoch"],
            f"best epoch {history[-1]['best_epoch']}, JAX {golden['best_epoch']}")
    return dict(partition={k: len(v) for k, v in parts.items()}, steps=steps,
                forwards_without_gradient=evals, launches=counts,
                best_epoch=history[-1]["best_epoch"], golden_worst=worst, golden_tolerance=tol,
                cache_seconds=cache_s, fit_seconds=fit_s,
                epochs=[{k: h[k] for k in ("train_seconds", "val_seconds",
                                           "checkpoint_seconds")} for h in history[:-1]])


def db5_sized_sizes(n: int, seed: int = 7):
    """(n_lig, n_rec) pairs drawn independently, with replacement, from the
    residue counts of the tracked DB5 chains."""
    from equidock_public_tpu_torch.data.featurize import filter_residues
    from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb

    pdb_dir = os.path.join(REPO, "artifacts", "db5_test_outputs")
    base = sorted(len(filter_residues(group_residues(read_pdb(os.path.join(pdb_dir, f)))))
                  for f in os.listdir(pdb_dir) if f.endswith(".pdb"))
    idx = np.random.default_rng(seed).integers(0, len(base), (n, 2))
    return [(base[i], base[j]) for i, j in idx]


def run_epoch_db5_sized(dev, root) -> dict:
    """Epoch phase (b): the training CLI (`cli/train.py::main`), 2 epochs of
    a random full-width DB5 paper model (shared layers, 5 layers, 64 wide,
    50 heads) with the fused intersection loss, on a synthetic split of
    the cv_fold0 counts (152 / 25 / 25); each step timed between
    synchronizations; then one more epoch under the profiler."""
    from equidock_public_tpu_torch.cli import train as cli
    from equidock_public_tpu_torch.data.dataset import DockingDataset
    from equidock_public_tpu_torch.data.synth import write_synth_split
    from equidock_public_tpu_torch.train import loop
    from equidock_public_tpu_torch.train.checkpoint import load_checkpoint

    counts_by_split = {"train": 152, "val": 25, "test": 25}
    sizes = db5_sized_sizes(sum(counts_by_split.values()))
    argv = ["-shared_layers", "-iegmn_n_lays", "5", "-iegmn_lay_hid_dim", "64",
            "-residue_emb_dim", "64", "-num_att_heads", "50", "-w_decay", "1e-3",
            "-node_buckets", "512,1024,2048,3072", "-pocket_buckets", "256,512,1024",
            "-use_fused_intersection", "-random_seed", "0", "-max_epochs", "2",
            "-cache_dir", os.path.join(root, "cache"),
            "-checkpoint_dir", os.path.join(root, "ckpt"), "-device", "cuda"]
    cfg = cli.config_from_args(cli._parser().parse_args(argv))
    t0 = time.perf_counter()
    start = 0
    for i, (split, n) in enumerate(counts_by_split.items()):
        write_synth_split(os.path.join(cfg.cache_path(), f"{split}.npz"),
                          sizes[start:start + n], seed=i, k=cfg.graph.graph_max_neighbor)
        start += n
    cache_s = time.perf_counter() - t0
    step_ms = []
    plain_step = loop.train_step

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain_step(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    cwd, out = os.getcwd(), io.StringIO()
    loop.train_step = timed_step
    os.chdir(root)                      # the CLI's text log: ./stdouterr
    reset_counts()
    try:
        with contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            require(cli.main(argv) == 0, "the training CLI failed")
            run_s = time.perf_counter() - t0
    finally:
        loop.train_step = plain_step
        os.chdir(cwd)
    counts = read_counts()
    with open(os.path.join(root, cfg.log_dir, cfg.banner() + ".scalars.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    require(len(epochs) == 2, f"{len(epochs)} epochs in the scalars file")
    steps = sum(e["train"]["num_batches"] for e in epochs)
    bs = cfg.train.bs
    evals = 2 * -(-counts_by_split["val"] // bs) + -(-counts_by_split["test"] // bs)
    expect_counts("epoch db5-sized", counts, steps, evals, fused=True)
    for e in epochs:
        require(all(e["train"][k] is not None and np.isfinite(e["train"][k])
                    for k in ("loss", "ot_loss", "intersection_loss")),
                f"non-finite training loss in {e['train']}")
    # one more epoch of the best state under the profiler
    state, _, _ = load_checkpoint(os.path.join(root, cfg.checkpoint_dir, cfg.banner(),
                                               "db5_model_best"), dev)
    ds = DockingDataset.from_cache(cfg, "train")
    holder, rng = [state], np.random.default_rng(1)

    def one_epoch():
        holder[0], _ = loop.run_train_epoch(holder[0], ds, cfg, rng, 2, log=lambda *a: None)
        torch.cuda.synchronize()

    prof = device_profile(one_epoch, reps=1, top=8)
    steady = epochs[-1]
    return dict(split=counts_by_split, size_source="residue counts of the 25 tracked DB5 "
                "chains, drawn with replacement (seed 7)", cache_seconds=cache_s,
                cli_seconds=run_s, steps=steps, forwards_without_gradient=evals,
                launches=counts, launches_per_step={k: counts[k] / steps for k in counts},
                epochs=[{k: e[k] for k in ("train_seconds", "val_seconds", "checkpoint_seconds")}
                        | {"loss": e["train"]["loss"], "num_batches": e["train"]["num_batches"]}
                        for e in epochs],
                epoch_seconds=steady["train_seconds"] + steady["val_seconds"],
                pairs_per_s=counts_by_split["train"] / steady["train_seconds"],
                step_ms_median=statistics.median(step_ms),
                step_ms_median_epoch1=statistics.median(step_ms[len(step_ms) // 2:]),
                timing="each step between synchronizations; epoch 1 is the steady one",
                profile_one_epoch=dict(prof, steps=-(-counts_by_split["train"] // bs)))


# --------------------------------------------------------------------------- #
# Slice 4: the halo graph-parallel path
# --------------------------------------------------------------------------- #

def served_requests(cfg, dev):
    """The serving golden file's 4 requests, featurized as the server does:
    [(golden entry, Request)]."""
    from equidock_public_tpu_torch.eval.inference import featurize_request

    with open(os.path.join(REPO, "equidock_public_tpu_torch", "assets",
                           "db5_model_best.golden.json")) as f:
        golden = json.load(f)["requests"]
    return [(g, featurize_request(cfg, os.path.join(REPO, g["ligand"]),
                                  os.path.join(REPO, g["receptor"]), dev)) for g in golden]


def halo_plans(pair):
    """(name, planner options, dp, gp) of the three halo forwards of a
    request: the padded ring tier at gp=2, the ragged one at gp=4, and gp=4
    in the chain order (spatial=False) with both tiers forced (hmax) to
    the widest width the unforced plan needs, so the residual tier ships."""
    from equidock_public_tpu_torch.parallel.halo import build_halo_batch

    _, st, _, _ = build_halo_batch(pair, gp=4, spatial=False)
    hmax = max(st.hring_lig, st.hring_rec, st.hres_lig, st.hres_rec)
    return (("padded_gp2", dict(gp=2), 1, 2), ("ragged_gp4", dict(gp=4, ragged=True), 1, 4),
            ("residual_gp4", dict(gp=4, spatial=False, hmax=hmax), 1, 4))


def halo_sides(pair, kw, dp, gp, dev, D=64, seed=0):
    """(mesh, the two sides' HaloPlans (on the host, for the ring
    composition), their folded ProteinBatches, [(x, h, ExchangeTable on the
    mesh)] of both sides with a random D-wide h) of a request or batch
    planned with `kw`."""
    from equidock_public_tpu_torch.parallel.halo import build_halo_batch, mesh_table
    from equidock_public_tpu_torch.parallel.mesh import ParallelMesh

    hb, _, _, _ = build_halo_batch(pair, **kw)
    mesh = ParallelMesh(dp, gp, dev)
    gen = torch.Generator().manual_seed(seed)
    plans, prots, sides = [], [], []
    for side in ("lig", "rec"):
        prot = mesh.shard_protein(getattr(hb.pair, side))
        h = torch.randn(prot.x.shape[:2] + (D,), generator=gen).to(dev)
        plans.append(getattr(hb, "plan_" + side))
        prots.append(prot)
        sides.append((prot.x.contiguous(), h, mesh_table(getattr(hb, "table_" + side), mesh)))
    return mesh, plans, prots, sides


def halo_kernel_cases(params, requests, train_batch, dev):
    """Rows 8 and 9 at the main path's shapes, both sides a launch: the
    512 x 1024 request at padded gp=2, ragged gp=4 and gp=4 with a forced
    residual tier; the training batch at padded gp=2 (dp 1 and 2) and
    ragged gp=2 at dp=2 with D = 16; random cotangents for row 9. The edge
    kernels at Nsrc != N: the request's receptor layer-body inputs at gp=2
    and at the forced residual tier."""
    from equidock_public_tpu_torch.models.iegmn import edge_kernel_inputs
    from equidock_public_tpu_torch.parallel.halo import halo_exchange

    pair = requests[0][1].batch
    require(tuple(pair.rec.x.shape[:2]) == (1, 1024), "request 0 is not 512 x 1024")
    plans = {name: (kw, dp, gp) for name, kw, dp, gp in halo_plans(pair)}
    exchange, edge = [], []

    def case(what, name, p, kw, dp, gp, D=64):
        mesh, side_plans, prots, sides = halo_sides(p, kw, dp, gp, dev, D)
        gen = torch.Generator().manual_seed(len(exchange) + 3)
        grads = [tuple(torch.randn(x.shape[0], t.dims[3], w, generator=gen).to(dev)
                       for w in (3, h.shape[-1])) for x, h, t in sides]
        shape = f"{what}: " + ", ".join(
            f"{n} x {tuple(x.shape[:2])} -> Ssrc {t.dims[3]}" for n, (x, _, t) in
            zip(("lig", "rec"), sides)) + f", dp={dp}, D={D}"
        exchange.append(dict(shape=shape, name=name, mesh=mesh, plans=side_plans,
                             sides=sides, grads=grads, prots=prots))

    for name in ("padded_gp2", "ragged_gp4", "residual_gp4"):
        case("512x1024 request, " + name, name, pair, *plans[name])
    case("training batch, padded gp=2", "padded_gp2", train_batch, dict(gp=2), 1, 2)
    case("training batch, padded gp=2", "padded_gp2", train_batch, dict(gp=2), 2, 2)
    case("training batch, ragged gp=2", "ragged_gp2", train_batch,
         dict(gp=2, ragged=True, dp=2), 2, 2, D=16)

    for c in (exchange[0], exchange[2]):       # the receptor, padded gp=2 and residual
        mesh, (_, prot), (_, (x, h, tab)) = c["mesh"], c["prots"], c["sides"]
        src_view = halo_exchange(x, h, tab, mesh)
        he = prot.edge_feat.contiguous()
        src, dst, kp = edge_kernel_inputs(params["original"]["rest"], x, h, he, src=src_view)
        gen = torch.Generator().manual_seed(2)
        grads = (torch.randn(dst.shape[:2] + (64,), generator=gen).to(dev),
                 torch.randn(dst.shape[:2] + (3,), generator=gen).to(dev))
        edge.append(dict(shape=f"512x1024 request, receptor, {c['name']}: B={src.shape[0]} "
                               f"N={dst.shape[1]} Nsrc={src.shape[1]} K=10 D=64 E=27",
                         args=(src, dst, he, prot.nbr, prot.nbr_mask, kp), grads=grads))
    return exchange, edge


def check_halo_case(c) -> dict:
    """Row 8 into outputs inside NaN guard regions, bit-equal to both plain
    versions (the table's index_select and the ring composition) and to a
    second launch; row 9 likewise guarded, bit-equal to the sequential
    index_add_ of the table on the CPU and to a second launch, and within
    HALO_BWD_REL_TOL (norm-wise) of autograd through the ring composition
    on the card."""
    from equidock_public_tpu_torch.ops.cuda import halo_ring as hr
    from equidock_public_tpu_torch.parallel.halo import ring_composition

    sides, dev, what = c["sides"], c["sides"][0][0].device, c["shape"]
    shapes = [s for x, h, t in sides for s in ((x.shape[0], t.dims[3], 3),
                                                (x.shape[0], t.dims[3], h.shape[-1]))]
    bufs, views = guarded(shapes, dev)
    got = hr.exchange_kernel(sides, out=[views[:2], views[2:]])
    synced("halo_exchange")
    require_guards("halo_exchange " + what, bufs)
    again = hr.exchange_kernel(sides)
    fwd_err = bwd_err = 0.0
    for (x, h, t), g, a, plan in zip(sides, got, again, c["plans"]):
        want = hr.exchange_plain(x, h, t)
        fwd_err = max(fwd_err, max_err(g, want))
        require(all(torch.equal(u, v) for u, v in zip(g, want)),
                f"halo_exchange {what}: differs from the table's index_select")
        require(all(torch.equal(u, v) for u, v in zip(g, ring_composition(x, h, plan, c["mesh"]))),
                f"halo_exchange {what}: differs from the ring composition")
        require(all(torch.equal(u, v) for u, v in zip(g, a)),
                f"halo_exchange {what}: two launches differ")

    grads = [(gx, gh, t) for (gx, gh), (_, _, t) in zip(c["grads"], sides)]
    shapes = [s for x, h, _ in sides for s in (tuple(x.shape), tuple(h.shape))]
    bufs, views = guarded(shapes, dev)
    got = hr.exchange_bwd_kernel(grads, out=[views[:2], views[2:]])
    synced("halo_exchange_bwd")
    require_guards("halo_exchange_bwd " + what, bufs)
    again = hr.exchange_bwd_kernel(grads)
    worst = 0.0
    for (gx, gh, t), g, a, (x, h, _), plan in zip(grads, got, again, sides, c["plans"]):
        cpu = hr.exchange_bwd_plain(gx.cpu(), gh.cpu(), t.to("cpu"))
        bwd_err = max(bwd_err, max_err([u.cpu() for u in g], cpu))
        require(all(torch.equal(u.cpu(), v) for u, v in zip(g, cpu)),
                f"halo_exchange_bwd {what}: differs from the sequential index_add_ on the CPU")
        require(all(torch.equal(u, v) for u, v in zip(g, a)),
                f"halo_exchange_bwd {what}: two launches differ")
        leaves = [x.detach().requires_grad_(True), h.detach().requires_grad_(True)]
        want = torch.autograd.grad(ring_composition(*leaves, plan, c["mesh"]), leaves, (gx, gh))
        for u, w in zip(g, want):
            require(torch.isfinite(u).all().item(), f"halo_exchange_bwd {what}: non-finite")
            worst = max(worst, rel_err(u, w))
    require(worst <= HALO_BWD_REL_TOL, f"halo_exchange_bwd {what}: {worst:.3g} from autograd "
                                       f"through the ring composition > {HALO_BWD_REL_TOL}")
    return {"shape": what, "fwd_bit_equal": True, "bwd_bit_equal_to_cpu_index_add": True,
            "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err,
            "bwd_rel_err_vs_composition": worst}


def check_halo_kernels(exchange, edge, slope) -> dict:
    """Rows 8 and 9 at every exchange case (check_halo_case); the edge
    kernels at Nsrc != N to their plain versions (forward EDGE_TOL,
    backward norm-wise), the d_src scatter to index_add_, two launches of
    each bit-equal (check_edge_case)."""
    return {"halo_exchange": [check_halo_case(c) for c in exchange],
            "edge_message_nsrc": [check_edge_case(c, slope) for c in edge]}


def inverse(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def timed_ms(fn, reps: int) -> list:
    """Host-clock ms of `reps` calls, each ended by a synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def run_halo(dev, requests, train_golden) -> dict:
    """The halo phase: (a) the 4 served requests through the halo forward
    at three plans each against the serving golden file, each forward
    launching row 8 5 times (both sides a layer), row 9 never and the edge
    forward 10 times; (b) 3 halo training steps at gp=2 on the golden batch
    against the training golden file, rows 8 and 9 5 times a step, the 2
    inverse neighbour lists of a dense step, no exchange table built, two
    steps from one state bit-equal; (c) times beside the dense path's in
    the same run, and a device profile of a halo forward and a halo step."""
    from equidock_public_tpu_torch.models.iegmn import docking_forward
    from equidock_public_tpu_torch.params import flatten
    from equidock_public_tpu_torch.parallel.halo import (build_halo_batch, make_halo_forward,
                                                         make_halo_loss, make_halo_train_step)
    from equidock_public_tpu_torch.parallel.mesh import ParallelMesh
    from equidock_public_tpu_torch.train.step import (create_train_state, loss_and_grads,
                                                      train_step)

    golden, params, cfg, batch, _ = train_golden
    per_fwd = LAYERS * SIDES
    # (a) serving requests, counts set to 0 just before
    plans = [(g, req, halo_plans(req.batch)) for g, req in requests]
    forwards = {}
    worst = {k: 0.0 for k in GOLDEN_ATOL}
    reset_counts()
    for g, req, req_plans in plans:
        for name, kw, dp, gp in req_plans:
            hb, stats, perm_l, _ = build_halo_batch(req.batch, **kw)
            before = read_counts()
            with torch.inference_mode():
                out = make_halo_forward(cfg, ParallelMesh(dp, gp, dev))(params, hb)
            after = read_counts()
            grew = {k: after[k] - before[k] for k in after}
            want = {k: 0 for k in grew}
            want.update({"halo_exchange": LAYERS, "edge_message": per_fwd})
            if name == "residual_gp4":
                require(stats.hres_lig > 0 and stats.hres_rec > 0, "no residual tier")
            require(grew == want, f"halo forward {name} {g['ligand']}: launches {grew}")
            inv = inverse(perm_l[0])
            got = {"R": out["R"][0].cpu().numpy(), "t": out["t"][0, 0].cpu().numpy(),
                   "ca": out["ligand_coords"][0].cpu().numpy()[inv][:8]}
            for k, atol in GOLDEN_ATOL.items():
                require(np.isfinite(got[k]).all(), f"halo forward {name}: non-finite {k}")
                err = float(np.abs(got[k] - np.asarray(g[k])).max())
                worst[k] = max(worst[k], err)
                require(err <= atol, f"halo forward {name} {g['ligand']}: {k} differs from "
                                     f"the JAX golden value by {err:.3g} > {atol}")
            forwards.setdefault(name, []).append(dict(
                buckets=[hb.pair.lig.x.shape[1], hb.pair.rec.x.shape[1]],
                hring=[stats.hring_lig, stats.hring_rec], hres=[stats.hres_lig, stats.hres_rec],
                ring_flat=[stats.ring_flat_lig, stats.ring_flat_rec],
                bytes_per_layer=stats.bytes_per_layer(64),
                demand_bytes_per_layer=stats.bytes_per_layer(64, padded=False),
                full_gather_bytes_per_layer=stats.full_gather_bytes_per_layer(
                    64, hb.pair.lig.x.shape[1], hb.pair.rec.x.shape[1], 1)))
    serve_counts = read_counts()

    # (b) training steps at gp=2 padded on the golden batch
    hb, stats, _, _ = build_halo_batch(batch, gp=2)
    mesh = ParallelMesh(1, 2, dev)
    grads, _, _ = loss_and_grads(params, cfg, hb, loss_fn_=make_halo_loss(cfg, mesh))
    worst_leaf = check_grad_norms("halo", grads, golden)
    step = make_halo_train_step(cfg, mesh)
    state0 = create_train_state(params, cfg, dev)
    p0 = {k: v.clone() for k, v in flatten(state0.params).items()}
    state, metrics = state0, []
    reset_counts()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, hb)
        metrics.append(m)
    train_counts = read_counts()
    want = {k: 0 for k in train_counts}
    want.update({k: per_fwd * TRAIN_STEPS for k in ("edge_message", "edge_message_bwd",
                                                    "edge_message_scatter")})
    want.update({k: LAYERS * TRAIN_STEPS for k in ("halo_exchange", "halo_exchange_bwd")})
    # the forward's two lists, as a dense step builds them
    want[INVERSE[2]] = PER_STEP_INVERSE * TRAIN_STEPS
    require(train_counts == want, f"halo train: launches {train_counts}, expected {want}")
    worst_step = check_step_golden("halo train", metrics, state, p0, golden, cfg)
    runs = [step(state0, hb) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(flatten(runs[0][0].params).values(),
                                                 flatten(runs[1][0].params).values()))
    same = same and all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    require(same, "halo train: two steps from one state differ")

    # (c) times, the halo path beside the dense one in the same run, in turns
    req = requests[0][1].batch
    hbr, st_r, _, _ = build_halo_batch(req, gp=2)
    fwd = make_halo_forward(cfg, ParallelMesh(1, 2, dev))
    with torch.inference_mode():
        halo_fwd = lambda: fwd(params, hbr)["R"].cpu()
        dense_fwd = lambda: docking_forward(params, cfg.model, req)["R"].cpu()
        fwd_ms = {"dense": [], "halo": []}
        for _ in range(2):
            fwd_ms["dense"] += timed_ms(dense_fwd, 5)
            fwd_ms["halo"] += timed_ms(halo_fwd, 5)
        fwd_profile = device_profile(halo_fwd, reps=3)
    step_ms = {"dense": [], "halo": []}
    for _ in range(2):
        step_ms["dense"] += timed_ms(lambda: train_step(state0, batch, cfg), 3)
        step_ms["halo"] += timed_ms(lambda: step(state0, hb), 3)
    step_profile = device_profile(lambda: step(state0, hb), reps=2)
    med = lambda d: {k: statistics.median(v) for k, v in d.items()}
    return dict(
        forwards=forwards, golden_max_abs_err=worst, golden_atol=GOLDEN_ATOL,
        launches_serve=serve_counts,
        launches_per_forward={"halo_exchange": LAYERS, "halo_exchange_bwd": 0,
                              "edge_message": per_fwd, "cross_attention": 0},
        train=dict(gp=2, hring=[stats.hring_lig, stats.hring_rec],
                   hres=[stats.hres_lig, stats.hres_rec], launches=train_counts,
                   golden_worst_rel_err=dict(worst_step, leaf_grad_norm=worst_leaf),
                   two_steps_bit_equal=same,
                   losses=[{k: float(m[k]) for k in ("loss", "ot_loss", "grad_norm")}
                           for m in metrics],
                   bytes_per_layer=stats.bytes_per_layer(64),
                   full_gather_bytes_per_layer=stats.full_gather_bytes_per_layer(64, 512, 512, 10)),
        forward_512x1024_gp2_ms=fwd_ms, forward_ms_median=med(fwd_ms),
        forward_bytes_per_layer=st_r.bytes_per_layer(64),
        forward_full_gather_bytes_per_layer=st_r.full_gather_bytes_per_layer(64, 512, 1024, 1),
        forward_profile_512x1024_gp2=fwd_profile,
        step_ms=step_ms, step_ms_median=med(step_ms), step_profile_train_gp2=step_profile,
        timing="host clock around calls ended by a synchronize, dense and halo in turns; "
               "steps from one state, not chained")


# --------------------------------------------------------------------------- #
# Main
# --------------------------------------------------------------------------- #

def main() -> int:
    wall0 = time.perf_counter()
    if not torch.cuda.is_available():
        print(json.dumps({"phase": "device", "ok": False,
                          "error": "torch.cuda.is_available() is False"}),
              file=sys.stderr, flush=True)
        return 1

    from equidock_public_tpu_torch.cli.serve import DockingServer
    from equidock_public_tpu_torch.device import resolve_device
    from equidock_public_tpu_torch.ops.cuda import _build
    from equidock_public_tpu_torch.ops.cuda import cross_attention as ca
    from equidock_public_tpu_torch.ops import softmin_field as sf
    from equidock_public_tpu_torch.ops.cuda import edge_message as em
    from equidock_public_tpu_torch.ops.cuda import softmin_field as ksf
    from equidock_public_tpu_torch.params import default_checkpoint, load_checkpoint

    # -- device -------------------------------------------------------------
    dev = resolve_device("cuda")
    smi = nvidia_smi_name_power()
    require(not torch.backends.cuda.matmul.allow_tf32, "cuBLAS TF32 is on")
    require(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi,
         allow_tf32=[torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32])

    # -- build --------------------------------------------------------------
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    res = _build.build()
    ptxas = [ln.strip() for ln in res.log.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    emit("build", seconds=round(res.seconds, 2), library=os.path.relpath(res.path, REPO),
         ptxas=ptxas)

    # -- kernels --------------------------------------------------------------
    params, cfg = load_checkpoint(default_checkpoint(), dev)
    slope = cfg.model.leakyrelu_neg_slope
    e_cases, a_cases = edge_cases(params, dev), attention_cases(dev)
    eb_case, e16, e_tiles = edge_bwd_case(params, dev), edge16_case(dev), edge_tile_cases(dev)
    # rows 1 and 2: the serving shapes (forward), the training batch at D 64
    # and 16, the edges of the tiles
    edge_checks = [check_edge_case(c, slope) for c in e_cases + [eb_case, e16] + e_tiles]
    edge_err = max(c["max_abs_err"] for c in edge_checks[:len(e_cases)])
    for c in e_cases + [eb_case, e16]:
        c["out"] = em.edge_message_aggregate(*c["args"], slope=slope)
    att_err = 0.0
    for c in a_cases:
        got = ca.cross_attention_fwd(*c["args"])
        synced("cross_attention")
        want = ca.cross_attention_plain(*c["args"])
        torch.cuda.synchronize()
        c["err"] = check_close("cross_attention " + c["shape"], got, want, ATT_TOL)
        c["empty"] = check_empty_rows("cross_attention " + c["shape"], c["args"], got)
        again = ca.cross_attention_fwd(*c["args"])
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"cross_attention {c['shape']}: two launches on the same inputs differ")
        c["out"] = got
        att_err = max(att_err, c["err"])
    ab_cases = attention_bwd_cases(dev)
    for c in ab_cases:
        got = ca.cross_attention_bwd(*c["args"])
        synced("cross_attention_dq, cross_attention_dkv")
        want = ca.cross_attention_bwd_plain(*c["args"][:5], c["args"][7])
        torch.cuda.synchronize()
        c["check_dq"] = check_grads("cross_attention_dq", c["shape"], got[:1], want[:1])
        c["check_dkv"] = check_grads("cross_attention_dkv", c["shape"], got[1:], want[1:])
        again = ca.cross_attention_bwd(*c["args"])
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"cross_attention dq / dkv {c['shape']}: two launches on the same inputs differ")
    # dQ also at the forward's shapes (the edges of its 64-row tiles) and widths
    dq_cases = attention_dq_cases(dev, a_cases)
    for c in dq_cases:
        q, k, v, qt, kt, o, lse, do = c["args"]
        delta = (do * o).sum(-1).contiguous()
        got = ca.cross_attention_dq(q, k, v, qt, kt, lse, do, delta)
        synced("cross_attention_dq")
        want = ca.cross_attention_bwd_plain(q, k, v, qt, kt, do)[0]
        torch.cuda.synchronize()
        c["check"] = check_grads("cross_attention_dq", c["shape"], [got], [want])
        require(torch.equal(got, ca.cross_attention_dq(q, k, v, qt, kt, lse, do, delta)),
                f"cross_attention dq {c['shape']}: two launches on the same inputs differ")
    # the combine passes of rows 3-5 against their plain versions
    combines = {}
    for _, _, name, _ in COMBINES:
        shape, parts, kern, plain, library = combine_case(name, ca, a_cases[1], ab_cases[0])
        got = kern(*parts)
        synced(name)
        want = plain(*parts)
        as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
        err = check_close(name, as_tuple(got), as_tuple(want), ATT_TOL)
        combines[name] = dict(shape=shape, parts=parts, kern=kern, plain=plain,
                              library=library, outs=as_tuple(got), err=err)
    # rows 6 and 7: the soft-min field sums and their backward
    s_cases = softmin_cases(dev)
    for c in s_cases:
        check_softmin_case(c)
    # rows 8 and 9, and the edge kernels at Nsrc != N, at the halo path's shapes
    requests = served_requests(cfg, dev)
    train_golden = training_golden(dev)
    h_exchange, h_edge = halo_kernel_cases(params, requests, train_golden[3], dev)
    halo_checks = check_halo_kernels(h_exchange, h_edge, slope)
    emit("kernels", **halo_checks,
         edge_message=edge_checks,
         cross_attention=[{"shape": c["shape"], "max_abs_err": c["err"], **c["empty"]}
                          for c in a_cases],
         cross_attention_dq=[{"shape": c["shape"], **c["check_dq"]} for c in ab_cases]
         + [{"shape": c["shape"], **c["check"]} for c in dq_cases],
         cross_attention_dkv=[{"shape": c["shape"], **c["check_dkv"]} for c in ab_cases],
         softmin_field=[{"shape": c["shape"], "max_abs_err": c["err"]} for c in s_cases],
         softmin_field_bwd=[{"shape": c["shape"], **c["check"]} for c in s_cases],
         bit_equal=[f"edge_message and edge_message_bwd ({len(edge_checks)} and "
                    f"{sum('bwd' in c for c in edge_checks)} shapes, Nsrc != N included)",
                              f"softmin_field and softmin_field_bwd ({len(s_cases)} shapes)",
                              "cross_attention_dq and _dkv (2 shapes)",
                              f"cross_attention_dq ({len(dq_cases)} more shapes)",
                              f"cross_attention forward ({len(a_cases)} shapes)"],
         combines={n: {"shape": c["shape"], "max_abs_err": c["err"]}
                   for n, c in combines.items()},
         bit_equal_to_plain=[f"halo_exchange ({len(h_exchange)} shapes, both sides a launch): "
                             "the table's index_select and the ring composition",
                             "halo_exchange_bwd: the sequential index_add_ of the table on "
                             "the CPU"],
         guarded_outputs=f"edge_message, edge_message_bwd, softmin_field, softmin_field_bwd, "
                         f"halo_exchange, halo_exchange_bwd: {GUARD} NaN floats before and "
                         "after each output, untouched",
         tolerance={"edge_message": EDGE_TOL, "cross_attention": ATT_TOL,
                    "softmin_field": SOFTMIN_TOL, "backward_relative_norm": BWD_REL_TOL,
                    "halo_exchange_bwd_vs_composition": HALO_BWD_REL_TOL})

    # -- serve: the main path ------------------------------------------------
    with open(os.path.join(REPO, "equidock_public_tpu_torch", "assets",
                           "db5_model_best.golden.json")) as f:
        golden = json.load(f)["requests"]
    server = DockingServer.from_checkpoint(default_checkpoint(), dev)
    n_warm, warm_s = server.warmup(WARMUP_BUCKETS)
    outputs, forward_ms = [], []
    inner = server.forward

    def recording_forward(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(batch)
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
        outputs.append({"R": out["R"][0].cpu().numpy(), "t": out["t"][0, 0].cpu().numpy(),
                        "ca": out["ligand_coords"][0, :8].cpu().numpy()})
        return out

    server.forward = recording_forward
    out_dir = tempfile.mkdtemp(prefix="equidock_smoke_")
    try:
        lines = [json.dumps({"ligand": os.path.join(REPO, g["ligand"]),
                             "receptor": os.path.join(REPO, g["receptor"]),
                             "output": os.path.join(out_dir, f"req{i}.pdb")})
                 for i, g in enumerate(golden)]
        buf = io.StringIO()
        reset_counts()
        served = server.serve_lines(lines, buf)
        serve_launches = read_counts()
        edge_launches = serve_launches["edge_message"]
        att_launches = serve_launches["cross_attention"]
        responses = [json.loads(x) for x in buf.getvalue().splitlines()]
        require(served == len(golden) == len(responses) == len(outputs),
                f"served {served} of {len(golden)} requests")
        for r in responses:
            require(r.get("ok") is True, f"request failed: {r}")
            require(os.path.getsize(r["output"]) > 0, f"empty output {r['output']}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    worst = {k: 0.0 for k in GOLDEN_ATOL}
    for o, g in zip(outputs, golden):
        for k, atol in GOLDEN_ATOL.items():
            require(np.isfinite(o[k]).all(), f"non-finite {k}")
            err = float(np.abs(o[k] - np.asarray(g[k])).max())
            worst[k] = max(worst[k], err)
            require(err <= atol, f"{g['ligand']}: {k} differs from the JAX golden "
                                 f"value by {err:.3g} > {atol}")
    per_fwd = LAYERS * SIDES
    require(edge_launches == per_fwd * served,
            f"edge_message launched {edge_launches} times for {served} forwards")
    require(att_launches == per_fwd * served,
            f"cross_attention launched {att_launches} times for {served} forwards")
    require(serve_launches[INVERSE[2]] == 0,
            f"{serve_launches[INVERSE[2]]} inverse neighbour lists built for {served} "
            "forwards without gradient")
    expect_combines("serve", serve_launches)
    emit("serve", warmed=n_warm, warmup_seconds=round(warm_s, 3), requests=served,
         launches=serve_launches,
         golden_max_abs_err=worst, golden_atol=GOLDEN_ATOL,
         buckets=[[r["num_lig_res"], r["num_rec_res"]] for r in responses])

    # -- train: the main path of slice 2 ----------------------------------------
    train = run_train(dev, train_golden)

    # -- epoch: the main path of slice 3 ----------------------------------------
    root = tempfile.mkdtemp(prefix="equidock_epoch_")
    try:
        epoch_golden = run_epoch_golden(dev, os.path.join(root, "golden"))
        epoch_db5 = run_epoch_db5_sized(dev, os.path.join(root, "db5_sized"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("epoch", golden_fit=epoch_golden, db5_sized=epoch_db5)

    # -- halo: the main path of slice 4 -----------------------------------------
    halo = run_halo(dev, requests, train_golden)
    emit("halo", **halo)

    # -- times -----------------------------------------------------------------
    rows = []
    for c in e_cases + [eb_case, e16]:      # row 1 also at the step's shape
        a = c["args"]
        nbytes, flops = edge_cost(*a, c["out"])
        b_ms, b_by = bound(nbytes, flops)
        kern = lambda: em.edge_message_aggregate(*a, slope=slope)
        rows.append(dict(kernel="edge_message", shape=c["shape"], ms=device_ms(kern),
                         call_ms=call_ms(kern),
                         plain_ms=device_ms(lambda: em.edge_message_plain(*a, slope=slope)),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for c in (c for c in a_cases if c["timed"]):
        a = c["args"]
        q, k, v, qt, kt = a
        nbytes, flops = attention_cost(*a, c["out"])
        b_ms, b_by = bound(nbytes, flops)
        keep = (qt[:, :, None] > 0) & (qt[:, :, None] == kt[:, None, :])
        add_mask = torch.where(keep, 0.0, -1000.0)
        kern = lambda: ca.cross_attention_fwd(*a)
        rows.append(dict(kernel="cross_attention", shape=c["shape"], ms=device_ms(kern),
                         call_ms=call_ms(kern),
                         plain_ms=device_ms(lambda: ca.cross_attention_plain(*a)),
                         bound_ms=b_ms, bound_by=b_by,
                         library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                             q, k, v, attn_mask=add_mask, scale=1.0))))
    for c in (eb_case, e16):
        a = c["args"] + c["grads"]
        nbytes, flops = edge_bwd_cost(*a)
        b_ms, b_by = bound(nbytes, flops)
        # the whole backward as the path runs it: kernel, d_src scatter
        # kernel through the side's inverse list (built once per forward, 2
        # a step, timed apart), sum of the partials
        nbr, nsrc = a[3], a[0].shape[1]
        inv = em.inverse_neighbors(nbr, nsrc)
        kern = lambda a=a, inv=inv: em.edge_message_bwd(*a, slope=slope, inverse=inv)
        raw = em.edge_message_bwd_kernel(*a, slope=slope)
        leaves = [x.detach().requires_grad_(True) for x in (*a[:3], *a[5].values())]
        plain_out = em.edge_message_plain(*leaves[:3], a[3], a[4],
                                          dict(zip(em.PARAM_NAMES, leaves[3:])), slope)
        rows.append(dict(kernel="edge_message_bwd", shape=c["shape"], ms=device_ms(kern),
                         kernel_only_ms=device_ms(
                             lambda a=a: em.edge_message_bwd_kernel(*a, slope=slope)),
                         scatter_ms=device_ms(lambda raw=raw, nbr=nbr, nsrc=nsrc, inv=inv:
                                              em.launch_scatter(nbr, nsrc, *raw[:2], inv)),
                         inverse_build_ms=device_ms(
                             lambda nbr=nbr, nsrc=nsrc: em.inverse_neighbors(nbr, nsrc)),
                         call_ms=call_ms(kern), plain_ms=backward_ms(plain_out, leaves, a[6:]),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for c in ab_cases:
        q, k, v, qt, kt, o, lse, do = c["args"]
        args = (q, k, v, qt, kt, lse, do, c["delta"])
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        plain_o, _ = ca.cross_attention_plain(*leaves, qt, kt)
        plain = backward_ms(plain_o, leaves, do)
        lib_eager, lib_why = sdpa_bwd_ms(q, k, v, qt, kt, do)
        # the whole backward as device time, the same way for the port, the
        # plain version and SDPA: forward + backward in one CUDA graph less
        # the forward alone
        device_bwd = {
            "port": graph_backward_ms(lambda l: ca.cross_attention_fwd(*l, qt, kt)[0],
                                      (q, k, v), do),
            "plain": graph_backward_ms(lambda l: ca.cross_attention_plain(*l, qt, kt)[0],
                                       (q, k, v), do)}
        lib_ms, lib_graph_why = sdpa_graph_bwd_ms(q, k, v, qt, kt, do)
        device_bwd["sdpa"] = lib_ms
        for part, fn in (("dq", ca.cross_attention_dq), ("dkv", ca.cross_attention_dkv)):
            nbytes, flops = attention_bwd_cost(part, q, k, v, qt, kt, o, lse, do)
            b_ms, b_by = bound(nbytes, flops)
            kern = lambda fn=fn: fn(*args)
            rows.append(dict(kernel=f"cross_attention_{part}", shape=c["shape"],
                             ms=device_ms(kern), call_ms=call_ms(kern),
                             plain_ms=device_bwd["plain"], plain_eager_ms=plain,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             library_eager_ms=lib_eager,
                             library_note=lib_graph_why or lib_why,
                             whole_backward_device_ms=device_bwd))
    no_library = ("none: no single PyTorch call computes the soft-min field sums "
                  "(torch.cdist gives only the distances)")
    for c in s_cases[:3]:      # the training, ragged and largest shapes
        x, a, am = c["args"]
        for name in ("softmin_field", "softmin_field_bwd"):
            bwd = name.endswith("bwd")
            nbytes, flops = softmin_cost(x, a, am, c["c"] if bwd else None)
            b_ms, b_by = bound(nbytes, flops)
            if bwd:
                kern = lambda: ksf.softmin_field_bwd(x, a, am, c["c"], SIGMA)
                plain = lambda: sf.softmin_field_bwd_plain(x, a, am, c["c"], SIGMA)
            else:
                kern = lambda: ksf.softmin_field_fwd(x, a, am, SIGMA)
                plain = lambda: sf.softmin_field_sums_plain(x, a, am, SIGMA)
            rows.append(dict(kernel=name, shape=c["shape"], ms=device_ms(kern),
                             call_ms=call_ms(kern), plain_ms=device_ms(plain, reps=5),
                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             library_note=no_library))
    from equidock_public_tpu_torch.ops.cuda import halo_ring as hr
    for c in (h_exchange[0], h_exchange[3]):   # the request and the training batch, gp=2
        sides, grads = c["sides"], [(gx, gh, t) for (gx, gh), (*_, t) in zip(c["grads"],
                                                                            c["sides"])]
        lib_f, lib_b = library_gathers(sides, grads)
        for name, args, kern, plain, lib, bwd in (
                ("halo_exchange", sides, hr.exchange_kernel, hr.exchange_plain, lib_f, False),
                ("halo_exchange_bwd", grads, hr.exchange_bwd_kernel, hr.exchange_bwd_plain,
                 lib_b, True)):
            b_ms, b_by = bound(exchange_nbytes(args, kern(args), bwd), 0)
            rows.append(dict(kernel=name, shape=c["shape"],
                             ms=device_ms(lambda k=kern, a=args: k(a)),
                             call_ms=call_ms(lambda k=kern, a=args: k(a)),
                             plain_ms=device_ms(lambda p=plain, a=args: [p(*s) for s in a]),
                             bound_ms=b_ms, bound_by=b_by, library_ms=device_ms(lib),
                             library_note=("index_select, 4 calls (x and h of both sides) "
                                           "on inputs with a zero row appended beforehand"
                                           if not bwd else "torch.zeros and index_add_ "
                                           "(atomics), 4 calls (x and h of both sides)")))
    for name, c in combines.items():
        parts = c["parts"]
        b_ms, b_by = bound(nbytes_of(*parts, *c["outs"]), float(sum(p.numel() for p in parts)))
        kern = lambda c=c: c["kern"](*c["parts"])
        library = c["library"]
        rows.append(dict(kernel=name, shape=c["shape"], ms=device_ms(kern),
                         call_ms=call_ms(kern),
                         plain_ms=device_ms(lambda c=c: c["plain"](*c["parts"])),
                         bound_ms=b_ms, bound_by=b_by,
                         library_ms=device_ms(lambda: library(*parts)) if library else None,
                         library_note="torch.sum over the splits (the plain version's call)"
                         if library else "none: no single PyTorch call merges the splits"))
    from equidock_public_tpu_torch.cli.serve import warmup_batch

    profile_batch = warmup_batch(server.cfg, 512, 1024, dev)
    latency = [r["seconds"] * 1e3 for r in responses]
    emit("times", card=smi, kernels=rows, request_ms=latency,
         request_ms_median=statistics.median(latency), forward_ms=forward_ms,
         forward_ms_median=statistics.median(forward_ms),
         forward_profile_512x1024=device_profile(lambda: inner(profile_batch)["R"].cpu(),
                                                 reps=3),
         timing="ms, plain_ms, library_ms: device time per call from CUDA-graph "
                "replays; call_ms: eager back-to-back calls, host overhead included; "
                "edge backward rows: ms is kernel + scatter (through a prebuilt inverse "
                "list) + partial sums, inverse_build_ms the list's build (2 a step); "
                "plain_ms is the whole backward through an autograd "
                "graph built once, over back-to-back eager calls between CUDA events; "
                "attention backward rows (dq, dkv): plain_ms and library_ms are the "
                "whole backward (dq, dk and dv) as device time, forward and backward "
                "in one CUDA graph less the forward, the same for the port "
                "(whole_backward_device_ms.port); *_eager_ms: the same backward over "
                "back-to-back eager calls, host work included; the rows of the attention "
                "kernels (forward, dq, dkv) take kernel and combine pass together, the "
                "*_combine rows the combine pass alone",
         library_call="torch.nn.functional.scaled_dot_product_attention, scale 1, "
                      "additive mask (0 kept, -1000 masked); for rows 4 and 5 its "
                      "backward",
         wall_seconds=round(time.perf_counter() - wall0, 1))

    # -- kernel table, card, result -----------------------------------------
    def row(name, case_shape):
        return next(r for r in rows if r["kernel"] == name and r["shape"] == case_shape)

    main = {"edge_message": (row("edge_message", e_cases[1]["shape"]), edge_err),
            "cross_attention": (row("cross_attention", a_cases[1]["shape"]), att_err),
            "edge_message_bwd": (row("edge_message_bwd", eb_case["shape"]),
                                 edge_checks[len(e_cases)]["bwd"]["max_abs_err"]),
            "softmin_field": (row("softmin_field", s_cases[0]["shape"]),
                              max(c["err"] for c in s_cases)),
            "softmin_field_bwd": (row("softmin_field_bwd", s_cases[0]["shape"]),
                                  max(c["check"]["max_abs_err"] for c in s_cases))}
    for part in ("dq", "dkv"):
        main[f"cross_attention_{part}"] = (
            row(f"cross_attention_{part}", ab_cases[0]["shape"]),
            max(c[f"check_{part}"]["max_abs_err"] for c in ab_cases))
    h_checks = halo_checks["halo_exchange"]
    main["halo_exchange"] = (row("halo_exchange", h_exchange[0]["shape"]),
                             max(c["fwd_max_abs_err"] for c in h_checks))
    main["halo_exchange_bwd"] = (row("halo_exchange_bwd", h_exchange[3]["shape"]),
                                 max(c["bwd_max_abs_err"] for c in h_checks))
    for name, c in combines.items():
        main[name] = (row(name, c["shape"]), c["err"])
    # each combine pass beside its row: the same source, TPU kernel and path
    of_row = {k[0]: k for k in KERNELS}
    entries = list(KERNELS) + [(name, *of_row[row_name][1:])
                               for _, _, name, row_name in COMBINES]
    table = []
    for name, _, _, source, replaces, path in entries:
        r, err = main[name]
        by_path = {"serve": serve_launches[name], "train": train["launches"][name],
                   "epoch": epoch_golden["launches"][name],
                   "epoch_db5_sized": epoch_db5["launches"][name],
                   "halo_serve": halo["launches_serve"][name],
                   "halo_train": halo["train"]["launches"][name]}
        table.append(dict(name=name, route="cuda",
                          source=f"equidock_public_tpu_torch/{source}",
                          replaces=f"equidock_public_tpu/{replaces}",
                          launches=by_path[path], launches_by_path=by_path,
                          max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"],
                          bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          library_ms=r["library_ms"], shape=r["shape"]))
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
