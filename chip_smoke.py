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
  native   builds the host graph builder (native/graph_builder.cc) with one
           g++ call; on the chains of the served requests its distance
           matrices and kNN tables must be bit-equal to the numpy versions;
           both timed
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
           0, M = 1, N below one key tile) and at the clash descent's
           shapes (B = 1, masks of ones, sigma 8, 4132 x 3591 atoms both
           ways, against the plain versions in float64), with the stated
           tolerances; the
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
  models   the six other shipped models (assets/<name>.pt.xz: the DIPS-
           pretrained and curriculum 64-wide models, the four 16-wide ones)
           each serve their golden requests (the JAX package's dock_one)
           through DockingServer.serve_lines: keypoints within 1e-3 A, R
           within 1e-3, t and CA within 1e-2 A plus the measured R error's
           spectral norm times their lever arm; each forward launching rows
           1 and 3 2 x n_layers times
  resident on the cache of epoch (b): the training CLI with -device_resident
           -trim_remainder beside the host-loop CLI, in turns (resident,
           host loop, resident; 2 epochs each, no synchronization added):
           epoch seconds, pairs/s, the store's MB and peak device memory,
           launches per step; resident epochs apart from the CLI: one
           profiled (device idle share, device ops a step), one counting
           host syncs a step, one with each step timed between
           synchronizations (the step median); `fit` with device_resident and trim_remainder
           on the split chains of epoch (a) replaying the JAX package's
           draws against assets/db5_resident_fit.golden.json
  curriculum  synthetic DIPS shards (6 of 8 pairs, kNN graphs of the tracked
           chains' sizes) through the training CLI's default run (the DIPS
           -> DB5 curriculum) with -device_resident -stream_dips
           -stream_window 1, 1 epoch a stage: the DIPS train groups stream
           through a side CUDA stream; at the end the shard LRU holds at most
           1 shard, every uploaded group's tensors are released (weak
           references) and the device memory
           after the streamed epoch is that before it plus the new train
           state
  options  slice 7, full width (the paper DB5 model), on the DB5-sized
           split of epoch (b): (a) the training CLI one epoch each, packed
           (-pack -pack_max_per_slot 4), unpacked, packed, in turns (epoch
           seconds, pairs/s, slots a step, dead-node share; rows 1-5 10
           launches a step, rows 6-7 none when packed); the training
           golden's complexes packed 4 a slot (digest of
           assets/db5_train_step_packed.golden.json): a step's loss terms
           within 1e-5 and gradient norm within 1e-4 of the unpacked step's,
           3 packed steps against the packed golden's JAX steps, rows 1-2
           on its ligand and receptor tables (block-diagonal, the pad tail
           self-looping with mask 0) and rows 3-5 with its tags (up to 4)
           against their plain versions; (b) 3 train
           steps of the paper model from its committed weights with
           layer_norm and final_h_layer_norm 'BN', final_h 'BN' alone,
           swish, coordinate LN and dropout 0.1 (the CPU's masks replayed),
           each step against a step of the CPU's plain path from the same
           state at the training gate's first-step tolerances, with its
           kernel-path line and the rows it launched (rows 1-2 only where
           the edge kernel covers the config, else the plain layer body,
           counted); (c) the CLI's -fine_tune_from the unpacked epoch's
           checkpoint with -freeze_original -fine_tune_init copy, one epoch:
           the original stage bit-equal, the fine-tune stage moved; (d) a
           gradient with and without remat (bit-equal, peak memory); (e) a
           step with the exact OT solver: its OT loss against the same plan
           on the CPU, the host LP's ms
  slice8   (slice 8, after options; one JSON line a part, each with its
           seconds) (a) a 'BN' model (the paper's config with layer_norm
           and final_h 'BN', its committed weights) and a bf16 model (the
           16-wide db5_model_small at bf16), trained 2 steps through the
           CLI (-continue_train_model of a step-0 checkpoint), every step
           held to a CPU step from the same state (bf16: the loss terms
           within 2^-8, the gradient norm within the CPU's bf16 - f32
           distance), each training checkpoint served through
           DockingServer.from_checkpoint on the 4 golden requests against
           the CPU's forward of the same checkpoint ('BN': the serving
           gates; bf16: R, t, CA and keypoints within d0 / 2 of the CPU's
           bf16 and at least d0 / 4 off its f32, BF16_SHARE, and the
           checkpoint served at f32 to the 16-wide models' serving gates)
           and through cli.inference; (b) the paper model served at
           -dtype bfloat16 against assets/db5_model_best_bf16.golden.json
           (R, t, CA, keypoints within half of d0), request ms and the
           forward's device profile at
           bf16 and f32 in turns; (c) one CLI epoch with -node_buckets
           auto:4 -pocket_buckets auto:4 on epoch (b)'s split (the
           resolved ladders), rows 1-7 at the largest resolved bucket off a
           multiple of 512 (keys 64 more) against their plain versions,
           timed; (d) teacher poses written by directory inference on the
           card, one distilled CLI epoch, its blended targets against the
           host's; (e) slices 6-7's paths at 2 layers from the committed
           weights, every train step held to a CPU step from the same
           state: 'BN' with dropout and remat through a CLI and a resident
           epoch, coordinate 'BN', -fine_tune_init random, -continue_train_
           model of that fine-tune checkpoint, packed DIPS streaming with
           -stream_window 2, a resident epoch with -val_repeats 2 under the
           cyclic scheduler; each run's launches as counted
  slice9   (slice 9, after slice8; one JSON line a part, each with its
           seconds) raw PDB files to caches the port builds, trained on the
           card, against assets/slice9.golden.json (the JAX package's
           outputs on the same tree, its recipe inside): (a) a DB5 tree of
           16 tracked chains cut in two (10 / 3 / 3) under
           EQUIDOCK_REFERENCE_ROOT; (b) cli.preprocess at -n_jobs 4 and 1
           as processes, each cache's ints and bools hash-equal to the
           JAX digest and its floats' sums within 1e-6 (the codes kept and
           dropped equal); (c) the paper model from its committed weights,
           cli.train -toy -max_epochs 1 on that cache, every step held to
           the CPU, rows 1-7 at path_launches' counts; (d) cli.testset_gen
           (coordinates within 1e-3 A of JAX's), -dips_frozen_complexes of
           its complexes (digests as (b)), cli.inference on the card
           against the CPU's forward at the serving gates, cli.eval_outputs,
           cli.align_receptor (residual below 0.1, the ligand as JAX's);
           (e) cli.crop_corpus (digests as (b)), then the curriculum (the
           DIPS stage streaming the crops, the DB5 stage on (b)'s cache)
           one epoch a stage, every step held; (f) cli.hyper_search, 2
           trials each a process on the card, the draws and banners JAX's,
           each checkpoint served a request, the kernels' build directory
           untouched; (g) two steps in profiling.trace (the Chrome trace
           names rows 1-7's kernels and the named span), StepTimer's mean
           beside chip_smoke's own step median; (h) cli.padding_report
           (equal to JAX's) and cli.surface_analysis -depth sas / hull on
           two chains (rhos within 1e-9), preprocess seconds a complex and
           crop seconds a pair; (i) the DIPS pickle readers and
           cli.partition_dips need pandas: CPU tests only
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
  inference  the rest of inference: (a) the 4 requests served with the
           native builder and with its numpy versions, in turns (request
           ms); (b) remove_clashes: the descent of the clash golden file's
           request (4132 x 3591 atoms) from the JAX package's docked pose
           and from its shifted pose on rows 6 and 7 (2 launches of each an
           evaluation, the backward none at the stop), the same steps, loss
           and moved atoms as the JAX package's, again on the plain
           versions on the card, then the request served with
           remove_clashes per request and batched; (c) batched serving,
           max_batch 4, warmed at 4 slots: the 4 requests as one
           co-arrival, grouped by bucket pair, against the serving golden
           file (forward ms and dead slots a group); (d) run_inference_dir,
           run_batched_inference and a two-member ensemble on a directory
           of tracked chains cut in two, each scored by evaluate_output_dir
           and held to the same path on the plain versions on the card
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
import gc
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
import weakref

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


def expect_launches(what: str, counts: dict, want: dict, inverse: int) -> None:
    """Each kernel launched exactly as `want` says (0 where it says nothing),
    the scatter once a backward, `inverse` inverse neighbour lists built,
    no halo table, each combine pass once with its kernel."""
    for name, *_ in KERNELS:
        require(counts[name] == want.get(name, 0),
                f"{what}: {name} launched {counts[name]} times, expected {want.get(name, 0)}")
    require(counts["edge_message_scatter"] == counts["edge_message_bwd"],
            f"{what}: the edge backward's scatter launched {counts['edge_message_scatter']} "
            f"times for {counts['edge_message_bwd']} backwards")
    require(counts[HALO_TABLES[2]] == 0, f"{what}: halo exchange tables built")
    require(counts[INVERSE[2]] == inverse,
            f"{what}: {counts[INVERSE[2]]} inverse neighbour lists built, expected {inverse}")
    expect_combines(what, counts)


def step_launches(layers: int, steps: int, evals: int, edge: bool = True,
                  softmin: bool = False) -> dict:
    """Launches of `steps` train steps and `evals` forwards without gradient
    of a model of `layers` layers: rows 1 and 3 two a layer a forward, rows
    2, 4 and 5 two a layer a step (rows 1-2 only with `edge`), rows 6-7 two
    a forward / a step with `softmin`."""
    per = SIDES * layers
    want = {"cross_attention": per * (steps + evals), "cross_attention_dq": per * steps,
            "cross_attention_dkv": per * steps}
    if edge:
        want.update(edge_message=per * (steps + evals), edge_message_bwd=per * steps)
    if softmin:
        want.update(softmin_field=2 * (steps + evals), softmin_field_bwd=2 * steps)
    return want


def expect_counts(what: str, counts: dict, steps: int, evals: int, fused: bool) -> None:
    """The paper model's launches for `steps` training steps and `evals`
    forwards without gradient (`step_launches`, the soft-min field kernels
    with `fused`), one inverse neighbour list built per side per step."""
    expect_launches(f"{what} ({steps} steps, {evals} forwards)", counts,
                    step_launches(LAYERS, steps, evals, softmin=fused), PER_STEP_INVERSE * steps)


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
    outputs, and two launches bit-equal. Fills c["err"] and c["check"]. A
    case may carry its own "sigma", and "reference": "float64" to be held
    to the plain versions evaluated in float64 (rounded to f32); the f32
    plain versions' own errors against that are reported as c["plain_f32"]."""
    from equidock_public_tpu_torch.ops import softmin_field as sf
    from equidock_public_tpu_torch.ops.cuda import softmin_field as ksf

    (x, a, am), name = c["args"], c["shape"]
    sigma = c.get("sigma", SIGMA)
    f64 = c.get("reference") == "float64"
    ref = ((lambda *t: [u.double() for u in t]) if f64 else (lambda *t: list(t)))
    B, M, N = x.shape[0], x.shape[1], a.shape[1]
    bufs, views = guarded([(B, M)], x.device)
    got = ksf.softmin_field_fwd(x, a, am, sigma, out=views)
    synced(f"softmin_field {name}")
    require_guards(f"softmin_field {name}", bufs)
    want_s = sf.softmin_field_sums_plain(*ref(x, a, am), sigma).float()
    c["err"] = check_close(f"softmin_field {name}", [got], [want_s], SOFTMIN_TOL)
    require(torch.equal(got, ksf.softmin_field_fwd(x, a, am, sigma)),
            f"softmin_field {name}: two launches on the same inputs differ")
    bufs, views = guarded([(B, M, 3), (B, N, 3)], x.device)
    got = ksf.softmin_field_bwd(x, a, am, c["c"], sigma, out=views)
    synced(f"softmin_field_bwd {name}")
    require_guards(f"softmin_field_bwd {name}", bufs)
    want = [w.float() for w in sf.softmin_field_bwd_plain(*ref(x, a, am, c["c"]), sigma)]
    c["check"] = check_grads("softmin_field_bwd", name, got, want)
    again = ksf.softmin_field_bwd(x, a, am, c["c"], sigma)
    require(all(torch.equal(g, h) for g, h in zip(got, again)),
            f"softmin_field_bwd {name}: two launches on the same inputs differ")
    if f64:
        plain_g = sf.softmin_field_bwd_plain(x, a, am, c["c"], sigma)
        c["plain_f32"] = {
            "softmin_field_max_abs_err": max_err(
                [sf.softmin_field_sums_plain(x, a, am, sigma)], [want_s]),
            "softmin_field_bwd_rel_err": [rel_err(g, w) for g, w in zip(plain_g, want)]}


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


DB5_SIZED_SPLIT = {"train": 152, "val": 25, "test": 25}


def db5_sized_argv(root, epochs=2) -> list:
    """The training CLI's flags of the epoch phase (b): the DB5 paper model's
    widths, the fused intersection loss, seed 0, `epochs` epochs (None: no
    -max_epochs), the caches under root/cache."""
    return (["-shared_layers", "-iegmn_n_lays", "5", "-iegmn_lay_hid_dim", "64",
             "-residue_emb_dim", "64", "-num_att_heads", "50", "-w_decay", "1e-3",
             "-node_buckets", "512,1024,2048,3072", "-pocket_buckets", "256,512,1024",
             "-use_fused_intersection", "-random_seed", "0",
             "-cache_dir", os.path.join(root, "cache"), "-device", "cuda"]
            + ([] if epochs is None else ["-max_epochs", str(epochs)]))


def write_db5_sized_split(root) -> None:
    """The DB5-sized synthetic split (DB5_SIZED_SPLIT complexes, sizes of
    the tracked chains, seed 7) as npz caches under root/cache."""
    from equidock_public_tpu_torch.cli import train as cli
    from equidock_public_tpu_torch.data.synth import write_synth_split

    cfg = cli.config_from_args(cli._parser().parse_args(db5_sized_argv(root)))
    sizes = db5_sized_sizes(sum(DB5_SIZED_SPLIT.values()))
    start = 0
    for i, (split, n) in enumerate(DB5_SIZED_SPLIT.items()):
        write_synth_split(os.path.join(cfg.cache_path(), f"{split}.npz"),
                          sizes[start:start + n], seed=i, k=cfg.graph.graph_max_neighbor)
        start += n


def run_epoch_db5_sized(dev, root) -> dict:
    """Epoch phase (b): the training CLI (`cli/train.py::main`), 2 epochs of
    a random full-width DB5 paper model (shared layers, 5 layers, 64 wide,
    50 heads) with the fused intersection loss, on a synthetic split of
    the cv_fold0 counts (152 / 25 / 25); each step timed between
    synchronizations; then one more epoch under the profiler."""
    from equidock_public_tpu_torch.cli import train as cli
    from equidock_public_tpu_torch.data.dataset import DockingDataset
    from equidock_public_tpu_torch.train import loop
    from equidock_public_tpu_torch.train.checkpoint import load_checkpoint

    counts_by_split = DB5_SIZED_SPLIT
    argv = db5_sized_argv(root) + ["-checkpoint_dir", os.path.join(root, "ckpt")]
    cfg = cli.config_from_args(cli._parser().parse_args(argv))
    t0 = time.perf_counter()
    write_db5_sized_split(root)
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
# Slice 5: the rest of inference
# --------------------------------------------------------------------------- #

CLASH_SIGMA, CLASH_CT = 8.0, 8.0    # remove_clashes_descent's defaults
MAX_BATCH = 4                       # batched serving
# Outputs of one model through two paths on the card (batched against one
# complex a forward, kernels against the plain versions): the serving gate
# on t and CA, in A; PDB files hold 3 decimals.
PATH_ATOL = 1e-2
DIR_CODES = ("2VDB", "2SNI", "1NW9", "1AVX")   # tracked chains cut in two
# The request served with remove_clashes starts from the port's own docked
# pose, which differs from the JAX package's by the forward's rounding (R
# within about 3e-5); the descent turns the ligand about the origin, some
# 80 A away, and carries that on: 0.057 A at the recorded atoms through the
# port's CPU path against the JAX golden file. The golden file's own cases
# start from the JAX package's pose and are held to its tolerance.
SERVED_CLASH_ATOL = 0.25


def load_asset(name: str) -> dict:
    with open(os.path.join(REPO, "equidock_public_tpu_torch", "assets", name)) as f:
        return json.load(f)


def chain_path(code: str) -> str:
    return os.path.join(REPO, "artifacts", "db5_test_outputs", f"{code}_l_b_EQUIDOCK_TPU.pdb")


def clash_start(g):
    """(ligand atoms at the clash golden's docked pose, receptor atoms),
    float32: R @ ligand + t in numpy, as the JAX package's dock_one moves
    them."""
    from equidock_public_tpu_torch.data.pdb import read_pdb

    lig = read_pdb(os.path.join(REPO, g["ligand"])).coords
    rec = read_pdb(os.path.join(REPO, g["receptor"])).coords.astype(np.float32)
    R, t = np.asarray(g["R"], np.float32), np.asarray(g["t"], np.float32)
    return ((R @ lig.T).T + t).astype(np.float32), rec


def descent_softmin_cases(dev):
    """Rows 6 and 7 at the descent's shapes: B = 1, masks of ones, the clash
    golden request's atoms at its docked pose (4132 ligand, 3591 receptor),
    sigma 8, in both directions, with the cotangent of S that the descent's
    loss gives there; held to the plain versions in float64."""
    from equidock_public_tpu_torch.ops import softmin_field as sf

    lig, rec = clash_start(load_asset("db5_clashes.golden.json"))
    cases = []
    for q, k, what in ((lig, rec, "ligand atoms in the receptor's field"),
                       (rec, lig, "receptor atoms in the ligand's field")):
        x = torch.from_numpy(q).to(dev)[None].contiguous()
        a = torch.from_numpy(k).to(dev)[None].contiguous()
        am = torch.ones(1, a.shape[1], device=dev)
        s = sf.softmin_field_sums_plain(x.double(), a.double(), am.double(), CLASH_SIGMA)
        g = -CLASH_SIGMA * torch.log(1e-3 + s)
        c = torch.where(CLASH_CT - g > 0, CLASH_SIGMA / (1e-3 + s), 0.0) / x.shape[1]
        cases.append(dict(shape=f"B=1 M={x.shape[1]} N={a.shape[1]} (descent: {what}, "
                                f"sigma 8, masks of ones)", args=(x, a, am),
                          c=c.float().contiguous(), sigma=CLASH_SIGMA, reference="float64"))
    return cases


def run_native() -> dict:
    """The native graph builder: one g++ call into _build/, then on the
    chains of the served requests its distance matrix and kNN tables
    bit-equal to the numpy versions, both timed (host ms)."""
    from equidock_public_tpu_torch import native
    from equidock_public_tpu_torch.data import featurize as fz
    from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb

    res = native.build()
    require(res.seconds > 0, "the native library was not built in this run")
    golden = load_asset("db5_model_best.golden.json")["requests"]
    codes = sorted({os.path.basename(p)[:4] for g in golden for p in (g["ligand"], g["receptor"])})
    rows = []
    for code in codes:
        atoms = fz.local_frames(fz.filter_residues(group_residues(read_pdb(chain_path(code)))))[-1]
        ms = {}
        for name, fn in (("native", native.residue_mean_dist),
                         ("numpy", fz.residue_mean_distance_matrix)):
            t0 = time.perf_counter()
            ms[name] = (fn(atoms), (time.perf_counter() - t0) * 1e3)
        require(np.array_equal(ms["native"][0], ms["numpy"][0]),
                f"{code}: native distance matrix differs from the numpy version")
        tables = {}
        for name, fn in (("native", native.knn_edges), ("numpy", fz.knn_tables)):
            t0 = time.perf_counter()
            tables[name] = (fn(ms["native"][0], 30.0, 10), (time.perf_counter() - t0) * 1e3)
        require(all(np.array_equal(u, v) for u, v in zip(tables["native"][0], tables["numpy"][0])),
                f"{code}: native kNN tables differ from the numpy version")
        rows.append(dict(chain=code, residues=len(atoms), atoms=int(sum(len(a) for a in atoms)),
                         distances_native_ms=ms["native"][1], distances_numpy_ms=ms["numpy"][1],
                         knn_native_ms=tables["native"][1], knn_numpy_ms=tables["numpy"][1]))
    return dict(build_seconds=round(res.seconds, 3), library=os.path.relpath(res.path, REPO),
                flags=list(native.CXX_FLAGS), bit_equal_to_numpy=codes, chains=rows,
                threads=os.cpu_count())


@contextlib.contextmanager
def numpy_graph_builder():
    """build_protein_graph on the numpy versions instead of the native
    library, for timing the featurization it replaced."""
    from equidock_public_tpu_torch import native
    from equidock_public_tpu_torch.data import featurize as fz

    saved = native.residue_mean_dist, native.knn_edges
    native.residue_mean_dist, native.knn_edges = fz.residue_mean_distance_matrix, fz.knn_tables
    try:
        yield
    finally:
        native.residue_mean_dist, native.knn_edges = saved


def serve_lines_ms(server, golden, out_dir, **extra) -> list:
    """Per-request seconds (ms) of the golden requests through serve_lines."""
    lines = [json.dumps({"ligand": os.path.join(REPO, g["ligand"]),
                         "receptor": os.path.join(REPO, g["receptor"]),
                         "output": os.path.join(out_dir, f"r{i}.pdb"), **extra})
             for i, g in enumerate(golden)]
    buf = io.StringIO()
    server.serve_lines(lines, buf)
    resp = [json.loads(x) for x in buf.getvalue().splitlines()]
    require(len(resp) == len(golden) and all(r["ok"] for r in resp), f"requests failed: {resp}")
    return [r["seconds"] * 1e3 for r in resp]


def check_descent(what, got, case, atoms, tol) -> dict:
    """A descent on the card against a case of the clash golden file: the
    same steps and stop, the loss and the recorded atoms within tol."""
    require(np.isfinite(got.coords).all(), f"{what}: non-finite coordinates")
    require((got.iterations, got.stopped) == (case["steps"], case["stopped"]),
            f"{what}: {got.iterations} steps (stopped {got.stopped}), the JAX package "
            f"{case['steps']} (stopped {case['stopped']})")
    v_err = abs(got.value - case["value"])
    require(v_err <= tol["value_atol"], f"{what}: loss {got.value:.7g} at the stop, "
                                        f"JAX {case['value']:.7g}")
    err = float(np.abs(got.coords[atoms] - np.asarray(case["coords"])).max())
    require(err <= tol["coords_atol"], f"{what}: atoms {err:.3g} A from the JAX package's")
    return dict(steps=got.iterations, value=got.value, value_err=v_err, coords_max_abs_err=err)


def run_clashes(dev, server) -> dict:
    """remove_clashes on the card: the clash golden's two descents from its
    exact start through rows 6 and 7 (2 forward launches an evaluation, 2
    backward a step), then on the plain versions on the card; the served
    request with remove_clashes per request and batched."""
    from equidock_public_tpu_torch.data.pdb import read_pdb
    from equidock_public_tpu_torch.eval.inference import remove_clashes_descent

    g = load_asset("db5_clashes.golden.json")
    lig, rec = clash_start(g)
    atoms, shift, tol = np.asarray(g["atoms"]), np.asarray(g["shift"], np.float32), g["tolerance"]
    out = {"tolerance": tol}
    for name, l0, r0 in (("served", lig, rec), ("shifted", lig - shift, rec - shift)):
        case = g["cases"][name]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = remove_clashes_descent(l0, r0, device=dev)
        seconds = time.perf_counter() - t0
        launches = read_counts()
        evals = got.iterations + int(got.stopped)
        want = {"softmin_field": 2 * evals, "softmin_field_bwd": 2 * got.iterations}
        for k, n in want.items():
            require(launches[k] == n, f"descent {name}: {k} launched {launches[k]} times, "
                                      f"expected {n} ({got.iterations} steps)")
        require(all(launches[k] == 0 for k, *_ in KERNELS if k not in want),
                f"descent {name}: other kernels launched: {launches}")
        check = check_descent(f"descent {name}", got, case, atoms, tol)
        with plain_versions():
            plain = remove_clashes_descent(l0, r0, device=dev)
        plain_check = check_descent(f"descent {name} (plain versions)", plain, case, atoms, tol)
        out[name] = dict(check, seconds=seconds, ms_per_step=seconds * 1e3 / max(evals, 1),
                         launches=launches,
                         plain_versions=plain_check,
                         kernel_vs_plain_max_abs=float(np.abs(got.coords - plain.coords).max()))
    # where a step's time goes: a device profile of 20 steps from the served pose
    out["profile_20_steps"] = device_profile(
        lambda: remove_clashes_descent(lig, rec, max_iters=20, device=dev), reps=1)
    # the request itself, served with remove_clashes, per request and batched
    req = {"ligand": os.path.join(REPO, g["ligand"]), "receptor": os.path.join(REPO, g["receptor"]),
           "remove_clashes": True}
    out_dir = tempfile.mkdtemp(prefix="equidock_clash_")
    try:
        paths = [os.path.join(out_dir, n) for n in ("one.pdb", "batched.pdb")]
        buf = io.StringIO()
        reset_counts()
        server.serve_lines([json.dumps(dict(req, output=paths[0]))], buf)
        server.serve_batched([json.dumps(dict(req, output=paths[1]))], buf, MAX_BATCH)
        launches = read_counts()
        resp = [json.loads(x) for x in buf.getvalue().splitlines()]
        require(all(r["ok"] for r in resp), f"served remove_clashes failed: {resp}")
        coords = [read_pdb(p).coords for p in paths]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    served = np.asarray(g["cases"]["served"]["coords"])
    errs = [float(np.abs(c[atoms] - served).max()) for c in coords]
    for what, e in zip(("per request", "batched"), errs):
        require(e <= SERVED_CLASH_ATOL, f"served remove_clashes ({what}): atoms {e:.3g} A "
                                        "from the JAX package's descent")
    require(launches["softmin_field_bwd"] > 0, "served remove_clashes launched no row 7")
    out["served_request"] = dict(seconds=[r["seconds"] for r in resp],
                                 atoms_max_abs_err=errs, atol=SERVED_CLASH_ATOL,
                                 launches=launches)
    return out


def run_batched_serving(server, golden) -> dict:
    """Batched serving (max_batch 4, warmed at 4 slots): the 4 golden
    requests as one co-arrival, grouped by bucket pair, each group one
    forward; R, t and CA against the serving golden file."""
    n_warm, warm_s = server.warmup(WARMUP_BUCKETS, batch_size=MAX_BATCH)
    inner, outputs, groups = server.forward, [], []

    def recording_forward(batch):
        out = inner(batch)
        outputs.append(out)
        return out

    server.forward = recording_forward
    out_dir = tempfile.mkdtemp(prefix="equidock_batched_")
    try:
        lines = [json.dumps({"ligand": os.path.join(REPO, g["ligand"]),
                             "receptor": os.path.join(REPO, g["receptor"]),
                             "output": os.path.join(out_dir, f"req{i}.pdb")})
                 for i, g in enumerate(golden)]
        buf = io.StringIO()
        reset_counts()
        served = server.serve_batched(lines, buf, MAX_BATCH, on_group=groups.append)
        launches = read_counts()
        resp = [json.loads(x) for x in buf.getvalue().splitlines()]
    finally:
        server.forward = inner
        shutil.rmtree(out_dir, ignore_errors=True)
    require(served == len(golden) and all(r["ok"] and r["batched"] == len(golden) for r in resp),
            f"batched serving: {resp}")
    # the groups (one forward each) in order of first arrival; each request
    # in the next slot of its group
    keys = [tuple(gr["buckets"]) for gr in groups]
    filled, slots = [0] * len(keys), []
    for r in resp:
        k = keys.index((bucket_of(server, r["num_lig_res"]), bucket_of(server, r["num_rec_res"])))
        slots.append((k, filled[k]))
        filled[k] += 1
    worst = {k: 0.0 for k in GOLDEN_ATOL}
    for (group, j), g in zip(slots, golden):
        o = outputs[group]
        got = {"R": o["R"][j].cpu().numpy(), "t": o["t"][j, 0].cpu().numpy(),
               "ca": o["ligand_coords"][j, :8].cpu().numpy()}
        for k, atol in GOLDEN_ATOL.items():
            err = float(np.abs(got[k] - np.asarray(g[k])).max())
            worst[k] = max(worst[k], err)
            require(np.isfinite(got[k]).all() and err <= atol,
                    f"batched {g['ligand']}: {k} differs from the JAX golden value by {err:.3g}")
    per_fwd = LAYERS * SIDES
    for k in ("edge_message", "cross_attention"):
        require(launches[k] == per_fwd * len(groups),
                f"batched: {k} launched {launches[k]} times for {len(groups)} forwards")
    expect_combines("batched", launches)
    return dict(warmed=n_warm, warmup_seconds=warm_s, max_batch=MAX_BATCH, launches=launches,
                groups=[dict(gr, forward_ms=gr.pop("forward_seconds") * 1e3) for gr in groups],
                batch_seconds=resp[0]["batch_seconds"], golden_max_abs_err=worst)


def bucket_of(server, n: int) -> int:
    from equidock_public_tpu_torch.config import bucket_for

    return bucket_for(n, server.cfg.data.node_buckets)


def write_complex_dirs(root: str):
    """in/X_l_b.pdb, gt/X_{l,r}_b_COMPLEX.pdb: the tracked chains of
    DIR_CODES cut in two at half their residues (file order)."""
    inp, gt = os.path.join(root, "in"), os.path.join(root, "gt")
    os.makedirs(inp)
    os.makedirs(gt)
    from equidock_public_tpu_torch.data.synth import write_chain_halves

    for code in DIR_CODES:
        lig = os.path.join(gt, f"{code}_l_b_COMPLEX.pdb")
        write_chain_halves(chain_path(code), lig, os.path.join(gt, f"{code}_r_b_COMPLEX.pdb"))
        shutil.copy(lig, os.path.join(inp, f"{code}_l_b.pdb"))
    return inp, gt


def run_directories(dev, root) -> dict:
    """run_inference_dir, run_batched_inference (2 a batch) and a two-member
    ensemble (the shipped weights and a random 16-wide db5_model_small-sized
    model) on a directory of tracked chains cut in two, each scored by
    evaluate_output_dir; each against the same path on the plain versions
    on the card, the batched outputs against the per-complex ones."""
    from equidock_public_tpu_torch.config import Config, ModelConfig
    from equidock_public_tpu_torch.data.pdb import read_pdb
    from equidock_public_tpu_torch.eval.batch_inference import run_batched_inference
    from equidock_public_tpu_torch.eval.ensemble import Member, run_ensemble_dir
    from equidock_public_tpu_torch.eval.inference import run_inference_dir
    from equidock_public_tpu_torch.eval.rmsd import evaluate_output_dir
    from equidock_public_tpu_torch.params import (default_checkpoint, init_params,
                                                  load_checkpoint, save_params)

    inp, gt = write_complex_dirs(root)
    params, cfg = load_checkpoint(default_checkpoint(), dev)
    small_cfg = dataclasses.replace(cfg, model=ModelConfig(
        residue_emb_dim=16, iegmn_lay_hid_dim=16, iegmn_n_lays=2, num_att_heads=8))
    small = os.path.join(root, "small.pt.xz")
    save_params(small, init_params(small_cfg.model, seed=3))
    with open(os.path.join(root, "small.config.json"), "w") as f:
        json.dump(dataclasses.asdict(small_cfg), f)
    n = len(DIR_CODES)
    quiet = lambda *a: None
    members = lambda: [Member(p, cfg, dev) for p in (default_checkpoint(), small)]
    paths = {
        "inference_dir": (lambda d: run_inference_dir(params, cfg, inp, gt, d, log=quiet,
                                                      device=dev), "equidock_tpu",
                          {"edge_message": 10 * n}),
        "batch_inference": (lambda d: run_batched_inference(params, cfg, inp, gt, d,
                                                            batch_size=2, log=quiet,
                                                            device=dev), "equidock_tpu",
                            {"edge_message": 10 * -(-n // 2)}),
        "ensemble": (lambda d: run_ensemble_dir(members(), inp, gt, d, log=quiet),
                     "equidock_tpu_ens", {"edge_message": (10 + 4) * n}),
    }
    out, coords = {}, {}
    for name, (run, method, want) in paths.items():
        d = os.path.join(root, name)
        reset_counts()
        t0 = time.perf_counter()
        run(d)
        seconds = time.perf_counter() - t0
        launches = read_counts()
        require(launches["edge_message"] == want["edge_message"]
                and launches["cross_attention"] == want["edge_message"],
                f"{name}: {launches['edge_message']} edge and {launches['cross_attention']} "
                f"attention launches, expected {want['edge_message']} each")
        expect_combines(name, launches)
        scores = evaluate_output_dir(d, gt, method)
        require(scores["num_files"] == n and all(np.isfinite(v) for v in scores.values()),
                f"{name}: scores {scores}")
        with plain_versions():
            run(d + "_plain")
        files = sorted(os.listdir(d))
        coords[name] = {f: read_pdb(os.path.join(d, f)).coords for f in files}
        err = max(float(np.abs(c - read_pdb(os.path.join(d + "_plain", f)).coords).max())
                  for f, c in coords[name].items())
        require(err <= PATH_ATOL, f"{name}: kernels {err:.3g} A from the plain versions")
        out[name] = dict(seconds=seconds, launches=launches, scores=scores,
                         vs_plain_max_abs=err)
    err = max(float(np.abs(coords["batch_inference"][f] - c).max())
              for f, c in coords["inference_dir"].items())
    require(err <= PATH_ATOL, f"batched inference {err:.3g} A from one complex a forward")
    out["batched_vs_per_complex_max_abs"] = err
    out["atol"] = PATH_ATOL
    return out


# --------------------------------------------------------------------------- #
# Slice 6: the other tracked models, device-resident and streamed epochs,
# the DIPS -> DB5 curriculum
# --------------------------------------------------------------------------- #

def model_served_atol(g, R) -> dict:
    """One golden request's tolerances, given the port's rotation R: the
    keypoints 1e-3 A, R 1e-3, t and CA 1e-2 A plus the measured rotation
    error's spectral norm times their lever arm. With t = m_rec - R m_lig
    and CA - m_rec = R (x - m_lig), |dR m_lig| and |dR (x - m_lig)| are at
    most ||dR||_2 |m_lig| and ||dR||_2 |CA - m_rec|; the keypoints' own
    error (the centroids' shift) stays inside the 1e-2 A. The same as
    tests/test_torch_models.py::served_atol."""
    d_r = np.linalg.norm(np.asarray(R, np.float64) - np.asarray(g["R"], np.float64), 2)
    lever_t = np.linalg.norm(np.mean(g["keypts_lig"], axis=0))
    lever_ca = np.linalg.norm(np.asarray(g["ca"]) - np.mean(g["keypts_rec"], axis=0),
                              axis=-1).max()
    return dict(GOLDEN_ATOL, keypts=1e-3, t=GOLDEN_ATOL["t"] + d_r * lever_t,
                ca=GOLDEN_ATOL["ca"] + d_r * lever_ca)


def run_models(dev, out_dir) -> dict:
    """The models phase: each of the six other shipped models serves its
    golden requests through `serve_lines`; each forward launches rows 1 and
    3 2 x n_layers times (and their combine passes as often) and builds no
    inverse list."""
    from equidock_public_tpu_torch.cli.serve import DockingServer
    from equidock_public_tpu_torch.params import TRACKED_MODELS, model_checkpoint

    out, failed = {"launches": {}}, []
    for name in TRACKED_MODELS[1:]:
        golden = load_asset(f"{name}.golden.json")
        server = DockingServer.from_checkpoint(model_checkpoint(name), dev)
        m = server.cfg.model
        outputs, forward_ms, inner = [], [], server.forward

        def recording(batch, inner=inner, outputs=outputs, forward_ms=forward_ms):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = inner(batch)
            torch.cuda.synchronize()
            forward_ms.append((time.perf_counter() - t0) * 1e3)
            outputs.append({k: o[k][0].cpu().numpy() for k in ("R", "keypts_lig", "keypts_rec")}
                           | {"t": o["t"][0, 0].cpu().numpy(),
                              "ca": o["ligand_coords"][0, :8].cpu().numpy()})
            return o

        server.forward = recording
        lines = [json.dumps({"ligand": os.path.join(REPO, g["ligand"]),
                             "receptor": os.path.join(REPO, g["receptor"]),
                             "output": os.path.join(out_dir, f"{name}_{i}.pdb")})
                 for i, g in enumerate(golden["requests"])]
        buf = io.StringIO()
        reset_counts()
        served = server.serve_lines(lines, buf)
        counts = read_counts()
        responses = [json.loads(x) for x in buf.getvalue().splitlines()]
        require(served == len(lines) == len(outputs) and all(r.get("ok") for r in responses),
                f"{name}: served {served} of {len(lines)}: {responses}")
        per_fwd = 2 * m.iegmn_n_lays
        for kernel in ("edge_message", "cross_attention"):
            require(counts[kernel] == per_fwd * served,
                    f"{name}: {kernel} launched {counts[kernel]} times for {served} forwards "
                    f"of {m.iegmn_n_lays} layers")
        require(counts[INVERSE[2]] == 0, f"{name}: inverse lists built without gradient")
        expect_combines(name, counts)
        worst, errors = {}, []
        for o, g in zip(outputs, golden["requests"]):
            errs = {}
            for k, atol in model_served_atol(g, o["R"]).items():
                keys = ("keypts_lig", "keypts_rec") if k == "keypts" else (k,)
                for key in keys:
                    got = o[key]
                    require(np.isfinite(got).all(), f"{name}: non-finite {key}")
                    err = float(np.abs(got - np.asarray(g[key])).max())
                    worst[key] = max(worst.get(key, 0.0), err)
                    errs[key] = [err, atol]
                    if err > atol:
                        failed.append(f"{name} {g['ligand']}: {key} {err:.3g} > {atol:.3g} "
                                      "from the JAX golden value")
            errors.append(errs)
        out[name] = dict(errors_and_atol=errors,width=m.iegmn_lay_hid_dim, layers=m.iegmn_n_lays,
                         shared_layers=m.shared_layers, heads=m.num_att_heads,
                         requests=served, dropped=golden["dropped"],
                         launches=counts, golden_max_abs_err=worst, forward_ms=forward_ms)
        for k, v in counts.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    if failed:
        emit("models_failed", **out)
    require(not failed, "; ".join(failed))
    return out


def resident_eval_steps(ds, cfg, bs) -> int:
    """Forwards without gradient of one resident evaluation of `ds`: one a
    step, ceil(n / bs) steps a bucket group (trimmed or not)."""
    from equidock_public_tpu_torch.train.resident import _group_by_bucket

    return sum(-(-len(v) // bs) for v in _group_by_bucket(ds, cfg).values())


def run_cli(argv, cwd) -> dict:
    """`cli/train.py::main(argv)` from `cwd` (its text and scalars logs go to
    ./stdouterr there), as a user runs it: no synchronization added; every
    kernel count set to 0 just before and read just after. Returns the
    launches, the banner of the model the run trained (as its log names
    it), the records of the scalars file (one an epoch and one a test,
    stage after stage), the seconds, the text logged and the peak device
    memory."""
    from equidock_public_tpu_torch.cli import train as cli

    os.makedirs(cwd, exist_ok=True)
    here, out = os.getcwd(), io.StringIO()
    os.chdir(cwd)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        with contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            require(cli.main(argv) == 0, "the training CLI failed")
            seconds = time.perf_counter() - t0
    finally:
        os.chdir(here)
    counts = read_counts()
    banner = logged(out.getvalue(), "Model name")
    log_dir = cli.config_from_args(cli._parser().parse_args(argv)).log_dir
    with open(os.path.join(cwd, log_dir, banner + ".scalars.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return dict(launches=counts, banner=banner, records=records, seconds=seconds,
                log=out.getvalue(), peak_gb=torch.cuda.max_memory_allocated() / 2**30)


def epoch_summary(run, pairs: int) -> dict:
    """Epoch seconds and pairs/s of a CLI run's last (steady) epoch."""
    steady = run["records"][-1]
    return dict(epoch_seconds=steady["train_seconds"] + steady["val_seconds"],
                train_seconds=steady["train_seconds"], val_seconds=steady["val_seconds"],
                pairs_per_s=pairs / steady["train_seconds"],
                cli_seconds=run["seconds"], peak_device_memory_gb=run["peak_gb"],
                resident_mb=steady.get("resident_mb"),
                losses=[r["train"]["loss"] for r in run["records"]])


def run_resident_golden(dev, root) -> dict:
    """`fit` with device_resident and trim_remainder, 2 epochs from the
    committed weights on the split-chain caches of the epoch phase (a),
    replaying the JAX package's draws, against
    assets/db5_resident_fit.golden.json."""
    from equidock_public_tpu_torch.data.dataset import DockingDataset
    from equidock_public_tpu_torch.params import default_checkpoint, load_checkpoint
    from equidock_public_tpu_torch.train.loop import fit
    from equidock_public_tpu_torch.train.resident import ReplayDraws
    from equidock_public_tpu_torch.train.step import create_train_state

    golden = load_asset("db5_resident_fit.golden.json")
    tol = golden["tolerance"]
    params, cfg = load_checkpoint(default_checkpoint(), dev)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, use_fused_intersection=True, random_seed=0,
                                       bs=10, val_repeats=1, trim_remainder=True),
        data=dataclasses.replace(cfg.data, cache_dir=os.path.join(root, "cache"),
                                 device_resident=True),
        checkpoint_dir=os.path.join(root, "ckpt_resident"),
        log_dir=os.path.join(root, "logs_resident"))
    train = dataclasses.asdict(cfg.train)
    require(train == {k: golden["train_config"][k] for k in train},
            "the resident config differs from the golden file's")
    passes = [[(d["swap"], d["rot"], d["tr"]) for d in steps] for steps in golden["draws"]]
    order = {("test", 0): 2 * golden["epochs"]}
    for e in range(golden["epochs"]):
        order[("train", e)], order[("val", e)] = 2 * e, 2 * e + 1
    draws = lambda purpose, epoch: ReplayDraws(passes[order[(purpose, epoch)]], dev)
    history = []
    reset_counts()
    t0 = time.perf_counter()
    fit(cfg, create_train_state(params, cfg, dev), max_epochs=golden["epochs"],
        log=lambda *a: None, device=dev, history=history, draws=draws)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    steps = sum(h["train"]["num_batches"] for h in history[:-1])
    evals = (golden["epochs"] * resident_eval_steps(DockingDataset.from_cache(cfg, "val"), cfg, 10)
             + resident_eval_steps(DockingDataset.from_cache(cfg, "test"), cfg, 10))
    expect_counts("resident golden", counts, steps, evals, fused=True)
    got = [dict(train=h["train"], val=h["val"]) for h in history[:-1]]
    got.append(dict(test=history[-1]["test"]))
    want = golden["history"] + [dict(test=golden["test"])]
    worst = {"loss_rel": 0.0, "median_abs": 0.0}
    for i, (g, w) in enumerate(zip(got, want)):
        for part in w:
            for key, value in w[part].items():
                v = g[part][key]
                require(v is not None and np.isfinite(v), f"resident epoch {i} {part} {key}: {v}")
                if key.endswith("median"):
                    worst["median_abs"] = max(worst["median_abs"], abs(v - value))
                    require(abs(v - value) <= tol["median_atol"],
                            f"resident epoch {i} {part} {key}: {v:.5f}, JAX {value:.5f}")
                else:
                    e = abs(v - value) / max(abs(value), 1e-12)
                    worst["loss_rel"] = max(worst["loss_rel"], e)
                    require(e <= tol["loss_rtol"] or (key == "num_clips" and v == value),
                            f"resident epoch {i} {part} {key}: {v:.7g}, JAX {value:.7g}")
    require(history[-1]["best_epoch"] == golden["best_epoch"],
            f"resident best epoch {history[-1]['best_epoch']}, JAX {golden['best_epoch']}")
    return dict(steps=steps, forwards_without_gradient=evals, launches=counts,
                golden_worst=worst, golden_tolerance=tol, fit_seconds=fit_s,
                resident_mb=history[0]["resident_mb"])


def resident_profile(dev, cfg, ckpt) -> dict:
    """Resident train epochs of the checkpoint's state on the DB5-sized
    split: one under the device profiler, one counting the host syncs it
    makes (torch's sync debug mode, by the line that made them) a step, and
    one with each train step timed between synchronizations (the step
    median; the syncs are added, so this epoch's own seconds are not
    reported)."""
    import warnings

    from equidock_public_tpu_torch.data.dataset import DockingDataset
    from equidock_public_tpu_torch.train import resident
    from equidock_public_tpu_torch.train.checkpoint import load_checkpoint

    state, _, _ = load_checkpoint(ckpt, dev)
    rs = resident.build_resident_split(DockingDataset.from_cache(cfg, "train"), cfg, dev)
    holder, rng = [state], np.random.default_rng(1)
    draws = resident.draws_factory(cfg, dev)
    steps = []

    def one_epoch():
        holder[0], avg = resident.run_train_epoch_resident(holder[0], rs, cfg, rng,
                                                           draws("train", 2), 2)
        steps.append(avg["num_batches"])
        torch.cuda.synchronize()

    prof = device_profile(one_epoch, reps=1, top=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            one_epoch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    step_ms, plain = [], resident.train_step

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    resident.train_step = timed
    try:
        one_epoch()
    finally:
        resident.train_step = plain
    where: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    n = steps[-1]
    return dict(prof, steps=n, device_ops_per_step=prof["device_ops_per_call"] / n,
                host_syncs_per_step={k: v / n for k, v in where.items()},
                host_syncs_per_step_total=sum(where.values()) / n,
                step_ms_median=statistics.median(step_ms), timed_steps=len(step_ms),
                store_mb=rs.nbytes() / 1e6)


def run_resident(dev, root, golden_root, counts_by_split) -> dict:
    """The resident phase: on the cache of the epoch phase (b), the training
    CLI with -device_resident -trim_remainder beside the host-loop CLI, in
    turns (resident, host loop, resident), 2 epochs each; profiled, sync-
    counted and step-timed resident epochs; the resident fit golden with
    replayed draws."""
    from equidock_public_tpu_torch.cli import train as cli
    from equidock_public_tpu_torch.data.dataset import DockingDataset

    base = db5_sized_argv(root)
    flags = ["-device_resident", "-trim_remainder"]
    runs = {}
    for i, mode in enumerate(("resident", "host", "resident")):
        argv = base + (flags if mode == "resident" else []) + [
            "-checkpoint_dir", os.path.join(root, f"ckpt_{mode}_{i}")]
        run = run_cli(argv, os.path.join(root, f"run_{mode}_{i}"))
        cfg = cli.config_from_args(cli._parser().parse_args(argv))
        steps = sum(r["train"]["num_batches"] for r in run["records"])
        evals = (2 * resident_eval_steps(DockingDataset.from_cache(cfg, "val"), cfg, cfg.train.bs)
                 + resident_eval_steps(DockingDataset.from_cache(cfg, "test"), cfg, cfg.train.bs)
                 if mode == "resident" else
                 2 * -(-counts_by_split["val"] // cfg.train.bs)
                 + -(-counts_by_split["test"] // cfg.train.bs))
        expect_counts(f"{mode} CLI run {i}", run["launches"], steps, evals, fused=True)
        require(all(np.isfinite(r["train"]["loss"]) for r in run["records"]),
                f"{mode} CLI run {i}: non-finite training loss")
        if mode == "resident":
            require("device-resident epochs:" in run["log"], "no store size in the log")
        runs[f"{mode}_{i}"] = dict(epoch_summary(run, counts_by_split["train"]), steps=steps,
                                   forwards_without_gradient=evals, launches=run["launches"],
                                   launches_per_step={k: v / steps
                                                      for k, v in run["launches"].items()})
        if i == 0:
            first_cfg, first_launches = cfg, run["launches"]
    ckpt = os.path.join(first_cfg.checkpoint_dir, first_cfg.banner(), "db5_model_best")
    return dict(runs=runs, launches=first_launches,
                order="resident, host loop, resident (each 2 epochs, its own checkpoints, "
                      "no synchronization added); epoch 1 is the steady one; the resident "
                      "step median is profile_one_epoch's timed epoch, the host loop's is "
                      "the epoch_db5_sized phase's",
                profile_one_epoch=resident_profile(dev, first_cfg, ckpt),
                golden_fit=run_resident_golden(dev, golden_root))


def run_curriculum(dev, root) -> dict:
    """The curriculum phase: synthetic DIPS shards (6 of 8 pairs for train,
    one of 8 for val and for test, kNN graphs of the tracked chains' sizes)
    through `cli/train.py`'s default run (no -toy, no -max_epochs) with
    -device_resident -stream_dips -stream_window 1, 1 epoch a stage: the DIPS
    stage streams its train groups, then the DB5 stage on the DB5-sized
    cache. At the end the shard LRU holds at most 1 shard, every uploaded
    group's tensors are released (held by weak references), and the device
    memory after the streamed epoch is that before it plus the new train
    state (params and Adam moments; the old one is still held)."""
    from equidock_public_tpu_torch.cli import train as cli
    from equidock_public_tpu_torch.data import dataset as dsmod
    from equidock_public_tpu_torch.data.synth import write_synth_shards
    from equidock_public_tpu_torch.train import loop, resident

    argv = db5_sized_argv(root, epochs=None) + [
        "-device_resident", "-stream_dips", "-stream_window", "1", "-num_epochs", "1",
        "-checkpoint_dir", os.path.join(root, "ckpt_curriculum")]
    cfg = cli.config_from_args(cli._parser().parse_args(argv))
    dips = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data="dips"))
    sizes = db5_sized_sizes(64, seed=11)
    t0 = time.perf_counter()
    for split, (n_shards, start) in {"train": (6, 0), "val": (1, 48), "test": (1, 56)}.items():
        write_synth_shards(dips.cache_path(), split, n_shards=n_shards, per_shard=8,
                           seed=start, k=cfg.graph.graph_max_neighbor,
                           sizes=sizes[start:start + 8 * n_shards])
    shard_s = time.perf_counter() - t0
    made, epochs, uploaded = [], [], []
    from_cache, streamed, upload = (dsmod.DockingDataset.from_cache,
                                    loop.run_train_epoch_resident_streamed, resident._upload)

    def recording_from_cache(cfg_, split, *a, **kw):
        ds = from_cache(cfg_, split, *a, **kw)
        made.append((cfg_, split, ds))
        return ds

    def recording_epoch(*a, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        n0 = len(uploaded)
        out = streamed(*a, **kw)
        torch.cuda.synchronize()
        gc.collect()
        # the new state (params, mu, nu: one size); the caller still holds the old
        state_bytes = 3 * sum(t.numel() * t.element_size() for t in out[0].mu.values())
        epochs.append(dict(allocated_before=before, allocated_after=torch.cuda.memory_allocated(),
                           new_state_bytes=state_bytes, uploads=len(uploaded) - n0,
                           live_tensors=sum(r() is not None for _, refs in uploaded[n0:]
                                            for r in refs)))
        return out

    def recording_upload(group, *a, **kw):
        out = upload(group, *a, **kw)
        uploaded.append((group.nbytes(), [weakref.ref(t) for t in out[0].tensors()]))
        return out

    dsmod.DockingDataset.from_cache = recording_from_cache
    loop.run_train_epoch_resident_streamed = recording_epoch
    resident._upload = recording_upload
    try:
        run = run_cli(argv, os.path.join(root, "run_curriculum"))
    finally:
        dsmod.DockingDataset.from_cache = from_cache
        loop.run_train_epoch_resident_streamed = streamed
        resident._upload = upload
    records = run["records"]
    stages = [r for r in records if "epoch" in r]
    require(len(stages) == 2 and len(epochs) == 1,
            f"{len(stages)} epochs and {len(epochs)} streamed epochs in the curriculum run")
    train_dips = next(ds for c, s, ds in made if c.data.data == "dips" and s == "train")
    require(train_dips.index is not None and train_dips._lru.resident() <= 1,
            f"the DIPS train LRU holds {train_dips._lru.resident()} shards")
    e = epochs[0]
    require(e["uploads"] > 0 and e["live_tensors"] == 0,
            f"{e['live_tensors']} tensors of the {e['uploads']} streamed groups still held "
            "after the epoch")
    grown = e["allocated_after"] - e["allocated_before"]
    require(grown <= e["new_state_bytes"] + 2**20,
            f"{grown} bytes more on the device after the streamed epoch than before it, "
            f"{e['new_state_bytes']} of them the new train state (smallest group "
            f"{min(n for n, _ in uploaded)} bytes)")
    steps = sum(r["train"]["num_batches"] for r in stages)
    evals = sum(resident_eval_steps(ds, c, c.train.bs) for c, s, ds in made
                if s in ("val", "test"))          # one epoch a stage, one test
    expect_counts("curriculum", run["launches"], steps, evals, fused=True)
    require(all(np.isfinite(r["train"]["loss"]) for r in stages), "non-finite curriculum loss")
    return dict(shards={"train": 6, "val": 1, "test": 1}, pairs_per_shard=8,
                shard_seconds=shard_s, stages=[dict(epoch_seconds=r["train_seconds"]
                                                    + r["val_seconds"],
                                                    num_batches=r["train"]["num_batches"],
                                                    loss=r["train"]["loss"],
                                                    resident_mb=r.get("resident_mb"))
                                               for r in stages],
                streamed_epoch=e, corpus_bytes=sum(n for n, _ in uploaded),
                groups=len(uploaded),
                lru_resident=train_dips._lru.resident(), lru_loads=train_dips._lru.loads,
                steps=steps, forwards_without_gradient=evals, launches=run["launches"],
                cli_seconds=run["seconds"], peak_device_memory_gb=run["peak_gb"])


# --------------------------------------------------------------------------- #
# Main
# --------------------------------------------------------------------------- #

# --------------------------------------------------------------------------- #
# Slice 7: packed batches, BatchNorm, dropout, fine-tuning, remat, exact OT
# --------------------------------------------------------------------------- #

PACK_MAX = 4            # complexes a slot, as the packed golden file
# A packed step against the unpacked step on the same complexes, on the
# card: the same per-complex sums, but the attention's key tiles split
# another way, so f32 rounding in another order. Loss terms relative; the
# global gradient norm (a sum over 10^5 leaves' elements) relative.
PACKED_LOSS_RTOL, PACKED_GNORM_RTOL = 1e-5, 1e-4
# The exact OT loss on the card against the same plan applied on the CPU.
EXACT_OT_RTOL = 1e-5
# Remat against the plain forward's gradients: the recompute launches the
# same kernels on the same inputs, each bit-equal on two launches.
REMAT_REL_TOL = 1e-6
OPTION_STEPS = 3
OPTION_CONFIGS = (("bn", dict(layer_norm="BN", final_h_layer_norm="BN")),
                  ("final_h_bn", dict(final_h_layer_norm="BN")),
                  ("swish", dict(nonlin="swish")),
                  ("coors_ln", dict(layer_norm_coors="LN")),
                  ("dropout", dict(dropout=0.1)))


def logged(log: str, key: str) -> str:
    """The value of the training log's first "<key> ===> " line."""
    mark = key + " ===> "
    return next(ln.split(mark, 1)[1].strip() for ln in log.splitlines() if mark in ln)


def batch_shapes(cfg) -> dict:
    """Slots a step and the dead-node share (padded node slots of both sides
    that hold no node) of the train split's batches under seed 0, on the
    host."""
    from equidock_public_tpu_torch.data.dataset import DockingDataset

    slots, valid, padded = [], 0.0, 0
    for b in DockingDataset.from_cache(cfg, "train").batches(np.random.default_rng(0),
                                                              device="cpu"):
        slots.append(b.pair_mask.shape[0])
        for side in (b.lig, b.rec):
            valid += float(side.node_mask.sum())
            padded += side.node_mask.numel()
    return dict(batches=len(slots), slots_per_step=float(np.mean(slots)),
                dead_node_share=1.0 - valid / padded)


def run_packed_epochs(root) -> tuple:
    """Options (a): the training CLI, one epoch each, packed (-pack
    -pack_max_per_slot 4), unpacked, packed, in turns, on the DB5-sized
    split of epoch (b) (fused intersection asked for: the packed loss is
    the plain packed one, so rows 6-7 do not launch). Returns (report,
    the unpacked run's checkpoint)."""
    from equidock_public_tpu_torch.cli import train as cli

    base = db5_sized_argv(root, epochs=1)
    evals = sum(-(-DB5_SIZED_SPLIT[s] // 10) for s in ("val", "test"))
    out, ckpt = {"packed": [], "unpacked": []}, None
    for i, kind in enumerate(("packed", "unpacked", "packed")):
        argv = base + ["-checkpoint_dir", os.path.join(root, "options", f"ckpt{i}")]
        if kind == "packed":
            argv += ["-pack", "-pack_max_per_slot", str(PACK_MAX)]
        run = run_cli(argv, os.path.join(root, "options", f"run{i}"))
        steps = run["records"][0]["train"]["num_batches"]
        packed = kind == "packed"
        expect_launches(f"options {kind} epoch", run["launches"],
                        step_launches(LAYERS, steps, evals, softmin=not packed),
                        PER_STEP_INVERSE * steps)
        paths = logged(run["log"], "Kernel paths")
        require(("intersection: the plain packed loss" in paths) == packed
                and ("(packed seg tags)" in paths) == packed, f"kernel paths: {paths}")
        out[kind].append(dict(epoch_summary(run, DB5_SIZED_SPLIT["train"]), steps=steps,
                              launches=run["launches"],
                              launches_per_step={k: v / steps for k, v in run["launches"].items()},
                              kernel_paths=paths))
        if not packed:
            ckpt = os.path.join(root, "options", f"ckpt{i}", run["banner"], "db5_model_best")
    pcfg = cli.config_from_args(cli._parser().parse_args(
        base + ["-pack", "-pack_max_per_slot", str(PACK_MAX)]))
    out["batches"] = {"packed": batch_shapes(pcfg),
                      "unpacked": batch_shapes(cli.config_from_args(cli._parser().parse_args(base)))}
    return out, ckpt


def packed_tag_cases(pbatch, dev) -> dict:
    """Rows 3-5 with the packed golden batch's tags (seg + 1) * mask, up to
    4, both directions, at D 64 (and 69, layer 0's width) against their
    plain versions: forward, dQ and dK/dV."""
    from equidock_public_tpu_torch.ops.cuda import cross_attention as ca

    tag = lambda side: ((side.seg_id.to(torch.float32) + 1.0) * side.node_mask).contiguous()
    out = []
    for qs, ks, D in ((pbatch.lig, pbatch.rec, 64), (pbatch.rec, pbatch.lig, 64),
                      (pbatch.lig, pbatch.rec, 69)):
        qt, kt = tag(qs), tag(ks)
        B, N, M = qt.shape[0], qt.shape[1], kt.shape[1]
        gen = torch.Generator().manual_seed(D + N)
        q, k, v, do = ((torch.randn(B, n, D, generator=gen) * s).to(dev).contiguous()
                       for n, s in ((N, 0.3), (M, 0.3), (M, 1.0), (N, 1.0)))
        shape = f"B={B} N={N} M={M} D={D} packed tags up to {int(qt.max())}"
        got = ca.cross_attention_fwd(q, k, v, qt, kt)
        synced("cross_attention (packed tags)")
        o, lse = ca.cross_attention_plain(q, k, v, qt, kt)
        fwd_err = check_close("cross_attention " + shape, got, (o, lse), ATT_TOL)
        gb = ca.cross_attention_bwd(q, k, v, qt, kt, o.contiguous(), lse.contiguous(), do)
        synced("cross_attention_dq, cross_attention_dkv (packed tags)")
        want = ca.cross_attention_bwd_plain(q, k, v, qt, kt, do)
        out.append(dict(shape=shape, fwd_max_abs_err=fwd_err,
                        dq=check_grads("cross_attention_dq", shape, gb[:1], want[:1]),
                        dkv=check_grads("cross_attention_dkv", shape, gb[1:], want[1:])))
    require(max(int(((c.seg_id + 1) * c.node_mask).max()) for c in (pbatch.lig, pbatch.rec)) > 2,
            "the packed golden batch has no tag above 2")
    return out


def packed_edge_cases(params, pbatch, cfg, dev) -> list:
    """Rows 1-2 on the packed golden batch's ligand and receptor tables as
    `collate_packed` built them (block-diagonal nbr, the pad tail
    self-looping from the slot's last member node with mask 0), with layer
    0's weights (h 69 wide) and the shared layer's (h 64 wide), random h
    and output cotangents; checked as every edge case is (check_edge_case:
    forward, backward, the scatter through the inverse neighbour list)."""
    from equidock_public_tpu_torch.models.iegmn import edge_kernel_inputs

    hid, cases = cfg.model.iegmn_lay_hid_dim, []
    for name, side in (("lig", pbatch.lig), ("rec", pbatch.rec)):
        B, N, K = side.nbr.shape
        tail = (side.node_mask == 0)[..., None].expand(B, N, K)
        rows = torch.arange(N, device=dev, dtype=side.nbr.dtype)[None, :, None].expand(B, N, K)
        require(bool(tail.any()) and torch.equal(side.nbr[tail], rows[tail])
                and float(side.nbr_mask[tail].abs().sum()) == 0.0,
                f"packed {name}: the pad tail does not self-loop with mask 0")
        for layer, Dh in (("layer0", cfg.model.input_node_feats_dim), ("rest", hid)):
            gen = torch.Generator().manual_seed(Dh + N)
            h = torch.randn(B, N, Dh, generator=gen).to(dev)
            he = side.edge_feat.contiguous()
            src, dst, kp = edge_kernel_inputs(params["original"][layer], side.x.contiguous(),
                                              h, he)
            grads = (torch.randn(B, N, hid, generator=gen).to(dev),
                     torch.randn(B, N, 3, generator=gen).to(dev))
            cases.append(dict(shape=f"packed {name}, {layer} weights: B={B} N={N} K={K} "
                                    f"h {Dh} D={hid} E={he.shape[-1]}",
                              args=(src, dst, he, side.nbr.contiguous(),
                                    side.nbr_mask.contiguous(), kp), grads=grads))
    return cases


def run_packed_golden(dev, train_golden) -> dict:
    """Options (a): on the training golden's complexes packed 4 a slot
    (checked against assets/db5_train_step_packed.golden.json's digest),
    a step's loss and gradient norm against the unpacked step's, 3 packed
    train_steps against the packed golden's JAX steps (rows 1-5 10 a step,
    rows 6-7 none), rows 1-2 on the packed tables and rows 3-5 with packed
    tags against their plain versions."""
    from equidock_public_tpu_torch.data.dataset import DockingDataset
    from equidock_public_tpu_torch.graph import batch_digest, digests_agree
    from equidock_public_tpu_torch.params import flatten
    from equidock_public_tpu_torch.train.optim import global_norm
    from equidock_public_tpu_torch.train.step import (create_train_state, loss_and_grads,
                                                      train_step)

    _, params, cfg, batch, _ = train_golden
    pgold = load_asset("db5_train_step_packed.golden.json")
    pcfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, pack=True, pack_max_per_slot=pgold["pack_max_per_slot"]))
    pbatch = next(DockingDataset(pcfg, split_chain_samples(pgold["codes"], cfg.graph)).batches(
        np.random.default_rng(pgold["seed"]), device=dev))
    bad = digests_agree(batch_digest(pbatch), pgold["batch_digest"])
    require(not bad, f"the packed batch differs from the packed golden one in {bad}")
    ug, um, _ = loss_and_grads(params, cfg, batch)
    reset_counts()
    pg, pm, _ = loss_and_grads(params, pcfg, pbatch)
    expect_launches("packed gradient", read_counts(), step_launches(LAYERS, 1, 0),
                    PER_STEP_INVERSE)
    vs_unpacked = {}
    for key in ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss"):
        got, want = float(pm[key]), float(um[key])
        vs_unpacked[key] = abs(got - want) / max(abs(want), 1e-12)
        require(vs_unpacked[key] <= PACKED_LOSS_RTOL,
                f"packed step {key}: {got:.8g}, unpacked {want:.8g}")
    gp, gu = float(global_norm(pg)), float(global_norm(ug))
    vs_unpacked["grad_norm"] = abs(gp - gu) / gu
    require(vs_unpacked["grad_norm"] <= PACKED_GNORM_RTOL,
            f"packed gradient norm {gp:.8g}, unpacked {gu:.8g}")
    state = create_train_state(params, pcfg, dev)
    p0 = {k: v.clone() for k, v in flatten(state.params).items()}
    reset_counts()
    metrics = []
    for _ in range(OPTION_STEPS):
        state, m = train_step(state, pbatch, pcfg)
        metrics.append(m)
    launches = read_counts()
    expect_launches("packed golden steps", launches, step_launches(LAYERS, OPTION_STEPS, 0),
                    PER_STEP_INVERSE * OPTION_STEPS)
    worst = check_step_golden("packed golden", metrics, state, p0, pgold, pcfg)
    return dict(slots=pbatch.pair_mask.shape[0], buckets=[pbatch.lig.x.shape[1],
                                                          pbatch.rec.x.shape[1]],
                rel_err_vs_unpacked=vs_unpacked,
                tolerance={"loss_rtol": PACKED_LOSS_RTOL, "grad_norm_rtol": PACKED_GNORM_RTOL},
                golden_worst_rel_err=worst, launches=launches,
                edge=[check_edge_case(c, cfg.model.leakyrelu_neg_slope)
                      for c in packed_edge_cases(params, pbatch, cfg, dev)],
                tags=packed_tag_cases(pbatch, dev))


def state_on(state, dev):
    """A copy of a train state on `dev`."""
    from equidock_public_tpu_torch.params import flatten, unflatten
    from equidock_public_tpu_torch.train.step import TrainState

    to = lambda d: {k: v.to(dev) for k, v in d.items()}
    return TrainState(unflatten(to(flatten(state.params))), to(state.mu), to(state.nu),
                      state.step, {s: to(st) for s, st in state.bn_state.items()})


def run_option_config(name, model_kw, train_golden, dev) -> dict:
    """Options (b): OPTION_STEPS train steps of the paper model's config
    with `model_kw`, from the committed weights (a norm's leaves that the
    config adds at their initial values: gain 1, shift 0), on the training
    golden batch on the card, each held to a step of the CPU's plain path
    from the same state (the card's, copied), with the same dropout masks
    (the CPU's, replayed on the card): loss terms and the gradient norm at
    the training gate's first-step tolerances, each leaf's move and the
    running statistics; which rows launched, how many sides ran the plain
    layer body, and the config's kernel-path line."""
    from equidock_public_tpu_torch.graph import batch_to
    from equidock_public_tpu_torch.models import iegmn
    from equidock_public_tpu_torch.models.layers import Dropout
    from equidock_public_tpu_torch.params import flatten, init_params, unflatten
    from equidock_public_tpu_torch.train.step import create_train_state, eval_step, train_step

    golden, trained, cfg, batch, _ = train_golden
    tol = golden["tolerance"]
    mcfg = dataclasses.replace(cfg.model, **model_kw)
    ocfg = dataclasses.replace(cfg, model=mcfg)
    base = flatten(trained)
    params = unflatten({k: base[k].cpu() if k in base and base[k].shape == v.shape else v
                        for k, v in flatten(init_params(mcfg, 0, "cpu")).items()})

    class Recording(Dropout):
        def __init__(self, rate, gen):
            super().__init__(rate, gen)
            self.kept = []

        def mask(self, shape, device):
            m = super().mask(shape, device)
            self.kept.append(m)
            return m

    cpu_batch = batch_to(batch, "cpu")
    state = create_train_state(params, ocfg, dev)
    worst, launches, plain = {}, {}, 0
    atol = tol["delta_norm_atol_lr"] * cfg.train.lr
    for i in range(OPTION_STEPS):
        before = state_on(state, "cpu")
        drop = Recording(mcfg.dropout, torch.Generator().manual_seed(i)) if mcfg.dropout else None
        host, want = train_step(before, cpu_batch, ocfg, drop=drop)
        reset_counts()
        iegmn.plain_body_calls = 0
        state, got = train_step(state, batch, ocfg,
                                drop=Dropout(mcfg.dropout, masks=drop.kept) if drop else None)
        launches = {k: launches.get(k, 0) + v for k, v in read_counts().items()}
        plain += iegmn.plain_body_calls
        for key in ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss", "grad_norm"):
            r = tol["grad_norm_rtol"] if key == "grad_norm" else tol["loss_rtol_step1"]
            g, w = float(got[key]), float(want[key])
            worst[key] = max(worst.get(key, 0.0), abs(g - w) / max(abs(w), 1e-12))
            require(np.isfinite(g) and abs(g - w) <= r * abs(w) + tol["loss_atol"],
                    f"option {name} step {i + 1} {key}: card {g:.7g}, CPU {w:.7g}")
        p0, after = flatten(before.params), flatten(state_on(state, "cpu").params)
        for key, v in flatten(host.params).items():
            g, w = float((after[key] - p0[key]).norm()), float((v - p0[key]).norm())
            worst["delta_norm"] = max(worst.get("delta_norm", 0.0), abs(g - w) / max(w, 1e-12))
            require(abs(g - w) <= tol["delta_norm_rtol"] * w + atol,
                    f"option {name} step {i + 1} {key}: moved {g:.6g} on the card, {w:.6g} "
                    "on the CPU")
        for site, st in state.bn_state.items():
            for k in ("mean", "var"):
                err = rel_err(st[k].cpu(), host.bn_state[site][k])
                worst["bn_state"] = max(worst.get("bn_state", 0.0), err)
                require(err <= tol["delta_norm_rtol"], f"option {name} {site}/{k}: {err:.3g}")
    eligible = iegmn.fused_edge_eligible(mcfg, train=True)
    expect_launches(f"option {name}", launches, step_launches(LAYERS, OPTION_STEPS, 0, eligible),
                    PER_STEP_INVERSE * OPTION_STEPS if eligible else 0)
    want_plain = 0 if eligible else SIDES * LAYERS * OPTION_STEPS
    require(plain == want_plain, f"option {name}: {plain} sides through the plain layer body, "
                                 f"expected {want_plain}")
    out = dict(config=model_kw, start="the committed weights; leaves the config adds at "
               "their initial values", kernel_path_report=iegmn.kernel_path_report(mcfg),
               edge_kernels=eligible, launches=launches, plain_body_sides=plain,
               worst_rel_err_vs_cpu=worst)
    if mcfg.dropout:        # an evaluation forward is eligible: rows 1 and 3, no plain body
        reset_counts()
        iegmn.plain_body_calls = 0
        eval_step(state.params, batch, ocfg, state.bn_state)
        ev = read_counts()
        require(ev["edge_message"] == SIDES * LAYERS and iegmn.plain_body_calls == 0,
                f"option {name}: an evaluation forward launched {ev['edge_message']} edge "
                f"kernels, {iegmn.plain_body_calls} plain sides")
        out["eval_forward_launches"] = ev
    return out


def run_fine_tune(root, stage1) -> dict:
    """Options (c): the training CLI, one epoch, -fine_tune_from the
    unpacked epoch's checkpoint with -freeze_original -fine_tune_init copy:
    the original stage bit-equal to stage 1 afterwards, the fine-tune stage
    moved from its copy; rows 1-7 launched for both stages (5 + 2 layers)."""
    from equidock_public_tpu_torch.params import flatten
    from equidock_public_tpu_torch.train.checkpoint import load_checkpoint

    argv = db5_sized_argv(root, epochs=1) + [
        "-checkpoint_dir", os.path.join(root, "options", "ft_ckpt"), "-fine_tune_from", stage1,
        "-freeze_original", "-fine_tune_init", "copy"]
    run = run_cli(argv, os.path.join(root, "options", "ft_run"))
    steps = run["records"][0]["train"]["num_batches"]
    evals = sum(-(-DB5_SIZED_SPLIT[s] // 10) for s in ("val", "test"))
    want = step_launches(LAYERS + 2, steps, evals, softmin=True)
    # the fine-tune stage's own attention (ft_att_*) is plain, as in the JAX package
    expect_launches("fine-tune epoch", run["launches"], want, 2 * PER_STEP_INVERSE * steps)
    s1, _, _ = load_checkpoint(stage1, "cpu")
    done, saved, _ = load_checkpoint(os.path.join(root, "options", "ft_ckpt", run["banner"],
                                                  "db5_model_best"), "cpu")
    require(saved.train.freeze_original and saved.model.fine_tune, "the fine-tune sidecar")
    orig = flatten(s1.params["original"])
    for k, v in flatten(done.params["original"]).items():
        require(torch.equal(v, orig[k]), f"fine-tune: the frozen original/{k} moved")
    moved = [k for k, v in flatten(done.params["finetune"]).items()
             if k in orig and v.shape == orig[k].shape and not torch.equal(v, orig[k])]
    require(moved, "fine-tune: the fine-tune stage did not move from its copy")
    return dict(epoch_summary(run, DB5_SIZED_SPLIT["train"]), steps=steps,
                launches=run["launches"],
                launches_per_step={k: v / steps for k, v in run["launches"].items()},
                original_bit_equal=True, finetune_leaves_moved=len(moved),
                kernel_paths=logged(run["log"], "Kernel paths"))


def run_remat_and_exact(dev, train_golden) -> dict:
    """Options (d): one gradient with and without remat from the committed
    weights on the training golden batch (bit-equal, else within
    REMAT_REL_TOL), peak device memory both ways, rows 1 and 3 relaunched
    for layers 1-4 in the recompute. (e): one train step with the exact OT
    solver; its OT loss against the same plan applied to the card's cost
    on the CPU, the host LP's milliseconds."""
    from equidock_public_tpu_torch.ops import sinkhorn as sk
    from equidock_public_tpu_torch.train import losses
    from equidock_public_tpu_torch.train.step import create_train_state, loss_and_grads, train_step

    _, params, cfg, batch, _ = train_golden
    remat = {}
    for on in (False, True):
        rcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=on))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        grads, m, _ = loss_and_grads(params, rcfg, batch)
        torch.cuda.synchronize()
        remat[on] = dict(grads=grads, loss=float(m["loss"]), launches=read_counts(),
                         peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    want = step_launches(LAYERS, 1, 0)
    expect_launches("no remat", remat[False]["launches"], want, PER_STEP_INVERSE)
    again = LAYERS - 1              # layers 1..4 run forward a second time
    want_r = dict(want, edge_message=want["edge_message"] + SIDES * again,
                  cross_attention=want["cross_attention"] + SIDES * again)
    expect_launches("remat", remat[True]["launches"], want_r, PER_STEP_INVERSE)
    g0, g1 = remat[False]["grads"], remat[True]["grads"]
    bit_equal = all(torch.equal(g0[k], g1[k]) for k in g0)
    worst = max(rel_err(g1[k], g0[k]) for k in g0)
    require(bit_equal or worst <= REMAT_REL_TOL, f"remat gradients: relative error {worst:.3g}")

    ecfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ot_solver="exact"))
    lp_ms, seen = [], {}
    plan_fn, loss_fn = sk.exact_emd_plan_host, losses.pocket_ot_loss_exact

    def timed_plan(*a):
        t0 = time.perf_counter()
        out = plan_fn(*a)
        lp_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def recording_loss(cost, mask):
        out = loss_fn(cost, mask)
        seen.update(cost=cost.detach().cpu(), mask=mask.detach().cpu(), ot=out.detach().cpu())
        return out

    sk.exact_emd_plan_host, losses.pocket_ot_loss_exact = timed_plan, recording_loss
    try:
        state = create_train_state(params, ecfg, dev)
        reset_counts()
        state, m = train_step(state, batch, ecfg)
        launches = read_counts()
    finally:
        sk.exact_emd_plan_host, losses.pocket_ot_loss_exact = plan_fn, loss_fn
    expect_launches("exact OT step", launches, step_launches(LAYERS, 1, 0), PER_STEP_INVERSE)
    plan = torch.from_numpy(plan_fn(seen["cost"].numpy(), seen["mask"].numpy()))
    ot_cpu = (plan * seen["cost"]).sum(dim=(1, 2))
    err = rel_err(seen["ot"], ot_cpu)
    pm = batch.pair_mask.cpu()
    step_err = abs(float(m["ot_loss"]) - float((ot_cpu * pm).sum() / pm.sum())) / float(
        (ot_cpu * pm).sum() / pm.sum())
    require(err <= EXACT_OT_RTOL and step_err <= EXACT_OT_RTOL,
            f"exact OT: card {seen['ot'].tolist()} against the CPU's {ot_cpu.tolist()}")
    require(np.isfinite(float(m["loss"])), "exact OT step: non-finite loss")
    return dict(remat=dict(grads_bit_equal=bit_equal, worst_rel_err=worst,
                           loss=[remat[False]["loss"], remat[True]["loss"]],
                           peak_device_memory_gb={"plain": remat[False]["peak_gb"],
                                                  "remat": remat[True]["peak_gb"]},
                           launches={"plain": remat[False]["launches"],
                                     "remat": remat[True]["launches"]}),
                exact_ot=dict(ot_loss=float(m["ot_loss"]), rel_err_vs_cpu_plan=err,
                              step_rel_err=step_err, host_lp_ms=lp_ms, launches=launches,
                              pocket=list(seen["cost"].shape)))


def run_options(dev, root, train_golden) -> dict:
    """The options phase (slice 7), full width, the paper DB5 model."""
    t0 = time.perf_counter()
    epochs, stage1 = run_packed_epochs(root)
    packed = run_packed_golden(dev, train_golden)
    configs = {name: run_option_config(name, kw, train_golden, dev)
               for name, kw in OPTION_CONFIGS}
    fine_tune = run_fine_tune(root, stage1)
    rest = run_remat_and_exact(dev, train_golden)
    return dict(packed_epochs=epochs, packed=packed, configs=configs, fine_tune=fine_tune,
                **rest, seconds=round(time.perf_counter() - t0, 1))


# --------------------------------------------------------------------------- #
# Slice 8: serving what the port trains, bf16, auto buckets, distillation,
# and slices 6-7's paths held step by step to the CPU
# --------------------------------------------------------------------------- #

SLICE8_LAYERS = 2       # the depth of the A5 runs (shared layers, 64 wide)
SLICE8_SPLIT = {"train": 8, "val": 4, "test": 4}
SLICE8_BS = 4
# A bf16 forward on the card against a reference's (the JAX package's
# golden values, or the CPU's), over the 4 requests together: R, t, CA and
# the keypoints within BF16_SHARE * d0 of the reference's bf16 outputs,
# d0 = ||bf16 - f32|| of the reference, and at least d0 / 4 from its f32
# outputs (the operands were rounded). bf16 rounding is discrete: another
# order of f32 sums (the card's) flips some roundings, each by up to 2^-8
# of the value, and the flips reach the outputs. scripts/bf16_sensitivity.py
# reads how far a move of every weight by a relative 1e-6 that keeps its
# bf16 rounding moves the bf16 forward, over d0: the paper model's and a
# paper-width checkpoint's after 2 bf16 training steps move by a large
# share of d0, up to 20 d0 a request, so the paper model is held to
# JAX's fixed golden values at d0 / 2; the trained bf16 checkpoint served
# on the card is the 16-wide db5_model_small's, whose forward moves by a
# small share of d0 (PERF.md section 7). The sites rounded are pinned on
# the CPU to d0 / 4 of JAX's at small width (tests/test_torch_bf16.py).
BF16_SHARE = {"jax": 0.5, "cpu": 0.5}
# A held bf16 train step (`held_to_cpu`): its loss terms within one bf16
# rounding (2^-8, relative) of the CPU's bf16 step, above the f32 gate;
# its gradient norm within the CPU's own bf16 - f32 distance, which must
# be above the f32 gate (every linear's backward rounds the gradient to
# bf16, so another order of f32 sums parts two bf16 steps by up to that
# distance); the moves and statistics at the f32 gates (Adam divides each
# gradient by its own scale).
BF16_U = 2.0 ** -8
BF16_ATOL = dict(GOLDEN_ATOL, keypts_lig=1e-3, keypts_rec=1e-3)
DISTILL_CODES = ("2VDB", "2SNI", "6B0S", "1NW9", "1HCF", "2AYO", "1QA9", "1JIW",
                 "5C7X", "4POU", "1ZHI", "7CEI", "1MLC", "1VFB", "3SZK", "1IRA")


def small_sizes(n: int, seed: int, top: int = 256):
    """(n_lig, n_rec) pairs drawn with replacement from the residue counts of
    the tracked chains of at most `top` residues."""
    pool = [s for pair in db5_sized_sizes(400, seed=seed) for s in pair if s <= top]
    idx = np.random.default_rng(seed).integers(0, len(pool), (n, 2))
    return [(pool[i], pool[j]) for i, j in idx]


def small_argv(root, tag) -> list:
    """The training CLI's flags of the slice-8 runs on the small split: the
    paper model's widths at SLICE8_LAYERS shared layers, bs SLICE8_BS, one
    epoch, the fused intersection loss, seed 0."""
    return ["-shared_layers", "-iegmn_n_lays", str(SLICE8_LAYERS), "-iegmn_lay_hid_dim", "64",
            "-residue_emb_dim", "64", "-num_att_heads", "50", "-bs", str(SLICE8_BS),
            "-node_buckets", "128,256", "-pocket_buckets", "32,64",
            "-use_fused_intersection", "-random_seed", "0", "-max_epochs", "1",
            "-cache_dir", os.path.join(root, "cache"), "-device", "cuda",
            "-checkpoint_dir", os.path.join(root, "ckpt", tag)]


def write_small_split(root) -> None:
    """The slice-8 split: SLICE8_SPLIT complexes of tracked-chain sizes up to
    256 residues, as npz caches (DB5) and as DIPS shards of 2 complexes."""
    from equidock_public_tpu_torch.cli import train as cli
    from equidock_public_tpu_torch.data.synth import write_synth_shards, write_synth_split

    cfg = cli.config_from_args(cli._parser().parse_args(small_argv(root, "x")))
    dips = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data="dips"))
    sizes = small_sizes(sum(SLICE8_SPLIT.values()), seed=17)
    start = 0
    for i, (split, n) in enumerate(SLICE8_SPLIT.items()):
        part = sizes[start:start + n]
        write_synth_split(os.path.join(cfg.cache_path(), f"{split}.npz"), part, seed=i, k=10)
        write_synth_shards(dips.cache_path(), split, n_shards=n // 2, per_shard=2, seed=i,
                           k=10, sizes=part)
        start += n


def start_checkpoint(path, model_kw, layers=LAYERS, model="db5_model_best") -> str:
    """A training checkpoint (step 0) of a shipped model's committed weights
    (the paper model's by default) under `model_kw` at `layers` layers, the
    leaves the config adds at their initial values: the start of a slice-8
    CLI run (-continue_train_model, which adopts its model config)."""
    from equidock_public_tpu_torch.params import (flatten, init_params, load_checkpoint,
                                                  model_checkpoint, unflatten)
    from equidock_public_tpu_torch.train.checkpoint import save_checkpoint
    from equidock_public_tpu_torch.train.step import create_train_state

    params, cfg = load_checkpoint(model_checkpoint(model), "cpu")
    mcfg = dataclasses.replace(cfg.model, iegmn_n_lays=layers, **model_kw)
    base = flatten(params)
    start = unflatten({k: base[k] if k in base and base[k].shape == v.shape else v
                       for k, v in flatten(init_params(mcfg, 0, "cpu")).items()})
    scfg = dataclasses.replace(cfg, model=mcfg)
    save_checkpoint(path, create_train_state(start, scfg, "cpu"), scfg, 0)
    return path


@contextlib.contextmanager
def held_to_cpu(name):
    """Every train step of the training loop and of the resident epochs
    (`train_step` of train/loop.py and train/resident.py) followed by a step
    of the CPU's plain path from the state before it (copied), on the same
    batch (copied) with the same dropout masks (recorded on the card,
    replayed): loss terms and the gradient norm at the training gate's
    first-step tolerances, each leaf's move and the running statistics, as
    `run_option_config` holds its steps. A bf16 step is held to the CPU's
    bf16 step with the bf16 gates (BF16_U), its gradient norm against the
    CPU's f32 step from the same state. Yields the report (steps, worst
    relative errors)."""
    from equidock_public_tpu_torch.graph import batch_to
    from equidock_public_tpu_torch.models.layers import Dropout
    from equidock_public_tpu_torch.params import flatten
    from equidock_public_tpu_torch.train import loop, resident
    from equidock_public_tpu_torch.train.step import train_step

    tol = load_asset("db5_train_step.golden.json")["tolerance"]
    report = {"steps": 0, "worst_rel_err_vs_cpu": {}}
    worst = report["worst_rel_err_vs_cpu"]

    def held(state, batch, cfg, lr_scale=1.0, loss_fn_=None, drop=None):
        before = state_on(state, "cpu")
        kept, drawing = [], drop is not None and drop.rate > 0
        if drawing:
            draw = drop.mask

            def recording(shape, device):
                kept.append(draw(shape, device))
                return kept[-1]

            drop.mask = recording
        try:
            new, got = train_step(state, batch, cfg, lr_scale, loss_fn_, drop)
        finally:
            if drawing:
                del drop.mask
        replay = lambda: Dropout(drop.rate, masks=[m.cpu() for m in kept]) if drawing else None
        # resident epochs pass the epoch factor as a tensor on the card
        scale = float(lr_scale)
        counts = read_counts()          # the CPU step's inverse lists are not the path's
        host_batch = batch_to(batch, "cpu")
        host, want = train_step(before, host_batch, cfg, scale, drop=replay())
        bf16 = cfg.model.dtype == "bfloat16"
        if bf16:
            cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                       dtype="float32"))
            want32 = train_step(before, host_batch, cfg32, scale, drop=replay())[1]
        for mod, attr, kname in kernel_counters():
            setattr(mod, attr, counts[kname])
        i = report["steps"] = report["steps"] + 1
        for key in ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss", "grad_norm"):
            r = tol["grad_norm_rtol"] if key == "grad_norm" else tol["loss_rtol_step1"]
            g, w = float(got[key]), float(want[key])
            worst[key] = max(worst.get(key, 0.0), abs(g - w) / max(abs(w), 1e-12))
            bound = r * abs(w) + tol["loss_atol"]
            if bf16 and key == "grad_norm":
                # within the CPU's own bf16 - f32 distance, which must be
                # above the f32 gate (the step rounded)
                d0 = abs(w - float(want32[key]))
                require(d0 > r * abs(w), f"{name} step {i}: gradient norm at bf16 {w:.7g}, "
                        f"at f32 {float(want32[key]):.7g}: not rounded")
                worst["grad_norm_over_d0"] = max(worst.get("grad_norm_over_d0", 0.0),
                                                 abs(g - w) / d0)
                bound += d0
            elif bf16:
                bound += BF16_U * abs(w)
            require(np.isfinite(g) and abs(g - w) <= bound,
                    f"{name} step {i} {key}: card {g:.7g}, CPU {w:.7g} (bound {bound:.3g})")
        atol = tol["delta_norm_atol_lr"] * cfg.train.lr * scale
        p0, after = flatten(before.params), flatten(state_on(new, "cpu").params)
        for key, v in flatten(host.params).items():
            g, w = float((after[key] - p0[key]).norm()), float((v - p0[key]).norm())
            worst["delta_norm"] = max(worst.get("delta_norm", 0.0), abs(g - w) / max(w, 1e-12))
            require(abs(g - w) <= tol["delta_norm_rtol"] * w + atol,
                    f"{name} step {i} {key}: moved {g:.6g} on the card, {w:.6g} on the CPU")
        for site, st in new.bn_state.items():
            for k in ("mean", "var"):
                err = rel_err(st[k].cpu(), host.bn_state[site][k])
                worst["bn_state"] = max(worst.get("bn_state", 0.0), err)
                require(err <= tol["delta_norm_rtol"], f"{name} step {i} {site}/{k}: {err:.3g}")
        return new, got

    saved = (loop.train_step, resident.train_step)
    loop.train_step = resident.train_step = held
    try:
        yield report
    finally:
        loop.train_step, resident.train_step = saved


def eval_forwards(cfg, resident_mode: bool) -> int:
    """Forwards without gradient of one epoch's validation (val_repeats
    times) and the final test, as `fit` runs them: resident groups, or the
    host loop's batches."""
    from equidock_public_tpu_torch.data.dataset import DockingDataset

    def count(split):
        ds = DockingDataset.from_cache(cfg, split, swap=False)
        if resident_mode:
            return resident_eval_steps(ds, cfg, cfg.train.bs)
        return sum(1 for _ in ds.batches(np.random.default_rng(0), device="cpu", shuffle=False))

    return max(cfg.train.val_repeats, 1) * count("val") + count("test")


def path_launches(mcfg, layers, steps, evals, packed=False, stages=1) -> tuple:
    """(launches, inverse lists) of `steps` train steps and `evals` forwards
    without gradient of a model config: rows 3-5 always; rows 1-2 where the
    edge kernel covers the config in training, else row 1 in evaluation
    only where it covers it there; rows 6-7 unless packed; remat relaunches
    rows 1 and 3 for layers 1..n-1 in each backward; `stages` 2 for a
    fine-tune model (one inverse list a side a stage)."""
    from equidock_public_tpu_torch.models.iegmn import fused_edge_eligible, remat_active

    train_edge = fused_edge_eligible(mcfg, train=True)
    want = step_launches(layers, steps, evals, edge=train_edge, softmin=not packed)
    if not train_edge and fused_edge_eligible(mcfg, train=False):
        want["edge_message"] = SIDES * layers * evals
    if remat_active(mcfg):
        again = SIDES * (layers - 1) * steps
        want["cross_attention"] += again
        if train_edge:
            want["edge_message"] += again
    return want, (PER_STEP_INVERSE * stages * steps if train_edge else 0)


def run_held(name, argv, root, mcfg, layers=SLICE8_LAYERS, resident_mode=False,
             packed=False, stages=1, evals=None) -> dict:
    """A slice-8 CLI run with every train step held to the CPU
    (`held_to_cpu`), its launches against `path_launches`; `evals`, the
    forwards without gradient, default to those of one `fit` of the argv's
    config (`eval_forwards`)."""
    from equidock_public_tpu_torch.cli import train as cli

    with held_to_cpu(name) as held:
        run = run_cli(argv, os.path.join(root, "runs", name))
    epochs = [r for r in run["records"] if "train" in r]
    steps = sum(r["train"]["num_batches"] for r in epochs)
    require(held["steps"] == steps and steps > 0,
            f"{name}: {held['steps']} held steps, {steps} in the records")
    if evals is None:
        evals = eval_forwards(cli.config_from_args(cli._parser().parse_args(argv)),
                              resident_mode)
    want, inverse = path_launches(mcfg, layers, steps, evals, packed, stages)
    expect_launches(name, run["launches"], want, inverse)
    require(all(np.isfinite(r["train"]["loss"]) for r in run["records"] if "train" in r),
            f"{name}: non-finite training loss")
    return dict(steps=steps, epochs=len(epochs), forwards_without_gradient=evals,
                launches=run["launches"], kernel_paths=logged(run["log"], "Kernel paths"),
                cli_seconds=run["seconds"], held_to_cpu=held, banner=run["banner"])


def run_a5(root) -> dict:
    """Slice 8 (e): slices 6-7's paths that had not run on the card, at
    SLICE8_LAYERS layers from the committed weights, each step held to the
    CPU: BN with dropout and remat through a CLI epoch and a resident epoch,
    coordinate BN, -fine_tune_init random, -continue_train_model of that
    fine-tune checkpoint, packed DIPS streaming with -stream_window 2, and a
    resident epoch with -val_repeats 2 under the cyclic scheduler."""
    from equidock_public_tpu_torch.config import ModelConfig

    starts = os.path.join(root, "starts")
    plain = start_checkpoint(os.path.join(starts, "plain"), {}, SLICE8_LAYERS)
    base = lambda tag: small_argv(root, tag)
    resident_flags = ["-device_resident", "-trim_remainder"]
    paper = ModelConfig(iegmn_n_lays=SLICE8_LAYERS, shared_layers=True, num_att_heads=50)
    out = {}
    for tag, kw in (("bn_dropout", dict(layer_norm="BN", final_h_layer_norm="BN", dropout=0.1)),
                    ("remat", dict(remat=True))):
        ckpt = start_checkpoint(os.path.join(starts, tag), kw, SLICE8_LAYERS)
        mcfg = dataclasses.replace(paper, **kw)
        for mode, flags in (("cli", []), ("resident", resident_flags)):
            name = f"{tag}_{mode}"
            out[name] = run_held(name, base(name) + flags + ["-continue_train_model", ckpt],
                                 root, mcfg, resident_mode=bool(flags))
    ckpt = start_checkpoint(os.path.join(starts, "coors_bn"), dict(layer_norm_coors="BN"),
                            SLICE8_LAYERS)
    out["coors_bn"] = run_held("coors_bn", base("coors_bn") + ["-continue_train_model", ckpt],
                               root, dataclasses.replace(paper, layer_norm_coors="BN"))
    ft = dataclasses.replace(paper, fine_tune=True)
    out["fine_tune_random"] = run_held(
        "fine_tune_random", base("fine_tune_random") + ["-fine_tune_from", plain,
                                                        "-fine_tune_init", "random"],
        root, ft, layers=SLICE8_LAYERS + 2, stages=2)
    ft_ckpt = os.path.join(root, "ckpt", "fine_tune_random", out["fine_tune_random"]["banner"],
                           "db5_model_best")
    out["continue_fine_tune"] = run_held(
        "continue_fine_tune", base("continue_fine_tune") + ["-continue_train_model", ft_ckpt],
        root, ft, layers=SLICE8_LAYERS + 2, stages=2)
    dips_argv = base("dips_packed_stream") + ["-data", "dips", "-stream_dips", "-stream_window",
                                              "2", "-pack", "-pack_max_per_slot", "4",
                                              "-continue_train_model", plain]
    out["dips_packed_stream"] = run_held("dips_packed_stream", dips_argv, root, paper,
                                         packed=True)
    out["resident_val2_cyclic"] = run_held(
        "resident_val2_cyclic", base("resident_val2_cyclic") + resident_flags
        + ["-val_repeats", "2", "-scheduler", "cyclic", "-continue_train_model", plain],
        root, paper, resident_mode=True)
    return out


def golden_requests():
    return load_asset("db5_model_best.golden.json")["requests"]


def request_lines(golden, out_dir, tag):
    return [json.dumps({"ligand": os.path.join(REPO, g["ligand"]),
                        "receptor": os.path.join(REPO, g["receptor"]),
                        "output": os.path.join(out_dir, f"{tag}{i}.pdb")})
            for i, g in enumerate(golden)]


def served_outputs(server, golden, out_dir, tag) -> tuple:
    """The golden requests through `server.serve_lines`: (R, t, CA of each
    forward, the launches)."""
    outputs, inner = [], server.forward

    def recording(batch):
        out = inner(batch)
        outputs.append({"R": out["R"][0].cpu().numpy(), "t": out["t"][0, 0].cpu().numpy(),
                        "ca": out["ligand_coords"][0, :8].cpu().numpy(),
                        "keypts_lig": out["keypts_lig"][0].cpu().numpy(),
                        "keypts_rec": out["keypts_rec"][0].cpu().numpy()})
        return out

    server.forward = recording
    buf = io.StringIO()
    reset_counts()
    try:
        served = server.serve_lines(request_lines(golden, out_dir, tag), buf)
    finally:
        server.forward = inner
    launches = read_counts()
    resp = [json.loads(x) for x in buf.getvalue().splitlines()]
    require(served == len(golden) == len(outputs) and all(r["ok"] for r in resp),
            f"{tag}: requests failed: {resp}")
    return outputs, launches


def bf16_check(got, ref16, ref32, gated, share, what) -> dict:
    """The card's bf16 forwards `got` against a reference's bf16 and f32
    forwards, over all requests together, for R, t, CA and the keypoints:
    d0 = ||ref16 - ref32||, ||got - ref16|| / d0 and ||got - ref32|| / d0
    (and each request's), emitted before the keys in `gated` are held to
    d0 above their f32 gate (BF16_ATOL), ||got - ref16|| <= share d0 and
    ||got - ref32|| >= d0 / 4."""
    dist = lambda a, b, k: [float(np.linalg.norm(np.asarray(x[k]) - np.asarray(y[k])))
                            for x, y in zip(a, b)]
    tot = lambda v: float(np.sqrt(np.sum(np.square(v))))
    out = {}
    for k in BF16_ATOL:
        d0, err, off = (dist(ref16, ref32, k), dist(got, ref16, k), dist(got, ref32, k))
        out[k] = {"d0": tot(d0), "vs_bf16_over_d0": tot(err) / tot(d0),
                  "off_f32_over_d0": tot(off) / tot(d0), "d0_per_request": d0,
                  "vs_bf16_per_request": err, "off_f32_per_request": off}
    emit("slice8_bf16_check", what=what, gated=list(gated), share=share, **out)
    for k in gated:
        o = out[k]
        require(o["d0"] > BF16_ATOL[k], f"{what} {k}: d0 {o['d0']:.3g} not above {BF16_ATOL[k]}")
        require(o["vs_bf16_over_d0"] <= share and o["off_f32_over_d0"] >= 0.25,
                f"{what} {k}: {o['vs_bf16_over_d0']:.3g} d0 from the reference's bf16, "
                f"{o['off_f32_over_d0']:.3g} d0 from its f32 (d0 {o['d0']:.3g})")
    return out


def cpu_outputs(path, golden, dtype=None) -> list:
    """The CPU's forward of the model at `path` (`load_model`) on the golden
    requests, featurized as the server does: [{R, t, ca}]."""
    from equidock_public_tpu_torch.cli.serve import DockingServer
    from equidock_public_tpu_torch.eval import inference

    server = DockingServer.from_checkpoint(path, "cpu", dtype)
    out = []
    for g in golden:
        req = inference.featurize_request(server.cfg, os.path.join(REPO, g["ligand"]),
                                          os.path.join(REPO, g["receptor"]), "cpu")
        o = server.forward(req.batch)
        out.append({"R": o["R"][0].numpy(), "t": o["t"][0, 0].numpy(),
                    "ca": o["ligand_coords"][0, :8].numpy(),
                    "keypts_lig": o["keypts_lig"][0].numpy(),
                    "keypts_rec": o["keypts_rec"][0].numpy()})
    return out


def run_trained_serving(dev, root) -> dict:
    """Slice 8 (a): a 'BN' model (the paper's config with layer_norm and
    final_h 'BN', from its committed weights) and a bf16 model (the 16-wide
    db5_model_small at bf16), each trained 2 steps through the CLI
    (-continue_train_model of its start), every step held to the CPU
    (`held_to_cpu`; the bf16 gates for the bf16 model); each one's training
    checkpoint served through DockingServer.from_checkpoint on the 4 golden
    requests against the CPU's forward of the same checkpoint ('BN': the
    serving gates; bf16: `bf16_check` of R, t, CA and the keypoints at
    BF16_SHARE, and the checkpoint served at f32 to the 16-wide models'
    serving gates, `model_served_atol`), and through cli.inference on a
    directory of the same requests (its written atoms against the server's
    R, t)."""
    from equidock_public_tpu_torch.cli import inference as inference_cli
    from equidock_public_tpu_torch.cli.serve import DockingServer
    from equidock_public_tpu_torch.data.pdb import read_pdb
    from equidock_public_tpu_torch.models import iegmn
    from equidock_public_tpu_torch.params import load_model, model_checkpoint

    golden = golden_requests()
    inp, gt = os.path.join(root, "serve_in"), os.path.join(root, "serve_gt")
    os.makedirs(inp)
    os.makedirs(gt)
    for i, g in enumerate(golden):
        shutil.copy(os.path.join(REPO, g["ligand"]), os.path.join(inp, f"R{i}_l_b.pdb"))
        shutil.copy(os.path.join(REPO, g["receptor"]), os.path.join(gt, f"R{i}_r_b_COMPLEX.pdb"))
    out = {}
    for tag, kw, model in (("bn", dict(layer_norm="BN", final_h_layer_norm="BN"),
                            "db5_model_best"),
                           ("bf16", dict(dtype="bfloat16"), "db5_model_small")):
        mcfg = load_model(model_checkpoint(model))[1].model
        start = start_checkpoint(os.path.join(root, "starts", f"serve_{tag}"), kw,
                                 mcfg.iegmn_n_lays, model)
        mcfg = dataclasses.replace(mcfg, **kw)
        name = f"serve_{tag}"
        run = run_held(name, small_argv(root, name) + ["-continue_train_model", start], root,
                       mcfg, layers=mcfg.iegmn_n_lays)
        ckpt = os.path.join(root, "ckpt", name, run["banner"], "db5_model_best")
        server = DockingServer.from_checkpoint(ckpt, dev)
        require((server.bn_state is not None) == (tag == "bn")
                and server.cfg.model.dtype == ("bfloat16" if tag == "bf16" else "float32"),
                f"{tag}: the served checkpoint's config or statistics")
        iegmn.plain_body_calls = 0
        got, launches = served_outputs(server, golden, os.path.join(root, "served"), tag)
        plain = iegmn.plain_body_calls
        per = SIDES * mcfg.iegmn_n_lays * len(golden)
        eligible = iegmn.fused_edge_eligible(server.cfg.model, train=False)
        require(launches["cross_attention"] == per
                and launches["edge_message"] == (per if eligible else 0)
                and plain == (0 if eligible else per) and launches[INVERSE[2]] == 0,
                f"{tag} serving: launches {launches}, {plain} plain sides")
        cpu = cpu_outputs(ckpt, golden)
        check = {}
        if tag == "bf16":
            ref = cpu_outputs(ckpt, golden, "float32")
            check["bf16"] = bf16_check(got, cpu, ref, tuple(BF16_ATOL), BF16_SHARE["cpu"],
                                       "bf16 training checkpoint, card vs CPU")
            # the same checkpoint served at f32: the card to the 16-wide
            # models' serving gates
            card, _ = served_outputs(DockingServer.from_checkpoint(ckpt, dev, "float32"),
                                     golden, os.path.join(root, "served"), "f32")
            atols = [model_served_atol(c, g["R"]) for g, c in zip(card, ref)]
        else:
            card, ref, atols = got, cpu, [GOLDEN_ATOL] * len(golden)
        for k in GOLDEN_ATOL:
            errs = [float(np.abs(g[k] - c[k]).max()) for g, c in zip(card, ref)]
            require(all(e <= a[k] for e, a in zip(errs, atols)),
                    f"{tag} served {k} at f32: {errs} from the CPU, gates "
                    f"{[a[k] for a in atols]}")
            check[k] = max(errs)
        d = os.path.join(root, f"cli_out_{tag}")
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            inference_cli.main(["-checkpoint", ckpt, "-input_dir", inp, "-ground_truth_dir", gt,
                                "-output_dir", d, "-node_buckets",
                                ",".join(map(str, server.cfg.data.node_buckets)),
                                "-device", "cuda"])
        cli_launches = read_counts()
        cli_err = 0.0
        for i, o in enumerate(got):
            table = read_pdb(os.path.join(inp, f"R{i}_l_b.pdb"))
            moved = table.coords @ o["R"].T + o["t"]
            written = read_pdb(os.path.join(d, f"R{i}_l_b_EQUIDOCK_TPU.pdb")).coords
            cli_err = max(cli_err, float(np.abs(written - moved).max()))
        require(cli_err <= PATH_ATOL and cli_launches["cross_attention"] == per,
                f"{tag} cli.inference: {cli_err:.3g} A from the server, launches {cli_launches}")
        out[tag] = dict(model=model, train_steps=run["steps"], train_launches=run["launches"],
                        train_held_to_cpu=run["held_to_cpu"],
                        serve_launches=launches, plain_body_sides=plain, vs_cpu=check,
                        cli_inference_vs_server_max_abs=cli_err, cli_launches=cli_launches,
                        checkpoint_model=dict(layer_norm=server.cfg.model.layer_norm,
                                              dtype=server.cfg.model.dtype))
    return out


def run_bf16_serving(dev, root) -> dict:
    """Slice 8 (b): the paper model served at -dtype bfloat16 from its
    committed weights on the 4 golden requests, against
    assets/db5_model_best_bf16.golden.json (the JAX package's fused path
    at bf16 and at f32: `bf16_check`, half of d0); request ms
    (serve_lines) and the forward's device time at bf16 and f32, in turns
    (f32, bf16, bf16, f32), the forward profiled on the 512 x 1024
    request."""
    from equidock_public_tpu_torch.cli.serve import DockingServer
    from equidock_public_tpu_torch.eval import inference
    from equidock_public_tpu_torch.params import default_checkpoint

    gold = load_asset("db5_model_best_bf16.golden.json")
    golden = golden_requests()
    servers = {dt: DockingServer.from_checkpoint(default_checkpoint(), dev, dt)
               for dt in ("float32", "bfloat16")}
    for s in servers.values():
        s.warmup(WARMUP_BUCKETS)
    got, launches = served_outputs(servers["bfloat16"], golden, root, "bf16_")
    per = SIDES * LAYERS * len(golden)
    require(launches["edge_message"] == launches["cross_attention"] == per
            and launches[INVERSE[2]] == 0, f"bf16 serving launches {launches}")
    check = bf16_check(got, gold["requests"], gold["float32"], tuple(BF16_ATOL),
                       BF16_SHARE["jax"], "bf16 serving, card vs the JAX package")
    ms = {"float32": [], "bfloat16": []}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        ms[dt] += serve_lines_ms(servers[dt], golden, root)
    req = inference.featurize_request(servers["float32"].cfg,
                                      os.path.join(REPO, golden[0]["ligand"]),
                                      os.path.join(REPO, golden[0]["receptor"]), dev)
    profile = {dt: device_profile(lambda s=s: s.forward(req.batch)["R"].cpu(), reps=3)
               for dt, s in servers.items()}
    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "TF32 turned on")
    return dict(vs_jax=check, share=BF16_SHARE["jax"], launches=launches,
                request_ms=ms, request_ms_median={k: statistics.median(v) for k, v in ms.items()},
                forward_profile_512x1024=profile, allow_tf32=False)


def non512_cases(params, N, M, dev):
    """Rows 1-7 at a resolved auto bucket: the edge case at B=10, N nodes
    (70-274 valid, trained weights of the shared layer); attention and the
    soft-min field at B=10, N x M with training masks."""
    from equidock_public_tpu_torch.ops.cuda import cross_attention as ca

    edge = edge_bwd_case(params, dev, B=10, N=N)
    rng = np.random.default_rng(N + M)
    gen = torch.Generator().manual_seed(N + M)
    q, k, v, do = (torch.randn(10, n, 64, generator=gen) * s
                   for n, s in ((N, 0.3), (M, 0.3), (M, 1.0), (N, 1.0)))
    qt, kt = training_tags(rng, 10, N), training_tags(rng, 10, M)
    q, k, v, qt, kt, do = (x.to(dev).contiguous() for x in (q, k, v, qt, kt, do))
    o, lse = ca.cross_attention_plain(q, k, v, qt, kt)
    att = dict(shape=f"B=10 N={N} M={M} D=Dv=64 (70-274 valid a side)",
               args=(q, k, v, qt, kt), bwd=(q, k, v, qt, kt, o.contiguous(), lse.contiguous(),
                                            do))
    x = torch.from_numpy(rng.standard_normal((10, N, 3)).astype(np.float32) * 15)
    a = torch.from_numpy(rng.standard_normal((10, M, 3)).astype(np.float32) * 15 + 5)
    c = torch.from_numpy(rng.standard_normal((10, N)).astype(np.float32)) * qt.cpu()
    soft = dict(shape=f"B=10 M={N} N={M} (split-chain halves)",
                args=(x.to(dev), a.to(dev), kt), c=c.to(dev).contiguous())
    return edge, att, soft


def run_auto_epoch(dev, root, db5_root) -> dict:
    """Slice 8 (c): the training CLI one epoch of a random full-width paper
    model with -node_buckets auto:4 -pocket_buckets auto:4 on the DB5-sized
    split of epoch (b): the resolved ladders (from the log), launches; rows
    1-7 at the largest resolved bucket that is not a multiple of 512 (N)
    against keys N + 64 (M): forwards to EDGE_TOL / ATT_TOL / SOFTMIN_TOL,
    backwards norm-wise to BWD_REL_TOL; each timed beside its plain
    version."""
    import ast

    from equidock_public_tpu_torch.ops import softmin_field as sf
    from equidock_public_tpu_torch.ops.cuda import cross_attention as ca
    from equidock_public_tpu_torch.ops.cuda import edge_message as em
    from equidock_public_tpu_torch.ops.cuda import softmin_field as ksf
    from equidock_public_tpu_torch.params import default_checkpoint, load_checkpoint

    argv = [a for a in db5_sized_argv(db5_root, epochs=1)]
    i = argv.index("-node_buckets")
    argv[i + 1] = "auto:4"
    argv[argv.index("-pocket_buckets") + 1] = "auto:4"
    argv += ["-checkpoint_dir", os.path.join(root, "ckpt", "auto")]
    run = run_cli(argv, os.path.join(root, "runs", "auto"))
    ladders = {}
    for line in run["log"].splitlines():
        for kind in ("node", "pocket"):
            mark = f"auto {kind} buckets ("
            if mark in line:
                ladders[kind] = ast.literal_eval(line.split("): ", 1)[1].strip())
    require(set(ladders) == {"node", "pocket"}, f"no resolved ladders in the log: {ladders}")
    steps = run["records"][0]["train"]["num_batches"]
    evals = sum(-(-DB5_SIZED_SPLIT[s] // 10) for s in ("val", "test"))
    expect_counts("auto-bucket epoch", run["launches"], steps, evals, fused=True)
    odd = [b for b in ladders["node"] if b % 512]
    require(odd, f"no resolved node bucket off a multiple of 512: {ladders['node']}")
    N = max(odd)
    M = N + 64
    params, cfg = load_checkpoint(default_checkpoint(), dev)
    slope = cfg.model.leakyrelu_neg_slope
    edge, att, soft = non512_cases(params, N, M, dev)
    checks = {"edge": check_edge_case(edge, slope)}
    got = ca.cross_attention_fwd(*att["args"])
    synced("cross_attention (auto bucket)")
    checks["cross_attention"] = check_close("cross_attention " + att["shape"], got,
                                            ca.cross_attention_plain(*att["args"]), ATT_TOL)
    gb = ca.cross_attention_bwd(*att["bwd"])
    synced("cross_attention_dq, cross_attention_dkv (auto bucket)")
    want = ca.cross_attention_bwd_plain(*att["bwd"][:5], att["bwd"][7])
    checks["cross_attention_dq"] = check_grads("cross_attention_dq", att["shape"], gb[:1],
                                               want[:1])
    checks["cross_attention_dkv"] = check_grads("cross_attention_dkv", att["shape"], gb[1:],
                                                want[1:])
    check_softmin_case(soft)
    checks["softmin_field"], checks["softmin_field_bwd"] = soft["err"], soft["check"]
    q, k, v, qt, kt, o, lse, do = att["bwd"]
    delta = (do * o).sum(-1).contiguous()
    bargs = (q, k, v, qt, kt, lse, do, delta)
    x, a, am = soft["args"]
    ea = edge["args"]
    inv = em.inverse_neighbors(ea[3], ea[0].shape[1])
    leaves = [t.detach().requires_grad_(True) for t in (*ea[:3], *ea[5].values())]
    plain_out = em.edge_message_plain(*leaves[:3], ea[3], ea[4],
                                      dict(zip(em.PARAM_NAMES, leaves[3:])), slope)
    times = {
        "edge_message": (device_ms(lambda: em.edge_message_aggregate(*ea, slope=slope)),
                         device_ms(lambda: em.edge_message_plain(*ea, slope=slope))),
        "edge_message_bwd": (device_ms(lambda: em.edge_message_bwd(*ea, *edge["grads"],
                                                                   slope=slope, inverse=inv)),
                             backward_ms(plain_out, leaves, edge["grads"])),
        "cross_attention": (device_ms(lambda: ca.cross_attention_fwd(*att["args"])),
                            device_ms(lambda: ca.cross_attention_plain(*att["args"]))),
        "cross_attention_dq": (device_ms(lambda: ca.cross_attention_dq(*bargs)), None),
        "cross_attention_dkv": (device_ms(lambda: ca.cross_attention_dkv(*bargs)), None),
        "softmin_field": (device_ms(lambda: ksf.softmin_field_fwd(x, a, am, SIGMA)),
                          device_ms(lambda: sf.softmin_field_sums_plain(x, a, am, SIGMA),
                                    reps=5)),
        "softmin_field_bwd": (device_ms(lambda: ksf.softmin_field_bwd(x, a, am, soft["c"],
                                                                      SIGMA)),
                              device_ms(lambda: sf.softmin_field_bwd_plain(x, a, am, soft["c"],
                                                                           SIGMA), reps=5))}
    plain_bwd = graph_backward_ms(lambda l: ca.cross_attention_plain(*l, qt, kt)[0], (q, k, v),
                                  do)
    return dict(ladders=ladders, steps=steps, forwards_without_gradient=evals,
                launches=run["launches"], epoch=epoch_summary(run, DB5_SIZED_SPLIT["train"]),
                shapes={"edge": edge["shape"], "attention": att["shape"],
                        "softmin": soft["shape"]},
                checks=checks, tolerance={"edge_message": EDGE_TOL, "cross_attention": ATT_TOL,
                                          "softmin_field": SOFTMIN_TOL,
                                          "backward_relative_norm": BWD_REL_TOL},
                ms={k: {"ms": t, "plain_ms": p} for k, (t, p) in times.items()},
                attention_backward_plain_whole_ms=plain_bwd,
                timing="device time per call from CUDA-graph replays (device_ms); the edge "
                       "backward's plain_ms is autograd through the plain forward over eager "
                       "calls; dq and dkv share the plain whole backward "
                       "(attention_backward_plain_whole_ms)")


def run_distill(dev, root) -> dict:
    """Slice 8 (d): teacher poses written by the port's directory inference
    on the card (the paper model's committed weights) for 8 tracked chains
    cut in two, each ligand half moved by a seeded rigid motion; then one
    distilled CLI epoch (-distill_dir, -distill_alpha 0.5) on split caches
    of those chains (8 train, 4 val, 4 test), SLICE8_LAYERS layers from the
    committed weights: the log's blend count, the blended targets against
    (1 - a) gt + a teacher on the host, launches."""
    from equidock_public_tpu_torch.cli import train as cli
    from equidock_public_tpu_torch.data.dataset import DockingDataset, write_cache
    from equidock_public_tpu_torch.data.pdb import read_pdb, write_pdb
    from equidock_public_tpu_torch.eval.inference import run_inference_dir
    from equidock_public_tpu_torch.params import default_checkpoint, load_checkpoint

    from scipy.spatial.transform import Rotation

    params, cfg = load_checkpoint(default_checkpoint(), dev)
    droot = os.path.join(root, "distill")
    inp, gt, teacher = (os.path.join(droot, d) for d in ("in", "gt", "teacher"))
    rng = np.random.default_rng(21)
    train_codes = DISTILL_CODES[:8]
    os.makedirs(inp)
    os.makedirs(gt)
    for code in train_codes:
        with open(chain_path(code)) as f:
            lines = [ln for ln in f if ln.startswith("ATOM")]
        keys = list(dict.fromkeys(ln[21:27] for ln in lines))
        first = set(keys[:len(keys) // 2])
        lig = os.path.join(gt, f"{code}_l_b_COMPLEX.pdb")
        with open(lig, "w") as f:
            f.writelines(ln for ln in lines if ln[21:27] in first)
        with open(os.path.join(gt, f"{code}_r_b_COMPLEX.pdb"), "w") as f:
            f.writelines(ln for ln in lines if ln[21:27] not in first)
        table = read_pdb(lig)
        c = table.coords.mean(axis=0)
        rot = Rotation.random(random_state=rng).as_matrix()
        write_pdb(os.path.join(inp, f"{code}_l_b.pdb"), table,
                  ((table.coords - c) @ rot.T + c + rng.normal(0, 5.0, 3)).astype(np.float32))
    reset_counts()
    run_inference_dir(params, cfg, inp, gt, teacher, log=lambda *a: None, device=dev)
    teacher_launches = read_counts()
    require(teacher_launches["edge_message"] == SIDES * LAYERS * len(train_codes),
            f"teacher inference launches {teacher_launches}")
    argv = small_argv(droot, "distill") + [
        "-distill_dir", teacher, "-distill_alpha", "0.5", "-continue_train_model",
        start_checkpoint(os.path.join(droot, "start"), {}, SLICE8_LAYERS)]
    dcfg = cli.config_from_args(cli._parser().parse_args(argv))
    splits = {"train": DISTILL_CODES[:8], "val": DISTILL_CODES[8:12],
              "test": DISTILL_CODES[12:]}
    for split, codes in splits.items():
        write_cache(os.path.join(dcfg.cache_path(), f"{split}.npz"), codes,
                    split_chain_samples(codes, dcfg.graph))
    run = run_cli(argv, os.path.join(root, "runs", "distill"))
    line = next(ln for ln in run["log"].splitlines() if ln.startswith("distill: "))
    require(line.startswith(f"distill: blended teacher poses into {len(train_codes)}/"
                            f"{len(train_codes)}"), f"distillation log: {line}")
    with contextlib.redirect_stdout(io.StringIO()):
        blended = DockingDataset.from_cache(dcfg, "train")
    plain = DockingDataset.from_cache(dataclasses.replace(
        dcfg, data=dataclasses.replace(dcfg.data, distill_dir="")), "train")
    err = 0.0
    for code, b, p in zip(blended.codes, blended.samples, plain.samples):
        t = read_pdb(os.path.join(teacher, f"{code}_l_b_EQUIDOCK_TPU.pdb"))
        ca = t.coords[t.atom_name == "CA"].astype(np.float32)
        err = max(err, float(np.abs(b.gt_lig - ((0.5 * p.gt_lig + 0.5 * ca)
                                                .astype(np.float32))).max()))
    require(err == 0.0, f"blended targets {err:.3g} from (1 - a) gt + a teacher")
    steps = run["records"][0]["train"]["num_batches"]
    from equidock_public_tpu_torch.config import ModelConfig

    want, inverse = path_launches(ModelConfig(iegmn_n_lays=SLICE8_LAYERS, shared_layers=True,
                                              num_att_heads=50), SLICE8_LAYERS, steps,
                                  eval_forwards(dcfg, False))
    expect_launches("distilled epoch", run["launches"], want, inverse)
    return dict(log=line, teacher_launches=teacher_launches, steps=steps,
                launches=run["launches"], blended_max_abs_vs_host=err,
                cli_seconds=run["seconds"])


def run_slice8(dev, root, db5_root) -> dict:
    """The slice-8 phases, each with its seconds."""
    os.makedirs(root, exist_ok=True)
    out, seconds = {}, {}
    t0 = time.perf_counter()
    write_small_split(root)
    seconds["small_split"] = time.perf_counter() - t0
    for name, run in (("trained_serving", lambda: run_trained_serving(dev, root)),
                      ("bf16_serving", lambda: run_bf16_serving(dev, root)),
                      ("auto_buckets", lambda: run_auto_epoch(dev, root, db5_root)),
                      ("distill", lambda: run_distill(dev, root)),
                      ("a5", lambda: run_a5(root))):
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = round(time.perf_counter() - t0, 1)
        emit(f"slice8_{name}", seconds=seconds[name], **out[name])
    out["seconds"] = seconds
    return out


# --------------------------------------------------------------------------- #
# Slice 9: the host builders and tools, from raw PDB files to caches the port
# builds itself, trained on the card
# --------------------------------------------------------------------------- #

SLICE9_SUM_RTOL = 1e-6      # float arrays of a cache: float64 sums against the JAX digest
TESTSET_ATOL = 1e-3         # written coordinates (%8.3f) against the JAX package's
RHO_ATOL = 1e-9             # surface rhos (analyze) against the JAX package's
RHO_PRINT_ATOL = 5e-4       # the CLI's printed rhos (3 decimals)
PROFILE_KERNELS = ("edge_message_fwd_kernel", "edge_message_bwd_kernel",
                   "cross_attention_fwd_kernel", "cross_attention_dq_kernel",
                   "cross_attention_dkv_kernel", "softmin_tiles_kernel")   # rows 1-5, 6-7
SLICE9_SPAN = "slice9_train_step"


def slice9_paths(root, recipe) -> dict:
    """The recipe's tree under `root` (the layout of slice9.golden.json),
    written: the raw structures and split files of its chains cut in two."""
    from equidock_public_tpu_torch.data.synth import write_db5_raw_tree

    paths = {k: os.path.join(root, v) for k, v in recipe["layout"].items()}
    chains = {c: os.path.join(REPO, recipe["chain_file"].format(c)) for c in recipe["codes"]}
    paths["raw"], paths["cv"] = write_db5_raw_tree(paths["reference_root"], chains,
                                                   [tuple(s) for s in recipe["splits"]])
    return paths


def host_env(paths) -> dict:
    """A subprocess's environment: the checkout importable, the reference
    root at the recipe's tree."""
    return dict(os.environ, PYTHONPATH=REPO, EQUIDOCK_REFERENCE_ROOT=paths["reference_root"])


def start_modules(calls, env, cwd) -> dict:
    """`python -m equidock_public_tpu_torch.<module> args` for each entry
    name -> (module, args), all started at once."""
    return {name: (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", f"equidock_public_tpu_torch.{m}", *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=cwd, env=env)) for name, (m, args) in calls.items()}


def stop_modules(procs) -> None:
    for _, p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def wait_modules(procs, timeout=600) -> dict:
    """Each started module to its end; fails unless each exits 0 (the rest
    are stopped). Returns name -> its seconds and its output."""
    out = {}
    try:
        for name, (t0, p) in procs.items():
            stdout, stderr = p.communicate(timeout=timeout)
            require(p.returncode == 0, f"{name} {' '.join(p.args[3:])} exited {p.returncode}:"
                                       f"\n{stdout[-2000:]}{stderr[-4000:]}")
            out[name] = dict(seconds=time.perf_counter() - t0, stdout=stdout)
    finally:
        stop_modules(procs)
    return out


def run_module(module, args, env, cwd, timeout=600) -> dict:
    """One module to its end, alone (`start_modules`, `wait_modules`)."""
    return wait_modules(start_modules({module: (module, args)}, env, cwd), timeout)[module]


def array_digest(a: np.ndarray) -> dict:
    """tests/torch_golden.py::array_digest: shape, dtype, sha256 of the
    bytes, for floats the float64 sum and sum of absolute values."""
    import hashlib

    d = {"shape": list(a.shape), "dtype": str(a.dtype),
         "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}
    if a.dtype.kind == "f":
        d["sum"] = float(a.astype(np.float64).sum())
        d["abs_sum"] = float(np.abs(a.astype(np.float64)).sum())
    return d


def check_digest(what, path, want) -> dict:
    """A cache file against its JAX digest: the same codes and keys, each
    array's shape and dtype; int, bool and str arrays hash-equal; float
    arrays' sums within SLICE9_SUM_RTOL. Counts the floats also hash-equal."""
    with np.load(path, allow_pickle=False) as z:
        codes = [str(c) for c in z["codes"]]
        got = {k: array_digest(z[k]) for k in z.files}
    require(codes == want["codes"], f"{what}: codes {codes}, the JAX package's {want['codes']}")
    require(sorted(got) == sorted(want["arrays"]), f"{what}: other keys than the JAX cache's")
    n_float = n_equal = 0
    worst = 0.0
    for key, w in want["arrays"].items():
        g = got[key]
        require(g["shape"] == w["shape"] and g["dtype"] == w["dtype"],
                f"{what} {key}: {g['shape']} {g['dtype']}, JAX {w['shape']} {w['dtype']}")
        if "sum" not in w:
            require(g["sha256"] == w["sha256"], f"{what} {key}: not hash-equal to JAX's")
            continue
        n_float += 1
        n_equal += g["sha256"] == w["sha256"]
        for s in ("sum", "abs_sum"):
            err = abs(g[s] - w[s]) / max(abs(w[s]), 1e-30)
            worst = max(worst, err)
            require(err <= SLICE9_SUM_RTOL, f"{what} {key} {s}: {g[s]!r} against JAX {w[s]!r}")
    return dict(complexes=len(codes), arrays=len(got), float_arrays=n_float,
                float_hash_equal=n_equal, worst_sum_rel_err=worst)


def check_pdb(what, path, want) -> dict:
    """A written PDB against the JAX package's: coordinates within
    TESTSET_ATOL (as the text gives them); whether the bytes are equal."""
    import hashlib

    from equidock_public_tpu_torch.data.pdb import read_pdb

    coords = read_pdb(path).coords.ravel().astype(np.float64)
    ref = np.asarray(want["coords"])
    require(coords.shape == ref.shape, f"{what}: {coords.size} coordinates, JAX {ref.size}")
    err = float(np.abs(coords - ref).max())
    require(err <= TESTSET_ATOL, f"{what}: coordinates {err:.3g} A from the JAX package's")
    with open(path, "rb") as f:
        same = hashlib.sha256(f.read()).hexdigest() == want["sha256"]
    return dict(max_abs_err=err, byte_equal=same)


def logged_seconds(stdout: str, unit: str) -> float:
    """The sum of the seconds a builder logs, `...: N <unit> ... in S s`,
    one line a split."""
    lines = [line for line in stdout.splitlines()
             if f" {unit} " in line and line.rstrip().endswith(" s") and " in " in line]
    require(lines, f"no '{unit} in ... s' line logged:\n{stdout[-2000:]}")
    return sum(float(line.rsplit(" in ", 1)[1].split()[0]) for line in lines)


def slice9_argv(paths, ckpt_dir, start) -> list:
    """The paper model's training flags (5 layers, one shared, 50 heads,
    fused intersection) from the `start` checkpoint on the tree's caches."""
    return ["-shared_layers", "-iegmn_n_lays", str(LAYERS), "-num_att_heads", "50",
            "-use_fused_intersection", "-random_seed", "0", "-device", "cuda",
            "-cache_dir", paths["cache_dir"], "-checkpoint_dir", ckpt_dir,
            "-continue_train_model", start]


def kabsch_pose(a, b):
    """(R, t) moving point set a (N, 3) onto b."""
    from equidock_public_tpu_torch.data.featurize import rigid_transform_kabsch

    R, t = rigid_transform_kabsch(a.T.astype(np.float64), b.T.astype(np.float64))
    return R, t[:, 0]


def check_inference(card_dir, cpu_dir, input_dir) -> dict:
    """Each ligand the card moved against the CPU's forward of the same
    files: R and t of the move (fitted to the written coordinates) and the
    moved CA atoms at the serving gates."""
    from equidock_public_tpu_torch.data.pdb import read_pdb

    files = sorted(os.listdir(card_dir))
    require(files == sorted(os.listdir(cpu_dir)) and files, f"outputs {files}")
    worst = {k: 0.0 for k in GOLDEN_ATOL}
    for f in files:
        card, cpu = read_pdb(os.path.join(card_dir, f)), read_pdb(os.path.join(cpu_dir, f))
        start = read_pdb(os.path.join(input_dir, f.split("_l_b_")[0] + "_l_b.pdb")).coords
        (Rg, tg), (Rw, tw) = kabsch_pose(start, card.coords), kabsch_pose(start, cpu.coords)
        ca = card.atom_name == "CA"
        errs = {"R": float(np.abs(Rg - Rw).max()), "t": float(np.abs(tg - tw).max()),
                "ca": float(np.abs(card.coords[ca] - cpu.coords[ca]).max())}
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
            require(np.isfinite(card.coords).all() and e <= GOLDEN_ATOL[k],
                    f"cli.inference {f}: {k} {e:.3g} from the CPU's forward (gate "
                    f"{GOLDEN_ATOL[k]})")
    return dict(files=len(files), max_abs_err_vs_cpu=worst, gates=GOLDEN_ATOL)


def build_snapshot() -> dict:
    """Every file under the kernels' build directory: (size, mtime, inode)."""
    from equidock_public_tpu_torch.ops.cuda import _build

    out = {}
    for d, _, files in os.walk(_build.BUILD_DIR):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.relpath(os.path.join(d, f), _build.BUILD_DIR)] = (st.st_size,
                                                                          st.st_mtime_ns,
                                                                          st.st_ino)
    return out


def run_profiled_steps(dev, paths, start) -> dict:
    """(g) Steps of the paper model on the tree's first train batch: 7 timed
    by `profiling.StepTimer` (2 warm-up) and, on the same steps, by
    chip_smoke's own clock (synchronized around each step); then 2 steps in
    `profiling.trace`, one `named_scope` each. The Chrome trace must name
    rows 1-7's `__global__` kernels and the span."""
    from equidock_public_tpu_torch.data.dataset import DockingDataset
    from equidock_public_tpu_torch.train.checkpoint import load_checkpoint
    from equidock_public_tpu_torch.train.step import train_step
    from equidock_public_tpu_torch.utils import profiling

    state, cfg, _ = load_checkpoint(start, dev)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, cache_dir=paths["cache_dir"]),
        train=dataclasses.replace(cfg.train, use_fused_intersection=True))
    batch = next(DockingDataset.from_cache(cfg, "train").batches(np.random.default_rng(0),
                                                                 device=dev))
    timer, own = profiling.StepTimer(warmup=2), []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer:
            state, m = train_step(state, batch, cfg)
        torch.cuda.synchronize()
        own.append((time.perf_counter() - t0) * 1e3)
    require(np.isfinite(float(m["loss"])), "profiled steps: non-finite loss")
    log_dir = os.path.join(paths["profile"], "trace")
    t0 = time.perf_counter()
    with profiling.trace(log_dir):
        for _ in range(2):
            with profiling.named_scope(SLICE9_SPAN):
                state, m = train_step(state, batch, cfg)
    trace_s = time.perf_counter() - t0
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in n for n in kernels) for k in PROFILE_KERNELS}
    missing = [k for k, n in found.items() if n == 0]
    require(not missing, f"the Chrome trace names no kernel {missing} ({len(kernels)} kernels)")
    spans = sum(e.get("name") == SLICE9_SPAN for e in events)
    require(spans >= 2, f"the Chrome trace holds {spans} '{SLICE9_SPAN}' spans")
    return dict(step_timer_mean_ms=timer.mean() * 1e3, step_timer_times=len(timer.times),
                chip_smoke_step_median_ms=statistics.median(own[2:]),
                chip_smoke_step_ms=own, trace_events=len(events), trace_kernels=len(kernels),
                kernels_named=found, spans=spans, trace_seconds=trace_s,
                trace_mb=os.path.getsize(os.path.join(log_dir, profiling.TRACE_FILE)) / 2**20)


def run_slice9(dev, root, smi) -> dict:
    """Slice 9: raw PDB files to caches the port builds, trained on the
    card, and the host tools, each part against slice9.golden.json (the
    JAX package's outputs on the same tree) or the CPU; see the module
    docstring. Emits each part as it ends, with its seconds."""
    from equidock_public_tpu_torch.cli import surface_analysis
    from equidock_public_tpu_torch.cli import train as cli
    from equidock_public_tpu_torch.cli.serve import DockingServer
    from equidock_public_tpu_torch.config import Config, DataConfig, ModelConfig
    from equidock_public_tpu_torch.eval.inference import run_inference_dir
    from equidock_public_tpu_torch.params import default_checkpoint, load_checkpoint, load_model

    golden = load_asset("slice9.golden.json")
    recipe = golden["recipe"]
    os.makedirs(root, exist_ok=True)
    out = {}
    clock = time.perf_counter()

    def done(name, **part):
        nonlocal clock
        now = time.perf_counter()
        out[name] = dict(part, seconds=round(now - clock, 1))
        clock = now
        emit(f"slice9_{name}", **out[name])

    cache_of = lambda cache, data="db5": Config(data=DataConfig(
        data=data, cache_dir=cache)).cache_path()
    # (a) the raw tree
    paths = slice9_paths(root, recipe)
    paths["profile"] = os.path.join(root, "profile")
    env, cwd = host_env(paths), root
    n_complexes = sum(n for _, n in recipe["splits"])
    done("tree", codes=recipe["codes"], splits=recipe["splits"])
    # (b) the DB5 caches, at -n_jobs 4 and 1, against the JAX digests
    runs, work, checks = {}, {}, {}
    for n_jobs, cache in ((4, paths["cache_dir"]), (1, os.path.join(root, "cache_nj1"))):
        run = run_module("cli.preprocess", ["-n_jobs", str(n_jobs), "-cache_dir", cache],
                         env, cwd)
        runs[n_jobs], work[n_jobs] = run["seconds"], logged_seconds(run["stdout"], "complexes")
        for split, want in golden["db5_cache"].items():
            checks[f"{split}_n_jobs{n_jobs}"] = check_digest(
                f"db5 {split} (n_jobs {n_jobs})", os.path.join(cache_of(cache), f"{split}.npz"),
                want)
            with open(os.path.join(paths["cv"], f"{split}.txt")) as f:
                listed = [line.strip() for line in f if line.strip()]
            dropped = sorted(set(listed) - set(want["codes"]))
            require(dropped == want["dropped"], f"db5 {split}: dropped {dropped}")
    done("caches", digests=checks, complexes=n_complexes, cli_seconds=runs,
         build_seconds=work, seconds_a_complex={n: w / n_complexes for n, w in work.items()},
         seconds_note="build_seconds: the three splits' seconds from reading to the written "
                      "file, as the CLI logs them (the pool's start included); cli_seconds: "
                      "the process, Python's and torch's start included", card=smi)
    # (c) full-width training on the cache the port built, every step held to the CPU
    start = start_checkpoint(os.path.join(root, "starts", "paper"), {}, LAYERS)
    paper = ModelConfig(iegmn_n_lays=LAYERS, shared_layers=True, num_att_heads=50)
    done("train", **run_held("slice9_train", slice9_argv(paths, os.path.join(root, "ckpt", "c"),
                                                         start) + ["-toy", "-max_epochs", "1"],
                             root, paper, layers=LAYERS))
    # (d) the paper's evaluation flow from raw structures, and (h) the host
    # tools beside it: the processes that need no other's output run at once
    test_dir = paths["testset"]
    run_module("cli.testset_gen", ["-dataset", "db5", "-split_file",
                                   os.path.join(paths["cv"], "test.txt"), "-out_dir", test_dir,
                                   "-seed", str(recipe["testset_seed"])], env, cwd)
    files = sorted(os.listdir(test_dir))
    require(files == sorted(golden["testset"]), f"test set files {files}")
    tests = {f: check_pdb(f"testset {f}", os.path.join(test_dir, f), golden["testset"][f])
             for f in files}
    card_dir, cpu_dir = os.path.join(root, "inference_card"), os.path.join(root, "inference_cpu")
    procs = start_modules({
        "frozen": ("cli.preprocess", ["-data", "dips", "-dips_frozen_complexes", test_dir,
                                      "-n_jobs", "4", "-cache_dir", paths["frozen_cache_dir"]]),
        "inference": ("cli.inference", ["-checkpoint", default_checkpoint(), "-input_dir",
                                        test_dir, "-ground_truth_dir", test_dir, "-output_dir",
                                        card_dir])}, env, cwd)
    try:
        params, cfg = load_checkpoint(default_checkpoint(), "cpu")
        run_inference_dir(params, cfg, test_dir, test_dir, cpu_dir, log=lambda *a: None,
                          device="cpu")
    except BaseException:
        stop_modules(procs)
        raise
    ran = wait_modules(procs)
    frozen_dir = cache_of(paths["frozen_cache_dir"], "dips")
    frozen = {name: check_digest(f"frozen {name}", os.path.join(frozen_dir, name), want)
              for name, want in golden["dips_frozen"].items()}
    inference = check_inference(card_dir, cpu_dir, test_dir)
    code = golden["align_receptor"]["code"]
    aligned = os.path.join(root, "aligned.pdb")
    calls = {
        "eval_outputs": ("cli.eval_outputs", ["-input_dir", card_dir, "-ground_truth_dir",
                                              test_dir, "-method", "equidock_tpu"]),
        "align_receptor": ("cli.align_receptor", [
            "-ligand", os.path.join(test_dir, f"{code}_l_b.pdb"),
            "-receptor", os.path.join(test_dir, f"{code}_r_b.pdb"),
            "-receptor_gt", os.path.join(test_dir, f"{code}_r_b_COMPLEX.pdb"), "-out", aligned]),
        "padding_report": ("cli.padding_report", ["-cache_dir", paths["cache_dir"],
                                                  "-dips_dir", paths["dips_sizes_dir"]])}
    for chain in recipe["surface_chains"]:
        for depth in ("sas", "hull"):
            calls[f"{chain}/{depth}"] = ("cli.surface_analysis", [
                "-pdb", os.path.join(REPO, recipe["chain_file"].format(chain)), "-depth", depth])
    tools = wait_modules(start_modules(calls, env, cwd))
    scores = json.loads(tools["eval_outputs"]["stdout"].splitlines()[0])
    require(scores["num_files"] == len(files) // 4
            and all(np.isfinite(v) for v in scores.values()), f"eval_outputs: {scores}")
    said = tools["align_receptor"]["stdout"]
    residual = float(said.split("residual ")[1].split(")")[0])
    require(residual < 0.1, f"align_receptor residual {residual}")
    done("evaluation",
         testset={"files": len(tests), "max_abs_err": max(t["max_abs_err"] for t in tests.values()),
                  "byte_equal": sum(t["byte_equal"] for t in tests.values())},
         dips_frozen=frozen, inference=dict(inference, cli_seconds=ran["inference"]["seconds"]),
         eval_outputs=scores,
         align_receptor=dict(residual=residual, **check_pdb("aligned", aligned,
                                                            golden["align_receptor"])))
    require(json.loads(tools["padding_report"]["stdout"]) == golden["padding_report"],
            "padding_report differs from the JAX package's")
    rho = {}
    for key, want in golden["surface_rhos"].items():
        chain, depth = key.split("/")
        got = surface_analysis.analyze(os.path.join(REPO, recipe["chain_file"].format(chain)),
                                       depth_method=depth)
        printed = [float(line.rsplit("= ", 1)[1]) for line in tools[key]["stdout"].splitlines()
                   if line.startswith("sigma=")]
        err = max(abs(g - w) for g, w in zip(got, want))
        perr = max(abs(g - w) for g, w in zip(printed, want))
        require(len(got) == len(printed) == 5 and err <= RHO_ATOL and perr <= RHO_PRINT_ATOL,
                f"surface {key}: rhos {got} (printed {printed}), JAX {want}")
        rho[key] = dict(max_abs_err=err, printed_max_abs_err=perr, rho_sigma30=got[4])
    done("tools", padding_report="equal to the JAX package's", surface=rho,
         cli_seconds={k: v["seconds"] for k, v in tools.items()}, card=smi)
    # (e) the crop corpus, then the curriculum on it and on (b)'s cache
    c = recipe["crops"]
    crop = run_module("cli.crop_corpus", [
        "-n_pairs", str(c["n_pairs"]), "-n_val_pairs", str(c["n_val_pairs"]), "-max_side",
        str(c["max_side"]), "-crop_seed", str(c["crop_seed"]), "-n_jobs", "4",
        "-dips_sizes_dir", paths["dips_sizes_dir"], "-cache_dir", paths["cache_dir"]], env, cwd)
    crop_dir = cache_of(paths["cache_dir"], "dips")
    crops = {name: check_digest(f"crops {name}", os.path.join(crop_dir, name), want)
             for name, want in golden["crops"].items()}
    n_crops = sum(v["complexes"] for v in crops.values())
    argv = slice9_argv(paths, os.path.join(root, "ckpt", "e"), start) + [
        "-stream_dips", "-num_epochs", "1"]
    stage = lambda data: cli.config_from_args(cli._parser().parse_args(argv + ["-data", data]))
    evals = eval_forwards(stage("dips"), False) + eval_forwards(stage("db5"), False)
    curriculum = run_held("slice9_curriculum", argv, root, paper, layers=LAYERS, evals=evals)
    require(curriculum["epochs"] == 2, f"the curriculum ran {curriculum['epochs']} epochs, "
                                       "not one a stage")
    crop_s = logged_seconds(crop["stdout"], "pairs")
    done("crops", shards=crops, pairs=n_crops, cli_seconds=crop["seconds"], build_seconds=crop_s,
         seconds_a_pair=crop_s / n_crops, curriculum=curriculum, card=smi)
    # (f) the hyper-parameter search: two trials, each a process on the card
    before = build_snapshot()
    hyper_ckpt = os.path.join(root, "hyper_ckpt")
    os.makedirs(os.path.join(root, "hyper"))
    search = run_module("cli.hyper_search", [
        "-num_trials", str(recipe["hyper"]["num_trials"]), "-max_epochs", "1",
        "-random_seed", str(recipe["hyper"]["random_seed"]), "-cache_dir", paths["cache_dir"],
        "-checkpoint_dir", hyper_ckpt], env, os.path.join(root, "hyper"), timeout=900)
    after = build_snapshot()
    require(after == before, "a trial changed the kernels' build directory: "
                             f"{sorted(set(after.items()) ^ set(before.items()))}")
    trials = []
    stem = files[0].split("_")[0]
    for i, want in enumerate(golden["hyper_search"]):
        require(f"=== trial {i} exit=0" in search["stdout"],
                f"hyper-search trial {i} failed:\n{search['stdout'][-3000:]}")
        require(f"trial {i}: {want['banner']}" in search["stdout"],
                f"hyper-search trial {i} is not the JAX package's draw {want['banner']}")
        ckpt = os.path.join(hyper_ckpt, want["banner"], "db5_model_best")
        _, tcfg, _ = load_model(ckpt, dev)
        for field, value in want.items():
            if field != "banner":
                sec, key = field.split(".")
                require(getattr(getattr(tcfg, sec), key) == value,
                        f"trial {i} checkpoint {field}: {getattr(getattr(tcfg, sec), key)}, "
                        f"drawn {value}")
        buf = io.StringIO()
        served = DockingServer.from_checkpoint(ckpt, dev).serve_lines([json.dumps({
            "ligand": os.path.join(test_dir, f"{stem}_l_b.pdb"),
            "receptor": os.path.join(test_dir, f"{stem}_r_b_COMPLEX.pdb"),
            "output": os.path.join(root, f"hyper_{i}.pdb")})], buf)
        reply = json.loads(buf.getvalue())
        require(served == 1 and reply.get("ok") is True, f"trial {i}'s checkpoint: {reply}")
        trials.append(dict(banner=want["banner"], layers=tcfg.model.iegmn_n_lays,
                           dropout=tcfg.model.dropout, request_seconds=reply["seconds"]))
    done("hyper_search", trials=trials, cli_seconds=search["seconds"],
         build_files_unchanged=len(after))
    # (g) profiling
    done("profiling", **run_profiled_steps(dev, paths, start), card=smi)
    # (i) not on the card
    emit("slice9_not_on_the_card",
         note="the DIPS pair-pickle readers (data/dips.py: read_dips_pair, read_dips_pair_tables, "
              "build_dips_cache) and cli.partition_dips need pandas, which this machine lacks: "
              "they run only in the CPU tests (tests/test_torch_dips_build.py, "
              "tests/test_torch_tools.py)")
    return out


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
    # -- native: the host graph builder (slice 5) ---------------------------
    emit("native", **run_native())

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
    s_cases = softmin_cases(dev) + descent_softmin_cases(dev)
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
         softmin_plain_f32_vs_float64={c["shape"]: c["plain_f32"] for c in s_cases
                                       if "plain_f32" in c},
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
        emit("epoch", golden_fit=epoch_golden, db5_sized=epoch_db5)

        # -- models, resident, curriculum: the main paths of slice 6 ---------
        os.makedirs(os.path.join(root, "models"))
        models = run_models(dev, os.path.join(root, "models"))
        emit("models", **models)
        resident = run_resident(dev, os.path.join(root, "db5_sized"),
                                os.path.join(root, "golden"), DB5_SIZED_SPLIT)
        emit("resident", card=smi, **resident)
        curriculum = run_curriculum(dev, os.path.join(root, "db5_sized"))
        emit("curriculum", **curriculum)

        # -- options: the main paths of slice 7 --------------------------------
        options = run_options(dev, os.path.join(root, "db5_sized"), train_golden)
        emit("options", card=smi, **options)

        # -- slice8: the main paths of slice 8 ---------------------------------
        slice8 = run_slice8(dev, os.path.join(root, "slice8"), os.path.join(root, "db5_sized"))

        # -- slice9: the main paths of slice 9 ---------------------------------
        slice9 = run_slice9(dev, os.path.join(root, "slice9"), smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- halo: the main path of slice 4 -----------------------------------------
    halo = run_halo(dev, requests, train_golden)
    emit("halo", **halo)

    # -- inference: the main paths of slice 5 -------------------------------------
    featurize_ms = {"native": [], "numpy": []}
    feat_dir = tempfile.mkdtemp(prefix="equidock_featurize_")
    try:
        for builder in ("native", "numpy", "numpy", "native"):      # in turns
            with numpy_graph_builder() if builder == "numpy" else contextlib.nullcontext():
                featurize_ms[builder] += serve_lines_ms(server, golden, feat_dir)
    finally:
        shutil.rmtree(feat_dir, ignore_errors=True)
    clashes = run_clashes(dev, server)
    batched = run_batched_serving(server, golden)
    root = tempfile.mkdtemp(prefix="equidock_dirs_")
    try:
        directories = run_directories(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("inference", request_ms={k: v for k, v in featurize_ms.items()},
         request_ms_median={k: statistics.median(v) for k, v in featurize_ms.items()},
         request_ms_note="the 4 golden requests through serve_lines, featurized with the "
                         "native builder or its numpy versions, in turns (native, numpy, "
                         "numpy, native)",
         clashes=clashes, batched=batched, directories=directories)

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
    for c in s_cases[:3] + s_cases[-2:]:   # training, ragged, largest; the descent's
        x, a, am = c["args"]
        for name in ("softmin_field", "softmin_field_bwd"):
            bwd = name.endswith("bwd")
            nbytes, flops = softmin_cost(x, a, am, c["c"] if bwd else None)
            b_ms, b_by = bound(nbytes, flops)
            sig = c.get("sigma", SIGMA)
            if bwd:
                kern = lambda: ksf.softmin_field_bwd(x, a, am, c["c"], sig)
                plain = lambda: sf.softmin_field_bwd_plain(x, a, am, c["c"], sig)
            else:
                kern = lambda: ksf.softmin_field_fwd(x, a, am, sig)
                plain = lambda: sf.softmin_field_sums_plain(x, a, am, sig)
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
                   "halo_train": halo["train"]["launches"][name],
                   "clashes_served": clashes["served"]["launches"][name],
                   "clashes_shifted": clashes["shifted"]["launches"][name],
                   "batched_serve": batched["launches"][name],
                   "models": models["launches"][name],
                   "resident": resident["launches"][name],
                   "resident_golden": resident["golden_fit"]["launches"][name],
                   "curriculum": curriculum["launches"][name],
                   "options_packed_epoch": options["packed_epochs"]["packed"][0]["launches"][name],
                   "options_packed_golden": options["packed"]["launches"][name],
                   **{f"options_{n}": options["configs"][n]["launches"][name]
                      for n, _ in OPTION_CONFIGS},
                   "options_fine_tune": options["fine_tune"]["launches"][name],
                   "options_remat": options["remat"]["launches"]["remat"][name],
                   "options_exact_ot": options["exact_ot"]["launches"][name],
                   **{p: directories[p]["launches"][name]
                      for p in ("inference_dir", "batch_inference", "ensemble")},
                   **{f"slice8_{t}_train": slice8["trained_serving"][t]["train_launches"][name]
                      for t in ("bn", "bf16")},
                   **{f"slice8_{t}_serve": slice8["trained_serving"][t]["serve_launches"][name]
                      for t in ("bn", "bf16")},
                   "slice8_bf16_paper_serve": slice8["bf16_serving"]["launches"][name],
                   "slice8_auto_epoch": slice8["auto_buckets"]["launches"][name],
                   "slice8_distill_epoch": slice8["distill"]["launches"][name],
                   **{f"slice8_{n}": r["launches"][name] for n, r in slice8["a5"].items()},
                   "slice9_train": slice9["train"]["launches"][name],
                   "slice9_curriculum": slice9["crops"]["curriculum"]["launches"][name]}
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
