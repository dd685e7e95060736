"""Profiling: the port of `equidock_public_tpu/utils/profiling.py`.

`trace(log_dir)` records `torch.profiler` activity, the CPU's and, where a
card is present, the card's kernels through CUPTI, and writes it as a
Chrome trace `<log_dir>/trace.json`; a card trace that cannot be taken
raises, it is never written CPU-only. `named_scope(name)`
marks a span in it (`torch.profiler.record_function`). `StepTimer` times
steps after a warm-up, with CUDA events where a card is present, so that a
step's kernels lie inside its time.

    with profiling.trace("./profile"):
        with profiling.named_scope("train_step"):
            state, _ = train_step(state, batch, cfg)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = "./profile") -> Iterator:
    """Profile the block; write `<log_dir>/trace.json`. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda and ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        raise RuntimeError("CUDA activity cannot be traced here (CUPTI missing): "
                           "no CPU-only trace is written in its place")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError(f"{path}: the trace holds no CUDA kernel (CUPTI gave no device "
                           "activity)")


named_scope = torch.profiler.record_function


class StepTimer:
    """Times each `with timer:` block after `warmup` blocks are discarded;
    `mean()` is the mean of the kept times in seconds. Where a card is
    present each block is timed with CUDA events on the current stream, so
    its kernels are inside the time (on an idle stream the events read the
    host's time between them); elsewhere by the host clock."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._n = 0
        self._cuda = torch.cuda.is_available()
        self._t0: Optional[float] = None
        self._start = None

    def __enter__(self):
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
