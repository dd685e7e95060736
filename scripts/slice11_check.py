#!/usr/bin/env python3
"""chip_smoke.py's `slice11` phase alone, on one CUDA card, in a fresh
process:

    python3 scripts/slice11_check.py

Builds the kernels, featurizes the training golden's batch, then runs
`run_slice11`: 4 rank processes sharing the card ('BN' and dropout models'
dp-2 and dp-2 x gp-2 steps, a swish / coordinate-LN model's halo forward
and step, a packed halo step), each step held to the CPU's one-process
dense step from the same state at `SLICE11_GATES`; remat at full width in
this process; then the training CLI under torchrun at -gp 2 with a
fine-tune stage. One JSON line a
part, the phase's launches of rows 1-9 by path, then the card's name and
power limit. Exit code 1 without a card.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from equidock_public_tpu_torch.device import resolve_device
    from equidock_public_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    dev = resolve_device("cuda")
    smi = cs.nvidia_smi_name_power()
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    cs.emit("build", seconds=round(_build.build().seconds, 2))
    train_golden = cs.training_golden(dev)
    root = tempfile.mkdtemp(prefix="equidock_slice11_")
    try:
        slice11 = cs.run_slice11(dev, train_golden, root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"launches": slice11["launches"]}), flush=True)
    cs.emit("done", wall_seconds=round(time.perf_counter() - t0, 1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
