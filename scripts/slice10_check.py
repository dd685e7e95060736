#!/usr/bin/env python3
"""chip_smoke.py's `slice10` phase alone, on one CUDA card, in a fresh
process:

    python3 scripts/slice10_check.py

Builds the kernels, featurizes the served requests and the training
golden's batch, then runs `run_slice10`: 4 rank processes sharing the card
(rows 8-9's peer form, the halo forward, the steps across ranks and a dp-2
resident epoch), then the training CLI under torchrun on 2 ranks. One JSON
line a part, the peer kernels' rows of chip_smoke's kernel line, then the
card's name and power limit. Exit code 1 without a card.
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
    requests = cs.served_requests(train_golden[2], dev)
    root = tempfile.mkdtemp(prefix="equidock_slice10_")
    try:
        slice10 = cs.run_slice10(dev, requests, train_golden, root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"kernels": cs.peer_kernel_rows(slice10)}), flush=True)
    cs.emit("done", wall_seconds=round(time.perf_counter() - t0, 1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
