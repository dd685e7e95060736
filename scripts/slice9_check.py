#!/usr/bin/env python3
"""chip_smoke.py's `slice9` phase alone, on one CUDA card, in a fresh
process:

    python3 scripts/slice9_check.py

Builds the kernels, then runs `run_slice9` with chip_smoke's gates: a raw
DB5 tree of tracked chains cut in two, the caches, test set, frozen DIPS
shards and crop corpus the port's CLIs build from it (against the JAX
package's digests in assets/slice9.golden.json), full-width training and
the curriculum on them with every step held to the CPU, directory
inference, the hyper-parameter search's trials, a profiled step pair and
the host tools. One JSON line a part, then the card's name and power
limit. Exit code 1 without a card.
"""

from __future__ import annotations

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
    root = tempfile.mkdtemp(prefix="equidock_slice9_")
    try:
        cs.run_slice9(dev, root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cs.emit("done", wall_seconds=round(time.perf_counter() - t0, 1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
