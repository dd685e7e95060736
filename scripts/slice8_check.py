#!/usr/bin/env python3
"""chip_smoke.py's `slice8` phases alone, on one CUDA card, in a fresh
process:

    python3 scripts/slice8_check.py

Builds the kernels, writes epoch (b)'s DB5-sized synthetic split (the
auto-bucket epoch reads it), then runs `run_slice8` with chip_smoke's
gates: trained checkpoints served, the paper model at bf16, the
auto-bucket epoch and rows 1-7 at its bucket, the distilled epoch, and
slices 6-7's paths held step by step to the CPU. One JSON line a part,
then the card's name and power limit. Exit code 1 without a card.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

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

    dev = resolve_device("cuda")
    smi = cs.nvidia_smi_name_power()
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    cs.emit("build", seconds=round(_build.build().seconds, 2))
    root = tempfile.mkdtemp(prefix="equidock_slice8_")
    try:
        cs.write_db5_sized_split(os.path.join(root, "db5_sized"))
        cs.run_slice8(dev, os.path.join(root, "slice8"), os.path.join(root, "db5_sized"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
