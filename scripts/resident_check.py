#!/usr/bin/env python3
"""chip_smoke.py's `models`, `resident` and `curriculum` phases alone, on
one CUDA card, in a fresh process:

    python3 scripts/resident_check.py [models] [resident] [curriculum]

Builds the kernels, writes the caches those phases read (epoch (b)'s
DB5-sized synthetic split, 152 / 25 / 25 pairs of the tracked chains'
sizes; epoch (a)'s tracked chains cut in two), then runs the phases named
(all three by default) with chip_smoke's gates: the six other models'
served requests; the training CLI with -device_resident -trim_remainder in
turns with the host loop, a profiled resident epoch and the resident fit
golden with replayed draws; the DIPS -> DB5 curriculum on streamed
synthetic DIPS shards. One JSON line a phase, then the card's name and
power limit. Faster to iterate on than the whole smoke run, and a fresh
process: the late phases of chip_smoke.py run on a host that has done
minutes of other work.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

PHASES = ("models", "resident", "curriculum")


def write_caches(root: str) -> None:
    """Epoch (b)'s synthetic split under root/db5_sized, epoch (a)'s split
    chains under root/golden (the caches chip_smoke's epoch phase writes)."""
    from equidock_public_tpu_torch.cli import train as cli
    from equidock_public_tpu_torch.data.dataset import write_cache
    from equidock_public_tpu_torch.data.synth import write_synth_split
    from equidock_public_tpu_torch.params import default_checkpoint, load_checkpoint

    db = os.path.join(root, "db5_sized")
    cfg = cli.config_from_args(cli._parser().parse_args(cs.db5_sized_argv(db)))
    sizes, start = cs.db5_sized_sizes(sum(cs.DB5_SIZED_SPLIT.values())), 0
    for i, (split, n) in enumerate(cs.DB5_SIZED_SPLIT.items()):
        write_synth_split(os.path.join(cfg.cache_path(), f"{split}.npz"),
                          sizes[start:start + n], seed=i, k=cfg.graph.graph_max_neighbor)
        start += n
    _, gcfg = load_checkpoint(default_checkpoint())
    gcfg = dataclasses.replace(gcfg, data=dataclasses.replace(
        gcfg.data, cache_dir=os.path.join(root, "golden", "cache")))
    for split, codes in cs.load_asset("db5_resident_fit.golden.json")["partition"].items():
        write_cache(os.path.join(gcfg.cache_path(), f"{split}.npz"), codes,
                    cs.split_chain_samples(codes, gcfg.graph))


def main(argv) -> int:
    which = argv or list(PHASES)
    unknown = sorted(set(which) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; choose from {PHASES}")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from equidock_public_tpu_torch.device import resolve_device
    from equidock_public_tpu_torch.ops.cuda import _build

    dev = resolve_device("cuda")
    smi = cs.nvidia_smi_name_power()
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    cs.emit("build", seconds=round(_build.build().seconds, 2))
    root = tempfile.mkdtemp(prefix="equidock_resident_")
    try:
        write_caches(root)
        if "models" in which:
            os.makedirs(os.path.join(root, "models"))
            cs.emit("models", **cs.run_models(dev, os.path.join(root, "models")))
        if "resident" in which:
            cs.emit("resident", card=smi, **cs.run_resident(
                dev, os.path.join(root, "db5_sized"), os.path.join(root, "golden"),
                cs.DB5_SIZED_SPLIT))
        if "curriculum" in which:
            cs.emit("curriculum", **cs.run_curriculum(dev, os.path.join(root, "db5_sized")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
