"""Rigid-ensemble inference CLI, the port of
`equidock_public_tpu/cli/ensemble_inference.py`:

    python -m equidock_public_tpu_torch.cli.ensemble_inference \
        -checkpoints A.pt.xz,B.pt.xz -input_dir IN -ground_truth_dir GT \
        -output_dir OUT [-weights 0.5,0.5] [-device cuda|cpu]

A member is a port weight file or a port training checkpoint.
Averages the members' predicted rigid motions (`eval/ensemble.py`); score
the output directory with `cli.eval_outputs`.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..device import resolve_device
from ..eval.ensemble import Member, run_ensemble_dir
from ._common import add_config_args, config_from_args, refuse_unported


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="EquiDock rigid-ensemble inference "
                                            "(PyTorch/CUDA port)")
    add_config_args(p)
    p.add_argument("-checkpoints", required=True,
                   help="comma-separated port weight files (.pt.xz with sidecars) or "
                        "training checkpoints")
    p.add_argument("-input_dir", required=True)
    p.add_argument("-ground_truth_dir", required=True)
    p.add_argument("-output_dir", required=True)
    p.add_argument("-method_name", default="equidock_tpu_ens")
    p.add_argument("-weights", default="",
                   help="comma-separated member weights (default uniform); "
                        "select on VAL, never on test")
    p.add_argument("-device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    refuse_unported(a, training=False)
    base_cfg = config_from_args(a)
    dev = resolve_device(a.device)
    members = [Member(c.strip(), base_cfg, dev) for c in a.checkpoints.split(",") if c.strip()]
    weights = [float(x) for x in a.weights.split(",")] if a.weights else None
    if weights is not None and len(weights) != len(members):
        raise ValueError(f"{len(weights)} weights for {len(members)} members")
    print(f"ensemble of {len(members)} members (weights {weights}):")
    for m in members:
        print(f"  {m.name}")
    run_ensemble_dir(members, a.input_dir, a.ground_truth_dir, a.output_dir,
                     method_name=a.method_name, weights=weights)


if __name__ == "__main__":
    main()
