"""Offline evaluation CLI, the port of `equidock_public_tpu/cli/eval_outputs.py`:

    python -m equidock_public_tpu_torch.cli.eval_outputs \
        -input_dir <method outputs> -ground_truth_dir <complexes> [-method equidock]

Prints the CRMSD / IRMSD summary (`eval/rmsd.py`) as one JSON line and two
text lines. Host only: numpy, no device.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from ..eval.rmsd import evaluate_output_dir


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="CRMSD/IRMSD evaluator")
    p.add_argument("-input_dir", required=True)
    p.add_argument("-ground_truth_dir", required=True)
    p.add_argument("-method", default="equidock")
    a = p.parse_args(argv)
    r = evaluate_output_dir(a.input_dir, a.ground_truth_dir, a.method)
    print(json.dumps({k: round(float(v), 4) for k, v in r.items()}))
    print(f"complex_rmsd_CA median/mean/std = {r['crmsd_median']:.2f} / "
          f"{r['crmsd_mean']:.2f} +- {r['crmsd_std']:.2f}")
    print(f"interface_rmsd_CA median/mean/std = {r['irmsd_median']:.2f} / "
          f"{r['irmsd_mean']:.2f} +- {r['irmsd_std']:.2f}")


if __name__ == "__main__":
    main()
