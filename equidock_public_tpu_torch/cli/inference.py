"""Inference CLI: dock every `X_l_b.pdb` of a directory against its
`X_r_b_COMPLEX.pdb`, the port of `equidock_public_tpu/cli/inference.py`.

    python -m equidock_public_tpu_torch.cli.inference -checkpoint W.pt.xz \
        -input_dir IN -ground_truth_dir GT -output_dir OUT \
        [-remove_clashes | -batched -batch_size 5] [-device cuda|cpu]

With -checkpoint (a port weight file), the model's config comes from its
sidecar; the other settings from the flags. `-batched` docks the whole
directory in padded batches and cannot remove clashes.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from ..device import resolve_device
from ..eval.batch_inference import run_batched_inference
from ..eval.inference import run_inference_dir
from ..params import init_params, load_checkpoint
from ._common import add_config_args, config_from_args, refuse_unported


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="EquiDock rigid inference (PyTorch/CUDA port)")
    add_config_args(p)
    p.add_argument("-checkpoint", default="", help="port weight file (.pt.xz)")
    p.add_argument("-input_dir", required=True)
    p.add_argument("-ground_truth_dir", required=True)
    p.add_argument("-output_dir", required=True)
    p.add_argument("-method_name", default="equidock_tpu")
    p.add_argument("-remove_clashes", action="store_true")
    p.add_argument("-batched", action="store_true",
                   help="dock the whole directory in padded batches")
    p.add_argument("-batch_size", type=int, default=5)
    p.add_argument("-device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    refuse_unported(a, training=False)
    if a.batched and a.remove_clashes:
        raise ValueError("-remove_clashes runs per complex; it cannot go with -batched")
    cfg = config_from_args(a)
    dev = resolve_device(a.device)
    if a.checkpoint:
        params, cfg_ckpt = load_checkpoint(a.checkpoint, dev)
        cfg = dataclasses.replace(cfg, model=cfg_ckpt.model)
    else:
        print("WARNING: no checkpoint given - running with random init")
        params = init_params(cfg.model, seed=0, device=dev)
    method = a.method_name + ("_no_clashes" if a.remove_clashes else "")
    if a.batched:
        run_batched_inference(params, cfg, a.input_dir, a.ground_truth_dir, a.output_dir,
                              method_name=method, batch_size=a.batch_size, device=dev)
    else:
        run_inference_dir(params, cfg, a.input_dir, a.ground_truth_dir, a.output_dir,
                          method_name=method, remove_clashes=a.remove_clashes, device=dev)


if __name__ == "__main__":
    main()
