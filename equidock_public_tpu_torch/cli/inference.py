"""Inference CLI: dock every `X_l_b.pdb` of a directory against its
`X_r_b_COMPLEX.pdb`, the port of `equidock_public_tpu/cli/inference.py`.

    python -m equidock_public_tpu_torch.cli.inference -checkpoint W.pt.xz \
        -input_dir IN -ground_truth_dir GT -output_dir OUT \
        [-remove_clashes | -batched -batch_size 5] [-device cuda|cpu]

With -checkpoint (a port weight file or a port training checkpoint,
`params.load_model`), the model's config comes from its sidecar, and a 'BN'
model runs with the checkpoint's running statistics; the other settings
come from the flags. `-node_buckets auto[:G]` derives the ladder from the
sizes of the directory's complexes (`input_ladder`). `-batched` docks the
whole directory in padded batches and cannot remove clashes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence, Tuple

from ..config import auto_node_buckets
from ..data.featurize import filter_residues
from ..data.pdb import group_residues, read_pdb
from ..device import resolve_device
from ..eval.batch_inference import run_batched_inference
from ..eval.inference import run_inference_dir
from ..models.iegmn import init_bn_state, uses_batch_norm
from ..params import init_params, load_model
from ._common import add_config_args, config_from_args, refuse_unported


def input_ladder(input_dir: str, ground_truth_dir: str, max_groups: int) -> Tuple[int, ...]:
    """The node-bucket ladder of `-node_buckets auto:G` at inference, as the
    JAX CLI derives it: `auto_node_buckets` of the residue counts of every
    ligand `X_l_b.pdb` of `input_dir` and its receptor
    `ground_truth_dir/X_r_b_COMPLEX.pdb` (where it exists), in file order."""
    sizes = []
    for f in sorted(os.listdir(input_dir)):
        if not f.endswith("_l_b.pdb"):
            continue
        rec = os.path.join(ground_truth_dir, f"{f[:-len('_l_b.pdb')]}_r_b_COMPLEX.pdb")
        for path in (os.path.join(input_dir, f), rec):
            if os.path.exists(path):
                sizes.append(len(filter_residues(group_residues(read_pdb(path)))))
    return auto_node_buckets(sizes, max_groups)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="EquiDock rigid inference (PyTorch/CUDA port)")
    add_config_args(p)
    p.add_argument("-checkpoint", default="",
                   help="port weight file (.pt.xz) or port training checkpoint")
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
        params, cfg_ckpt, bn_state = load_model(a.checkpoint, dev)
        cfg = dataclasses.replace(cfg, model=cfg_ckpt.model)
    else:
        print("WARNING: no checkpoint given - running with random init")
        params = init_params(cfg.model, seed=0, device=dev)
        bn_state = init_bn_state(cfg.model, device=dev) if uses_batch_norm(cfg.model) else None
    if cfg.data.auto_buckets_max:
        ladder = input_ladder(a.input_dir, a.ground_truth_dir, cfg.data.auto_buckets_max)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, node_buckets=ladder, auto_buckets_max=0))
        print(f"auto node buckets ({len(ladder)} steps): {ladder}")
    method = a.method_name + ("_no_clashes" if a.remove_clashes else "")
    if a.batched:
        run_batched_inference(params, cfg, a.input_dir, a.ground_truth_dir, a.output_dir,
                              method_name=method, batch_size=a.batch_size, device=dev,
                              bn_state=bn_state)
    else:
        run_inference_dir(params, cfg, a.input_dir, a.ground_truth_dir, a.output_dir,
                          method_name=method, remove_clashes=a.remove_clashes, device=dev,
                          bn_state=bn_state)


if __name__ == "__main__":
    main()
