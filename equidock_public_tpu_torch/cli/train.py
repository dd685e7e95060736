"""Training CLI: the port of `equidock_public_tpu/cli/train.py`, cut down to
what the port trains (npz caches and DIPS shards on one device).

    python -m equidock_public_tpu_torch.cli.train [-toy] [-max_epochs N] [flags]

The caches are read from `<cache_dir>/<data>_residues_..._pocketCut_<c>/
cv_<split>/` (`Config.cache_path`): `{train,val,test}.npz` for DB5, in the
layout either package writes (`data/dataset.py::write_cache`,
`data/synth.py`), and `<split>_shardNNNN.npz` for DIPS (`data/dips.py`).
With `-max_epochs` or `-max_seconds`, `fit` runs with the flags as given;
without them, the DIPS -> DB5 curriculum runs (`train/loop.py::curriculum`),
or with `-toy` its DB5 stage alone. `-device_resident` (with
`-trim_remainder`) holds the splits on the device; with `-data dips` and
`-stream_dips` the DIPS train split streams group by group. The flags of the
JAX CLI that the port does not honour raise NotImplementedError with their
name. `-device` chooses the device (default the card; `cpu` runs the plain
PyTorch versions).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from ..config import Config
from ..device import resolve_device
from ._common import REFUSED, add_config_args, config_from_args, refuse_unported  # noqa: F401


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train EquiDock (PyTorch/CUDA port)")
    add_config_args(p)
    # the run
    p.add_argument("-toy", action="store_true", help="train on DB5 only")
    p.add_argument("-max_epochs", type=int, default=None)
    p.add_argument("-max_seconds", type=float, default=None)
    p.add_argument("-continue_train_model", default="",
                   help="a checkpoint of the port to resume from; its model config is adopted")
    p.add_argument("-device", default="cuda", help="cuda (default) or cpu")
    return p


def kernel_path_report(cfg: Config, device) -> str:
    """Which of the port's kernels a training step of `cfg` launches."""
    if device.type != "cuda":
        return f"none: the plain PyTorch versions on {device}"
    names = ["edge_message", "edge_message_bwd"]
    if cfg.model.cross_msgs:
        names += ["cross_attention", "cross_attention_dq", "cross_attention_dkv"]
    if cfg.train.use_fused_intersection:
        names += ["softmin_field", "softmin_field_bwd"]
    return f"{len(names)} of 7 CUDA kernels: " + ", ".join(names)


def main(argv: Optional[List[str]] = None) -> int:
    from ..train.checkpoint import load_checkpoint
    from ..train.loop import check_fit_supported, curriculum, fit, make_logger

    a = _parser().parse_args(argv)
    refuse_unported(a)
    cfg = config_from_args(a)
    dev = resolve_device(a.device)
    state = None
    if a.continue_train_model:
        state, cfg_ckpt, epoch = load_checkpoint(a.continue_train_model, dev)
        cfg = dataclasses.replace(cfg, model=cfg_ckpt.model)
        print(f"Continuing from {a.continue_train_model} (epoch {epoch})")
    check_fit_supported(cfg)
    log = make_logger(cfg)
    log("Model name ===> ", cfg.banner())
    log("Kernel paths ===> ", kernel_path_report(cfg, dev))
    if a.max_epochs is not None or a.max_seconds is not None:
        fit(cfg, state=state, max_epochs=a.max_epochs, log=log, max_seconds=a.max_seconds,
            device=dev)
    else:
        curriculum(cfg, toy=a.toy, log=log, state=state, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
