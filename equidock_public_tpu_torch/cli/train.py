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
`-stream_dips` the DIPS train split streams group by group. `-pack` packs
each batch's complexes into shared slots. `-fine_tune_from` starts
two-stage fine-tuning from a checkpoint of the port: its model becomes the
original stage, a 2-layer fine-tune stage is added (`-fine_tune_init
random`, or `copy` of the original stage's matching leaves), and
`-freeze_original` trains the fine-tune stage alone. `-dp` / `-gp` train
on a mesh: under torchrun each of dp gp ranks is a process that steps on
its share of every batch (`train/loop.py::fit`, `parallel/`),

    python -m torch.distributed.run --nproc_per_node N \
        -m equidock_public_tpu_torch.cli.train -dp 2 -gp 1 [flags]

and without a launcher the mesh is stacked in one process. Rank 0 writes
the checkpoints and logs. `-device` chooses the device (default the card,
cuda:(LOCAL_RANK % cards) for a rank; `cpu` runs the plain PyTorch
versions). `-compile_cache` is accepted and changes nothing: the port
compiles nothing at run time but its kernels, once, into `_build/`. The
log's "Kernel paths" line names the kernels a step launches and the path
of each layer part (`models/iegmn.py::kernel_path_report`).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from ..config import Config
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
    p.add_argument("-fine_tune_from", default="",
                   help="a stage-1 checkpoint of the port: its model becomes the original "
                        "stage of a -fine_tune model with a fresh 2-layer fine-tune stage")
    p.add_argument("-freeze_original", action="store_true",
                   help="with -fine_tune_from: train the fine-tune stage alone")
    p.add_argument("-fine_tune_init", default="random", choices=["random", "copy"],
                   help="the fine-tune stage's start: random, or a copy of the stage-1 "
                        "trunk's matching leaves (its ft_att_* leaves stay random)")
    p.add_argument("-device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("-compile_cache", default=None,
                   help="accepted: the port compiles nothing at run time but its CUDA "
                        "kernels, built once into equidock_public_tpu_torch/_build/")
    return p


def kernel_path_report(cfg: Config, device) -> str:
    """Which of the port's kernels a training step of `cfg` launches, then
    the path of each layer part (`models.iegmn.kernel_path_report`)."""
    from ..models.iegmn import fused_edge_eligible, kernel_path_report as model_report

    packed = cfg.data.pack and cfg.data.pack_max_per_slot > 1
    parts = model_report(cfg.model, packed=packed)
    if device.type != "cuda":
        return f"none: the plain PyTorch versions on {device}; " + parts
    names = (["edge_message", "edge_message_bwd"]
             if fused_edge_eligible(cfg.model, train=True) else [])
    if cfg.model.cross_msgs:
        names += ["cross_attention", "cross_attention_dq", "cross_attention_dkv"]
    if cfg.train.use_fused_intersection and not packed:
        names += ["softmin_field", "softmin_field_bwd"]
    elif cfg.train.use_fused_intersection:
        parts += "; intersection: the plain packed loss (as the JAX package's packed loss)"
    return f"{len(names)} of 7 CUDA kernels: " + ", ".join(names) + "; " + parts


def fine_tune_state(path: str, cfg: Config, init: str, device):
    """The train state of two-stage fine-tuning from the port's stage-1
    checkpoint at `path`: its model config with `fine_tune` on (the run's
    kernel-path and numerics flags kept), its parameters as the original
    stage, the fine-tune stage from `init_params` (seeded with
    `random_seed`), with `init == 'copy'` its leaves that the original stage
    has at the same shape replaced by distinct copies of those. Returns
    (state, cfg, stage-1 epoch)."""
    from ..params import flatten, init_params, unflatten
    from ..train.checkpoint import load_checkpoint
    from ..train.step import create_train_state

    stage1, cfg1, epoch = load_checkpoint(path, device)
    model = dataclasses.replace(cfg1.model, fine_tune=True,
                                use_fused_attention=cfg.model.use_fused_attention,
                                factored_edge_mlp=cfg.model.factored_edge_mlp,
                                remat=cfg.model.remat, dtype=cfg.model.dtype)
    cfg = dataclasses.replace(cfg, model=model)
    finetune = flatten(init_params(model, cfg.train.random_seed, device)["finetune"])
    if init == "copy":
        orig = flatten(stage1.params["original"])
        finetune = {k: (orig[k].clone() if k in orig and orig[k].shape == v.shape else v)
                    for k, v in finetune.items()}
    params = {"original": stage1.params["original"], "finetune": unflatten(finetune)}
    return create_train_state(params, cfg, device), cfg, epoch


def main(argv: Optional[List[str]] = None) -> int:
    from ..parallel.dist import init_from_env

    a = _parser().parse_args(argv)
    refuse_unported(a)
    if a.continue_train_model and a.fine_tune_from:
        raise ValueError("-continue_train_model and -fine_tune_from are mutually exclusive")
    world = init_from_env(a.device)        # a world of one without a launcher
    try:
        return _run(a, world)
    finally:
        world.close()


def _run(a: argparse.Namespace, world) -> int:
    from ..train.checkpoint import load_checkpoint
    from ..train.loop import check_fit_supported, curriculum, fit, make_logger

    cfg = config_from_args(a)
    par = cfg.parallel
    if world.size > 1 and world.size != par.dp * par.gp:
        raise ValueError(f"{world.size} ranks for -dp {par.dp} -gp {par.gp}: launch dp x gp "
                         "ranks, or one")
    dev = world.device
    state = None
    if a.fine_tune_from:
        state, cfg, epoch = fine_tune_state(a.fine_tune_from, cfg, a.fine_tune_init, dev)
        print(f"Fine-tuning from {a.fine_tune_from} (stage-1 best epoch {epoch}); original "
              f"stage {'FROZEN' if cfg.train.freeze_original else 'trainable'}")
    if a.continue_train_model:
        state, cfg_ckpt, epoch = load_checkpoint(a.continue_train_model, dev)
        cfg = dataclasses.replace(cfg, model=cfg_ckpt.model)
        print(f"Continuing from {a.continue_train_model} (epoch {epoch})")
    check_fit_supported(cfg)
    log = make_logger(cfg) if world.rank == 0 else (lambda *x: None)
    log("Model name ===> ", cfg.banner())
    log("Kernel paths ===> ", kernel_path_report(cfg, dev))
    if a.compile_cache:
        log(f"-compile_cache {a.compile_cache}: nothing to cache; the port compiles nothing at "
            "run time but its CUDA kernels, built once into equidock_public_tpu_torch/_build/")
    if a.max_epochs is not None or a.max_seconds is not None:
        fit(cfg, state=state, max_epochs=a.max_epochs, log=log, max_seconds=a.max_seconds,
            device=dev, world=world)
    else:
        curriculum(cfg, toy=a.toy, log=log, state=state, device=dev, world=world)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
