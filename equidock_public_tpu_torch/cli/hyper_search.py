"""Random hyper-parameter search, the port of
`equidock_public_tpu/cli/hyper_search.py`: sample a config from the search
distributions (draw for draw the JAX package's under one `-random_seed`),
skip those whose log `<log_dir>/<banner>.txt` exists already (a trial run
before), and train each in a fresh `equidock_public_tpu_torch.cli.train`
process on DB5 (`-toy`).

    python -m equidock_public_tpu_torch.cli.hyper_search [-num_trials N] \
        [-max_epochs E] [-max_seconds S] [-device cuda|cpu] [flags...]

The trials load the kernels' library built for the sources (`_build/`), so
only the first process on a machine compiles. `-in_process` trains the
trials in this process (`train/loop.py::fit`) instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import subprocess
import sys
from typing import List, Optional

from ..config import Config
from ._common import add_config_args, config_from_args, refuse_unported


def sample_config(base: Config, rng: random.Random) -> Config:
    """`base` with the sampled model and training fields, in the JAX
    package's order of draws."""
    model = dataclasses.replace(
        base.model,
        dropout=rng.choices([0.0, 0.25], weights=(0.5, 0.5), k=1)[0],
        iegmn_lay_hid_dim=64, residue_emb_dim=64,
        iegmn_n_lays=rng.choice([5, 8]),
        shared_layers=rng.choice([True, False]),
        skip_weight_h=rng.choice([0.75, 0.5]),
        x_connection_init=rng.choices([0.0, 0.25], weights=(10, 1), k=1)[0],
        cross_msgs=True, use_dist_in_layers=True, use_edge_features_in_gmn=True,
        use_mean_node_features=True, layer_norm="LN", layer_norm_coors="0",
        final_h_layer_norm="0", num_att_heads=50, leakyrelu_neg_slope=0.01)
    train = dataclasses.replace(
        base.train, clip=100.0,
        w_decay=rng.choice([1e-4, 1e-3]),
        intersection_loss_weight=rng.choices([10.0, 1.0], weights=(0.6, 0.6), k=1)[0],
        intersection_sigma=25.0, intersection_surface_ct=10.0,
        pocket_ot_loss_weight=rng.choices([10.0, 1.0], weights=(0.3, 0.3), k=1)[0])
    return dataclasses.replace(base, model=model, train=train)


def _trial_cmd(a: argparse.Namespace, cfg: Config) -> list:
    """The `cli.train` command of one sampled config: a fresh process a
    trial, so no trial's device memory or cached state reaches the next."""
    m, t = cfg.model, cfg.train
    cmd = [sys.executable, "-m", "equidock_public_tpu_torch.cli.train",
           "-dropout", str(m.dropout), "-iegmn_n_lays", str(m.iegmn_n_lays),
           "-skip_weight_h", str(m.skip_weight_h),
           "-x_connection_init", str(m.x_connection_init), "-w_decay", str(t.w_decay),
           "-intersection_loss_weight", str(t.intersection_loss_weight),
           "-pocket_ot_loss_weight", str(t.pocket_ot_loss_weight),
           "-lr", str(t.lr), "-bs", str(t.bs), "-patience", str(t.patience),
           "-random_seed", str(t.random_seed), "-val_repeats", str(t.val_repeats),
           "-data", a.data, "-data_fraction", str(a.data_fraction),
           "-cache_dir", a.cache_dir, "-checkpoint_dir", a.checkpoint_dir,
           "-device", a.device, "-toy"]
    if m.shared_layers:
        cmd.append("-shared_layers")
    if a.node_buckets:
        cmd += ["-node_buckets", a.node_buckets]
    if a.pocket_buckets:
        cmd += ["-pocket_buckets", a.pocket_buckets]
    if a.max_epochs is not None:
        cmd += ["-max_epochs", str(a.max_epochs)]
    if a.max_seconds is not None:
        cmd += ["-max_seconds", str(a.max_seconds)]
    return cmd


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Random hyperparameter search")
    add_config_args(p)
    p.add_argument("-num_trials", type=int, default=5)
    p.add_argument("-max_epochs", type=int, default=None)
    p.add_argument("-max_seconds", type=float, default=None, help="wall-clock budget per trial")
    p.add_argument("-device", default="cuda", help="the trials' device: cuda (default) or cpu")
    p.add_argument("-in_process", action="store_true",
                   help="train the trials in this process instead of a fresh one each")
    a = p.parse_args(argv)
    refuse_unported(a)
    base = config_from_args(a)
    rng = random.Random(a.random_seed)
    for trial in range(a.num_trials):
        cfg = None
        for _ in range(100):
            cand = sample_config(base, rng)
            if not os.path.exists(os.path.join(cand.log_dir, cand.banner() + ".txt")):
                cfg = cand
                break
        if cfg is None:
            print("No hyperparams available !! Exiting ...")
            return 0
        if not a.in_process:
            print(f"=== hyper-search trial {trial}: {cfg.banner()}", flush=True)
            r = subprocess.run(_trial_cmd(a, cfg))
            print(f"=== trial {trial} exit={r.returncode}", flush=True)
            continue
        from ..device import resolve_device
        from ..train.loop import check_fit_supported, fit, make_logger

        check_fit_supported(cfg)
        log = make_logger(cfg)
        log(f"=== hyper-search trial {trial}: {cfg.banner()}")
        fit(cfg, max_epochs=a.max_epochs, log=log, max_seconds=a.max_seconds,
            device=resolve_device(a.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
