"""Epoch runner and early stopping: the port of `prefetch_to_device`,
`run_train_epoch`, `run_eval_epoch`, `selection_value`, `fit` (with its
device-resident branch, `train/resident.py`, and its resolution of auto
buckets, `resolve_auto_buckets`) and `curriculum` of
`equidock_public_tpu/train/loop.py`, single device.

The random streams are the JAX package's: `fit` seeds one numpy generator
with `cfg.train.random_seed`; the train epoch's batches draw from it on the
prefetch thread, the choice of metered train batches from a generator of
its own (`(seed, 7919, epoch)`), and the val and test epochs draw their
poses from it on the calling thread after the train epoch has finished
with it. So both packages see the same batches in the same order. With
`device_resident` the numpy generator orders the bucket groups and their
schedules as in the JAX package, and the swaps and poses are drawn on the
device from a generator per purpose and epoch (`resident.draws_factory`),
or replayed from a source that `fit`'s `draws` argument gives.

Scalars go to the text log (`<log_dir>/<banner>.txt`, and stdout) and, one
JSON object per epoch, to `<log_dir>/<banner>.scalars.jsonl`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import queue
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..config import Config, auto_node_buckets
from ..data.dataset import DockingDataset
from ..device import resolve_device
from ..graph import PairBatch, batch_to
from ..models.iegmn import check_supported
from ..params import flatten, init_params
from .checkpoint import load_checkpoint, save_checkpoint
from .meter import RmsdMeter
from .optim import ReduceOnPlateau, epoch_lr_factor
from .resident import (StreamedResidentSplit, build_resident_split, draws_factory,
                       run_eval_epoch_resident, run_train_epoch_resident,
                       run_train_epoch_resident_streamed)
from .step import TrainState, create_train_state, eval_step, make_dropout, train_step

LOSS_KEYS = ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss")


def prefetch_to_device(batches: Iterable[PairBatch], device, size: int = 2
                       ) -> Iterator[PairBatch]:
    """Run `batches` (the collate) on a host thread, `size` batches ahead,
    and yield each on `device`. For the card the thread collates into pinned
    memory and the copy to the card is issued here, on the consuming
    thread's current stream, asynchronously: the step that uses the batch
    runs after the copy on that same stream, so no event is needed, and the
    pinned buffers stay owned by PyTorch's host allocator until the copy is
    done. An exception on the thread is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()

    def producer():
        try:
            for item in batches:
                q.put(item)
        except Exception as e:              # handed to the consumer
            q.put(e)
        finally:
            q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, Exception):
            raise item
        yield batch_to(item, device, non_blocking=True) if device.type == "cuda" else item


def host_rss_gb() -> float:
    """The process's resident set size in GB (0.0 where /proc is absent)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def make_logger(cfg: Config) -> Callable:
    """A log function that prints each line with a time stamp and appends it
    to `<log_dir>/<banner>.txt`."""
    os.makedirs(cfg.log_dir, exist_ok=True)
    path = os.path.join(cfg.log_dir, cfg.banner() + ".txt")

    def log(*args):
        line = "[{}] {}".format(time.strftime("%Y-%m-%d %H:%M:%S"),
                                " ".join(str(a) for a in args))
        print(line, flush=True)
        with open(path, "a+") as f:
            f.write(line + "\n")

    return log


def _batches(ds: DockingDataset, rng, device, shuffle: bool):
    """The split's batches on `device`: through the prefetch thread and pinned
    memory for training, directly for evaluation (as the JAX package)."""
    if shuffle:
        host = "cpu" if device.type == "cuda" else device
        return prefetch_to_device(ds.batches(rng, device=host, shuffle=True,
                                             pin_memory=device.type == "cuda"), device)
    return ds.batches(rng, device=device, shuffle=False)


def run_train_epoch(state: TrainState, ds: DockingDataset, cfg: Config,
                    rng: np.random.Generator, epoch: int, log=print,
                    lr_scale: float = 1.0, drop=None):
    """One training epoch. Returns (state, averages): the loss terms over
    the batches, the complex-RMSD median and mean of the metered batches
    (the first, and each further one with probability
    `train_rmsd_fraction`), num_clips and num_batches. Dropout above 0
    draws from `drop`, by default a generator of the epoch
    (`step.make_dropout`)."""
    dev = next(iter(flatten(state.params).values())).device
    drop = drop if drop is not None else make_dropout(cfg, dev, epoch)
    meter_rng = np.random.default_rng((cfg.train.random_seed, 7919, epoch))
    meter = RmsdMeter()
    sums: Dict[str, torch.Tensor] = {}
    clips = []
    num_batches = 0
    for batch in _batches(ds, rng, dev, shuffle=True):
        state, metrics = train_step(state, batch, cfg, lr_scale, drop=drop)
        num_batches += 1
        for k in LOSS_KEYS:           # summed in float64 on the device: no sync a step
            sums[k] = sums.get(k, 0.0) + metrics[k].double()
        clips.append(metrics["clipped"])
        sampled = meter_rng.uniform() < cfg.train.train_rmsd_fraction
        if num_batches == 1 or sampled:
            meter.update_batch(batch, metrics["ligand_coords"].cpu().numpy())
    avg = {k: float(v) / max(num_batches, 1) for k, v in sums.items()}
    _, _, crmsd_median = meter.summarize("median")
    _, _, crmsd_mean = meter.summarize("mean")
    avg.update(complex_rmsd_median=crmsd_median, complex_rmsd_mean=crmsd_mean,
               num_clips=int(torch.stack(clips).sum()) if clips else 0,
               num_batches=num_batches)
    # the watchdog of parameters whose norm passed 500, once an epoch
    flat = flatten(state.params)
    norms = torch.stack([v.norm() for v in flat.values()]).cpu().tolist()
    for key, norm in zip(flat, norms):
        if norm > 500.0:
            log(f"    PARAM {key} --> norm = {norm:.1f}")
    return state, avg


def run_eval_epoch(params, ds: DockingDataset, cfg: Config,
                   rng: np.random.Generator, bn_state: Optional[dict] = None
                   ) -> Dict[str, float]:
    """One evaluation epoch: no shuffle and no swap, but a fresh random pose
    per complex from `rng`, so the metric is noisy (`val_repeats` averages
    it). Loss terms, and ligand, complex and interface RMSD medians and
    means. BatchNorm normalises by the running statistics `bn_state`."""
    dev = next(iter(flatten(params).values())).device
    meter = RmsdMeter()
    sums: Dict[str, torch.Tensor] = {}
    num_batches = 0
    for batch in _batches(ds, rng, dev, shuffle=False):
        out = eval_step(params, batch, cfg, bn_state)
        num_batches += 1
        for k in LOSS_KEYS:
            sums[k] = sums.get(k, 0.0) + out[k].double()
        meter.update_batch(batch, out["ligand_coords"].cpu().numpy(), meter_interface=True)
    avg = {k: float(v) / max(num_batches, 1) for k, v in sums.items()}
    lig_med, _, crmsd_median = meter.summarize("median")
    lig_mean, _, crmsd_mean = meter.summarize("mean")
    avg.update(complex_rmsd_median=crmsd_median, complex_rmsd_mean=crmsd_mean,
               ligand_rmsd_median=lig_med, ligand_rmsd_mean=lig_mean,
               interface_rmsd_median=meter.summarize_interface("median"),
               interface_rmsd_mean=meter.summarize_interface("mean"))
    return avg


def selection_value(va: Dict[str, float], metric: str) -> float:
    """The value early stopping minimises: the val complex-RMSD median
    ('crmsd'), the interface one ('irmsd'), their sum ('sum'), or the worse
    of the two margins over the bar of 14.2 / 12.1 A ('bar')."""
    if metric == "crmsd":
        return va["complex_rmsd_median"]
    if metric == "irmsd":
        return va["interface_rmsd_median"]
    if metric == "sum":
        return va["complex_rmsd_median"] + va["interface_rmsd_median"]
    if metric == "bar":
        return max(va["complex_rmsd_median"] - 14.2, va["interface_rmsd_median"] - 12.1)
    raise ValueError(f"unknown select_metric {metric!r}")


def check_fit_supported(cfg: Config) -> None:
    """Raise NotImplementedError naming every loop option outside the port
    (and, through `models.iegmn.check_supported`, every model option)."""
    check_supported(cfg.model)
    dc = cfg.data
    if dc.pack and cfg.model.final_h_layer_norm == "GN":
        raise ValueError("-pack with final_h_layer_norm='GN': GraphNorm normalizes per graph "
                         "and is not segment-aware; train packed batches with 'LN'/'0'")
    if dc.pack and dc.device_resident:
        raise NotImplementedError("training option not ported: -pack with -device_resident "
                                  "(the resident store is unpacked)")


def resolve_auto_buckets(cfg: Config, datasets, log) -> Config:
    """`cfg` with the ladders of `auto_buckets_max` / `auto_pocket_max`
    resolved from every complex of `datasets`, as the JAX package's `fit`
    does: node buckets from each pair's larger side (align 64), pocket
    buckets from the pocket sizes (align 32, quad_at 256); the auto fields
    set back to 0 and each dataset given the resolved config."""
    dc = cfg.data
    if not (dc.auto_buckets_max or dc.auto_pocket_max):
        return cfg
    repl = {"auto_buckets_max": 0, "auto_pocket_max": 0}
    if dc.auto_buckets_max:
        sizes = [ds.pair_max_nodes(i) for ds in datasets for i in range(len(ds.codes))]
        repl["node_buckets"] = auto_node_buckets(sizes, dc.auto_buckets_max)
        log(f"auto node buckets ({len(repl['node_buckets'])} steps): {repl['node_buckets']}")
    if dc.auto_pocket_max:
        psizes = [ds.pocket_size(i) for ds in datasets for i in range(len(ds.codes))]
        repl["pocket_buckets"] = auto_node_buckets(psizes, dc.auto_pocket_max, align=32,
                                                   quad_at=256)
        log(f"auto pocket buckets ({len(repl['pocket_buckets'])} steps): "
            f"{repl['pocket_buckets']}")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(dc, **repl))
    for ds in datasets:
        ds.cfg = cfg
    return cfg


def _json_scalars(d: dict) -> dict:
    return {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
            for k, v in d.items()}


def fit(cfg: Config, state: Optional[TrainState] = None, max_epochs: Optional[int] = None,
        log=None, checkpoint_name: Optional[str] = None,
        max_seconds: Optional[float] = None, device=None,
        history: Optional[List[dict]] = None, draws=None) -> TrainState:
    """Train on the cached train split with early stopping on the val
    selection metric (a new best must beat the old by 2% of its size, sign
    safe), `patience` epochs, the epoch LR factor (cyclic or
    ReduceOnPlateau), periodic and best checkpoints under
    `<checkpoint_dir>/<banner>/`, then the best checkpoint reloaded for the
    test split. A fresh state starts from `init_params` seeded with
    `random_seed`. `history`, if given, gets one dict per epoch (train and
    val averages, seconds, the best epoch so far) and a last one with the
    test averages. With `device_resident` the splits live on the device
    (`train/resident.py`; the train split streamed group by group for
    `data='dips'` with `stream_dips`), and `draws`, if given, maps
    (purpose, epoch) to the draw source of that epoch's train ('train'),
    val ('val') or test ('test') pass."""
    check_fit_supported(cfg)
    dev = resolve_device(device)
    log = log or make_logger(cfg)
    tc = cfg.train
    rng = np.random.default_rng(tc.random_seed)

    train_ds = DockingDataset.from_cache(cfg, "train")
    val_ds = DockingDataset.from_cache(cfg, "val", swap=False)
    test_ds = DockingDataset.from_cache(cfg, "test", swap=False)
    log(f"Train:{len(train_ds)} Valid:{len(val_ds)} Test:{len(test_ds)}")
    cfg = resolve_auto_buckets(cfg, (train_ds, val_ds, test_ds), log)
    if state is None:
        state = create_train_state(init_params(cfg.model, tc.random_seed, dev), cfg, dev)
        log(f"Number of parameters = {sum(v.numel() for v in state.mu.values()):,}")

    resident = _resident_splits(cfg, (train_ds, val_ds, test_ds), dev, log)
    if resident is not None and draws is None:
        draws = draws_factory(cfg, dev)

    ckpt_dir = os.path.join(cfg.checkpoint_dir, cfg.banner())
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt_path = os.path.join(ckpt_dir, checkpoint_name or (cfg.data.data + "_model_best"))
    os.makedirs(cfg.log_dir, exist_ok=True)
    scalars_path = os.path.join(cfg.log_dir, cfg.banner() + ".scalars.jsonl")

    best_val, best_epoch = float("inf"), -1
    patience_left = tc.patience
    epochs = max_epochs if max_epochs is not None else tc.num_epochs
    plateau = ReduceOnPlateau(factor=0.5, patience=100) if tc.scheduler == "ROP" else None
    t_start = time.time()
    for epoch in range(epochs):
        if max_seconds is not None and time.time() - t_start > max_seconds:
            log(f"Wall-clock budget ({max_seconds}s) reached at epoch {epoch}.")
            break
        t0 = time.perf_counter()
        lr_scale = epoch_lr_factor(tc, epoch, plateau)
        if resident is not None:
            runner = (run_train_epoch_resident_streamed
                      if isinstance(resident["train"], StreamedResidentSplit)
                      else run_train_epoch_resident)
            state, tr = runner(state, resident["train"], cfg, rng, draws("train", epoch), epoch,
                               log, lr_scale=lr_scale, do_swap=train_ds.swap)
            t1 = time.perf_counter()
            va = run_eval_epoch_resident(state.params, resident["val"], cfg,
                                         draws("val", epoch), repeats=max(tc.val_repeats, 1),
                                         bn_state=state.bn_state)
        else:
            state, tr = run_train_epoch(state, train_ds, cfg, rng, epoch, log,
                                        lr_scale=lr_scale)
            t1 = time.perf_counter()
            reps = [run_eval_epoch(state.params, val_ds, cfg, rng, state.bn_state)
                    for _ in range(max(tc.val_repeats, 1))]
            va = {k: float(np.mean([r[k] for r in reps])) for k in reps[0]}
        t2 = time.perf_counter()
        if plateau is not None:
            new_scale = plateau.step(va["loss"])
            if new_scale != lr_scale:
                log(f"  ReduceLROnPlateau: lr factor -> {new_scale}")
        log(f"[TRAIN] epoch {epoch} loss {tr['loss']:.4f} "
            f"lig {tr['ligand_coors_loss']:.4f} ot {tr['ot_loss']:.4f} "
            f"int {tr['intersection_loss']:.4f} "
            f"crmsd med {tr['complex_rmsd_median']:.4f} "
            f"clips {tr['num_clips']}/{tr['num_batches']}")
        rss = host_rss_gb()
        log(f"[VAL]   epoch {epoch} loss {va['loss']:.4f} "
            f"crmsd med {va['complex_rmsd_median']:.4f} "
            f"mean {va['complex_rmsd_mean']:.4f} "
            f"irmsd med {va['interface_rmsd_median']:.4f} "
            f"time {t2 - t0:.1f}s rss {rss:.1f}G")

        ckpt_s = 0.0
        if tc.save_every_epochs and (epoch + 1) % tc.save_every_epochs == 0:
            t = time.perf_counter()
            save_checkpoint(ckpt_path + "_latest", state, cfg, epoch)
            ckpt_s += time.perf_counter() - t
        sel = selection_value(va, tc.select_metric)
        threshold = best_val * 0.98 if best_val >= 0 else best_val * 1.02
        if sel < threshold:
            best_val, best_epoch = sel, epoch
            patience_left = tc.patience
            t = time.perf_counter()
            save_checkpoint(ckpt_path, state, cfg, epoch)
            ckpt_s += time.perf_counter() - t
            log(f"  saved best checkpoint (val {tc.select_metric} {best_val:.4f})")
        else:
            patience_left -= 1
        log(f"[BEST] epoch {best_epoch} val {tc.select_metric} {best_val:.4f} "
            f"patience left {patience_left}")
        record = {"epoch": epoch, "lr_scale": lr_scale, "train": _json_scalars(tr),
                  "val": _json_scalars(va), "train_seconds": t1 - t0,
                  "val_seconds": t2 - t1, "checkpoint_seconds": ckpt_s,
                  "best_epoch": best_epoch, "rss_gb": rss}
        if resident is not None:
            record["resident_mb"] = resident["mb"]
        with open(scalars_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if history is not None:
            history.append(record)
        if patience_left <= 0:
            log("Early stopping.")
            break

    if os.path.exists(ckpt_path):
        state, _, _ = load_checkpoint(ckpt_path, dev)
    if resident is not None:
        te = run_eval_epoch_resident(state.params, resident["test"], cfg, draws("test", 0),
                                     bn_state=state.bn_state)
    else:
        te = run_eval_epoch(state.params, test_ds, cfg, rng, state.bn_state)
    log(f"[FINAL TEST {cfg.data.data}] crmsd med {te['complex_rmsd_median']:.4f} "
        f"mean {te['complex_rmsd_mean']:.4f} loss {te['loss']:.4f}")
    if history is not None:
        history.append({"test": _json_scalars(te), "best_epoch": best_epoch})
    return state


def _resident_splits(cfg: Config, datasets, dev, log) -> Optional[dict]:
    """With `device_resident`: {"train", "val", "test": the resident splits
    (the train split a `StreamedResidentSplit` for streamed DIPS), "mb":
    the stores' MB on the device}; else None."""
    if not cfg.data.device_resident:
        return None
    train_ds, val_ds, test_ds = datasets
    streamed = cfg.data.data == "dips" and cfg.data.stream_dips
    if streamed:
        train = StreamedResidentSplit.build(train_ds, cfg)
        log("streamed-resident epochs: groups uploaded per epoch (prefetch 1), "
            f"{len(train.by_bucket)} bucket groups")
    else:
        train = build_resident_split(train_ds, cfg, dev)
    out = {"train": train, "val": build_resident_split(val_ds, cfg, dev),
           "test": build_resident_split(test_ds, cfg, dev)}
    n_bytes = sum(rs.nbytes() for rs in out.values() if not isinstance(rs, StreamedResidentSplit))
    groups = {k: sorted(getattr(rs, "groups", None) or rs.by_bucket) for k, rs in out.items()}
    out["mb"] = n_bytes / 1e6
    log(f"device-resident epochs: {n_bytes / 1e6:.1f} MB on {dev}"
        + (" (train streams per epoch)" if streamed else "") + f", groups/split = {groups}")
    return out


def curriculum(cfg: Config, toy: bool = False, log=None, state: Optional[TrainState] = None,
               device=None, history: Optional[List[dict]] = None) -> TrainState:
    """The DIPS -> DB5 curriculum: `fit` on DIPS (lr 2e-4, patience 100),
    then on DB5 from the DIPS stage's best state (lr 1e-4, patience 500);
    `toy` runs the DB5 stage only. `history`, if given, gets each stage's
    records (`fit`'s) after a {"stage": name} record."""
    log = log or make_logger(cfg)
    stages = ([] if toy else [("dips", 2e-4, 100)]) + [("db5", 1e-4, 500)]
    for data, lr, patience in stages:
        stage_cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, data=data),
            train=dataclasses.replace(cfg.train, lr=lr, patience=patience))
        if history is not None:
            history.append({"stage": data})
        state = fit(stage_cfg, state, log=log, device=device, history=history)
    return state
