"""Training checkpoints in the port's own format: the port of
`equidock_public_tpu/train/checkpoint.py` (`save_checkpoint`,
`load_checkpoint`), which writes orbax directories that the card's machine
cannot read.

A checkpoint is one `torch.save` file at `path` holding the parameters and
the Adam moments (flat `{key: f32 tensor}` dicts under the JAX package's
keys), the BatchNorm running statistics (flat `{"<site>/mean": tensor}`,
empty unless an option is 'BN'), the optimizer step and the epoch, and beside it a
`<path>.config.json` sidecar of the whole config (model, graph, data,
train, directories), so a run resumes with the settings it was started
with. Resume rule: a step from a loaded state equals, bit for bit, the step
from the state that was saved (the tensors are stored exactly, and the step
count carries the bias correction and the schedule).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from ..config import Config, config_from_dict
from ..device import resolve_device
from ..params import bn_state_from_flat, flatten, params_from_flat
from .step import TrainState

FORMAT = "equidock_public_tpu_torch/train_state/1"


def sidecar_path(path: str) -> str:
    return path + ".config.json"


def _write_atomic(path: str, write) -> None:
    """Write through a temporary name and rename it into place, so a run
    stopped mid-write leaves the previous file whole."""
    tmp = f"{path}.tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState, cfg: Config, epoch: int) -> None:
    """Write `state`, `epoch` and the whole `cfg` (replacing what was there)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    host = lambda d: {k: v.detach().cpu().contiguous() for k, v in d.items()}
    payload = {"format": FORMAT, "params": host(flatten(state.params)),
               "mu": host(state.mu), "nu": host(state.nu), "step": int(state.step),
               "bn_state": host(flatten(state.bn_state)),
               "epoch": int(epoch)}
    _write_atomic(path, lambda p: torch.save(payload, p))

    def write_config(p):
        with open(p, "w") as f:
            json.dump(dataclasses.asdict(cfg), f)

    _write_atomic(sidecar_path(path), write_config)


def load_checkpoint(path: str, device: Optional[str] = None
                    ) -> Tuple[TrainState, Config, int]:
    """(state on `device` (the card unless asked otherwise), config from the
    sidecar, epoch). Keys and shapes are checked against the config."""
    path = os.path.abspath(path)
    dev = resolve_device(device)
    with open(sidecar_path(path)) as f:
        cfg = config_from_dict(json.load(f))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of the port's format {FORMAT}")
    moments = [flatten(params_from_flat(payload[k], cfg.model, dev)) for k in ("mu", "nu")]
    state = TrainState(params=params_from_flat(payload["params"], cfg.model, dev),
                       mu=moments[0], nu=moments[1], step=int(payload["step"]),
                       bn_state=bn_state_from_flat(payload.get("bn_state", {}), cfg.model, dev))
    return state, cfg, int(payload["epoch"])
