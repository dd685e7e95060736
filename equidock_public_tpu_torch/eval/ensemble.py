"""Rigid-ensemble inference: the port of `equidock_public_tpu/eval/ensemble.py`.

EquiDock's answer for a complex is one rigid motion (R, t) of the unbound
ligand, so the members of an ensemble are averaged in pose space:
  * rotation: the chordal mean, the SO(3) projection of sum_i w_i R_i (SVD
    with the determinant's sign corrected);
  * translation: the ligand's CA centroid c goes to the weighted mean of
    the members' placements, t* = sum_i w_i (R_i c + t_i) - R* c.
Members are the port's weight files (`<stem>.pt.xz` with its
`<stem>.config.json`) or training checkpoints (`params.load_model`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..data.pdb import write_pdb
from ..device import resolve_device
from ..params import load_model
from .inference import (Featurized, collate_pairs, complex_stems, featurize_pair,
                        make_forward, output_name)


def chordal_mean_rotation(Rs: Sequence[np.ndarray],
                          weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """The SO(3) projection of sum_i w_i R_i (the chordal mean), float32."""
    Rs = np.asarray(Rs, dtype=np.float64)
    if weights is not None:
        Rs = Rs * np.asarray(weights, np.float64)[:, None, None]
    U, _, Vt = np.linalg.svd(np.sum(Rs, axis=0))
    d = np.sign(np.linalg.det(U @ Vt))
    return (U @ np.diag([1.0, 1.0, d]) @ Vt).astype(np.float32)


def ensemble_rigid(Rs: Sequence[np.ndarray], ts: Sequence[np.ndarray], center: np.ndarray,
                   weights: Optional[Sequence[float]] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(R*, t*): the chordal mean rotation, and the translation that puts
    `center` at the weighted mean of the members' placements of it."""
    R = chordal_mean_rotation(Rs, weights)
    w = (np.full(len(Rs), 1.0 / len(Rs)) if weights is None
         else np.asarray(weights, np.float64) / np.sum(weights))
    moved_c = np.sum([wi * (Ri @ center + ti) for wi, Ri, ti in zip(w, Rs, ts)], axis=0)
    return R, (moved_c - R @ center).astype(np.float32)


GRAPH_FIELDS = ("graph_cutoff", "graph_max_neighbor", "pocket_cutoff")


class Member:
    """One member: the params (and BatchNorm statistics) of a port weight
    file or training checkpoint on `device`, the ensemble's config with the
    member's model, and its forward."""

    def __init__(self, path: str, base_cfg: Config, device=None):
        self.device = resolve_device(device)
        self.params, cfg_ckpt, self.bn_state = load_model(path, self.device)
        # The inputs are featurized once with the ensemble's graph settings;
        # a member trained on other settings would read mismatched features.
        for f in GRAPH_FIELDS:
            got, want = getattr(cfg_ckpt.graph, f), getattr(base_cfg.graph, f)
            if got != want:
                raise ValueError(f"ensemble member {path} was trained with graph.{f}={got} "
                                 f"but the ensemble featurizes with {want}; rebuild inputs "
                                 "with the member's settings")
        self.cfg = dataclasses.replace(base_cfg, model=cfg_ckpt.model)
        self.name = path
        self.forward = make_forward(self.params, self.cfg, self.bn_state)

    def predict_rigid(self, pair: Featurized) -> Tuple[np.ndarray, np.ndarray]:
        """(R (3, 3), t (1, 3)) of one featurized complex, float32."""
        out = self.forward(collate_pairs(self.cfg, [pair], self.device))
        return out["R"][0].cpu().numpy(), out["t"][0].cpu().numpy()


def run_ensemble_dir(members: List[Member], input_dir: str, ground_truth_dir: str,
                     output_dir: str, method_name: str = "equidock_tpu_ens",
                     weights: Optional[Sequence[float]] = None, log=print) -> None:
    """Dock every `X_l_b.pdb` of `input_dir` with the rigid ensemble of
    `members` into `output_dir/X_l_b_<METHOD_NAME>.pdb`."""
    os.makedirs(output_dir, exist_ok=True)
    times = []
    for stem in complex_stems(input_dir):
        t0 = time.perf_counter()
        pair = featurize_pair(members[0].cfg, os.path.join(input_dir, f"{stem}_l_b.pdb"),
                              os.path.join(ground_truth_dir, f"{stem}_r_b_COMPLEX.pdb"))
        rigids = [m.predict_rigid(pair) for m in members]
        R, t = ensemble_rigid([r for r, _ in rigids], [t for _, t in rigids],
                              pair.lig.x.mean(axis=0), weights)
        moved = (R @ pair.lig_table.coords.T).T + t
        write_pdb(os.path.join(output_dir, output_name(stem, method_name)), pair.lig_table,
                  moved)
        times.append(time.perf_counter() - t0)
        log(f"{stem}: {times[-1]:.2f}s ({len(members)} members)")
    if times:
        log(f"Mean runtime: {np.mean(times):.3f}s over {len(times)} complexes")
