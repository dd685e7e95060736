"""Single-complex inference, PDB in -> docked ligand PDB out: the port of
`equidock_public_tpu/eval/inference.py` (`euler_to_rotmat`,
`remove_clashes_descent`, `dock_one`, `run_inference_dir`).

Parse the ligand and the receptor, featurize both, run one forward pass,
apply the predicted (R, t) to ALL ligand atoms, optionally run the
clash-removal descent, and write the output PDB. On the card the descent's
intersection loss runs on the soft-min field kernels
(`ops/softmin_field.py::body_intersection_loss_fused`, rows 6-7); on the
CPU on the plain `ops/intersection.py`, the same function.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.featurize import (ProteinGraph, alpha_carbon_array, build_protein_graph,
                              filter_residues)
from ..data.pdb import AtomTable, group_residues, read_pdb, write_pdb
from ..device import resolve_device
from ..graph import PairBatch, collate
from ..models.iegmn import docking_forward
from ..ops.intersection import body_intersection_loss
from ..ops.softmin_field import body_intersection_loss_fused


@dataclasses.dataclass
class InferenceResult:
    out_path: str
    seconds: float
    num_lig_res: int
    num_rec_res: int


def make_forward(params, cfg: Config, bn_state: Optional[dict] = None
                 ) -> Callable[[PairBatch], dict]:
    """The model forward for a batch, under inference mode; `bn_state`: the
    BatchNorm running statistics of a model with a 'BN' option
    (`params.load_model`)."""
    def forward(batch: PairBatch) -> dict:
        with torch.inference_mode():
            return docking_forward(params, cfg.model, batch, bn_state=bn_state)
    return forward


def euler_to_rotmat(angles: torch.Tensor) -> torch.Tensor:
    """RZ(yaw) @ RY(pitch) @ RX(roll) for angles (roll, yaw, pitch), as the
    JAX package's `euler_to_rotmat`; differentiable."""
    roll, yaw, pitch = angles[0], angles[1], angles[2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    one, zero = torch.ones_like(roll), torch.zeros_like(roll)
    mat = lambda rows: torch.stack([torch.stack(r) for r in rows])
    RX = mat([[one, zero, zero], [zero, cr, -sr], [zero, sr, cr]])
    RY = mat([[cp, zero, sp], [zero, one, zero], [-sp, zero, cp]])
    RZ = mat([[cy, -sy, zero], [sy, cy, zero], [zero, zero, one]])
    return RZ @ RY @ RX


@dataclasses.dataclass
class Descent:
    """The outcome of `remove_clashes_descent`."""

    coords: np.ndarray    # (A, 3) float32, the moved ligand atoms
    iterations: int       # gradient steps taken
    value: float          # the loss at the last evaluation
    stopped: bool         # True when the loss reached STOP_VALUE before max_iters


STOP_VALUE = 0.5


def remove_clashes_descent(lig_atoms: np.ndarray, rec_atoms: np.ndarray,
                           sigma: float = 8.0, surface_ct: float = 8.0,
                           max_iters: int = 2000, device=None) -> Descent:
    """Clash removal after docking: gradient descent on the Euler angles
    and the translation of the whole ligand against the body-intersection
    loss over all atoms, with the JAX package's schedule (eta 1e-3, 1e-4
    once the loss is below 2, 1e-2 after iteration 1500; stop at a loss of
    at most 0.5). The loss is read on the host every iteration, as the JAX
    loop does; an iteration that stops runs no backward. Inputs are taken
    in float32. Runs on the card unless `device` says otherwise."""
    dev = resolve_device(device)
    lig_np = np.asarray(lig_atoms, dtype=np.float32)
    lig = torch.from_numpy(lig_np).to(dev)
    rec = torch.from_numpy(np.asarray(rec_atoms, dtype=np.float32)).to(dev)[None]
    ones_l = torch.ones(1, lig.shape[0], device=dev)
    ones_r = torch.ones(1, rec.shape[1], device=dev)
    loss = body_intersection_loss_fused if dev.type == "cuda" else body_intersection_loss
    angles = torch.zeros(3, device=dev)
    trans = torch.zeros(3, device=dev)
    it, v, stopped = 0, float("nan"), False
    for it in range(max_iters):
        angles.requires_grad_(True)
        trans.requires_grad_(True)
        moved = (euler_to_rotmat(angles) @ lig.T).T + trans
        val = loss(moved[None], ones_l, rec, ones_r, sigma, surface_ct)[0]
        v = float(val.detach())
        if v <= STOP_VALUE:
            stopped = True
            break
        g_a, g_t = torch.autograd.grad(val, (angles, trans))
        eta = 1e-3
        if v < 2.0:
            eta = 1e-4
        if it > 1500:
            eta = 1e-2
        with torch.no_grad():
            angles = angles - eta * g_a
            trans = trans - eta * g_t
    else:
        it = max_iters
    with torch.no_grad():
        R = euler_to_rotmat(angles.detach()).cpu().numpy()
    t = trans.detach().cpu().numpy()
    return Descent((R @ lig_np.T).T + t, it, v, stopped)


@dataclasses.dataclass
class Featurized:
    """Both proteins of a request parsed and featurized, not yet collated."""

    lig_table: AtomTable
    rec_atoms: np.ndarray
    lig: ProteinGraph
    rec: ProteinGraph
    lig_ca: np.ndarray      # (n_l, 3) the ligand's CA coordinates
    num_lig_res: int
    num_rec_res: int


def featurize_pair(cfg: Config, ligand_pdb: str, receptor_pdb: str) -> Featurized:
    """Parse both PDB files and featurize both proteins on the host."""
    lig_table = read_pdb(ligand_pdb)
    rec_table = read_pdb(receptor_pdb)
    lig_res = filter_residues(group_residues(lig_table))
    rec_res = filter_residues(group_residues(rec_table))
    gc = cfg.graph
    return Featurized(lig_table, rec_table.coords,
                      build_protein_graph(lig_res, gc.graph_cutoff, gc.graph_max_neighbor),
                      build_protein_graph(rec_res, gc.graph_cutoff, gc.graph_max_neighbor),
                      alpha_carbon_array(lig_res), len(lig_res), len(rec_res))


@dataclasses.dataclass
class Request(Featurized):
    """A featurized request with its one-complex batch."""

    batch: PairBatch        # padded to its buckets, on the serving device


def collate_pairs(cfg: Config, pairs, device, batch_size: Optional[int] = None) -> PairBatch:
    """Featurized pairs -> one padded batch on `device` (pocket slots are
    unused placeholders), `batch_size` slots when given."""
    placeholder = np.zeros((4, 3), np.float32)
    ligs = [p.lig for p in pairs]
    return collate(ligs, [p.rec for p in pairs], [g.x for g in ligs],
                   [p.lig_ca for p in pairs], [placeholder] * len(pairs),
                   [placeholder] * len(pairs), cfg.data.node_buckets,
                   cfg.data.pocket_buckets, device=device, batch_size=batch_size)


def featurize_request(cfg: Config, ligand_pdb: str, receptor_pdb: str, device) -> Request:
    """Parse both PDB files, featurize both proteins and collate the
    one-complex batch on `device`."""
    f = featurize_pair(cfg, ligand_pdb, receptor_pdb)
    return Request(**vars(f), batch=collate_pairs(cfg, [f], device))


def dock_one(params, cfg: Config, ligand_pdb: str, receptor_pdb: str,
             out_path: str, remove_clashes: bool = False,
             forward_fn: Optional[Callable[[PairBatch], dict]] = None,
             device=None, bn_state: Optional[dict] = None) -> InferenceResult:
    """Dock one ligand onto one receptor and write the moved ligand PDB;
    with `remove_clashes`, the clash-removal descent against every receptor
    atom moves it first. Runs on the card unless `device` says otherwise
    (see `resolve_device`); `params` (and `bn_state`, for `make_forward`
    when no `forward_fn` is given) must already lie on that device."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    req = featurize_request(cfg, ligand_pdb, receptor_pdb, dev)
    forward_fn = forward_fn or make_forward(params, cfg, bn_state)
    out = forward_fn(req.batch)
    R = out["R"][0].cpu().numpy().astype(np.float64)
    t = out["t"][0].cpu().numpy().astype(np.float64)

    # R @ CA + t must equal the model's moved coordinates
    lig_x = req.lig.x
    pred_ca = out["ligand_coords"][0, :lig_x.shape[0]].cpu().numpy()
    resid = np.linalg.norm((R @ lig_x.T).T + t - pred_ca)
    if not resid < 1e-1:
        raise RuntimeError(f"R/t inconsistent with the moved coordinates: {resid}")

    moved = (R @ req.lig_table.coords.T).T + t          # ALL ligand atoms
    if remove_clashes:
        moved = remove_clashes_descent(moved.astype(np.float32), req.rec_atoms,
                                       device=dev).coords
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_pdb(out_path, req.lig_table, moved)
    return InferenceResult(out_path, time.perf_counter() - t0, req.num_lig_res,
                           req.num_rec_res)


def complex_stems(input_dir: str) -> List[str]:
    """The X of every `X_l_b.pdb` in `input_dir`, sorted."""
    return sorted(f[:-len("_l_b.pdb")] for f in os.listdir(input_dir)
                  if f.endswith("_l_b.pdb"))


def output_name(stem: str, method_name: str) -> str:
    return f"{stem}_l_b_{method_name.upper()}.pdb"


def run_inference_dir(params, cfg: Config, input_dir: str, ground_truth_dir: str,
                      output_dir: str, method_name: str = "equidock_tpu",
                      remove_clashes: bool = False, log=print,
                      device=None, bn_state: Optional[dict] = None) -> List[InferenceResult]:
    """Dock every `X_l_b.pdb` of `input_dir` against its receptor
    `ground_truth_dir/X_r_b_COMPLEX.pdb`, one forward each, into
    `output_dir/X_l_b_<METHOD_NAME>.pdb`."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    forward_fn = make_forward(params, cfg, bn_state)
    results = []
    for stem in complex_stems(input_dir):
        r = dock_one(params, cfg, os.path.join(input_dir, f"{stem}_l_b.pdb"),
                     os.path.join(ground_truth_dir, f"{stem}_r_b_COMPLEX.pdb"),
                     os.path.join(output_dir, output_name(stem, method_name)),
                     remove_clashes=remove_clashes, forward_fn=forward_fn, device=dev)
        log(f"{stem}: {r.seconds:.2f}s ({r.num_lig_res}/{r.num_rec_res} res)")
        results.append(r)
    times = np.array([r.seconds for r in results])
    if len(times):
        log(f"Mean runtime: {times.mean():.3f}s, std: {times.std():.3f}s")
    return results
