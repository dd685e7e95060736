"""Single-complex inference, PDB in -> docked ligand PDB out: the port of
`dock_one` in `equidock_public_tpu/eval/inference.py`.

Parse the ligand and the receptor, featurize both, run one forward pass,
apply the predicted (R, t) to ALL ligand atoms and write the output PDB.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..data.featurize import alpha_carbon_array, build_protein_graph, filter_residues
from ..data.pdb import AtomTable, group_residues, read_pdb, write_pdb
from ..device import resolve_device
from ..graph import PairBatch, collate
from ..models.iegmn import docking_forward


@dataclasses.dataclass
class InferenceResult:
    out_path: str
    seconds: float
    num_lig_res: int
    num_rec_res: int


def make_forward(params, cfg: Config) -> Callable[[PairBatch], dict]:
    """The model forward for a batch, under inference mode."""
    def forward(batch: PairBatch) -> dict:
        with torch.inference_mode():
            return docking_forward(params, cfg.model, batch)
    return forward


@dataclasses.dataclass
class Request:
    """One docking request, parsed and featurized."""

    batch: PairBatch        # one complex, padded to its buckets
    lig_table: AtomTable    # every ligand atom, to move at the end
    lig_x: np.ndarray       # (n_l, 3) the ligand graph's node coordinates
    num_lig_res: int
    num_rec_res: int


def featurize_request(cfg: Config, ligand_pdb: str, receptor_pdb: str, device) -> Request:
    """Parse both PDB files, featurize both proteins and collate the
    one-complex batch on `device`."""
    lig_table = read_pdb(ligand_pdb)
    lig_res = filter_residues(group_residues(lig_table))
    rec_res = filter_residues(group_residues(read_pdb(receptor_pdb)))
    lig_ca = alpha_carbon_array(lig_res)
    gc = cfg.graph
    lig_g = build_protein_graph(lig_res, gc.graph_cutoff, gc.graph_max_neighbor)
    rec_g = build_protein_graph(rec_res, gc.graph_cutoff, gc.graph_max_neighbor)
    placeholder = np.zeros((4, 3), np.float32)   # pocket slots, unused here
    batch = collate([lig_g], [rec_g], [lig_g.x], [lig_ca], [placeholder],
                    [placeholder], cfg.data.node_buckets, cfg.data.pocket_buckets,
                    device=device)
    return Request(batch, lig_table, lig_g.x, len(lig_res), len(rec_res))


def dock_one(params, cfg: Config, ligand_pdb: str, receptor_pdb: str,
             out_path: str, remove_clashes: bool = False,
             forward_fn: Optional[Callable[[PairBatch], dict]] = None,
             device=None) -> InferenceResult:
    """Dock one ligand onto one receptor and write the moved ligand PDB.
    Runs on the card unless `device` says otherwise (see `resolve_device`);
    `params` must already lie on that device."""
    if remove_clashes:
        raise NotImplementedError("remove_clashes is not ported yet")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    req = featurize_request(cfg, ligand_pdb, receptor_pdb, dev)
    forward_fn = forward_fn or make_forward(params, cfg)
    out = forward_fn(req.batch)
    R = out["R"][0].cpu().numpy().astype(np.float64)
    t = out["t"][0].cpu().numpy().astype(np.float64)

    # R @ CA + t must equal the model's moved coordinates
    n_l = req.lig_x.shape[0]
    pred_ca = out["ligand_coords"][0, :n_l].cpu().numpy()
    resid = np.linalg.norm((R @ req.lig_x.T).T + t - pred_ca)
    if not resid < 1e-1:
        raise RuntimeError(f"R/t inconsistent with the moved coordinates: {resid}")

    moved = (R @ req.lig_table.coords.T).T + t          # ALL ligand atoms
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_pdb(out_path, req.lig_table, moved)
    return InferenceResult(out_path, time.perf_counter() - t0, req.num_lig_res,
                           req.num_rec_res)
