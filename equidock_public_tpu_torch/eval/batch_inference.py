"""Whole-directory inference in padded batches: the port of
`equidock_public_tpu/eval/batch_inference.py`.

Every complex is featurized on the host first; the complexes are sorted by
size (fewer dead nodes a batch), cut into batches of `batch_size` slots and
docked one forward a batch; each predicted (R, t) then moves all atoms of
its ligand.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.pdb import write_pdb
from ..device import resolve_device
from .inference import collate_pairs, complex_stems, featurize_pair, make_forward, output_name


def run_batched_inference(params, cfg: Config, input_dir: str, ground_truth_dir: str,
                          output_dir: str, method_name: str = "equidock_tpu",
                          batch_size: int = 5, log=print, device=None,
                          bn_state: Optional[dict] = None) -> float:
    """Dock every `X_l_b.pdb` of `input_dir` against
    `ground_truth_dir/X_r_b_COMPLEX.pdb` in padded batches of `batch_size`.
    Returns the model's wall time in seconds (the forwards, synchronised),
    without featurization and PDB I/O."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    entries = [(stem, featurize_pair(cfg, os.path.join(input_dir, f"{stem}_l_b.pdb"),
                                     os.path.join(ground_truth_dir, f"{stem}_r_b_COMPLEX.pdb")))
               for stem in complex_stems(input_dir)]
    entries.sort(key=lambda e: max(e[1].lig.num_nodes, e[1].rec.num_nodes))
    forward = make_forward(params, cfg, bn_state)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    model_time = 0.0
    for start in range(0, len(entries), batch_size):
        chunk = entries[start:start + batch_size]
        batch = collate_pairs(cfg, [f for _, f in chunk], dev, batch_size=batch_size)
        sync()
        t0 = time.perf_counter()
        out = forward(batch)
        sync()
        model_time += time.perf_counter() - t0
        R, t = out["R"].cpu().numpy(), out["t"].cpu().numpy()
        for i, (stem, f) in enumerate(chunk):
            moved = (R[i] @ f.lig_table.coords.T).T + t[i]
            write_pdb(os.path.join(output_dir, output_name(stem, method_name)), f.lig_table,
                      moved.astype(np.float32))
    log(f"batched inference: {len(entries)} complexes, model time {model_time:.2f}s "
        f"({model_time / max(len(entries), 1) * 1e3:.1f} ms/complex)")
    return model_time
