"""What the ranks of the multi-rank tests run (`parallel/launch.py::run_ranks`
targets). Torch and the port only: the rank processes never import JAX,
this package's conftest or the JAX package; the tests hand them inputs made
in the parent (numpy, then the port's tensors) and compare what they
return."""

from __future__ import annotations

import shutil
import sys
import tempfile
from typing import List, Optional

import torch

from equidock_public_tpu_torch.ops.cuda import halo_ring as hr
from equidock_public_tpu_torch.parallel.input_pipeline import local_rows
from equidock_public_tpu_torch.parallel.mesh import ParallelMesh


def run_module_ranks(module: str, argv: List[str], world: int, cwd: str,
                     timeout_s: float = 120.0, threads: int = 1,
                     env_extra: Optional[dict] = None) -> List[str]:
    """`python -m module argv` as `world` ranks in `cwd` (what torchrun
    does, over a FileStore instead of a TCP port), under the launcher's
    time limit and failure rules; returns each rank's output. A CLI of the
    port joins the ranks through `parallel/dist.py::init_from_env`."""
    from equidock_public_tpu_torch.parallel.launch import _run_processes

    tmp = tempfile.mkdtemp(prefix="ranks_")
    try:
        return _run_processes(lambda r: [sys.executable, "-m", module, *argv], world, tmp,
                              module, timeout_s, threads, cwd, env_extra)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _mesh(world, payload):
    return ParallelMesh(payload.get("dp", 1), payload["gp"], world=world)


def exchange(world, payload):
    """Rows 8-9 across the ranks of one data group, for each case of
    `payload["cases"]`: this rank's shard of x and h through
    `peer_exchange_sides`, its slice of the cotangents back. Returns
    [(x_src, h_src, d_x, d_h)] of this rank."""
    mesh = _mesh(world, payload)
    out = []
    for case in payload["cases"]:
        Bl = case["x"].shape[0]
        x, h = (mesh.local_nodes(case[k]).requires_grad_(True) for k in ("x", "h"))
        tab = hr.peer_table(case["table"], mesh.p)
        xs, hs = hr.peer_exchange_sides(mesh.peers, (tab,), (x, h))
        own = slice(mesh.p * Bl, (mesh.p + 1) * Bl)
        torch.autograd.backward((xs, hs), (case["gx"][own], case["gh"][own]))
        out.append((xs.detach(), hs.detach(), x.grad, h.grad))
    mesh.close()
    return out


def halo_forwards(world, payload):
    """The halo forward of this rank's data group's batch, for each
    (config, params) of `payload["models"]`."""
    from equidock_public_tpu_torch.parallel.halo import make_halo_forward

    mesh = _mesh(world, payload)
    hb = payload["hbs"][mesh.g]
    outs = []
    with torch.no_grad():
        for cfg, params in payload["models"]:
            outs.append(dict(make_halo_forward(cfg, mesh)(params, hb)))
    mesh.close()
    return outs


def ring_attention(world, payload):
    """`make_ring_cross_attention` on whole arrays."""
    from equidock_public_tpu_torch.parallel.ring_attention import make_ring_cross_attention

    return make_ring_cross_attention(_mesh(world, payload))(*payload["args"])


def _drop(payload, i):
    """The dropout masks of step i: recorded ones replayed (`payload["masks"]`,
    one list a step), or one generator for every step from
    `payload["drop_seed"]`; None without either."""
    from equidock_public_tpu_torch.models.layers import Dropout

    rate = payload["cfg"].model.dropout
    if "masks" in payload:
        return Dropout(rate, masks=payload["masks"][i])
    if "drop_seed" in payload:
        if "_gen" not in payload:
            payload["_gen"] = Dropout(rate, torch.Generator().manual_seed(payload["drop_seed"]))
        return payload["_gen"]
    return None


def _steps(world, payload, make_step, batch_of, masks_of=lambda drop, mesh: drop):
    from equidock_public_tpu_torch.params import flatten
    from equidock_public_tpu_torch.parallel.train import params_digest
    from equidock_public_tpu_torch.train.step import create_train_state

    mesh = _mesh(world, payload)
    state = create_train_state(payload["params"], payload["cfg"], mesh.device)
    step = make_step(payload["cfg"], mesh)
    metrics = []
    for i in range(payload.get("steps", 1)):
        state, m = step(state, batch_of(mesh, i), payload.get("lr_scale", 1.0),
                        masks_of(_drop(payload, i), mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    digests = params_digest(state, mesh)
    mesh.close()
    return {"metrics": metrics, "digests": digests, "step": state.step,
            "params": {k: v.detach().cpu() for k, v in flatten(state.params).items()},
            "bn_state": {s: {k: v.detach().cpu() for k, v in st.items()}
                         for s, st in state.bn_state.items()}}


def dp_steps(world, payload):
    """`make_parallel_train_step` steps on this rank's rows of each batch."""
    from equidock_public_tpu_torch.parallel.train import make_parallel_train_step, rank_dropout

    batches = payload["batches"]
    return _steps(world, payload, make_parallel_train_step,
                  lambda mesh, i: local_rows(batches[i % len(batches)], mesh), rank_dropout)


def halo_steps(world, payload):
    """`make_halo_train_step` steps on this rank's data group's halo batch."""
    from equidock_public_tpu_torch.parallel.halo import make_halo_train_step

    return _steps(world, payload, make_halo_train_step, lambda mesh, i: payload["hbs"][mesh.g])


def several(world, payload):
    """Each (target, world size, payload) of `payload["runs"]` in turn, on
    the first `size` ranks (the others wait): one launch for several
    checks."""
    from equidock_public_tpu_torch.parallel.dist import host_barrier
    from equidock_public_tpu_torch.parallel.launch import resolve_target

    out = []
    for target, size, sub_payload in payload["runs"]:
        if world.rank < size:
            sub = world.sub(range(size)) if size < world.size else world
            out.append(resolve_target(target)(sub, sub_payload))
        else:
            out.append(None)
        host_barrier(world.cpu_group)
    return out


def fit_run(world, payload):
    """`fit` across the ranks; returns its history, the final parameters
    and the log lines of this rank."""
    from equidock_public_tpu_torch.params import flatten
    from equidock_public_tpu_torch.train.loop import fit

    from equidock_public_tpu_torch.train.step import create_train_state

    logs, history = [], []
    state = payload.get("params")
    if state is not None:
        state = create_train_state(state, payload["cfg"], "cpu")
    state = fit(payload["cfg"], state, max_epochs=payload["epochs"], device="cpu", world=world,
                log=lambda *a: logs.append(" ".join(map(str, a))), history=history)
    return {"history": history, "logs": logs,
            "params": {k: v.detach().cpu() for k, v in flatten(state.params).items()}}


def resident_dp_epochs(world, payload):
    """`run_train_epoch_resident_dp` epochs on the cache at `payload["cache"]`
    (ranks: each its shard of the store; a world of one: the stacked
    store), with the generator draws of `fit`, or `payload["triples"]` and
    `payload["masks"]` replayed. Returns each epoch's averages and the final
    parameters."""
    import numpy as np

    from equidock_public_tpu_torch.data.dataset import DockingDataset
    from equidock_public_tpu_torch.params import flatten
    from equidock_public_tpu_torch.train.resident import (build_resident_split_dp,
                                                          draws_factory,
                                                          run_train_epoch_resident_dp)
    from equidock_public_tpu_torch.train.step import create_train_state

    from equidock_public_tpu_torch.models.layers import Dropout
    from equidock_public_tpu_torch.train.resident import ReplayDraws

    cfg = payload["cfg"]
    mesh = ParallelMesh(payload["dp"], 1, "cpu", world=world)
    ds = DockingDataset.from_cache(cfg, "train", swap=True, cache_path=payload["cache"])
    rs = build_resident_split_dp(ds, cfg, mesh)
    state = create_train_state(payload["params"], cfg, "cpu")
    rng, draws = np.random.default_rng(0), draws_factory(cfg, "cpu")
    averages = []
    for epoch in range(payload["epochs"]):
        # recorded draws and dropout masks (one list for the epoch), if given
        src = (ReplayDraws(payload["triples"], "cpu") if "triples" in payload
               else draws("train", epoch))
        drop = Dropout(cfg.model.dropout, masks=payload["masks"]) if "masks" in payload else None
        state, tr = run_train_epoch_resident_dp(state, rs, cfg, mesh, rng, src, epoch,
                                                do_swap=True, drop=drop)
        averages.append(tr)
    return {"averages": averages, "rows": {b: g.lig.x.shape[0] for b, g in rs.groups.items()},
            "params": {k: v.detach().cpu() for k, v in flatten(state.params).items()}}
