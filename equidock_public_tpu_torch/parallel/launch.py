"""Start ranks as processes and collect what each returns.

    run_ranks("pkg.module:fn" or "path/to/file.py:fn", world, payload,
              device="cuda", timeout_s=120)

starts `world` processes of `python -m equidock_public_tpu_torch.parallel.launch`,
each with an explicit environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`LOCAL_WORLD_SIZE`, `EQUIDOCK_DIST_STORE` a fresh FileStore path, one
intra-op thread unless asked otherwise; each rank on the card, cuda:(rank %
cards), unless `device="cpu"`). Each rank joins the group
(`dist.init_from_env`), calls `fn(world, payload)`, checks that neither JAX
nor the JAX package was imported, and saves the result. Any rank's failure,
or the time limit, kills every rank and raises with each rank's last
output. The ranks load the kernels the parent built (`ops/cuda/_build.py`
finds the library of the same source hash) and never build them.

The CLIs join ranks that torchrun starts: `python -m torch.distributed.run
--nproc_per_node N -m equidock_public_tpu_torch.cli.train -dp ... -gp ...`.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional

import torch

from .dist import STORE_ENV, init_from_env

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "equidock_public_tpu")


class RankFailure(RuntimeError):
    """A rank exited non-zero, or the ranks outlived their time limit."""


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def _run_processes(argv_of, world: int, tmp: str, what: str, timeout_s: float, threads: int,
                   cwd: str, env_extra: Optional[dict]) -> List[str]:
    """Start `argv_of(rank)` for every rank with the rank's environment (a
    FileStore under `tmp`), wait for all; any failure or the time limit
    kills every rank and raises. Returns each rank's output."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                         "MASTER_ADDR", "MASTER_PORT", "PYTHONPATH", STORE_ENV)}
    base.update(PYTHONPATH=REPO, OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads),
                LOCAL_WORLD_SIZE=str(world), WORLD_SIZE=str(world),
                **{STORE_ENV: os.path.join(tmp, "store")}, **(env_extra or {}))
    procs = []
    try:
        for r in range(world):
            out = open(os.path.join(tmp, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(argv_of(r), env=dict(base, RANK=str(r),
                                                                LOCAL_RANK=str(r)),
                                           cwd=cwd, stdout=out, stderr=subprocess.STDOUT), out))
        deadline = time.monotonic() + timeout_s
        failed = None
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = f"ranks still running after {timeout_s} s"
                break
            time.sleep(0.05)
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            out.close()
    logs = [_tail(os.path.join(tmp, f"rank{r}.log"), 1 << 20) for r in range(world)]
    if failed:
        raise RankFailure(f"{what} on {world} ranks: {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{log[-4000:]}" for r, log in enumerate(logs)))
    return logs


def run_ranks(target: str, world: int, payload: Any = None, device: str = "cuda",
              timeout_s: float = 120.0, threads: int = 1, workdir: Optional[str] = None,
              env_extra: Optional[dict] = None) -> List[Any]:
    """Run `target(world, payload)` on `world` ranks; returns their results
    in rank order."""
    tmp = tempfile.mkdtemp(prefix="ranks_", dir=workdir)
    try:
        payload_path = os.path.join(tmp, "payload.pt")
        torch.save(payload, payload_path)
        _run_processes(lambda r: [sys.executable, "-m", "equidock_public_tpu_torch.parallel.launch",
                                  target, payload_path, os.path.join(tmp, f"rank{r}.pt"),
                                  device, str(threads)],
                       world, tmp, target, timeout_s, threads, REPO, env_extra)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def resolve_target(target: str):
    """"pkg.module:fn" or "path/file.py:fn" -> the function."""
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(where))[0], where)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, name)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if sys.modules[m] is not None and m.split(".")[0] in FORBIDDEN)


def main(argv: List[str]) -> int:
    target, payload_path, out_path, device, threads = argv
    torch.set_num_threads(int(threads))
    fn = resolve_target(target)
    payload = torch.load(payload_path, weights_only=False)
    world = init_from_env(device=device)
    try:
        result = fn(world, payload)
    finally:
        world.close()
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"rank {world.rank} imported {bad}")
    torch.save(result, out_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
