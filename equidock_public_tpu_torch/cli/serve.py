"""Long-running docking server: load the model once, dock on demand.

Protocol: one JSON object per input line
    {"ligand": "path/l.pdb", "receptor": "path/r.pdb", "output": "out.pdb",
     "remove_clashes": false}
-> one JSON response per output line
    {"output": "...", "seconds": 0.12, "num_lig_res": 172, "num_rec_res": 548,
     "ok": true}
or {"ok": false, "error": "..."}; the server keeps serving after an error.

    python -m equidock_public_tpu_torch.cli.serve [-checkpoint W.pt.xz] \
        [-warmup_buckets 512,1024] [-max_batch 4 -batch_window_ms 5] \
        [-dtype bfloat16] [-device cuda|cpu]

The port of `equidock_public_tpu/cli/serve.py`. With `-max_batch` above 1,
requests that arrive within the window of the first one share padded
forwards: they are grouped by (ligand, receptor) bucket pair, each group is
collated at `max_batch` slots, and the responses keep arrival order and add
`batch_seconds` (the wall time of the whole co-arrival) and `batched` (its
requests); `seconds` is then the share of one request. `-checkpoint` is a
port weight file or a port training checkpoint (`params.load_model`); the
model's config is its sidecar, and a 'BN' model is served with the
checkpoint's running statistics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import sys
import threading
import time
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, TextIO, Tuple

import numpy as np

from ..config import Config, bucket_for
from ..data.featurize import ProteinGraph
from ..data.pdb import write_pdb
from ..data.synth import synth_graph
from ..device import resolve_device
from ..eval import inference
from ..graph import collate
from ..params import default_checkpoint, load_model


def warmup_batch(cfg: Config, n_lig: int, n_rec: int, device, batch_size: int = 1):
    """Synthetic one-complex batch at exactly (n_lig, n_rec) padded nodes and
    `batch_size` slots, the shapes a request in those buckets produces."""
    rng = np.random.default_rng(0)

    def graph(n):
        d = synth_graph(rng, n, k=cfg.graph.graph_max_neighbor)
        return ProteinGraph(res_id=d["res_id"], x=d["x"], mu_r_norm=d["mu_r_norm"],
                            nbr=d["nbr"], nbr_mask=d["nbr_mask"],
                            edge_feat=d["edge_feat"])

    lg, rg = graph(n_lig), graph(n_rec)
    zeros = np.zeros((4, 3), np.float32)
    return collate([lg], [rg], [lg.x], [lg.x], [zeros], [zeros],
                   tuple(sorted({n_lig, n_rec})), cfg.data.pocket_buckets,
                   device=device, batch_size=batch_size)


def error_response(e: Exception) -> dict:
    return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def arrivals(stream: TextIO, max_batch: int, window_ms: float) -> Iterator[List[str]]:
    """Co-arrivals of `stream`'s non-empty lines, read by a thread: the first
    pending line and whatever follows within `window_ms`, at most
    `max_batch` lines each."""
    q: "queue.Queue[Optional[str]]" = queue.Queue()

    def reader():
        for line in stream:
            if line.strip():
                q.put(line.strip())
        q.put(None)

    threading.Thread(target=reader, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        lines = [item]
        deadline = time.monotonic() + window_ms / 1e3
        while len(lines) < max_batch:
            try:
                nxt = q.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                break
            if nxt is None:
                q.put(None)          # the end, for the outer loop
                break
            lines.append(nxt)
        yield lines


class DockingServer:
    """A loaded model on one device, answering JSON-lines docking requests;
    `bn_state`: the running statistics of a model with a 'BN' option."""

    def __init__(self, params, cfg: Config, device, bn_state: Optional[dict] = None):
        self.params = params
        self.cfg = cfg
        self.device = device
        self.bn_state = bn_state
        self.forward = inference.make_forward(params, cfg, bn_state)

    @classmethod
    def from_checkpoint(cls, path: str, device=None,
                        dtype: Optional[str] = None) -> "DockingServer":
        """The server of a port weight file or training checkpoint; `dtype`
        replaces the model's compute dtype (`ModelConfig.dtype`)."""
        dev = resolve_device(device)
        params, cfg, bn_state = load_model(path, dev)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
        return cls(params, cfg, dev, bn_state)

    def warmup(self, sizes: Sequence[int], batch_size: int = 1) -> Tuple[int, float]:
        """Run one forward per (ligand, receptor) bucket pair at `batch_size`
        slots, so no request pays first-launch costs. Returns (pairs run,
        seconds)."""
        t0 = time.perf_counter()
        n = 0
        for bl in sizes:
            for br in sizes:
                out = self.forward(warmup_batch(self.cfg, bl, br, self.device, batch_size))
                out["R"].cpu()
                n += 1
        return n, time.perf_counter() - t0

    def handle(self, line: str) -> dict:
        """One request line -> one response dict; errors become ok=false."""
        try:
            req = json.loads(line)
            r = inference.dock_one(self.params, self.cfg, req["ligand"], req["receptor"],
                                   req["output"],
                                   remove_clashes=req.get("remove_clashes", False),
                                   forward_fn=self.forward, device=self.device)
        except Exception as e:  # the server keeps serving; the caller sees why
            return error_response(e)
        return {"output": r.out_path, "seconds": round(r.seconds, 4),
                "num_lig_res": r.num_lig_res, "num_rec_res": r.num_rec_res,
                "ok": True}

    def serve_lines(self, lines: Iterable[str], out: TextIO) -> int:
        """Answer every non-empty line of `lines` with one JSON line on
        `out`, one forward each. Returns the number of requests answered."""
        n = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            out.write(json.dumps(self.handle(line)) + "\n")
            out.flush()
            n += 1
        return n

    def handle_batch(self, lines: Sequence[str], max_batch: int,
                     on_group: Optional[Callable[[dict], None]] = None) -> List[dict]:
        """One co-arrival of at most `max_batch` request lines -> their
        responses in arrival order. Requests are grouped by (ligand,
        receptor) bucket pair, each group docked in one forward at
        `max_batch` slots; a request that fails alone (its line, its files,
        its output) or whose group fails gets ok=false. `on_group` receives
        each group's bucket pair, size, dead slots and node share, and
        forward seconds (the forward and the read of (R, t))."""
        if not 0 < len(lines) <= max_batch:
            raise ValueError(f"{len(lines)} requests for a batch of {max_batch}")
        t0 = time.perf_counter()
        entries = []
        for line in lines:
            try:
                req = json.loads(line)
                entries.append({"req": req, "err": None, "pair": inference.featurize_pair(
                    self.cfg, req["ligand"], req["receptor"])})
            except Exception as e:  # a bad request must not stop its co-arrivals
                entries.append({"err": error_response(e)})
        ok = [e for e in entries if e["err"] is None]
        buckets = self.cfg.data.node_buckets
        groups: dict = {}
        for e in ok:
            groups.setdefault((bucket_for(e["pair"].num_lig_res, buckets),
                               bucket_for(e["pair"].num_rec_res, buckets)), []).append(e)
        for key, group in groups.items():
            try:
                g0 = time.perf_counter()
                out = self.forward(inference.collate_pairs(
                    self.cfg, [e["pair"] for e in group], self.device, batch_size=max_batch))
                R, t = out["R"].cpu().numpy(), out["t"].cpu().numpy()
                seconds = time.perf_counter() - g0
            except Exception as e_:  # the whole group failed; keep serving
                for e in group:
                    e["err"] = error_response(e_)
                continue
            for i, e in enumerate(group):
                e["rigid"] = (R[i], t[i])
            if on_group is not None:
                real = sum(e["pair"].num_lig_res + e["pair"].num_rec_res for e in group)
                on_group({"buckets": list(key), "requests": len(group),
                          "dead_slots": max_batch - len(group),
                          "dead_node_share": 1 - real / (max_batch * sum(key)),
                          "forward_seconds": seconds})
        for e in ok:
            if e["err"] is not None:
                continue
            try:
                R_i, t_i = e["rigid"]
                pair = e["pair"]
                moved = (R_i @ pair.lig_table.coords.T).T + t_i
                if e["req"].get("remove_clashes", False):
                    moved = inference.remove_clashes_descent(
                        moved.astype(np.float32), pair.rec_atoms, device=self.device).coords
                out_path = e["req"]["output"]
                os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
                write_pdb(out_path, pair.lig_table, moved.astype(np.float32))
            except Exception as e_:  # per-request failure
                e["err"] = error_response(e_)
        dt = time.perf_counter() - t0
        n_ok = len(ok)
        return [e["err"] if e["err"] is not None else
                {"output": e["req"]["output"], "seconds": round(dt / max(n_ok, 1), 4),
                 "batch_seconds": round(dt, 4), "num_lig_res": e["pair"].num_lig_res,
                 "num_rec_res": e["pair"].num_rec_res, "batched": n_ok, "ok": True}
                for e in entries]

    def serve_groups(self, groups: Iterable[Sequence[str]], out: TextIO, max_batch: int,
                     on_group: Optional[Callable[[dict], None]] = None) -> int:
        """Answer each co-arrival of `groups` (`handle_batch`) with one JSON
        line per request on `out`, in arrival order. Returns the number of
        requests answered."""
        n = 0
        for lines in groups:
            for resp in self.handle_batch(lines, max_batch, on_group):
                out.write(json.dumps(resp) + "\n")
                n += 1
            out.flush()
        return n

    def serve_batched(self, lines: Iterable[str], out: TextIO, max_batch: int,
                      on_group: Optional[Callable[[dict], None]] = None) -> int:
        """Batched serving of a list of lines, as if they all arrived at once:
        the non-empty lines in co-arrivals of `max_batch`."""
        todo = [ln.strip() for ln in lines if ln.strip()]
        return self.serve_groups((todo[i:i + max_batch]
                                  for i in range(0, len(todo), max_batch)),
                                 out, max_batch, on_group)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="EquiDock docking server (PyTorch/CUDA)")
    p.add_argument("-checkpoint", default=default_checkpoint(),
                   help="port weight file (.pt.xz with a .config.json sidecar) or port "
                        "training checkpoint; default: the DB5 paper model shipped with "
                        "the package")
    p.add_argument("-warmup_buckets", default="",
                   help="comma-separated node bucket sizes to run once at "
                        "startup (all ligand x receptor pairs)")
    p.add_argument("-max_batch", type=int, default=1,
                   help=">1: requests that arrive together share padded forwards")
    p.add_argument("-batch_window_ms", type=float, default=5.0,
                   help="how long to wait for co-arrivals after the first request")
    p.add_argument("-dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype of the linears (default: the checkpoint's)")
    p.add_argument("-device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if a.max_batch < 1:
        raise ValueError(f"-max_batch {a.max_batch} < 1")
    server = DockingServer.from_checkpoint(a.checkpoint, a.device, a.dtype)
    if a.warmup_buckets:
        n, secs = server.warmup([int(x) for x in a.warmup_buckets.split(",")],
                                batch_size=a.max_batch)
        print(json.dumps({"warmed": n, "seconds": round(secs, 2)}), flush=True)
    print(json.dumps({"ready": True}), flush=True)
    if a.max_batch > 1:
        server.serve_groups(arrivals(sys.stdin, a.max_batch, a.batch_window_ms),
                            sys.stdout, a.max_batch)
    else:
        server.serve_lines(sys.stdin, sys.stdout)


if __name__ == "__main__":
    main()
