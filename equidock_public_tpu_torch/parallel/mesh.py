"""The (data, graph) mesh: the port's counterpart of
`equidock_public_tpu/parallel/mesh.py::make_mesh` and of `shard_map` over
`P("data", "graph")`, in two forms.

Across ranks (`ParallelMesh(dp, gp, world=init_from_env())` with a world
of dp gp processes, `parallel/dist.py`): rank r = g gp + p, JAX's
`devices.reshape(dp, gp)`, holds data group g (complexes g B/dp ...
(g+1) B/dp - 1, as `P("data")` cuts the batch) and graph shard p of each
(nodes p S ... (p+1) S - 1). `graph` is the subgroup of the ranks of one
g, `data` that of the ranks of one p (None for a group of one rank);
`peers` is the graph group's exchange (`ops/cuda/halo_ring.py::
PeerGroup`).

In one process (a world of one, the default): every shard lives on the
mesh's one device, stacked on leading axes: a node
array (B, N, ...) of one side becomes (dp, gp, B/dp, S, ...) with
S = N / gp (data group g holds complexes g B/dp ... (g+1) B/dp - 1, as
`P("data")` cuts the batch; graph shard p holds nodes p S ... (p+1) S - 1).
The layer body runs once over the folded (dp gp B/dp, S, ...) blocks; the
ring kernels read and write the (dp, gp, ...) view of the same memory. The
stacked form is what the rank form is held to. A world of any other size
than 1 or dp gp raises.

The JAX package's SPMD specs (`batch_pspec`, `shard_batch`, `replicate`)
have no counterpart: a rank holds its rows of the batch itself
(`parallel/input_pipeline.py`) and a full copy of the parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from ..device import resolve_device
from ..graph import ProteinBatch

DeviceLike = Union[str, torch.device]


def _resolve(device) -> torch.device:
    """`resolve_device`, with the index of the current card filled in."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ParallelMesh:
    """dp data groups x gp graph shards: across the ranks of `world` (a
    `parallel.dist.World` of dp gp ranks, each on its own device), or all
    on one device (no world, or a world of one: the card unless the caller
    asks for the CPU)."""

    def __init__(self, dp: int = 1, gp: int = 1,
                 device: Optional[Union[DeviceLike, Sequence[DeviceLike]]] = None,
                 world=None):
        if dp < 1 or gp < 1:
            raise ValueError(f"dp={dp}, gp={gp}: both must be at least 1")
        self.dp, self.gp = dp, gp
        self.world = world if world is not None and world.size > 1 else None
        self.g, self.p = 0, 0
        self.graph = self.graph_cpu = self.data = self.peers = None
        if self.world is not None:
            if world.size != dp * gp:
                raise ValueError(f"a world of {world.size} ranks for dp={dp} x gp={gp}: give "
                                 f"{dp * gp} ranks, or one for the stacked form")
            from ..ops.cuda.halo_ring import PeerGroup

            self.device = world.device
            self.g, self.p = divmod(world.rank, gp)
            # every rank makes its two groups, graph then data (a group of one
            # rank is None: its collectives are the identity)
            if gp > 1:
                self.graph, self.graph_cpu = world.new_group([self.g * gp + p
                                                              for p in range(gp)])
                self.peers = PeerGroup(self.graph, self.graph_cpu, self.p, gp, self.device)
            if dp > 1:
                self.data = world.new_group([g * gp + self.p for g in range(dp)])[0]
            return
        if isinstance(device, (list, tuple)):
            devs = {_resolve(d) for d in device}
            if len(devs) > 1:
                raise ValueError(
                    f"shards on {len(devs)} devices ({sorted(map(str, devs))}) in one process: "
                    "run one rank a device (parallel/dist.py) and pass world=")
            device = next(iter(devs)) if devs else None
        self.device = _resolve(device)

    @property
    def ranked(self) -> bool:
        """Whether the shards are ranks (processes) rather than stacked blocks."""
        return self.world is not None

    def __repr__(self) -> str:
        where = (f"rank {self.world.rank} of {self.world.size}" if self.ranked
                 else f"device={self.device}")
        return f"ParallelMesh(dp={self.dp}, gp={self.gp}, {where})"

    def close(self) -> None:
        """Unmap the peers' exchange buffers (collective over the graph group)."""
        if self.peers is not None:
            self.peers.close()

    def local_slice(self, B: int) -> slice:
        """This rank's complexes of a global batch of B."""
        if B % self.dp:
            raise ValueError(f"batch {B} does not split into dp={self.dp} groups")
        Bl = B // self.dp
        return slice(self.g * Bl, (self.g + 1) * Bl)

    def local_nodes(self, a: torch.Tensor) -> torch.Tensor:
        """(Bl, N, ...) of this rank's data group -> its shard (Bl, S, ...)."""
        N = a.shape[1]
        if N % self.gp:
            raise ValueError(f"{N} nodes do not split into gp={self.gp} shards")
        S = N // self.gp
        return a[:, self.p * S:(self.p + 1) * S].contiguous()

    def check(self, B: int, N: int) -> None:
        if B % self.dp or N % self.gp:
            raise ValueError(f"batch {B} x {N} nodes does not split into dp={self.dp} "
                             f"groups x gp={self.gp} shards")

    def fold(self, a: torch.Tensor) -> torch.Tensor:
        """(B, N, ...) -> (dp gp B/dp, S, ...), shard-major (a copy)."""
        B, N = a.shape[:2]
        self.check(B, N)
        dp, gp = self.dp, self.gp
        rest = tuple(a.shape[2:])
        st = a.reshape(dp, B // dp, gp, N // gp, *rest).transpose(1, 2)
        return st.reshape(B * gp, N // gp, *rest)

    def unfold(self, a: torch.Tensor) -> torch.Tensor:
        """Folded (dp gp Bl, X, ...) -> the stacked (dp, gp, Bl, X, ...) view."""
        return a.reshape(self.dp, self.gp, a.shape[0] // (self.dp * self.gp), *a.shape[1:])

    def gather(self, a: torch.Tensor) -> torch.Tensor:
        """Folded (dp gp Bl, S, ...) -> (B, N, ...): the all-gather over the
        graph axis that ends the trunk (a copy, no communication)."""
        st = self.unfold(a)
        dp, gp, Bl, S = st.shape[:4]
        return st.transpose(1, 2).reshape(dp * Bl, gp * S, *st.shape[4:])

    def fold_plan(self, a: torch.Tensor) -> torch.Tensor:
        """A padded-tier send table (B, gp, W) -> (dp gp B/dp, W), the rows of
        each local block in the folded order."""
        B, gp, W = a.shape
        if gp != self.gp or B % self.dp:
            raise ValueError(f"plan {tuple(a.shape)} does not fit {self}")
        return a.reshape(self.dp, B // self.dp, gp, W).transpose(1, 2).reshape(B * gp, W)

    def shard_protein(self, side: ProteinBatch) -> ProteinBatch:
        """Every per-node array of one side, folded."""
        return ProteinBatch(**{f.name: self.fold(getattr(side, f.name))
                               for f in dataclasses.fields(side)
                               if getattr(side, f.name) is not None})
