"""The (data, graph) mesh of the halo path, in one process on one device:
the port's counterpart of `equidock_public_tpu/parallel/mesh.py::make_mesh`
and of `shard_map` over `P("data", "graph")`.

Every shard lives on the mesh's one device, stacked on leading axes: a node
array (B, N, ...) of one side becomes (dp, gp, B/dp, S, ...) with
S = N / gp (data group g holds complexes g B/dp ... (g+1) B/dp - 1, as
`P("data")` cuts the batch; graph shard p holds nodes p S ... (p+1) S - 1).
The layer body runs once over the folded (dp gp B/dp, S, ...) blocks; the
ring kernels read and write the (dp, gp, ...) view of the same memory.
Shards on several devices (NCCL or peer copies between cards) are not
ported: a mesh that names more than one device raises.

The JAX package's SPMD specs (`protein_pspec`, `batch_pspec`,
`shard_batch`, `replicate`) serve `fit`'s mesh path, which is not ported.
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
    """dp data groups x gp graph shards, all on one device (the card unless
    the caller asks for the CPU)."""

    def __init__(self, dp: int = 1, gp: int = 1,
                 device: Optional[Union[DeviceLike, Sequence[DeviceLike]]] = None):
        if dp < 1 or gp < 1:
            raise ValueError(f"dp={dp}, gp={gp}: both must be at least 1")
        if isinstance(device, (list, tuple)):
            devs = {_resolve(d) for d in device}
            if len(devs) > 1:
                raise NotImplementedError(
                    f"shards on {len(devs)} devices ({sorted(map(str, devs))}): moving halo "
                    "rows between cards is not ported (ROADMAP A9); give one device")
            device = next(iter(devs)) if devs else None
        self.dp, self.gp = dp, gp
        self.device = _resolve(device)

    def __repr__(self) -> str:
        return f"ParallelMesh(dp={self.dp}, gp={self.gp}, device={self.device})"

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
