"""Ranks as processes: the port's counterpart of
`equidock_public_tpu/parallel/train.py::distributed_initialize_if_needed`
and of the device list `parallel/mesh.py::make_mesh` reshapes.

Every rank is one process with one device. `init_from_env` reads what
torchrun exports (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`,
`MASTER_ADDR` / `MASTER_PORT`), or, for the port's own launcher
(`parallel/launch.py`), `EQUIDOCK_DIST_STORE`, the path of a `FileStore`,
so that concurrent test workers never race for TCP ports. A rank's device
is `cuda:(LOCAL_RANK % cards)` unless the caller asks for the CPU.

The backend follows one rule, printed when the group starts
(`choose_backend`): gloo on the CPU and wherever two ranks of the host
share a card (NCCL refuses two ranks on one device), NCCL where every
rank has a card of its own. It is never chosen by catching NCCL's error.
gloo takes only `broadcast` and `all_reduce` on CUDA tensors, so every
collective the port issues on CUDA tensors is one of those two (a gather is
an `all_reduce` of a buffer that is zero outside the rank's slot), or it
reads the peers' memory directly (`ops/cuda/halo_ring.py::PeerArena`);
object collectives and host barriers run on a gloo group over the CPU
(`World.cpu_group`, the world group itself under gloo).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

DEFAULT_TIMEOUT_S = 60.0
STORE_ENV = "EQUIDOCK_DIST_STORE"


def choose_backend(device: torch.device, local_world: int, cards: int) -> Tuple[str, str]:
    """(backend, the reason): the rule of the module docstring."""
    if device.type != "cuda":
        return "gloo", f"ranks on {device.type}"
    if local_world > cards:
        return "gloo", f"{local_world} ranks share {cards} card(s) of this host"
    return "nccl", f"each of {local_world} ranks has a card of its own"


@dataclasses.dataclass
class World:
    """This process's place among the ranks. `group` is None for a world of
    one (no process group: the one-process stacked form)."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    backend: str = "none"
    timeout_s: float = DEFAULT_TIMEOUT_S
    group: Optional[object] = None
    cpu_group: Optional[object] = None
    # the process-group ranks of this world's ranks 0 .. size - 1 (a part of
    # the processes, `sub`); None: all of them, in order
    members: Optional[Tuple[int, ...]] = None
    _groups: Dict[Tuple[int, ...], Tuple[object, object]] = dataclasses.field(
        default_factory=dict)
    _parent: Optional["World"] = None

    def new_group(self, ranks: Sequence[int]) -> Tuple[object, object]:
        """(group, its gloo twin for host barriers and objects) over this
        world's `ranks`. Only the members call it (local synchronization),
        each member in the same order as the others."""
        if self._parent is not None:
            return self._parent.new_group([self.members[r] for r in ranks])
        key = tuple(ranks)
        if key not in self._groups:
            to = datetime.timedelta(seconds=self.timeout_s)
            g = dist.new_group(list(key), timeout=to, backend=self.backend,
                               use_local_synchronization=True)
            cg = g if self.backend == "gloo" else dist.new_group(
                list(key), timeout=to, backend="gloo", use_local_synchronization=True)
            self._groups[key] = (g, cg)
        return self._groups[key]

    def sub(self, ranks: Sequence[int]) -> "World":
        """The world of `ranks` of this one (this rank among them), e.g. a
        two-rank mesh inside a larger launch."""
        ranks = tuple(ranks)
        if self.rank not in ranks:
            raise ValueError(f"rank {self.rank} is not in {ranks}")
        g, cg = self.new_group(ranks)
        glob = tuple(self.members[r] for r in ranks) if self.members else ranks
        root = self._parent or self
        return World(ranks.index(self.rank), len(ranks), self.local_rank, self.device,
                     self.backend, self.timeout_s, g, cg, members=glob, _parent=root)

    def close(self) -> None:
        if self._parent is None and self.group is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.group = self.cpu_group = None
        self._groups.clear()


def init_from_env(device=None, store_path: Optional[str] = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S, env=None, log=print) -> World:
    """Join the ranks the environment describes (a world of one when it
    names none). `store_path` (default `$EQUIDOCK_DIST_STORE`) rendezvous
    through a FileStore, else `env://` (torchrun's MASTER_ADDR / PORT).
    Every group is made with `timeout_s`, so a lost rank fails its peers."""
    env = os.environ if env is None else env
    rank, size = int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", size))
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    if size == 1:
        return World(device=dev, timeout_s=timeout_s)
    backend, why = choose_backend(dev, local_world,
                                  torch.cuda.device_count() if dev.type == "cuda" else 0)
    to = datetime.timedelta(seconds=timeout_s)
    store_path = store_path or env.get(STORE_ENV)
    if store_path:
        dist.init_process_group(backend, store=dist.FileStore(store_path, size), rank=rank,
                                world_size=size, timeout=to)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size,
                                timeout=to)
    if rank == 0:
        log(f"ranks: world {size}, backend {backend} ({why}), device of rank 0 {dev}")
    world = World(rank, size, local_rank, dev, backend, timeout_s, dist.group.WORLD)
    world.cpu_group = (world.group if backend == "gloo"
                       else dist.new_group(list(range(size)), timeout=to, backend="gloo"))
    return world


def host_barrier(cpu_group) -> None:
    """Every rank of the group has reached this point (gloo, on the host;
    None: a group of one)."""
    if cpu_group is not None:
        dist.barrier(group=cpu_group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group` (None: a group of one, nothing to do)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group, on every rank; its transpose is the
    same sum of the cotangents (every rank consumes y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over the ranks of `group`."""
    return _AllReduceSum.apply(x, group)


class _GatherSlots(torch.autograd.Function):
    """(gp, *x.shape): every rank's x in its slot, by an all_reduce of a
    buffer that is zero outside this rank's slot (gloo takes that on CUDA
    tensors). `own_slot_grad`: the transpose takes this rank's slot of the
    cotangent alone (the gathered value feeds computation that every rank
    repeats, so each rank seeds only its own part); else the cotangents are
    summed over the group first (each rank's use of the peers' slots is its
    own)."""

    @staticmethod
    def forward(ctx, x, group, slot, n, own_slot_grad):
        ctx.group, ctx.slot, ctx.own = group, slot, own_slot_grad
        buf = x.new_zeros((n,) + tuple(x.shape))
        buf[slot] = x
        return all_reduce_(buf, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if not ctx.own:
            g = all_reduce_(g.clone(), ctx.group)
        return g[ctx.slot].clone(), None, None, None, None


def gather_slots(x: torch.Tensor, group, slot: int, n: int,
                 own_slot_grad: bool = False) -> torch.Tensor:
    """Differentiable all-gather of `x` over `group` into (n, *x.shape)."""
    return _GatherSlots.apply(x, group, slot, n, own_slot_grad)


class _ScatterOwn(torch.autograd.Function):
    """x (n, *s) repeated on every rank -> x[slot]; the transpose sums the
    ranks' cotangents, each zero outside its slot."""

    @staticmethod
    def forward(ctx, x, group, slot):
        ctx.group, ctx.slot, ctx.shape = group, slot, x.shape
        return x[slot].clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.slot] = g
        return all_reduce_(full, ctx.group), None, None


def scatter_own(x: torch.Tensor, group, slot: int) -> torch.Tensor:
    """This rank's slot of a value every rank of `group` holds alike."""
    return _ScatterOwn.apply(x, group, slot)


def broadcast_object(obj, world: World, src: int = 0):
    """`obj` of the world's rank `src` on every rank (host objects, gloo)."""
    if world.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=world.members[src] if world.members else src,
                               group=world.cpu_group)
    return box[0]
