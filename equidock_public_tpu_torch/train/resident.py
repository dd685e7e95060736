"""Device-resident epochs: the port of `equidock_public_tpu/train/resident.py`
on one device.

The cached split is padded, stacked and uploaded to the device once; an
epoch then sends only an index schedule, and the 50% role swap and the
uniform random pose of each complex are drawn and applied on the device
(`assemble_batch`). Pairs are grouped by `bucket_for(max(n_lig, n_rec))`
and BOTH sides pad to that bucket, so a swap is a masked select, not a
reshape. A group's epoch slice is cut into chunks (`_group_chunks`, the
JAX package's schedule bit for bit under one numpy seed): a metered prefix
whose predicted coordinates come back for the train RMSD, the rest, and
with `trim_remainder` the group's n % bs leftover pairs as one narrow step.
A chunk runs as a loop of the port's `train_step` (`train_chunk`); its
scalars stay stacked on the device until the whole epoch has been
dispatched (`_dispatch_group`, then `_sync_group`).

The draws. JAX draws them with `jax.random` inside its scan; the port takes
them from a draw source: `GeneratorDraws` (a `torch.Generator` on the
batch's device, one per purpose, seeded from `random_seed`, the epoch and a
tag: `make_generator`), or `ReplayDraws`, which hands out recorded
(swap, rot, tr) triples, one per step in order (the tests and chip_smoke
replay the JAX package's draws through it). Everything else about the
stream is the JAX package's: the bucket shuffle, the chunk order, the
metered prefix, the val and test schedules.

`run_train_epoch_resident_streamed` is the twin for corpora whose store
does not fit at once (DIPS): a producer thread materializes the next group
in pinned host memory and copies it on a side CUDA stream while the
current group trains; a group's tensors are dropped once its results are on
the host. The data-parallel twin is not ported (`build_resident_split_dp`,
`run_train_epoch_resident_dp` raise), and neither is a packed store (the
store is unpacked, as in the JAX package).

The train state's BatchNorm statistics go through every step and evaluation
as in the JAX package's scans; dropout above 0 draws its masks from a
generator of the epoch (`step.make_dropout`).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, bucket_for
from ..graph import PairBatch, ProteinBatch, pad_protein
from .meter import RmsdMeter, complex_rmsd
from .step import TrainState, eval_step, make_dropout, train_step

_SCALARS = ("loss", "ligand_coors_loss", "ot_loss", "intersection_loss")
# the stores are unpacked: every side field but the packed segment ids
_SIDE_FIELDS = tuple(f.name for f in dataclasses.fields(ProteinBatch) if f.name != "seg_id")
# One generator per purpose of the draws (`make_generator`).
DRAW_TAGS = {"train": 1, "val": 2, "test": 3}


@dataclasses.dataclass
class ResidentGroup:
    """All pairs of one bucket group padded to (N,) on both sides, stacked on
    a leading pair axis P."""

    lig: ProteinBatch           # (P, N, ...) bound coordinates in .x
    rec: ProteinBatch           # (P, N, ...)
    gt_lig: torch.Tensor        # (P, N, 3) bound ligand CA (the MSE target)
    gt_rec: torch.Tensor        # (P, N, 3) bound receptor CA (the target under swap)
    pocket: torch.Tensor        # (P, Pk, 3) pocket midpoints
    pocket_mask: torch.Tensor   # (P, Pk)

    def tensors(self) -> List[torch.Tensor]:
        return ([getattr(self.lig, f) for f in _SIDE_FIELDS]
                + [getattr(self.rec, f) for f in _SIDE_FIELDS]
                + [self.gt_lig, self.gt_rec, self.pocket, self.pocket_mask])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ResidentGroup":
        side = lambda pb: ProteinBatch(**{f: fn(getattr(pb, f)) for f in _SIDE_FIELDS})
        return ResidentGroup(lig=side(self.lig), rec=side(self.rec), gt_lig=fn(self.gt_lig),
                             gt_rec=fn(self.gt_rec), pocket=fn(self.pocket),
                             pocket_mask=fn(self.pocket_mask))


@dataclasses.dataclass
class HostMeta:
    """What the meter needs, kept on the host."""

    n_lig: List[int]
    n_rec: List[int]
    gt_lig: List[np.ndarray]    # unpadded (n_l, 3)
    gt_rec: List[np.ndarray]    # unpadded (n_r, 3) == bound receptor coordinates


@dataclasses.dataclass
class ResidentSplit:
    groups: Dict[int, ResidentGroup]       # bucket N -> tensors on the device
    metas: Dict[int, HostMeta]
    bs: int

    def nbytes(self) -> int:
        return sum(g.nbytes() for g in self.groups.values())


def _group_by_bucket(ds, cfg: Config) -> Dict[int, List[int]]:
    """Pair indices by the bucket of the larger side. For a streamed dataset
    each group is ordered by owning shard, so materializing it walks the
    shards in order through the LRU."""
    by_bucket: Dict[int, List[int]] = {}
    for i in range(len(ds.codes)):
        b = bucket_for(ds.pair_max_nodes(i), cfg.data.node_buckets)
        by_bucket.setdefault(b, []).append(i)
    if ds.index is not None:
        for idxs in by_bucket.values():
            idxs.sort(key=lambda i: ds.index.shard_of[i])
    return by_bucket


def _materialize_group(ds, cfg: Config, b: int, idxs: Sequence[int]
                       ) -> Tuple[ResidentGroup, HostMeta]:
    """One bucket group's pairs padded and stacked, as CPU tensors."""
    pk = bucket_for(max(ds.pocket_size(i) for i in idxs), cfg.data.pocket_buckets)
    sides: Dict[str, List[dict]] = {"lig": [], "rec": []}
    gts_l, gts_r, pockets, pmasks = [], [], [], []
    meta = HostMeta([], [], [], [])
    for i in idxs:
        s = ds.get_sample(i)
        sides["lig"].append(pad_protein(s.lig, b))
        sides["rec"].append(pad_protein(s.rec, b))
        for gts, gt in ((gts_l, s.gt_lig), (gts_r, s.gt_rec)):
            padded = np.zeros((b, 3), np.float32)
            padded[:gt.shape[0]] = gt
            gts.append(padded)
        p = np.zeros((pk, 3), np.float32)
        pm = np.zeros(pk, np.float32)
        p[:s.pocket.shape[0]] = s.pocket
        pm[:s.pocket.shape[0]] = 1.0
        pockets.append(p)
        pmasks.append(pm)
        meta.n_lig.append(s.lig.num_nodes)
        meta.n_rec.append(s.rec.num_nodes)
        meta.gt_lig.append(np.asarray(s.gt_lig, np.float32))
        meta.gt_rec.append(np.asarray(s.gt_rec, np.float32))
    t = lambda arrs: torch.from_numpy(np.stack(arrs))
    side = lambda cols: ProteinBatch(**{f: t([c[f] for c in cols]) for f in _SIDE_FIELDS})
    group = ResidentGroup(lig=side(sides["lig"]), rec=side(sides["rec"]), gt_lig=t(gts_l),
                          gt_rec=t(gts_r), pocket=t(pockets), pocket_mask=t(pmasks))
    return group, meta


def build_resident_split(ds, cfg: Config, device) -> ResidentSplit:
    """Group a materialized dataset by bucket, pad, stack and put each group
    on `device` once."""
    if cfg.data.pack:
        raise NotImplementedError("-pack with -device_resident: the resident store is unpacked")
    groups: Dict[int, ResidentGroup] = {}
    metas: Dict[int, HostMeta] = {}
    for b, idxs in sorted(_group_by_bucket(ds, cfg).items()):
        group, meta = _materialize_group(ds, cfg, b, idxs)
        groups[b] = group.map(lambda x: x.to(device))
        metas[b] = meta
    return ResidentSplit(groups=groups, metas=metas, bs=cfg.train.bs)


# --------------------------------------------------------------------------- #
# Augmentation on the device
# --------------------------------------------------------------------------- #

def make_generator(seed: int, purpose: str, epoch: int, device) -> torch.Generator:
    """A generator on `device` for one purpose's draws (`DRAW_TAGS`) in one
    epoch, seeded from (seed, tag, epoch) as the meter's generator is from
    (seed, 7919, epoch)."""
    state = np.random.SeedSequence([seed, DRAW_TAGS[purpose], epoch]).generate_state(2)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


def random_rotations(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, 3, 3) uniform rotations from normalized normal quaternions."""
    q = torch.randn((n, 4), generator=gen, device=gen.device)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def draw_augmentations(gen: torch.Generator, bs: int, do_swap: bool,
                       translation_interval: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(swap_flag (bs,) bool, rot (bs, 3, 3), tr (bs, 3)) on the generator's
    device: a fair coin per pair (all False without `do_swap`), a uniform
    rotation, and a translation of uniform direction and length
    U(0, translation_interval)."""
    dev = gen.device
    swap = (torch.rand(bs, generator=gen, device=dev) < 0.5) if do_swap else \
        torch.zeros(bs, dtype=torch.bool, device=dev)
    rot = random_rotations(gen, bs)
    d = torch.randn((bs, 3), generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    tr = d * (torch.rand((bs, 1), generator=gen, device=dev) * translation_interval)
    return swap, rot, tr


class GeneratorDraws:
    """A draw source: each step's (swap, rot, tr) from one generator."""

    def __init__(self, gen: torch.Generator, translation_interval: float):
        self.gen, self.translation_interval = gen, translation_interval

    def draw(self, width: int, do_swap: bool):
        return draw_augmentations(self.gen, width, do_swap, self.translation_interval)


class ReplayDraws:
    """A draw source that hands out recorded (swap, rot, tr) triples (any
    array type), one a step in order, on `device`; a step of another width
    than the recorded one raises."""

    def __init__(self, triples: Sequence, device):
        self.triples, self.device, self.used = list(triples), torch.device(device), 0

    def draw(self, width: int, do_swap: bool):
        if self.used >= len(self.triples):
            raise IndexError(f"replay: {len(self.triples)} draws recorded, step "
                             f"{self.used + 1} asked for one")
        swap, rot, tr = self.triples[self.used]
        self.used += 1
        t = lambda a, dtype: torch.as_tensor(np.array(a), dtype=dtype, device=self.device)
        swap, rot, tr = t(swap, torch.bool), t(rot, torch.float32), t(tr, torch.float32)
        if swap.shape[0] != width:
            raise ValueError(f"replay step {self.used}: {swap.shape[0]} draws recorded "
                             f"for a step of {width} pairs")
        return swap, rot, tr


def draws_factory(cfg: Config, device) -> Callable[[str, int], GeneratorDraws]:
    """(purpose, epoch) -> the generator draw source `fit` uses by default."""
    return lambda purpose, epoch: GeneratorDraws(
        make_generator(cfg.train.random_seed, purpose, epoch, device),
        cfg.graph.translation_interval)


def assemble_batch(store: ResidentGroup, idx: torch.Tensor, valid: torch.Tensor,
                   swap_flag: torch.Tensor, rigid: Tuple[torch.Tensor, torch.Tensor]
                   ) -> PairBatch:
    """Gather the `idx` rows of the store, swap the roles where `swap_flag`
    says and move the ligand side by `rigid` (rot, tr) about its centroid,
    all on the device; slots with `valid` 0 are masked out."""
    bs = idx.shape[0]
    g = store.map(lambda t: t.index_select(0, idx))

    def sel(a, b):
        return torch.where(swap_flag.reshape((bs,) + (1,) * (a.dim() - 1)), a, b)

    lig = ProteinBatch(**{f: sel(getattr(g.rec, f), getattr(g.lig, f)) for f in _SIDE_FIELDS})
    rec = ProteinBatch(**{f: sel(getattr(g.lig, f), getattr(g.rec, f)) for f in _SIDE_FIELDS})
    gt = sel(g.gt_rec, g.gt_lig)
    rot, tr = rigid
    mask = lig.node_mask                                            # (bs, N)
    mean = ((lig.x * mask[..., None]).sum(dim=1)
            / torch.clamp(mask.sum(dim=1), min=1.0)[..., None])     # (bs, 3)
    new_x = torch.einsum("bij,bnj->bni", rot, lig.x - mean[:, None]) + tr[:, None]
    new_x = new_x * mask[..., None]
    pocket_lig = torch.einsum("bij,bpj->bpi", rot, g.pocket - mean[:, None]) + tr[:, None]
    v = valid.to(torch.float32)
    lig = dataclasses.replace(lig, x=new_x, node_mask=lig.node_mask * v[:, None],
                              nbr_mask=lig.nbr_mask * v[:, None, None])
    rec = dataclasses.replace(rec, node_mask=rec.node_mask * v[:, None],
                              nbr_mask=rec.nbr_mask * v[:, None, None])
    pk_mask = g.pocket_mask * v[:, None]
    return PairBatch(lig=lig, rec=rec, gt_lig=gt, pocket_lig=pocket_lig * pk_mask[..., None],
                     pocket_rec=g.pocket * pk_mask[..., None], pocket_mask=pk_mask, pair_mask=v)


# --------------------------------------------------------------------------- #
# Chunk runners: a loop of the port's steps over a chunk's rows
# --------------------------------------------------------------------------- #

def train_chunk(state: TrainState, store: ResidentGroup, idx: torch.Tensor,
                valid: torch.Tensor, draws, lr_scale: torch.Tensor, cfg: Config,
                do_swap: bool, emit_coords: bool = True, drop=None):
    """S train steps over the rows of idx / valid (S, w), on the device.
    Returns (state, outs): the loss terms and `clipped` stacked (S,), and
    with `emit_coords` the predicted ligand coordinates (S, w, N, 3) and the
    swap flags (S, w); nothing is read back here."""
    outs: Dict[str, list] = {k: [] for k in _SCALARS + ("clipped",)}
    coords, swaps = [], []
    for s in range(idx.shape[0]):
        swap, rot, tr = draws.draw(idx.shape[1], do_swap)
        state, m = train_step(state, assemble_batch(store, idx[s], valid[s], swap, (rot, tr)),
                              cfg, lr_scale, drop=drop)
        for k in outs:
            outs[k].append(m[k])
        if emit_coords:
            coords.append(m["ligand_coords"])
            swaps.append(swap)
    stacked = {k: torch.stack(v) for k, v in outs.items()}
    if emit_coords:
        stacked["coords"], stacked["swap"] = torch.stack(coords), torch.stack(swaps)
    return state, stacked


def eval_chunk(params, store: ResidentGroup, idx: torch.Tensor, valid: torch.Tensor,
               draws, cfg: Config, bn_state: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """S forwards without gradient (no swap, a fresh pose each): the loss
    terms (S,) and the predicted ligand coordinates (S, w, N, 3)."""
    outs: Dict[str, list] = {k: [] for k in _SCALARS + ("coords",)}
    for s in range(idx.shape[0]):
        swap, rot, tr = draws.draw(idx.shape[1], False)
        m = eval_step(params, assemble_batch(store, idx[s], valid[s], swap, (rot, tr)), cfg,
                      bn_state)
        for k in _SCALARS:
            outs[k].append(m[k])
        outs["coords"].append(m["ligand_coords"])
    return {k: torch.stack(v) for k, v in outs.items()}


# --------------------------------------------------------------------------- #
# The schedule (numpy, the JAX package's bit for bit) and the metering
# --------------------------------------------------------------------------- #

def _schedule(n: int, bs: int, rng: Optional[np.random.Generator]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(S, bs) index plan and validity; the last step padded with repeats."""
    order = (rng.permutation(n) if rng is not None else np.arange(n)).astype(np.int32)
    S = -(-n // bs)
    idx = np.zeros((S, bs), np.int32)
    valid = np.zeros((S, bs), np.float32)
    flat = np.concatenate([order, np.full(S * bs - n, order[-1], np.int32)])
    idx[:] = flat.reshape(S, bs)
    valid.reshape(-1)[:n] = 1.0
    return idx, valid


def _group_chunks(n: int, bs: int, rng: np.random.Generator,
                  meter_rng: np.random.Generator, frac: float,
                  trim: bool) -> Tuple[list, int]:
    """One group's shuffled epoch slice cut into chunks [(idx (s, w) int32,
    valid (s, w) f32, emit_coords)] and the step count S = ceil(n / bs).

    trim=False: S steps of width bs, the last padded with repeats (valid
    0), all S permuted and the first round(S * frac) (at least 1) metered.
    trim=True: the n % bs leftover pairs run as one (1, r) step with no
    dead slots, after the full steps and never metered unless it is the
    group's only step; the membership of the steps and the update are the
    same (dead slots add nothing to the pair_mask-normalized loss)."""
    if not trim:
        idx, valid = _schedule(n, bs, rng)
        S = idx.shape[0]
        k_c = max(1, round(S * frac))
        perm = meter_rng.permutation(S).astype(np.int64)
        idx, valid = idx[perm], valid[perm]
        chunks = [(idx[:k_c], valid[:k_c], True)]
        if k_c < S:
            chunks.append((idx[k_c:], valid[k_c:], False))
        return chunks, S
    order = (rng.permutation(n) if rng is not None else np.arange(n)).astype(np.int32)
    s_full, r = divmod(n, bs)
    S = s_full + (1 if r else 0)
    k_c = max(1, round(S * frac))
    if s_full == 0:
        return [(order.reshape(1, n), np.ones((1, n), np.float32), True)], S
    idx = order[: s_full * bs].reshape(s_full, bs)
    perm = meter_rng.permutation(s_full).astype(np.int64)
    idx = idx[perm]
    k_m = min(k_c, s_full)
    chunks = [(idx[:k_m], np.ones((k_m, bs), np.float32), True)]
    if k_m < s_full:
        chunks.append((idx[k_m:], np.ones((s_full - k_m, bs), np.float32), False))
    if r:
        chunks.append((order[s_full * bs:].reshape(1, r), np.ones((1, r), np.float32), False))
    return chunks, S


def _eval_parts(n: int, bs: int, trim: bool) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The eval schedule of one group, unshuffled: the padded plan, or with
    `trim` the full steps and one (1, r) step."""
    if not trim:
        return [_schedule(n, bs, rng=None)]
    s_full, r = divmod(n, bs)
    order = np.arange(n, dtype=np.int32)
    parts = []
    if s_full:
        parts.append((order[: s_full * bs].reshape(s_full, bs),
                      np.ones((s_full, bs), np.float32)))
    if r:
        parts.append((order[s_full * bs:].reshape(1, r), np.ones((1, r), np.float32)))
    return parts


def _meter_rows(meter: RmsdMeter, meta: HostMeta, idx: np.ndarray, valid: np.ndarray,
                coords: np.ndarray, swap: Optional[np.ndarray],
                meter_interface: bool) -> None:
    """Meter one step's pairs from the predicted coordinates and the host's
    ground truth."""
    for b in range(idx.shape[0]):
        if valid[b] == 0:
            continue
        j = int(idx[b])
        if swap is not None and swap[b]:
            lt, rt = meta.gt_rec[j], meta.gt_lig[j]
        else:
            lt, rt = meta.gt_lig[j], meta.gt_rec[j]
        lp = coords[b, :lt.shape[0]]
        meter.update(lp, rt, lt, rt)
        if meter_interface:
            d = np.linalg.norm(lt[:, None, :] - rt[None, :, :], axis=-1)
            ai, aj = np.where(d < 8.0)
            if ai.size:
                meter.interface.append(complex_rmsd(lp[ai], rt[aj], lt[ai], rt[aj])[2])


def _device_of(state: TrainState) -> torch.device:
    return state.mu[next(iter(state.mu))].device


def _dispatch_group(state: TrainState, store: ResidentGroup, meta: HostMeta, bs: int,
                    cfg: Config, rng: np.random.Generator, meter_rng: np.random.Generator,
                    draws, swap: bool, scale: torch.Tensor, drop=None
                    ) -> Tuple[TrainState, int, list]:
    """Run one group's chunks without reading a result back. Returns
    (state, steps, pending [(outs on the device, idx, valid, emit)])."""
    chunks, S = _group_chunks(len(meta.n_lig), bs, rng, meter_rng,
                              cfg.train.train_rmsd_fraction, cfg.train.trim_remainder)
    dev = scale.device
    pending = []
    for idx, valid, emit in chunks:
        state, outs = train_chunk(
            state, store, torch.from_numpy(idx.astype(np.int64)).to(dev),
            torch.from_numpy(valid).to(dev), draws, scale, cfg, swap, emit_coords=emit,
            drop=drop)
        pending.append((outs, idx, valid, emit))
    return state, S, pending


def _sync_group(pending: list, meta: HostMeta, meter: RmsdMeter,
                sums: Dict[str, float]) -> int:
    """The host side of `_dispatch_group`: the scalars summed, the metered
    chunks' coordinates metered. Returns the group's clip count."""
    n_clips = 0
    for outs, idx, valid, emit in pending:
        host = {k: outs[k].cpu().numpy() for k in _SCALARS + ("clipped",)}
        for k in _SCALARS:
            sums[k] = sums.get(k, 0.0) + float(host[k].sum())
        n_clips += int(host["clipped"].sum())
        if emit:
            coords, swaps = outs["coords"].cpu().numpy(), outs["swap"].cpu().numpy()
            for si in range(idx.shape[0]):
                _meter_rows(meter, meta, idx[si], valid[si], coords[si], swaps[si],
                            meter_interface=False)
    return n_clips


def _run_group(state, store, meta, bs, cfg, rng, meter_rng, draws, swap, scale,
               meter, sums, drop=None) -> Tuple[TrainState, int, int]:
    """One group's train-epoch slice, dispatched and read: (state, steps,
    clips). Shared by the whole and the streamed runners."""
    state, S, pending = _dispatch_group(state, store, meta, bs, cfg, rng, meter_rng,
                                        draws, swap, scale, drop)
    return state, S, _sync_group(pending, meta, meter, sums)


def _train_averages(sums, meter, num_batches, num_clips) -> Dict[str, float]:
    avg = {k: v / max(num_batches, 1) for k, v in sums.items()}
    _, _, crmsd_median = meter.summarize("median")
    _, _, crmsd_mean = meter.summarize("mean")
    avg.update(complex_rmsd_median=crmsd_median, complex_rmsd_mean=crmsd_mean,
               num_clips=num_clips, num_batches=num_batches)
    return avg


def run_train_epoch_resident(state: TrainState, rs: ResidentSplit, cfg: Config,
                             rng: np.random.Generator, draws, epoch: int, log=print,
                             lr_scale: float = 1.0, do_swap: Optional[bool] = None
                             ) -> Tuple[TrainState, Dict[str, float]]:
    """A train epoch on the resident store: the groups in an order shuffled
    by `rng`, every group's chunks dispatched before any result is read.
    Returns (state, averages) as `loop.run_train_epoch` does."""
    meter_rng = np.random.default_rng((cfg.train.random_seed, 7919, epoch))
    meter, sums = RmsdMeter(), {}
    scale = torch.tensor(lr_scale, dtype=torch.float32, device=_device_of(state))
    drop = make_dropout(cfg, _device_of(state), epoch)
    buckets = list(rs.groups)
    rng.shuffle(buckets)
    swap = cfg.data.swap_train if do_swap is None else do_swap
    num_batches, deferred = 0, []
    for b in buckets:
        state, S, pending = _dispatch_group(state, rs.groups[b], rs.metas[b], rs.bs, cfg,
                                            rng, meter_rng, draws, swap, scale, drop)
        num_batches += S
        deferred.append((pending, rs.metas[b]))
    num_clips = sum(_sync_group(pending, meta, meter, sums) for pending, meta in deferred)
    return state, _train_averages(sums, meter, num_batches, num_clips)


def run_eval_epoch_resident(params, rs: ResidentSplit, cfg: Config, draws,
                            repeats: int = 1, bn_state: Optional[dict] = None
                            ) -> Dict[str, float]:
    """An evaluation epoch on the resident store: each repeat draws fresh
    poses; per repeat the loss terms averaged and the RMSD medians and
    means, then the mean over repeats (the loop's `val_repeats`). BatchNorm
    normalises by the running statistics `bn_state`."""
    reps: List[Dict[str, float]] = [dict() for _ in range(repeats)]
    meters = [RmsdMeter() for _ in range(repeats)]
    counts = [0] * repeats
    dev = next(iter(rs.groups.values())).gt_lig.device if rs.groups else None
    for b, store in rs.groups.items():
        meta = rs.metas[b]
        for idx, valid in _eval_parts(len(meta.n_lig), rs.bs, cfg.train.trim_remainder):
            S = idx.shape[0]
            outs = eval_chunk(params, store,
                              torch.from_numpy(np.tile(idx, (repeats, 1)).astype(np.int64)).to(dev),
                              torch.from_numpy(np.tile(valid, (repeats, 1))).to(dev), draws, cfg,
                              bn_state)
            host = {k: v.cpu().numpy() for k, v in outs.items()}
            for r in range(repeats):
                for s in range(S):
                    row = r * S + s
                    for k in _SCALARS:
                        reps[r][k] = reps[r].get(k, 0.0) + float(host[k][row])
                    counts[r] += 1
                    _meter_rows(meters[r], meta, idx[s], valid[s], host["coords"][row], None,
                                meter_interface=True)
    out_reps = []
    for r in range(repeats):
        avg = {k: v / max(counts[r], 1) for k, v in reps[r].items()}
        m = meters[r]
        lig_med, _, crmsd_median = m.summarize("median")
        lig_mean, _, crmsd_mean = m.summarize("mean")
        avg.update(complex_rmsd_median=crmsd_median, complex_rmsd_mean=crmsd_mean,
                   ligand_rmsd_median=lig_med, ligand_rmsd_mean=lig_mean,
                   interface_rmsd_median=m.summarize_interface("median"),
                   interface_rmsd_mean=m.summarize_interface("mean"))
        out_reps.append(avg)
    return {k: float(np.mean([r[k] for r in out_reps])) for k in out_reps[0]}


# --------------------------------------------------------------------------- #
# Streamed resident epochs
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class StreamedResidentSplit:
    """The plan of streamed resident epochs: the dataset stays on the host
    (materialized or shard-streamed), groups are made and uploaded per
    epoch."""

    ds: object
    by_bucket: Dict[int, List[int]]
    bs: int

    @classmethod
    def build(cls, ds, cfg: Config) -> "StreamedResidentSplit":
        return cls(ds=ds, by_bucket=_group_by_bucket(ds, cfg), bs=cfg.train.bs)


def _upload(group: ResidentGroup, device, stream):
    """(group on `device`, event after its copy): from pinned memory on
    `stream` for the card, else a plain copy and no event."""
    if device.type != "cuda":
        return group.map(lambda t: t.to(device)), None
    pinned = group.map(lambda t: t.pin_memory())
    with torch.cuda.stream(stream):
        dev = pinned.map(lambda t: t.to(device, non_blocking=True))
        event = torch.cuda.Event()
        event.record(stream)
    return dev, event


def run_train_epoch_resident_streamed(
        state: TrainState, srs: StreamedResidentSplit, cfg: Config,
        rng: np.random.Generator, draws, epoch: int, log=print, lr_scale: float = 1.0,
        do_swap: Optional[bool] = None) -> Tuple[TrainState, Dict[str, float]]:
    """The streamed twin of `run_train_epoch_resident`: a producer thread
    materializes and uploads the next group (at most one waiting) while
    the current one trains; each group is read back and dropped
    before the next starts. Same schedule, draws and update as the whole
    runner."""
    meter_rng = np.random.default_rng((cfg.train.random_seed, 7919, epoch))
    meter, sums = RmsdMeter(), {}
    dev = _device_of(state)
    scale = torch.tensor(lr_scale, dtype=torch.float32, device=dev)
    drop = make_dropout(cfg, dev, epoch)
    buckets = list(srs.by_bucket)
    rng.shuffle(buckets)
    swap = cfg.data.swap_train if do_swap is None else do_swap
    side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=1)
    end = object()

    def producer():
        try:
            for b in buckets:
                group, meta = _materialize_group(srs.ds, cfg, b, srs.by_bucket[b])
                q.put((b, *_upload(group, dev, side), meta))
        except Exception as e:                      # handed to the consumer
            q.put(e)
        finally:
            q.put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    num_batches = num_clips = 0
    while True:
        item = q.get()
        if item is end:
            break
        if isinstance(item, Exception):
            raise item
        b, store, event, meta = item
        if event is not None:
            main = torch.cuda.current_stream(dev)
            main.wait_event(event)
            for t in store.tensors():       # freed blocks wait for this stream's work
                t.record_stream(main)
        state, S, clips = _run_group(state, store, meta, srs.bs, cfg, rng, meter_rng, draws,
                                     swap, scale, meter, sums, drop)
        num_batches += S
        num_clips += clips
        del store, item                     # its results are on the host now
    thread.join()                           # and with it the producer's last group
    return state, _train_averages(sums, meter, num_batches, num_clips)


def build_resident_split_dp(*a, **kw):
    raise NotImplementedError("dp-resident epochs (the store's pair axis sharded over "
                              "dp devices) are not ported")


def run_train_epoch_resident_dp(*a, **kw):
    raise NotImplementedError("dp-resident epochs (the store's pair axis sharded over "
                              "dp devices) are not ported")
