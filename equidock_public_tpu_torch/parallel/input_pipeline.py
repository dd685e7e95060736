"""The multi-host input pipeline: the port of
`equidock_public_tpu/parallel/input_pipeline.py` (`global_batch_schedule`,
`host_sharded_batches`), with each rank as JAX's "host".

Every rank collates only its share of the global batch, padded to the
shape every rank agrees on without communication:
  1. every rank holds the whole sample list and the same seeded generator;
  2. every epoch, every rank computes the same global schedule (shuffle,
     size sort, chunks, shuffled chunks) and the same padded bucket shape
     a batch (from the chunk's maxima);
  3. rank h collates rows [h B/H, (h+1) B/H) of each global batch, its
     augmentation drawn from `default_rng((aug_seed, step, index))`, so it
     depends on neither the schedule's rank nor its position.
Pure host code, bit-equal to the JAX package's. `local_rows` cuts a batch
that every rank collated whole (`fit`'s mesh path, which keeps the
single-device run's draws) to the rank's rows instead.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np
import torch

from ..config import bucket_for
from ..data.dataset import DockingDataset
from ..graph import PairBatch, ProteinBatch, collate


def global_batch_schedule(ds: DockingDataset, rng: np.random.Generator, bs: int,
                          shuffle: bool = True, sort_by_size: bool = True
                          ) -> List[Tuple[np.ndarray, Tuple[int, int, int]]]:
    """[(global sample indices, (N_l, N_r, P) bucket shape)] of an epoch,
    the same on every rank for the same generator state. The shapes use
    each pair's larger side, so they do not depend on the swap."""
    order = np.arange(len(ds))
    if shuffle:
        rng.shuffle(order)
    if sort_by_size:
        sizes = np.array([ds.pair_max_nodes(int(i)) for i in order])
        order = order[np.argsort(sizes, kind="stable")]
    chunks = [order[i:i + bs] for i in range(0, len(order), bs)]
    if shuffle:
        rng.shuffle(chunks)
    nb, pb = ds.cfg.data.node_buckets, ds.cfg.data.pocket_buckets
    out = []
    for chunk in chunks:
        n_max = max(ds.pair_max_nodes(int(i)) for i in chunk)
        p_max = max(ds.pocket_size(int(i)) for i in chunk)
        out.append((chunk, (bucket_for(n_max, nb), bucket_for(n_max, nb),
                            bucket_for(p_max, pb))))
    return out


def host_sharded_batches(ds: DockingDataset, rng: np.random.Generator, global_bs: int,
                         process_index: int, process_count: int, aug_seed: int = 1234,
                         device="cpu") -> Iterator[PairBatch]:
    """This rank's (`process_index` of `process_count`) share of each global
    batch, padded to the globally agreed shape, on `device`."""
    h, H = process_index, process_count
    if global_bs % H:
        raise ValueError(f"global batch {global_bs} does not split into {H} ranks")
    local_bs = global_bs // H
    for step, (chunk, (n_l, n_r, P)) in enumerate(global_batch_schedule(ds, rng, global_bs)):
        local_idx = chunk[h * local_bs:(h + 1) * local_bs]
        if len(local_idx) == 0:
            local_idx = chunk[:1]             # a short last chunk: masked copies
        items = [ds.sample(int(i), np.random.default_rng((aug_seed, step, int(i))))
                 for i in local_idx]
        ligs, recs, new_xs, gts, pls, prs = zip(*items)
        yield collate(ligs, recs, new_xs, gts, pls, prs, (max(n_l, n_r),), (P,),
                      torch.device(device), batch_size=local_bs, pad_cache=ds.pad_cache)


def slice_rows(batch: PairBatch, rows: slice) -> PairBatch:
    """Rows of every per-slot array of a batch (packed ones too)."""
    cut = lambda t: t[rows] if isinstance(t, torch.Tensor) else t
    side = lambda pb: ProteinBatch(**{f.name: cut(getattr(pb, f.name))
                                      for f in dataclasses.fields(pb)})
    return PairBatch(lig=side(batch.lig), rec=side(batch.rec),
                     **{f.name: cut(getattr(batch, f.name)) for f in dataclasses.fields(batch)
                        if f.name not in ("lig", "rec")})


def local_rows(batch: PairBatch, mesh) -> PairBatch:
    """The rows of a whole batch that this rank's data group holds (as
    `P("data")` cuts it)."""
    return slice_rows(batch, mesh.local_slice(batch.pair_mask.shape[0]))
