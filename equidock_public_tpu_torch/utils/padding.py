"""Padding-waste accounting for the bucketed batching policy, the port of
`equidock_public_tpu/utils/padding.py`: `waste_report` replays the chunking
of `DockingDataset.batches` (size-sorted chunks of bs, each side padded to
the bucket of its chunk's largest complex) over a list of complex sizes and
counts padded against real node slots (the same share of edge slots, E =
N K) and the distinct padded shapes; `compare_policies` scores several
bucket ladders on the same sizes; `waste_report_packed` replays packed
batches (`graph.plan_packing`). Host arithmetic only.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import bucket_for


def simulate_chunks(sizes_lr: Sequence[Tuple[int, int]], bs: int) -> List[List[Tuple[int, int]]]:
    """The chunks of a sorted epoch: by max(n_lig, n_rec), stable, bs a
    chunk, the last one filled with copies of its last complex (the shuffle
    changes no chunk's sizes and is left out)."""
    sizes = list(sizes_lr)
    order = np.argsort([max(l, r) for l, r in sizes], kind="stable")
    chunks = []
    for i in range(0, len(sizes), bs):
        chunk = [sizes[j] for j in order[i:i + bs]]
        while len(chunk) < bs:
            chunk.append(chunk[-1])
        chunks.append(chunk)
    return chunks


def waste_report(sizes_lr: Sequence[Tuple[int, int]], node_buckets: Sequence[int],
                 bs: int) -> Dict:
    """real_nodes, padded_nodes, waste_pct (the share of padded node slots
    that hold no residue), distinct_shapes (the (n_l bucket, n_r bucket)
    pairs of the epoch) and per_bucket rows (batches, real, padded,
    waste_pct of each bucket a side used)."""
    per_bucket: Dict[int, Dict[str, float]] = {}
    shapes = set()
    real_total = padded_total = 0
    for chunk in simulate_chunks(sizes_lr, bs):
        n_l = bucket_for(max(l for l, _ in chunk), tuple(node_buckets))
        n_r = bucket_for(max(r for _, r in chunk), tuple(node_buckets))
        shapes.add((n_l, n_r))
        real_total += sum(l + r for l, r in chunk)
        padded_total += len(chunk) * (n_l + n_r)
        for b in (n_l, n_r):
            per_bucket.setdefault(b, {"batches": 0, "real": 0, "padded": 0})
        for b, side in ((n_l, 0), (n_r, 1)):
            per_bucket[b]["batches"] += 1
            per_bucket[b]["real"] += sum(c[side] for c in chunk)
            per_bucket[b]["padded"] += len(chunk) * b
    for row in per_bucket.values():
        row["waste_pct"] = 100.0 * (1.0 - row["real"] / max(row["padded"], 1))
    return {"real_nodes": real_total, "padded_nodes": padded_total,
            "waste_pct": 100.0 * (1.0 - real_total / max(padded_total, 1)),
            "distinct_shapes": len(shapes), "per_bucket": dict(sorted(per_bucket.items()))}


def compare_policies(sizes_lr: Sequence[Tuple[int, int]], bs: int,
                     policies: Dict[str, Sequence[int]]) -> Dict[str, Dict]:
    """`waste_report` of each named bucket ladder on the same sizes."""
    return {name: waste_report(sizes_lr, buckets, bs) for name, buckets in policies.items()}


def waste_report_packed(sizes_lr: Sequence[Tuple[int, int]], node_buckets: Sequence[int],
                        bs: int, max_per_slot: int,
                        slot_count_buckets: Sequence[int] = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
                        ) -> Dict:
    """real_nodes, padded_nodes, waste_pct, slots and distinct_shapes of the
    packed batches: each chunk planned by `plan_packing`, its shape by
    `packed_shape` (slot count padded to its bucket)."""
    from ..graph import packed_shape, plan_packing

    shapes = set()
    real_total = padded_total = slot_total = 0
    for chunk in simulate_chunks(sizes_lr, bs):
        nl, nr = [l for l, _ in chunk], [r for _, r in chunk]
        slots = plan_packing(nl, nr, tuple(node_buckets), max_per_slot,
                             tuple(slot_count_buckets))
        B, b_l, b_r = packed_shape(slots, nl, nr, tuple(node_buckets), tuple(slot_count_buckets))
        shapes.add((B, b_l, b_r))
        real_total += sum(nl) + sum(nr)
        padded_total += B * (b_l + b_r)
        slot_total += B
    return {"real_nodes": real_total, "padded_nodes": padded_total,
            "waste_pct": 100.0 * (1.0 - real_total / max(padded_total, 1)),
            "slots": slot_total, "distinct_shapes": len(shapes)}
