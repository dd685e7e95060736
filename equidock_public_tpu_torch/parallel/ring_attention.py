"""Ring cross-attention over the graph shards: the port of
`equidock_public_tpu/parallel/ring_attention.py` (`ring_cross_attention_local`,
`make_ring_cross_attention`).

Each shard keeps its query rows and one K/V chunk; over gp steps the
chunks rotate shard p -> p + 1 around the ring (`lax.ppermute` there) while
an online softmax folds one chunk in per step, in the JAX package's order:
the own chunk first, then the chunk of shard p - 1, p - 2, ... The logit
convention is the reference's, `mask * (q.k) - 1000 * (1 - mask)`, with
m0 = -inf and acc / max(l, 1e-30) at the end. Plain tensor ops, as in the
JAX package, where this runs outside any Pallas kernel. Stacked shards
rotate by a roll of the shard axis; shards that are ranks gather the
group's chunks by an all_reduce (`parallel/dist.py::gather_slots`) and fold
them in the same order.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


def _fold(q, q_mask, chunks: Iterable[Tuple], q_seg=None):
    """The online softmax over K/V chunks (k, v, k_mask, k_seg), in the
    order given. With segment ids (packed slots) only same-segment pairs
    count, as in the dense packed attention (`ops/attention.py`)."""
    lead = q.shape[:-1]
    m = l = acc = None
    for k, v, k_mask, k_seg in chunks:
        if m is None:
            m = torch.full(lead, float("-inf"), dtype=q.dtype, device=q.device)
            l = torch.zeros(lead, dtype=q.dtype, device=q.device)
            acc = torch.zeros(lead + (v.shape[-1],), dtype=q.dtype, device=q.device)
        scores = torch.matmul(q, k.transpose(-1, -2))
        mask = q_mask[..., :, None] * k_mask[..., None, :]
        if q_seg is not None:
            mask = mask * (q_seg[..., :, None] == k_seg[..., None, :]).to(mask.dtype)
        a = mask * scores - 1000.0 * (1.0 - mask)
        m_new = torch.maximum(m, a.amax(dim=-1))
        corr = torch.exp(m - m_new)
        e = torch.exp(a - m_new[..., None])
        l = l * corr + e.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(e, v)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def ring_cross_attention_local(q, k, v, q_mask, k_mask, q_seg=None, k_seg=None) -> torch.Tensor:
    """Stacked shards: q (G, P, Bl, Nq, D) the local queries of each shard;
    k, v (G, P, Bl, Nk, D / Dv) each shard's K/V chunk; masks (G, P, Bl,
    Nq) and (G, P, Bl, Nk); packed slots' segment ids shaped as the masks.
    Returns (G, P, Bl, Nq, Dv)."""
    gp = q.shape[1]
    roll = lambda a, s: None if a is None else torch.roll(a, s, dims=1)
    return _fold(q, q_mask, ((roll(k, s), roll(v, s), roll(k_mask, s), roll(k_seg, s))
                             for s in range(gp)), q_seg)


def ring_cross_attention_ranks(q, k, v, q_mask, k_mask, group, rank: int, gp: int,
                               q_seg=None, k_seg=None):
    """Shards that are ranks of `group` (this one `rank` of `gp`): q (Bl,
    Nq, D), k, v (Bl, Nk, .) this rank's chunk, masks (and packed slots'
    segment ids) alike. The chunks are gathered and folded own first, then
    rank - 1, rank - 2, ...; a rank's use of its peers' chunks sends their
    cotangents back in the backward."""
    from .dist import gather_slots

    ks, vs = gather_slots(k, group, rank, gp), gather_slots(v, group, rank, gp)
    kms = gather_slots(k_mask, group, rank, gp)
    kss = None if k_seg is None else gather_slots(k_seg, group, rank, gp)
    at = lambda s: (rank - s) % gp
    return _fold(q, q_mask, ((ks[at(s)], vs[at(s)], kms[at(s)],
                              None if kss is None else kss[at(s)]) for s in range(gp)), q_seg)


def make_ring_cross_attention(mesh):
    """fn(q, k, v, q_mask, k_mask) on whole (B, N, .) arrays: the batch cut
    over the mesh's data groups, the node axes over its graph shards, the
    ring attention on the shards, and the (B, Nq, Dv) result whole again
    (on every rank, across ranks). JAX's shard_map wrapper."""
    def fn(q, k, v, q_mask, k_mask):
        if not mesh.ranked:
            folded = [mesh.fold(a) for a in (q, k, v, q_mask, k_mask)]
            out = ring_cross_attention_local(*(mesh.unfold(a) for a in folded))
            return mesh.gather(out.reshape(folded[0].shape[:-1] + (v.shape[-1],)))
        from .dist import gather_slots

        rows = mesh.local_slice(q.shape[0])
        local = [mesh.local_nodes(a[rows]) for a in (q, k, v, q_mask, k_mask)]
        out = ring_cross_attention_ranks(*local, mesh.graph, mesh.p, mesh.gp)
        full = gather_slots(out, mesh.graph, mesh.p, mesh.gp, own_slot_grad=True)
        full = full.transpose(0, 1).reshape(out.shape[0], -1, out.shape[-1])
        if mesh.dp == 1:
            return full
        return gather_slots(full, mesh.world.group, mesh.world.rank, mesh.world.size,
                            own_slot_grad=True)[::mesh.gp].reshape(q.shape[:-1] + (-1,))
    return fn
