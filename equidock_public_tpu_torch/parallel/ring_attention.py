"""Ring cross-attention over the graph shards: the port of
`equidock_public_tpu/parallel/ring_attention.py::ring_cross_attention_local`.

Each shard keeps its query rows and one K/V chunk; over gp steps the
chunks rotate shard p -> p + 1 around the ring (`lax.ppermute` there, a
roll of the stacked shard axis here) while an online softmax folds one
chunk in per step, in the JAX package's order: the own chunk first, then
the chunk of shard p - 1, p - 2, ... The logit convention is the
reference's, `mask * (q.k) - 1000 * (1 - mask)`, with m0 = -inf and
acc / max(l, 1e-30) at the end. Plain tensor ops, as in the JAX package,
where this runs outside any Pallas kernel.
"""

from __future__ import annotations

import torch


def ring_cross_attention_local(q, k, v, q_mask, k_mask) -> torch.Tensor:
    """q (G, P, Bl, Nq, D) the local queries of each shard; k, v
    (G, P, Bl, Nk, D / Dv) each shard's K/V chunk; masks (G, P, Bl, Nq) and
    (G, P, Bl, Nk). Returns (G, P, Bl, Nq, Dv)."""
    gp = q.shape[1]
    lead = q.shape[:-1]
    m = torch.full(lead, float("-inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros(lead, dtype=q.dtype, device=q.device)
    acc = torch.zeros(lead + (v.shape[-1],), dtype=q.dtype, device=q.device)
    for step in range(gp):
        scores = torch.matmul(q, k.transpose(-1, -2))
        mask = q_mask[..., :, None] * k_mask[..., None, :]
        a = mask * scores - 1000.0 * (1.0 - mask)
        m_new = torch.maximum(m, a.amax(dim=-1))
        corr = torch.exp(m - m_new)
        e = torch.exp(a - m_new[..., None])
        l = l * corr + e.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(e, v)
        m = m_new
        if step < gp - 1:
            k, v, k_mask = (torch.roll(x, 1, dims=1) for x in (k, v, k_mask))
    return acc / torch.clamp(l, min=1e-30)[..., None]
