"""Attention strategies over the sequence — counterpart of
``ai4e_tpu/parallel/ring_attention.py``.

Only ``reference_attention``, the plain single-device ``"full"`` strategy,
is ported. Ring attention and Ulysses all-to-all shard a sequence over a
device mesh; they come with the parallel plane (ROADMAP A15).
"""

from __future__ import annotations

import torch

PARALLEL_PLANE = "is not ported yet (ROADMAP A15, the parallel plane)"


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Plain full attention in q's dtype, as the JAX package computes it:
    scores = q.k^T * D**-0.5, ``-inf`` above the diagonal when causal,
    softmax, then the weighted sum of v. Shapes: q (B, H, S_q, D), k/v
    (B, H, S_k, D)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        s_q, s_k = scores.shape[-2:]
        keep = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=scores.device).tril_()
        scores = scores.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)


def ring_attention(*args, **kwargs):
    raise NotImplementedError(f"ring attention {PARALLEL_PLANE}")


def ulysses_attention(*args, **kwargs):
    raise NotImplementedError(f"Ulysses attention {PARALLEL_PLANE}")
