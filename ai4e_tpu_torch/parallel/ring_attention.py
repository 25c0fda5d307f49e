"""Sequence parallelism: ring attention and Ulysses all-to-all —
counterpart of ``ai4e_tpu/parallel/ring_attention.py``.

Both shard a sequence over the mesh's ``sp`` axis; each rank holds its
contiguous sequence chunk of q, k and v, (B, H, S/n, D), and gets its chunk
of the output.

- **Ring attention** (``ring_attention``): each rank keeps its q chunk
  while the k/v chunks rotate one hop around the sp ring a step
  (``comm.ring_shift``, one ``batch_isend_irecv``). Every block goes
  through the port's flash forward with ``return_lse`` (on the card the
  hand-written kernel, on the CPU its plain version), and the partial
  outputs merge by their logsumexp in float32: ``o = sum_i exp(lse_i -
  lse) * o_i`` with ``lse = logsumexp_i lse_i``. JAX computes each block
  with ``einsum`` and an online softmax over masks built from global
  positions (``q_pos >= k_pos``); causally that mask is all-true for a
  chunk from an earlier rank, the causal triangle on the rank's own chunk,
  and all-false for a later rank's. So a causal ring runs the own chunk
  causal, the earlier chunks full, and skips the later ones: rank r
  launches the flash forward r + 1 times a call, n times when not causal.
  Under autograd the ring is ``_RingAttention``: its backward runs the
  flash backward once a block the forward ran, from the merged output and
  logsumexp, with each block's dk and dv travelling the ring with it back
  to the rank that owns the block.
- **Ulysses** (``ulysses_attention``): one ``all_to_all`` turns the
  sequence chunk into a head chunk (B, H/n, S, D), the flash forward
  attends over the whole sequence on 1/n of the heads, and a second turns
  it back. It needs ``H % n == 0``. It trains through the exchanges'
  autograd form (``comm.all_to_all``: the inverse exchange backward) and
  the flash attention's own.

``reference_attention`` is the plain single-device oracle.
"""

from __future__ import annotations

import torch

from . import comm
from .sharding import axis_group, axis_index, axis_size


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


def _need_mesh(mesh, what: str) -> None:
    if mesh is None:
        raise ValueError(f"{what} attention needs a device mesh (a "
                         f"DeviceMesh from parallel.sharding.make_mesh)")


def _flash(q, k, v, causal: bool):
    from ..ops.flash_attention import flash_attention
    return flash_attention(q, k, v, causal=causal, return_lse=True)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, causal: bool = False,
                   axis_name: str = "sp") -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``axis_name``: q/k/v are
    this rank's chunks (B, H, S/n, D), chunk i on the axis's rank i; the
    result is this rank's chunk of the output, in q's dtype.
    Differentiable in q, k and v (``_RingAttention``)."""
    _need_mesh(mesh, "ring")
    n = axis_size(mesh, axis_name)
    me = axis_index(mesh, axis_name)
    group = axis_group(mesh, axis_name)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingAttention.apply(q, k, v, n, me, group, causal)
    return _ring_forward(q, k, v, n, me, group, causal)[0]


def _ring_blocks(n: int, me: int, causal: bool):
    """``(step, src, causal block)`` of each hop: the chunk this rank holds
    after ``step`` hops is rank ``src``'s; ``causal block`` is None for a
    chunk a causal ring skips (a later rank's)."""
    for step in range(n):
        src = (me - step) % n
        yield step, src, (None if causal and src > me
                          else causal and src == me)


def _ring_forward(q, k, v, n: int, me: int, group, causal: bool):
    """The ring's output in q's dtype and its float32 logsumexp (B, H,
    S/n): one flash forward a block with ``return_lse``, merged by the
    logsumexp in float32."""
    kv = torch.stack((k, v))  # one message a hop
    out = lse = None
    for step, _, block_causal in _ring_blocks(n, me, causal):
        if block_causal is not None:
            o_blk, lse_blk = _flash(q, kv[0], kv[1], block_causal)
            o_blk = o_blk.float()
            if out is None:
                out, lse = o_blk, lse_blk
            else:
                new = torch.logaddexp(lse, lse_blk)
                out = (out * torch.exp(lse - new).unsqueeze(-1)
                       + o_blk * torch.exp(lse_blk - new).unsqueeze(-1))
                lse = new
        if step + 1 < n:
            kv = comm.ring_shift(kv, group)
    return out.to(q.dtype), lse.contiguous()


def _shift_with_grads(kv: torch.Tensor, dkv: torch.Tensor, group):
    """One hop of a K/V block and its float32 gradient sums, as one
    message (their bytes side by side)."""
    a = kv.contiguous().reshape(-1).view(torch.uint8)
    b = dkv.reshape(-1).view(torch.uint8)
    both = comm.ring_shift(torch.cat((a, b)), group)
    return (both[:a.numel()].view(kv.dtype).view(kv.shape),
            both[a.numel():].view(dkv.dtype).view(dkv.shape))


class _RingAttention(torch.autograd.Function):
    """The ring under autograd. Forward: ``_ring_forward``, saving q, k, v,
    the merged output and the merged lse. Backward: each block's softmax
    is the merged one restricted to its keys, ``exp(s_blk - lse)``, and
    Delta = rowsum(dO * O) is the merged output's; so each block the
    forward ran takes one ``flash_attention_bwd(q, k_blk, v_blk, out, lse,
    do, causal and src == me)`` (the fused kernel on the card; its
    preparation pass computes Delta from ``out`` and ``do``, the same for
    every block), and the blocks a causal ring skipped are skipped again.
    dq adds up on the rank; each block's dk and dv add up in float32 as
    the block travels the ring again, and one last hop hands them to the
    rank that owns it."""

    @staticmethod
    def forward(ctx, q, k, v, n, me, group, causal):
        out, lse = _ring_forward(q, k, v, n, me, group, causal)
        ctx.ring = (n, me, group, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        from ..ops.flash_attention import flash_attention_bwd

        q, k, v, out, lse = ctx.saved_tensors
        n, me, group, causal = ctx.ring
        do = do.to(q.dtype)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack((k, v))
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for step, _, block_causal in _ring_blocks(n, me, causal):
            if block_causal is not None:
                dq_b, dk_b, dv_b = flash_attention_bwd(
                    q, kv[0], kv[1], out, lse, do, block_causal)
                dq += dq_b
                dkv[0] += dk_b
                dkv[1] += dv_b
            if step + 1 < n:
                kv, dkv = _shift_with_grads(kv, dkv, group)
        if n > 1:  # the block now held is the next rank's: hand it over
            dkv = comm.ring_shift(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, causal: bool = False,
                      axis_name: str = "sp") -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses style); the same
    contract as ``ring_attention``. Raises ValueError where the heads do
    not divide over the axis."""
    _need_mesh(mesh, "Ulysses")
    n = axis_size(mesh, axis_name)
    b, h, s, d = q.shape
    if h % n:
        raise ValueError(f"heads {h} not divisible by sp={n}")
    group = axis_group(mesh, axis_name)

    # (3, B, H, S/n, D) -> head chunk j for rank j -> (3, B, H/n, S, D):
    # one message for q, k and v.
    x = torch.stack((q, k, v)).reshape(3, b, n, h // n, s, d)
    x = comm.all_to_all(x.permute(2, 0, 1, 3, 4, 5).contiguous(), group)
    q2, k2, v2 = x.permute(1, 2, 3, 0, 4, 5).reshape(3, b, h // n, n * s, d)
    o2, _ = _flash(q2, k2, v2, causal)
    # (B, H/n, S, D) -> chunk i of the sequence for rank i -> (B, H, S/n, D)
    o2 = o2.reshape(b, h // n, n, s, d).permute(2, 0, 1, 3, 4).contiguous()
    o = comm.all_to_all(o2, group)  # chunk j: head chunk j
    return o.transpose(0, 1).reshape(b, h, s, d)
