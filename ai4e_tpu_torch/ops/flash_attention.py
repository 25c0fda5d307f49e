"""Fused attention forward: online softmax, no (S_q, S_k) score matrix in
device memory.

Counterpart of ``ai4e_tpu/ops/pallas/flash_attention.py`` (the forward; the
backward kernels belong to the training slice). On a CUDA tensor
``flash_attention`` launches the hand-written kernel in
``csrc/flash_attention.cu``; on a CPU tensor it runs
``flash_attention_plain``, the TPU kernel's arithmetic written out over a
materialised score matrix, which the tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against.

The kernel reads q/k/v through their own B/H/S strides, so the
``(B, S, 3, H, D)`` view of a fused qkv projection reaches it without a
copy, and it writes the output in ``(B, S, H, D)`` memory order, returned as
a ``(B, H, S, D)`` view: the transpose back to ``(B, S, H*D)`` for the out
projection is then free too.
"""

from __future__ import annotations

import ctypes

import torch

from . import _native

#: Kernel launches on CUDA tensors since import (or since a caller reset it).
launches = 0

NEG_INF = -1e30  # the TPU kernel's mask value and initial running max
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations
#: How far the kernel's output may lie from ``flash_attention_plain``'s on
#: the same inputs (see ``tolerance``), and its logsumexp (abs).
FLOAT32_ATOL, BFLOAT16_ATOL, LSE_ATOL = 2e-5, 1e-2, 1e-4


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, return_lse: bool = False):
    """q (B, H, S_q, D), k/v (B, H, S_k, D), float32 or bfloat16 ->
    (B, H, S_q, D) in q's dtype; with ``return_lse`` also the float32
    (B, H, S_q) logsumexp of each score row. Causal needs S_q == S_k."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _flash_cuda(q, k, v, causal, return_lse)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, return_lse: bool = False):
    """The plain PyTorch version, in the TPU kernel's arithmetic: float32
    throughout, q scaled by D**-0.5 before the product, masked scores and
    the running max start at ``NEG_INF``, ``acc / max(l, 1e-30)`` cast to
    q's dtype, ``lse = m + log(max(l, 1e-30))``. It materialises the
    scores: 4 * B * H * S_q * S_k bytes."""
    scores = torch.matmul(q.float() * q.shape[-1] ** -0.5,
                          k.float().transpose(-1, -2))
    if causal:
        s = scores.shape[-1]
        keep = torch.ones((s, s), dtype=torch.bool,
                          device=scores.device).tril_()
        scores = scores.masked_fill_(~keep, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True).clamp_min_(NEG_INF)
    p = torch.exp(scores.sub_(m))
    l = p.sum(dim=-1, keepdim=True).clamp_min_(1e-30)
    out = (torch.matmul(p, v.float()) / l).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


def tolerance(want: torch.Tensor) -> torch.Tensor:
    """Per-element tolerance of the kernel's output against the plain
    output ``want``. float32: the same float32 products summed in another
    order, ``FLOAT32_ATOL``. bfloat16: the kernel rounds P to bfloat16 for
    the second product, then each side rounds the output to bfloat16 on its
    own, so a value near a rounding boundary may land one bfloat16 ulp
    apart: ``BFLOAT16_ATOL``, or one ulp of ``want`` where that is larger
    (0.0156 for |o| in [2, 4), which causal rows that see few keys reach)."""
    if want.dtype == torch.float32:
        return torch.full_like(want, FLOAT32_ATOL)
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                      torch.frexp(want.float()).exponent - 8)
    return ulp.clamp_min(BFLOAT16_ATOL)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q (B, H, S_q, D) and k/v (B, H, S_k, D)")
    b, h, s_q, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[2] < 1:
        raise ValueError("S_k must be at least 1")
    if causal and s_q != k.shape[2]:
        raise ValueError("causal flash attention expects S_q == S_k")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"expected float32 or bfloat16 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not supported; supported: "
                         f"{HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q/k/v need unit stride on D")
    if not q.device == k.device == v.device:
        raise ValueError("q/k/v must be on one device")


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, return_lse: bool):
    global launches
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel grid's 65535")
    size = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(st * size % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned: pointer "
                             f"and B/H/S strides")
    out = torch.empty((b, s_q, h, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    lse = (torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr() if lse is not None else None, b, h, s_q,
                   s_k, d, strides, d ** -0.5, int(causal),
                   int(q.dtype == torch.bfloat16),
                   torch.cuda.current_stream(q.device).cuda_stream,
                   q.device.index or 0)
    _native.check(err, "flash_attention kernel")
    launches += 1
    return (out, lse) if return_lse else out


_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _native.load("flash_attention").ai4e_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn
