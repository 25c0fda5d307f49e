"""Fused attention, forward and backward: online softmax, no (S_q, S_k)
score matrix in device memory in either pass.

Counterpart of ``ai4e_tpu/ops/pallas/flash_attention.py``. On a CUDA tensor
``flash_attention`` launches the hand-written kernel in
``csrc/flash_attention.cu``; on a CPU tensor it runs
``flash_attention_plain``, the TPU kernel's arithmetic written out over a
materialised score matrix, which the tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against.

Where autograd records (grad enabled and an input requires grad),
``flash_attention`` goes through ``_FlashAttention``, the counterpart of the
TPU's ``_flash3`` custom VJP: the forward also returns the float32
logsumexp and saves q, k, v, out and lse; the backward launches the
hand-written backward, which computes Delta = rowsum(dO * O) in float32 and
rebuilds P from lse (``flash_attention_bwd``; on the CPU
``flash_attention_bwd_plain``). Under ``no_grad``/``inference_mode`` the
served path computes no lse and saves nothing.

The kernel reads q/k/v through their own B/H/S strides, so the
``(B, S, 3, H, D)`` view of a fused qkv projection reaches it without a
copy, and it writes the output in ``(B, S, H, D)`` memory order, returned as
a ``(B, H, S, D)`` view: the transpose back to ``(B, S, H*D)`` for the out
projection is then free too.

Head dims: every D from 1 to ``MAX_HEAD_DIM`` = 256, as JAX's kernel takes
them. The kernels are instantiated at ``HEAD_DIMS``; a D between two runs
at the next one up, with the columns past D read as zero (the TMA tensor
maps' inner extent is the true D) and left out of every store, and the
softmax scale stays D**-0.5 of the true D. The kernels move rows as 16-byte
chunks, so a D that is not a multiple of 8 in bfloat16 (of 4 in float32)
makes the wrapper copy q, k and v (and, in the backward, out and do) into a
zero-padded tensor of the next multiple first, and slice the results back:
``padded_copies`` counts those calls. The kernel still runs. A D above 256
is refused: wgmma's N is at most 256.
"""

from __future__ import annotations

import ctypes

import torch

from . import _native

#: Kernel launches on CUDA tensors since import (or since a caller reset
#: them): the forward, and the backward (one per ``flash_bwd_cuda`` call,
#: which launches its preparation pass, the fused kernel and the dQ
#: conversion).
launches = 0
bwd_launches = 0
#: Of those, calls (forward or backward) whose operands were copied to a
#: zero-padded head dim first (see the module's docstring).
padded_copies = 0

NEG_INF = -1e30  # the TPU kernel's mask value and initial running max
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations
MAX_HEAD_DIM = 256  # the largest head dim taken
BWD_BLOCK_M = 64  # the backward's query tile: its scratch rows are padded to it
BWD_SEMS_PER_TILE = 2  # int32 counters of the ordered dQ a query tile
#: How far the kernel's output may lie from ``flash_attention_plain``'s on
#: the same inputs (see ``tolerance``), and its logsumexp (abs).
FLOAT32_ATOL, BFLOAT16_ATOL, LSE_ATOL = 2e-5, 1e-2, 1e-4
#: How far a backward kernel's gradient may lie from
#: ``flash_attention_bwd_plain``'s, as a share of that gradient's largest
#: magnitude (see ``grad_tolerance``).
GRAD_FLOAT32_RTOL, GRAD_BFLOAT16_RTOL = 1e-5, 2 ** -8


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, return_lse: bool = False):
    """q (B, H, S_q, D), k/v (B, H, S_k, D), float32 or bfloat16 ->
    (B, H, S_q, D) in q's dtype; with ``return_lse`` also the float32
    (B, H, S_q) logsumexp of each score row. Causal needs S_q == S_k.
    Differentiable in q, k and v (the lse is not)."""
    _check(q, k, v, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, causal)
        return (out, lse) if return_lse else out
    return _flash_forward(q, k, v, causal, return_lse)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, return_lse: bool):
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


class _FlashAttention(torch.autograd.Function):
    """``_flash3`` with ``_flash3_fwd``/``_flash3_bwd`` of the TPU package:
    the forward keeps q, k, v, out and the float32 lse; the backward
    rebuilds P from lse in the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_forward(q, k, v, causal, True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = False):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v, causal)`` for
    the upstream gradient ``do`` of its output ``out``, whose float32
    logsumexp is ``lse`` (B, H, S_q). On a CUDA tensor:
    ``flash_bwd_cuda``. On a CPU tensor: ``flash_attention_bwd_plain``."""
    _check(q, k, v, causal)
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} and out {tuple(out.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.shape[0] == 0 or q.shape[2] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    do, out = do.to(q.dtype), out.to(q.dtype)
    if do.stride(3) != 1:
        do = do.contiguous()
    if out.stride(3) != 1:
        out = out.contiguous()
    return flash_bwd_cuda(q, k, v, out, lse, do, causal)


def bwd_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O) in float32, (B, H, S_q) contiguous: the
    softmax Jacobian's correction, which the TPU package computes in XLA
    outside its kernels. The plain backward's; on the card
    ``flash_bwd_cuda``'s preparation pass computes it."""
    return (do.float() * out.float()).sum(dim=-1).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = False,
                              parts: str = "qkv"):
    """The plain PyTorch version of the backward, in the TPU backward
    kernels' arithmetic (``_bwd_recompute``) over materialised float32
    matrices: s = scale * (q . k^T) with q not pre-scaled (unlike the
    forward), masked to ``NEG_INF``, p = exp(s - lse), dp = do . v^T,
    ds = p * (dp - Delta), then dv = p^T . do, dk = scale * ds^T . q,
    dq = scale * ds . k, each cast to its input's dtype. ``parts`` picks
    which of (dq, dk, dv) to compute ("q", "kv" or "qkv"); the others come
    back as None. It materialises four (S_q, S_k) float32 matrices a
    (batch, head)."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)).mul_(scale)
    if causal:
        n = s.shape[-1]
        keep = torch.ones((n, n), dtype=torch.bool, device=s.device).tril_()
        s.masked_fill_(~keep, NEG_INF)
    p = torch.exp(s.sub_(lse.unsqueeze(-1)))
    ds = torch.matmul(dof, vf.transpose(-1, -2))
    ds.sub_(bwd_delta(out, do).unsqueeze(-1)).mul_(p)
    dq = dk = dv = None
    if "q" in parts:
        dq = (torch.matmul(ds, kf) * scale).to(q.dtype)
    if "kv" in parts:
        dv = torch.matmul(p.transpose(-1, -2), dof).to(v.dtype)
        dk = (torch.matmul(ds.transpose(-1, -2), qf) * scale).to(k.dtype)
    return dq, dk, dv


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


def grad_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Per-element tolerance of a backward kernel's gradient against the
    plain gradient ``want``. Each element sums S products (S_q for dK and
    dV, S_k for dQ), so its error scales with the gradient's largest
    magnitude, not with its own value, which may be near 0. float32:
    ``GRAD_FLOAT32_RTOL`` of that magnitude (the same products summed in
    another order). bfloat16: the kernels round P and dS to bfloat16 for
    the tensor-core products, ``GRAD_BFLOAT16_RTOL`` of that magnitude, and
    each side rounds its result on its own, so a value near a rounding
    boundary may land an ulp apart, in the binade above: two bfloat16 ulps
    of ``want``."""
    top = max(float(want.float().abs().max()), 1e-6)
    if want.dtype == torch.float32:
        return torch.full_like(want, GRAD_FLOAT32_RTOL * top)
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                      torch.frexp(want.float()).exponent - 8)
    return 2 * ulp + GRAD_BFLOAT16_RTOL * top


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
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not supported: the kernels take "
                         f"1 to {MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q/k/v need unit stride on D")
    if not q.device == k.device == v.device:
        raise ValueError("q/k/v must be on one device")


def _check_rows(tensors) -> None:
    """Each (name, tensor) must start on 16 bytes with 16-byte B/H/S
    strides: the kernels move rows as TMA boxes and 16-byte chunks."""
    for name, t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or any(st * size % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned: pointer "
                             f"and B/H/S strides")


def instantiation(d: int) -> int:
    """The kernel instantiation that runs head dim ``d``: the narrowest of
    ``HEAD_DIMS`` that holds it (``tile_d`` in the CUDA source)."""
    return next(t for t in HEAD_DIMS if t >= d)


def row_multiple(dtype: torch.dtype) -> int:
    """Elements of a 16-byte chunk: a head dim the kernels take without a
    padded copy is a multiple of it."""
    return 8 if dtype == torch.bfloat16 else 4


def _pad_d(tensors, d: int):
    """``tensors`` zero-padded on D to the next multiple of
    ``row_multiple`` (contiguous copies), or as they are if ``d`` already
    is one; and whether they were copied."""
    step = row_multiple(tensors[0].dtype)
    if d % step == 0:
        return tensors, False
    pad = -d % step
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in tensors), True


def _bshd_like(t: torch.Tensor, s: int) -> torch.Tensor:
    """An empty (B, H, s, D) tensor of t's dtype in (B, S, H, D) memory
    order."""
    b, h, _, d = t.shape
    return torch.empty((b, s, h, d), dtype=t.dtype,
                       device=t.device).permute(0, 2, 1, 3)


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, return_lse: bool):
    global launches, padded_copies
    b, h, s_q, d_true = q.shape
    s_k = k.shape[2]
    (q, k, v), padded = _pad_d((q, k, v), d_true)
    d = q.shape[3]
    _check_rows((("q", q), ("k", k), ("v", v)))
    out = _bshd_like(q, s_q)
    lse = (torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    err = _entry("fwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(),
                        lse.data_ptr() if lse is not None else None, b, h,
                        s_q, s_k, d, strides, d_true ** -0.5, int(causal),
                        int(q.dtype == torch.bfloat16),
                        torch.cuda.current_stream(q.device).cuda_stream,
                        q.device.index or 0)
    _native.check(err, "flash_attention kernel")
    launches += 1
    if padded:
        padded_copies += 1
        out = out[..., :d_true]
    return (out, lse) if return_lse else out


def _check_bwd_cuda(q, k, v, out, lse, do) -> None:
    b, h, s_q, _ = q.shape
    for name, t in (("do", do), ("out", out)):
        if t.dtype != q.dtype or t.shape != q.shape or t.stride(3) != 1:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)} "
                             f"with unit stride on D")
    if (lse.dtype != torch.float32 or lse.shape != (b, h, s_q)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(b, h, s_q)} "
                         f"tensor")
    _check_rows((("q", q), ("k", k), ("v", v), ("do", do), ("out", out)))


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   causal: bool = False):
    """The backward on CUDA tensors: (dq, dk, dv) in q's dtype, (B, H, S,
    D) views of (B, S, H, D) memory. One C call launches the preparation
    pass (Delta = rowsum(do * out) in float32, lse * log2(e), both padded to
    a multiple of ``BWD_BLOCK_M`` rows) and then, for bfloat16, the fused
    kernel (dK and dV in registers, dQ added into a float32 accumulator
    that the preparation pass zeroed; above D = 128 the wide kernel, whose
    consumers split the columns) and the dQ conversion; for float32, the
    dK/dV and dQ CUDA-core kernels. The scratch (``work``) is allocated
    here. Under ``torch.use_deterministic_algorithms(True)`` the fused
    kernel orders its dQ adds (``ordered_dq``), so dq, like dk and dv, is
    the same bit for bit from call to call. A head dim that is not a whole
    number of 16-byte chunks is padded first (``padded_copies``)."""
    global bwd_launches, padded_copies
    b, h, s_q, d_true = q.shape
    s_k = k.shape[2]
    (q, k, v, out, do), padded = _pad_d((q, k, v, out, do), d_true)
    _check_bwd_cuda(q, k, v, out, lse, do)
    d = q.shape[3]
    bf16 = q.dtype == torch.bfloat16
    ordered = ordered_dq(q.dtype, torch.are_deterministic_algorithms_enabled())
    s_pad = -(-s_q // BWD_BLOCK_M) * BWD_BLOCK_M
    # lse * log2(e) and Delta; for bf16 also the (B, H, s_pad, T) dQ
    # accumulator, T the instantiation's head dim, and when ordered its
    # int32 counters.
    sems = b * h * (s_pad // BWD_BLOCK_M) * BWD_SEMS_PER_TILE if ordered else 0
    acc = instantiation(d) if bf16 else 0
    work = torch.empty(b * h * s_pad * (2 + acc) + sems,
                       dtype=torch.float32, device=q.device)
    dq, dk, dv = _bshd_like(q, s_q), _bshd_like(k, s_k), _bshd_like(v, s_k)
    strides = (ctypes.c_longlong * 24)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *out.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
        *dv.stride()[:3])
    err = _entry("bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, s_q, s_k, d, strides,
        d_true ** -0.5, int(causal), int(bf16), int(ordered),
        torch.cuda.current_stream(q.device).cuda_stream, q.device.index or 0)
    _native.check(err, "flash_attention backward kernels")
    bwd_launches += 1
    if padded:
        padded_copies += 1
        return dq[..., :d_true], dk[..., :d_true], dv[..., :d_true]
    return dq, dk, dv


def ordered_dq(dtype: torch.dtype, deterministic: bool) -> bool:
    """Whether the backward on the card orders its dQ adds, given PyTorch's
    deterministic-algorithms flag (``deterministic``). Only the bfloat16
    fused kernel needs to: its dQ tiles are float32 reduce-adds into L2,
    which by default land in whatever order the CTAs reach them. The
    float32 kernels (``flash_bwd_dkv_f32``, ``flash_bwd_dq_f32``) sum every
    gradient in registers in a fixed order and are deterministic already,
    as is the plain version on the CPU."""
    return deterministic and dtype == torch.bfloat16


_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes argument types of each C entry point of csrc/flash_attention.cu.
_ARGTYPES = {
    "fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _I, _I, _P, _I],
    "bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _I, _I, _I, _P,
            _I],
}
_fns: dict = {}


def _entry(which: str):
    fn = _fns.get(which)
    if fn is None:
        fn = getattr(_native.load("flash_attention"),
                     f"ai4e_flash_attention_{which}")
        fn.argtypes = _ARGTYPES[which]
        fn.restype = ctypes.c_int
        _fns[which] = fn
    return fn
