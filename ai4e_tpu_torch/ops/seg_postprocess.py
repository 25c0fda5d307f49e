"""Segmentation postprocess: per-pixel argmax -> uint8 class map, and the
per-image class histogram.

Counterpart of ``ai4e_tpu/ops/pallas/seg_postprocess.py``. The JAX package
runs the argmax as a Pallas kernel and counts its map with an XLA one-hot
sum; here one hand-written kernel (``csrc/seg_postprocess.cu``) does both in
one pass over the logits and writes the map only when asked, so a
histogram-only API moves B*C int32 counts off the card and nothing else.

Argmax semantics are the TPU kernel's: strict ``>`` from class 0 upward, so
ties go to the lower class and a NaN logit never wins unless it is class 0.
``torch.argmax`` treats NaN as the maximum, so the plain version is an
explicit loop over classes, not ``torch.argmax``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _native

#: Kernel launches on CUDA tensors since import (or since a caller reset it).
launches = 0


def segmentation_argmax(logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) float32/bfloat16 logits -> (B, H, W) uint8 class map."""
    return fused_seg_postprocess(logits, with_classmap=True)["classmap"]


def class_histogram(classmap: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, H, W) uint8 -> (B, num_classes) int32 pixel counts."""
    return torch.stack([(classmap == c).sum(dim=(1, 2))
                        for c in range(num_classes)], dim=1).to(torch.int32)


def fused_seg_postprocess(logits: torch.Tensor,
                          with_classmap: bool = True) -> dict:
    """Per-class pixel counts (``counts``, (B, C) int32), plus the uint8
    class map (``classmap``, (B, H, W)) when ``with_classmap``."""
    _check_logits(logits)
    if logits.device.type == "cpu":
        return fused_seg_postprocess_plain(logits, with_classmap)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    return _fused_cuda(logits, with_classmap)


def fused_seg_postprocess_plain(logits: torch.Tensor,
                                with_classmap: bool = True) -> dict:
    """The plain PyTorch version: the TPU kernel's compare loop, then a
    per-class count."""
    best = logits[..., 0]
    classmap = torch.zeros(best.shape, dtype=torch.uint8, device=logits.device)
    for c in range(1, logits.shape[-1]):
        cand = logits[..., c]
        take = cand > best
        best = torch.where(take, cand, best)
        classmap.masked_fill_(take, c)
    counts = class_histogram(classmap, logits.shape[-1])
    if with_classmap:
        return {"classmap": classmap, "counts": counts}
    return {"counts": counts}


def _check_logits(logits: torch.Tensor) -> None:
    if logits.dim() != 4:
        raise ValueError(f"expected (B, H, W, C) logits, got shape "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expected float32 or bfloat16 logits, got "
                         f"{logits.dtype}")
    if not 1 <= logits.shape[-1] <= 256:
        raise ValueError(f"class count must be in [1, 256] for a uint8 map "
                         f"(classes 0 to 255), got {logits.shape[-1]}")


def _fused_cuda(logits: torch.Tensor, with_classmap: bool) -> dict:
    global launches
    b, h, w, c = logits.shape
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous (B, H, W, C)")
    if logits.data_ptr() % 16:
        raise ValueError("logits must be 16-byte aligned")
    counts = torch.zeros((b, c), dtype=torch.int32, device=logits.device)
    classmap = (torch.empty((b, h, w), dtype=torch.uint8, device=logits.device)
                if with_classmap else None)
    err = _entry()(logits.data_ptr(),
                   classmap.data_ptr() if classmap is not None else None,
                   counts.data_ptr(), b, h * w, c,
                   int(logits.dtype == torch.bfloat16),
                   torch.cuda.current_stream(logits.device).cuda_stream,
                   logits.device.index or 0)
    _native.check(err, "fused_seg_postprocess kernel")
    launches += 1
    if with_classmap:
        return {"classmap": classmap, "counts": counts}
    return {"counts": counts}


_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _native.load("seg_postprocess").ai4e_seg_postprocess
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn
