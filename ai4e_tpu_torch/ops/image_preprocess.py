"""uint8 image normalisation: (B, H, W, C) uint8 -> (B, H, W, C) float32.

Counterpart of ``ai4e_tpu/ops/pallas/image_preprocess.py``. Clients ship
uint8 pixels and the card widens and normalises them, so the host->device
copy is a quarter of a float32 batch. On a CUDA tensor ``normalize_image``
launches the hand-written kernel in ``csrc/image_preprocess.cu``; on a CPU
tensor it runs the plain PyTorch version below, which the tests hold against
the JAX package and ``chip_smoke.py`` holds the kernel against.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _native

#: Kernel launches on CUDA tensors since import (or since a caller reset it).
launches = 0

_MAX_CHANNELS = 8  # kMaxChannels in csrc/image_preprocess.cu


def channel_affine(mean, std, c: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel ``(scale, bias)`` as float32, with
    ``(x/255 - mean)/std == x*scale + bias``: ``scale = 1/(255*std)``,
    ``bias = -mean/std``, computed in float32 as the JAX package does."""
    mean = np.asarray([0.0] * c if mean is None else mean, np.float32)
    std = np.asarray([1.0] * c if std is None else std, np.float32)
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"mean/std must have {c} entries, got "
                         f"{mean.shape} and {std.shape}")
    scale = (np.float32(1.0) / (np.float32(255.0) * std)).astype(np.float32)
    bias = (-mean / std).astype(np.float32)
    return scale, bias


def normalize_image(images: torch.Tensor, mean=None, std=None) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, H, W, C) float32 in normalised range."""
    if images.dtype != torch.uint8:
        raise ValueError(f"expected uint8 input, got {images.dtype}")
    if images.dim() != 4:
        raise ValueError(f"expected (B, H, W, C), got shape {tuple(images.shape)}")
    scale, bias = channel_affine(mean, std, images.shape[-1])
    if images.device.type == "cpu":
        return normalize_image_plain(images, scale, bias)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    return _normalize_cuda(images, scale, bias)


def normalize_image_plain(images: torch.Tensor, scale: np.ndarray,
                          bias: np.ndarray) -> torch.Tensor:
    """The plain PyTorch version: widen, multiply, add (two roundings)."""
    s = torch.from_numpy(scale).to(images.device)
    b = torch.from_numpy(bias).to(images.device)
    return images.to(torch.float32) * s + b


def _normalize_cuda(images: torch.Tensor, scale: np.ndarray,
                    bias: np.ndarray) -> torch.Tensor:
    global launches
    c = images.shape[-1]
    if c > _MAX_CHANNELS:
        raise ValueError(f"the CUDA kernel takes at most {_MAX_CHANNELS} "
                         f"channels, got {c}")
    images = images.contiguous()
    if images.data_ptr() % 16:
        images = images.clone()  # fresh allocations are 16-byte aligned
    out = torch.empty(images.shape, dtype=torch.float32, device=images.device)
    scale_c = (ctypes.c_float * c)(*scale.tolist())
    bias_c = (ctypes.c_float * c)(*bias.tolist())
    err = _entry()(images.data_ptr(), out.data_ptr(), images.numel(), c,
                   scale_c, bias_c, torch.cuda.current_stream(images.device).cuda_stream,
                   images.device.index or 0)
    _native.check(err, "normalize_image kernel")
    launches += 1
    return out


_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _native.load("image_preprocess").ai4e_normalize_u8
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn
