"""YUV 4:2:0 host->device wire codec — half the h2d bytes of raw RGB for the
image models. Counterpart of ``ai4e_tpu/ops/yuv.py``.

Camera and aerial imagery arrives as JPEG, which already stores chroma
subsampled 4:2:0, so shipping the card full-resolution chroma carries no
information the source had. The codec moves the subsampling to the
host->device copy:

- host (``rgb_to_yuv420``): decoded RGB -> planar JPEG-convention YCbCr
  with 2x2-averaged chroma, 1.5 bytes a pixel, half of raw RGB; the C++
  encoder (``native/yuv_codec.cpp``) when it builds, numpy otherwise;
- device (``yuv420_to_rgb``): flat planes -> nearest-upsampled chroma ->
  inverse transform -> [0, 1] float32 RGB, plain PyTorch ops that run
  inside the servable's CUDA graph, before the model. The JAX package
  leaves this decode to XLA's fusion, not to a Pallas kernel.

The transform pair is JPEG's own (JFIF full-range BT.601). The float32
arithmetic is JAX's, in JAX's order (``y + 1.402 * cr``, then ``/ 255.0``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch


def yuv420_nbytes(h: int, w: int) -> int:
    return h * w + 2 * (h // 2) * (w // 2)


_native_encode = None
_native_tried = False


def _get_native_encode():
    """The C++ encoder (``native/yuv_codec.cpp``, built on first use), or
    None when it cannot be built."""
    global _native_encode, _native_tried
    if _native_tried:
        return _native_encode
    _native_tried = True
    from ..utils.native_build import load_native_function
    _native_encode = load_native_function(
        "yuv_codec.cpp", "libyuv_codec.so", "yuv420_encode",
        restype=ctypes.c_int,
        argtypes=[ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                  ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)])
    return _native_encode


def encoder() -> str:
    """The host encoder ``rgb_to_yuv420`` runs: ``"cpp"`` or ``"numpy"``."""
    return "cpp" if _get_native_encode() is not None else "numpy"


def rgb_to_yuv420(arr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> flat planar uint8 [Y | Cb | Cr], chroma 2x2
    box-averaged. H and W must be even. The C++ encoder when it is
    available (the numpy version's contract within 1 LSB: exact halves
    round another way); numpy otherwise."""
    if arr.ndim != 3 or arr.shape[-1] != 3 or arr.dtype != np.uint8:
        # Before dispatch: the C++ path reinterprets raw bytes and would
        # encode float or RGBA input into plausible garbage.
        raise ValueError(
            f"expected (H, W, 3) uint8, got {arr.shape} {arr.dtype}")
    h, w, _ = arr.shape
    if h % 2 or w % 2:
        raise ValueError(f"yuv420 needs even dims, got {arr.shape}")
    encode = _get_native_encode()
    if encode is not None:
        arr = np.ascontiguousarray(arr)
        out = np.empty(yuv420_nbytes(h, w), np.uint8)
        rc = encode(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc == 0:
            return out
    return _rgb_to_yuv420_numpy(arr)


def _rgb_to_yuv420_numpy(arr: np.ndarray) -> np.ndarray:
    h, w, _ = arr.shape
    n = h * w
    q = (h // 2) * (w // 2)
    out = np.empty(yuv420_nbytes(h, w), np.uint8)
    f = arr.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    cb = cb.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    cr = cr.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    out[:n] = (y + 0.5).astype(np.uint8).reshape(-1)  # y in [0, 255] exactly
    out[n:n + q] = np.clip(np.round(cb), 0, 255).astype(np.uint8).reshape(-1)
    out[n + q:] = np.clip(np.round(cr), 0, 255).astype(np.uint8).reshape(-1)
    return out


def yuv420_to_rgb_numpy(flat: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host inverse: flat planes -> (H, W, 3) uint8 RGB, for consumers that
    need the image back on the host (a crops handoff cropping a yuv-wire
    detector's input). The device inverse's arithmetic, rounded."""
    flat = np.asarray(flat, np.uint8)
    n = h * w
    q = (h // 2) * (w // 2)
    y = flat[:n].reshape(h, w).astype(np.float32)
    cb = flat[n:n + q].reshape(h // 2, w // 2).astype(np.float32) - 128.0
    cr = flat[n + q:].reshape(h // 2, w // 2).astype(np.float32) - 128.0
    cb = np.repeat(np.repeat(cb, 2, axis=0), 2, axis=1)
    cr = np.repeat(np.repeat(cr, 2, axis=0), 2, axis=1)
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def upsample2x(plane: torch.Tensor) -> torch.Tensor:
    """(B, h, w) -> (B, 2h, 2w), each value repeated over a 2x2 block
    (nearest, as fast JPEG decoders upsample chroma)."""
    b, h, w = plane.shape
    return (plane[:, :, None, :, None].expand(b, h, 2, w, 2)
            .reshape(b, 2 * h, 2 * w))


def ycbcr_to_unit_rgb(y: torch.Tensor, cb: torch.Tensor,
                      cr: torch.Tensor) -> torch.Tensor:
    """Full-resolution float32 planes (Y, and Cb/Cr level-shifted to zero)
    -> (B, H, W, 3) float32 RGB in [0, 1]: JFIF's inverse, then
    ``clip(rgb / 255, 0, 1)``, in JAX's order."""
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(rgb / 255.0, 0.0, 1.0)


def yuv420_to_rgb(flat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Device inverse: (B, yuv420_nbytes) uint8 -> (B, H, W, 3) float32 in
    [0, 1]. Elementwise ops and reshapes only, so it is captured in the
    servable's CUDA graph with the model."""
    n = h * w
    q = (h // 2) * (w // 2)
    bsz = flat.shape[0]
    y = flat[:, :n].reshape(bsz, h, w).to(torch.float32)
    cb = flat[:, n:n + q].reshape(bsz, h // 2, w // 2).to(torch.float32)
    cr = flat[:, n + q:].reshape(bsz, h // 2, w // 2).to(torch.float32)
    return ycbcr_to_unit_rgb(y, upsample2x(cb) - 128.0,
                             upsample2x(cr) - 128.0)
