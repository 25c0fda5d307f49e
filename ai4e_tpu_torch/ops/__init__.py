"""Ops with hand-written Hopper kernels (CUDA C++ in ``csrc/``), each beside
its plain PyTorch version. Counterpart of ``ai4e_tpu/ops/pallas``."""

from .image_preprocess import normalize_image
from .seg_postprocess import (
    class_histogram,
    fused_seg_postprocess,
    segmentation_argmax,
)

__all__ = [
    "normalize_image",
    "class_histogram",
    "fused_seg_postprocess",
    "segmentation_argmax",
]
