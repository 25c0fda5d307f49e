"""Ops with hand-written Hopper kernels (CUDA C++ in ``csrc/``), each beside
its plain PyTorch version. Counterpart of ``ai4e_tpu/ops/pallas``.

``flash_attention`` is imported from its module,
``ai4e_tpu_torch.ops.flash_attention``, so that the name stays the module
(with its ``launches`` counter) and does not become the function."""

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
