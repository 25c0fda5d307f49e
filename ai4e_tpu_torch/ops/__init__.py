"""Ops with hand-written Hopper kernels (CUDA C++ in ``csrc/``), each beside
its plain PyTorch version. Counterpart of ``ai4e_tpu/ops/pallas``.

``flash_attention`` is imported from its module,
``ai4e_tpu_torch.ops.flash_attention``, so that the name stays the module
(with its ``launches`` counter) and does not become the function.

Each kernel module counts its launches in a module global (``launches``,
and ``bwd_launches`` for the flash backward), one per wrapper call that
reaches the kernel. A CUDA graph replays kernels without calling their
wrappers, so the runtime records what each graph's capture launched
(``launch_counts`` before and after) and adds it on every replay
(``add_launches``)."""

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
    "launch_counts",
    "add_launches",
]

#: Kernel name -> (module under ``ai4e_tpu_torch.ops``, its counter).
COUNTERS = {
    "normalize_image": ("image_preprocess", "launches"),
    "fused_seg_postprocess": ("seg_postprocess", "launches"),
    "flash_attention": ("flash_attention", "launches"),
    "flash_attention_bwd": ("flash_attention", "bwd_launches"),
}


def _module(name: str):
    import importlib

    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict[str, int]:
    """Each kernel's launch count in this process."""
    return {kernel: getattr(_module(mod), attr)
            for kernel, (mod, attr) in COUNTERS.items()}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the kernels' counters:
    what one replay of a captured graph launched."""
    for kernel, n in counts.items():
        mod, attr = COUNTERS[kernel]
        module = _module(mod)
        setattr(module, attr, getattr(module, attr) + n)
