"""Model registry — servable PyTorch modules on one device.

Counterpart of ``ai4e_tpu/runtime/registry.py``. A servable is a module plus
pure pre/postprocess functions; the runtime moves the module to its device
and runs one padded batch at a time. There is no compile step to manage:
PyTorch runs eagerly, but the first run of a (model, bucket) shape still
pays one-off costs (cuDNN algorithm choice, the hand-written kernels' build
at first use), so ``run_batch_phases`` labels it ``compile`` as the JAX
runtime does.

``cudnn.allow_tf32`` is switched off on the card: the head conv is float32
in the reference, and cuDNN would otherwise run it in TF32 (about three
decimal digits), which can flip the argmax of close logits. Likewise for
cuBLAS: no TF32 for float32 products, and bfloat16 products reduce in
float32 (PyTorch lets cuBLAS reduce them in bfloat16 by default), as XLA's
do.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .ladder import DEFAULT_BUCKETS

log = logging.getLogger("ai4e_tpu_torch.runtime")

Preprocess = Callable[[bytes, str], np.ndarray]
Postprocess = Callable[[Any], Any]


@dataclass
class ServableModel:
    """One deployable model API.

    - ``apply_fn(module, batch) -> outputs``: a function of a dense batch
      tensor on the runtime's device; outputs are a tensor or a dict of
      tensors with the batch as their first axis;
    - ``preprocess(body, content_type) -> example``: request payload -> one
      example array of ``input_shape`` (raises ValueError on bad input —
      that fails one task, never a batch);
    - ``postprocess(example_outputs) -> result``: one example's slice of the
      host outputs -> JSON-able result;
    - ``batch_buckets``: allowed batch sizes, ascending; a batch is padded
      up to the smallest that fits.
    - ``state_dict_from_flax``: converts the JAX package's params tree for
      this servable to ``module``'s state_dict (None: no conversion).
    """

    name: str
    apply_fn: Callable
    module: nn.Module
    input_shape: tuple[int, ...]
    preprocess: Preprocess
    postprocess: Postprocess
    batch_buckets: tuple[int, ...] = DEFAULT_BUCKETS
    input_dtype: Any = np.float32
    version: str = "1.0"
    checkpoint_path: str | None = None
    params_version: int = 1
    state_dict_from_flax: Callable | None = None

    def bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    @property
    def max_bucket(self) -> int:
        return self.batch_buckets[-1]


def _to_host(out):
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    return out.cpu().numpy()


class ModelRuntime:
    """Owns the device and the registered modules; runs padded batches."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.models: dict[str, ServableModel] = {}
        # (model, padded-batch-size) shapes this process has run — the
        # first run of each is labelled ``compile`` by run_batch_phases.
        self._executed_shapes: set[tuple[str, int]] = set()

    def register(self, servable: ServableModel) -> ServableModel:
        """Move the module to the device, channels-last, inference mode."""
        servable.module = servable.module.to(
            device=self.device, memory_format=torch.channels_last).eval()
        servable.module.requires_grad_(False)
        self.models[servable.name] = servable
        return servable

    def warmup(self, names: list[str] | None = None) -> dict[str, float]:
        """Run every bucket of every model once on zeros, so the first
        served request pays no one-off cost. Returns seconds per model."""
        times: dict[str, float] = {}
        for name, servable in self.models.items():
            if names is not None and name not in names:
                continue
            t0 = time.perf_counter()
            for bucket in servable.batch_buckets:
                self.run_batch(name, np.zeros((bucket, *servable.input_shape),
                                              servable.input_dtype))
            times[name] = time.perf_counter() - t0
            log.info("warmup %s: %d buckets in %.1fs", name,
                     len(servable.batch_buckets), times[name])
        return times

    def run_batch(self, name: str, batch: np.ndarray):
        """Execute one padded batch; blocking (call from an executor)."""
        return self.run_batch_phases(name, batch)[0]

    def run_batch_report(self, name: str, batch: np.ndarray
                         ) -> tuple[object, frozenset]:
        """``run_batch`` plus the poisoned-rows set of the JAX runtime's
        surface — always empty on one device."""
        return self.run_batch(name, batch), frozenset()

    def run_batch_phases(self, name: str, batch: np.ndarray
                         ) -> tuple[object, frozenset, dict[str, float]]:
        """``run_batch_report`` with the device boundary split into
        measured phases, each ended by a device synchronize:

        - ``h2d``: the padded batch copied from pinned host memory;
        - ``execute`` (``compile`` on the first run of this shape):
          ``apply_fn`` on the resident batch;
        - ``d2h``: the outputs copied back (counts-only land-cover: B*C
          int32).

        Returns ``(host_outputs, poisoned_rows, {phase: seconds})``."""
        servable = self.models[name]
        cuda = self.device.type == "cuda"
        phases: dict[str, float] = {}
        t0 = time.perf_counter()
        host = torch.from_numpy(batch)
        if cuda:
            host = host.pin_memory()
        device_batch = host.to(self.device, non_blocking=True)
        self._sync()
        phases["h2d"] = time.perf_counter() - t0
        key = (name, int(batch.shape[0]))
        first = key not in self._executed_shapes
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = servable.apply_fn(servable.module, device_batch)
        self._sync()
        phases["compile" if first else "execute"] = time.perf_counter() - t0
        self._executed_shapes.add(key)
        t0 = time.perf_counter()
        host_out = _to_host(out)
        phases["d2h"] = time.perf_counter() - t0
        return host_out, frozenset(), phases

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
