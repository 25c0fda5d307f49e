"""Micro-batcher — packs queued requests into dense, bucket-padded batches
for the card. Counterpart of ``ai4e_tpu/runtime/batcher.py``.

- requests arrive one at a time (``submit`` returns the example's result);
- a flusher cuts a model's batch when its largest bucket is full or its
  oldest request has waited ``max_wait_ms``; under load batches grow toward
  the largest bucket, an idle request leaves at batch 1;
- the batch is padded to ``bucket_for(n)`` with zero rows and run on one
  executor thread (the device is the serial resource), one batch at a time:
  while it runs, arrivals keep joining the queue, so the next cut is as full
  as possible;
- outputs fan back out to per-request futures; postprocess runs on the
  executor, and an error there fails only that request.

Backpressure: with ``max_pending`` requests queued, ``submit`` raises
``BatcherSaturated`` and the service answers 503.
"""

from __future__ import annotations

import asyncio
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from .ladder import EXPOSITION_BUCKETS
from .registry import ModelRuntime

log = logging.getLogger("ai4e_tpu_torch.batcher")


class BatcherSaturated(RuntimeError):
    pass


@dataclass
class _Pending:
    example: np.ndarray
    future: asyncio.Future
    enqueued: float = field(default_factory=time.perf_counter)


class MicroBatcher:
    def __init__(self, runtime: ModelRuntime, max_wait_ms: float = 5.0,
                 max_pending: int = 256,
                 metrics: MetricsRegistry | None = None):
        self.runtime = runtime
        self.max_wait = max_wait_ms / 1000.0
        self.max_pending = max_pending
        self.metrics = metrics or DEFAULT_REGISTRY
        self._pending: dict[str, list[_Pending]] = {}
        self._wakeup = asyncio.Event()
        self._stop = False
        self._flusher: asyncio.Task | None = None
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="device-batcher")
        self._batch_size_hist = self.metrics.histogram(
            "ai4e_batch_size", "Executed batch sizes",
            buckets=(*EXPOSITION_BUCKETS, float("inf")))
        self._batch_latency = self.metrics.histogram(
            "ai4e_batch_exec_seconds", "Device execution time per batch")
        self._queue_wait = self.metrics.histogram(
            "ai4e_batch_queue_wait_seconds", "Request wait before batching")
        self._pending_gauge = self.metrics.gauge(
            "ai4e_batcher_pending", "Requests waiting for a batch slot")
        self._phase_hist = self.metrics.histogram(
            "ai4e_device_phase_seconds",
            "Device-boundary phase durations (h2d/compile/execute/d2h) per batch")
        self._h2d_bytes = self.metrics.counter(
            "ai4e_batch_h2d_bytes_total",
            "Host-to-device bytes shipped (padded batches)")
        self._d2h_bytes = self.metrics.counter(
            "ai4e_batch_d2h_bytes_total",
            "Device-to-host bytes fetched (batch outputs)")

    # -- request side ------------------------------------------------------

    @property
    def pending_count(self) -> int:
        return sum(len(v) for v in self._pending.values())

    async def submit(self, model_name: str, example: np.ndarray):
        """Queue one example; resolves to its postprocessed result."""
        if self._stop:
            raise RuntimeError("batcher stopped")
        if self.pending_count >= self.max_pending:
            raise BatcherSaturated(
                f"batcher at {self.pending_count}/{self.max_pending} pending")
        expected = tuple(self.runtime.models[model_name].input_shape)
        if tuple(example.shape) != expected:
            raise ValueError(
                f"bad input shape {example.shape}, expected {expected}")
        fut = asyncio.get_running_loop().create_future()
        self._pending.setdefault(model_name, []).append(_Pending(example, fut))
        self._pending_gauge.set(self.pending_count)
        self._wakeup.set()
        return await fut

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._stop = False
        self._flusher = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stop = True
        self._wakeup.set()
        if self._flusher is not None:
            await self._flusher
        self._executor.shutdown(wait=True)

    # -- flusher -----------------------------------------------------------

    async def _run(self) -> None:
        while not self._stop:
            if self.pending_count == 0:
                self._wakeup.clear()
                try:
                    await asyncio.wait_for(self._wakeup.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    continue
            if self.max_wait > 0:
                sleep_for = self._nearest_cut_deadline(time.perf_counter())
                if sleep_for is not None and sleep_for > 0:
                    await asyncio.sleep(sleep_for)
            now = time.perf_counter()
            for model_name in list(self._pending):
                if not self._cut_ready(model_name, now):
                    continue
                batch, bucket = self._take_batch(model_name)
                # One batch on the device at a time; awaiting it here keeps
                # later arrivals queued until the next cut.
                await self._execute(model_name, batch, bucket)

    def _cut_ready(self, model_name: str, now: float) -> bool:
        """Full largest bucket, or the oldest request waited ``max_wait``."""
        queue = self._pending.get(model_name)
        if not queue:
            return False
        if len(queue) >= self.runtime.models[model_name].max_bucket:
            return True
        return self.max_wait <= 0 or now - queue[0].enqueued >= self.max_wait

    def _nearest_cut_deadline(self, now: float) -> float | None:
        """Seconds until the first model is cut-ready (None: nothing
        pending)."""
        nearest: float | None = None
        for name, queue in self._pending.items():
            if not queue:
                continue
            if self._cut_ready(name, now):
                return 0.0
            remaining = self.max_wait - (now - queue[0].enqueued)
            nearest = remaining if nearest is None else min(nearest, remaining)
        return nearest

    def _take_batch(self, model_name: str) -> tuple[list[_Pending], int]:
        """Cut the oldest ``max_bucket`` requests; return them and the
        bucket they pad to."""
        servable = self.runtime.models[model_name]
        queue = self._pending[model_name]
        take = min(len(queue), servable.max_bucket)
        batch, self._pending[model_name] = queue[:take], queue[take:]
        self._pending_gauge.set(self.pending_count)
        return batch, servable.bucket_for(take)

    async def _execute(self, model_name: str, batch: list[_Pending],
                       bucket: int) -> None:
        """Run one cut batch padded to ``bucket`` with zero rows, then
        deliver each request's result."""
        loop = asyncio.get_running_loop()
        servable = self.runtime.models[model_name]
        n = len(batch)
        now = time.perf_counter()
        for p in batch:
            self._queue_wait.observe(now - p.enqueued, model=model_name)
        padded = np.zeros((bucket, *servable.input_shape), servable.input_dtype)
        for i, p in enumerate(batch):
            padded[i] = p.example

        t0 = time.perf_counter()
        try:
            outputs, _, phases = await loop.run_in_executor(
                self._executor, self.runtime.run_batch_phases, model_name,
                padded)
        except Exception as exc:  # noqa: BLE001 — a device failure fails the batch
            log.exception("batch execution failed for %s", model_name)
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
            return
        self._batch_latency.observe(time.perf_counter() - t0, model=model_name)
        for phase, seconds in phases.items():
            self._phase_hist.observe(seconds, phase=phase, model=model_name)
        self._batch_size_hist.observe(n, model=model_name)
        self._h2d_bytes.inc(padded.nbytes, model=model_name)
        self._d2h_bytes.inc(_tree_nbytes(outputs), model=model_name)

        # Postprocess on the executor, not the event loop: a heavy one
        # (PNG-encoding 64 class maps) would stall every other request.
        # Skip examples whose futures are already done (cancelled).
        wanted = [i for i, p in enumerate(batch) if not p.future.done()]

        def _fan_out() -> list:
            results: list = []
            for i in wanted:
                try:
                    results.append(
                        (True, servable.postprocess(_tree_index(outputs, i))))
                except Exception as exc:  # noqa: BLE001 — delivered to that request's future
                    results.append((False, exc))
            return results

        for i, (ok, value) in zip(
                wanted, await loop.run_in_executor(self._executor, _fan_out)):
            fut = batch[i].future
            if fut.done():  # cancelled while the fan-out ran
                continue
            if ok:
                fut.set_result(value)
            else:
                fut.set_exception(value)


def _tree_index(outputs, i: int):
    """Example ``i`` of an array or a dict of batched arrays."""
    if isinstance(outputs, dict):
        return {k: v[i] for k, v in outputs.items()}
    return outputs[i]


def _tree_nbytes(outputs) -> int:
    """Total bytes of an array or a dict of arrays."""
    if isinstance(outputs, dict):
        return sum(v.nbytes for v in outputs.values())
    return outputs.nbytes
