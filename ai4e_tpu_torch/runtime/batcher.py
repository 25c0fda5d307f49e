"""Micro-batcher — packs queued requests into dense, bucket-padded batches
for the card. Counterpart of ``ai4e_tpu/runtime/batcher.py``.

- requests arrive one at a time (``submit`` returns the example's result);
- a flusher cuts a model's batch when its largest bucket is full or its
  oldest request has waited ``max_wait_ms``; under load batches grow toward
  the largest bucket, an idle request leaves at batch 1;
- the batch is padded to the smallest bucket that fits with zero rows and
  run by ``pipeline_depth`` executor threads under a window of as many
  batches (2 by default, as in JAX): the runtime still runs one batch at a
  time on the card, but batch N+1's host work (padding, the copy to the
  card, postprocess) overlaps batch N's device time;
- with ``double_buffer`` the copy to the card, the execution and the copy
  back run on three single-thread executors through the runtime's
  split-phase surface, each batch padded into a staging ring of
  ``pipeline_depth`` host buffers per (model, bucket), pinned on the card,
  so batch N+1's copy overlaps batch N's execution;
- outputs fan back out to per-request futures; postprocess runs on the
  executor, and an error there fails only that request.

Priority classes: ``submit(..., priority=0)`` is interactive, higher
values are background (the batch API submits at 1). Background submits
saturate at ``max_pending * (1 - interactive_reserve)``, so a stack never
takes the whole queue from interactive requests; a batch that cannot take
every pending request is filled interactive-first on the aged key
``priority - waited / priority_aging_s`` (oldest first within a class; 0
means strict priority), so a background request waits boundedly.

Backpressure: with ``max_pending`` requests queued, ``submit`` raises
``BatcherSaturated`` and the service answers 503. While draining
(``begin_drain``), ``submit`` raises ``DrainingError``, uncut requests are
retired with it, and batches already cut finish.

``ladder_manager`` (``runtime.ladder.LadderManager``) sees every cut's
demand and derives the servables' ladders in the background.
``measure_phases`` records the device phases of every batch, the h2d time
that overlapped another batch's execution (``ai4e_batch_overlap_ratio``)
and, with a ladder manager too, the padding spent (``ai4e_batch_pad_*``).

Hop ledger: a request submitted with ``ledger=`` (an
``observability.HopLedger``) gets ``batched`` at the cut and, with
``measure_phases``, one ``h2d`` / ``execute`` (``compile``) / ``d2h`` event
each with its ``ms``, ``t`` being the phase's start mapped from
``perf_counter`` onto the epoch clock. The windows are the ones the
runtime measured, each ended by a synchronize of the stream it ran on, so
they are device intervals; on the double-buffered path each batch stamps
its own windows (batch N+1's h2d may start before batch N's d2h). A ledger
that several requests of one batch share (a batch-API stack) gets that
batch's events once. Nothing of this runs inside a captured graph.

Deadlines: ``submit(..., deadline_at=)`` (absolute unix seconds; 0.0 =
none). An entry whose deadline passes while it waits is dropped at the
batch cut, the last gate before the card: its await raises
``DeadlineExceeded`` (hop ``batcher``, counted in
``ai4e_admission_expired_total``) and the example is never padded into a
batch.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..admission.deadline import DeadlineExceeded, priority_name
from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from ..rollout.drain import DrainingError, retire_pending
from .ladder import EXPOSITION_BUCKETS, exposition_buckets
from .registry import ModelRuntime

log = logging.getLogger("ai4e_tpu_torch.batcher")


class BatcherSaturated(RuntimeError):
    pass


@dataclass
class _Pending:
    example: np.ndarray
    future: asyncio.Future
    enqueued: float = field(default_factory=time.perf_counter)
    priority: int = 0  # 0 = interactive, higher = background
    # Absolute deadline (unix seconds; 0.0 = none): past it the entry is
    # dropped at the cut with DeadlineExceeded instead of batched.
    deadline_at: float = 0.0
    # observability.HopLedger the worker passed; None stamps nothing.
    ledger: object = None


class MicroBatcher:
    def __init__(self, runtime: ModelRuntime, max_wait_ms: float = 5.0,
                 max_pending: int = 256,
                 metrics: MetricsRegistry | None = None,
                 pipeline_depth: int = 2, interactive_reserve: float = 0.25,
                 priority_aging_s: float = 2.0, measure_phases: bool = False,
                 ladder_manager=None, double_buffer: bool = False):
        self.runtime = runtime
        self.max_wait = max_wait_ms / 1000.0
        self.max_pending = max_pending
        self._background_cap = max(1, int(max_pending
                                          * (1.0 - interactive_reserve)))
        self.priority_aging_s = priority_aging_s
        self.metrics = metrics or DEFAULT_REGISTRY
        self._pending: dict[str, list[_Pending]] = {}
        self._wakeup = asyncio.Event()
        self._stop = False
        self._draining = False
        self._flusher: asyncio.Task | None = None
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.pipeline_depth = pipeline_depth
        self._executor = ThreadPoolExecutor(max_workers=pipeline_depth,
                                            thread_name_prefix="device-batcher")
        self._window = asyncio.Semaphore(pipeline_depth)
        self._inflight_execs: set[asyncio.Task] = set()
        self._ladders = ladder_manager
        # With derivation on, the ai4e_batch_size buckets are the servables'
        # own ladders (register every model before building the batcher).
        expo = (exposition_buckets(runtime.models.values())
                if ladder_manager is not None else EXPOSITION_BUCKETS)
        self._batch_size_hist = self.metrics.histogram(
            "ai4e_batch_size", "Executed batch sizes",
            buckets=(*expo, float("inf")))
        self._batch_latency = self.metrics.histogram(
            "ai4e_batch_exec_seconds", "Device execution time per batch")
        self._queue_wait = self.metrics.histogram(
            "ai4e_batch_queue_wait_seconds", "Request wait before batching")
        self._pending_gauge = self.metrics.gauge(
            "ai4e_batcher_pending", "Requests waiting for a batch slot")
        self._inflight_gauge = self.metrics.gauge(
            "ai4e_batcher_inflight_batches",
            "Device batches currently in the pipeline window")
        self._h2d_bytes = self.metrics.counter(
            "ai4e_batch_h2d_bytes_total",
            "Host-to-device bytes shipped (padded batches)")
        self._d2h_bytes = self.metrics.counter(
            "ai4e_batch_d2h_bytes_total",
            "Device-to-host bytes fetched (batch outputs)")
        self._expired_total = self.metrics.counter(
            "ai4e_admission_expired_total",
            "Requests dropped on deadline expiry, by hop/priority")
        self.measure_phases = measure_phases
        if measure_phases:
            self._phase_hist = self.metrics.histogram(
                "ai4e_device_phase_seconds",
                "Device-boundary phase durations (h2d/compile/execute/"
                "d2h) per batch")
            self._overlap_total = self.metrics.counter(
                "ai4e_batch_h2d_overlap_seconds_total",
                "H2D transfer seconds that overlapped another batch's "
                "execute phase")
            self._overlap_ratio = self.metrics.gauge(
                "ai4e_batch_overlap_ratio",
                "Cumulative h2d/execute overlap ratio (overlapped h2d "
                "seconds / total h2d seconds)")
            self._phase_lock = threading.Lock()
            # Completed execute windows and in-flight batches' execute
            # starts: what a batch's h2d window is held against. On the
            # fused path an in-flight window is taken from the batch's call
            # start (its own h2d included), which over-counts a little; on
            # the double-buffered path it starts at the execute stage.
            self._exec_windows: deque = deque(maxlen=64)
            self._exec_pending: dict[int, float] = {}
            self._h2d_seconds = 0.0
            self._h2d_overlap_seconds = 0.0
        self._pad_enabled = measure_phases or ladder_manager is not None
        if self._pad_enabled:
            self._pad_state: dict[str, list[int]] = {}
            self._pad_ratio = self.metrics.gauge(
                "ai4e_batch_pad_ratio",
                "Cumulative padded-slots / occupied-slots per model "
                "(0 = every executed batch exactly filled its bucket)")
            self._pad_bytes = self.metrics.counter(
                "ai4e_batch_pad_bytes_total",
                "Host-to-device bytes spent on bucket padding, per model")
        self._double = bool(
            double_buffer
            and getattr(runtime, "supports_split_phases", None) is not None
            and runtime.supports_split_phases())
        if self._double:
            self._h2d_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="device-h2d")
            self._exec_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="device-exec")
            self._d2h_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="device-d2h")
            # Host staging ring per (model, bucket), pipeline_depth buffers:
            # the window admits at most pipeline_depth batches, in order,
            # so a buffer is never handed out again before its batch's
            # copy to the card completed.
            self._staging: dict[tuple[str, int], list] = {}
            self._staging_idx: dict[tuple[str, int], int] = {}

    # -- request side ------------------------------------------------------

    @property
    def pending_count(self) -> int:
        return sum(len(v) for v in self._pending.values())

    async def submit(self, model_name: str, example: np.ndarray,
                     priority: int = 0, deadline_at: float = 0.0,
                     ledger=None):
        """Queue one example; resolves to its postprocessed result.
        ``priority`` 0 is interactive, higher values background.
        ``deadline_at`` (absolute unix seconds, 0.0 none): still pending
        when it passes, the await raises ``DeadlineExceeded`` at the next
        cut and the example never reaches the card. ``ledger`` (an
        ``observability.HopLedger``) gets the batch cut and the device
        phases this example rides."""
        if self._stop:
            raise RuntimeError("batcher stopped")
        if self._draining:
            raise DrainingError("batcher draining; submit refused")
        cap = self.max_pending if priority <= 0 else self._background_cap
        if self.pending_count >= cap:
            raise BatcherSaturated(
                f"batcher at {self.pending_count}/{cap} pending "
                f"(priority {priority})")
        expected = tuple(self.runtime.models[model_name].input_shape)
        if tuple(example.shape) != expected:
            raise ValueError(
                f"bad input shape {example.shape}, expected {expected}")
        fut = asyncio.get_running_loop().create_future()
        self._pending.setdefault(model_name, []).append(
            _Pending(example, fut, priority=priority,
                     deadline_at=deadline_at, ledger=ledger))
        self._pending_gauge.set(self.pending_count)
        self._wakeup.set()
        return await fut

    # -- drain (rollout/drain.py drives these) -----------------------------

    def begin_drain(self) -> int:
        """Stop cutting new batches and retire every uncut pending entry
        with ``DrainingError``, in one synchronous step with the flip (no
        await), so a batch cut can never deliver into a future this sweep
        failed. Batches already in the window finish; ``drain_complete``
        turns true when they have."""
        self._draining = True
        retired = retire_pending(self._pending)
        self._pending_gauge.set(self.pending_count)
        self._wakeup.set()
        return retired

    @property
    def drain_complete(self) -> bool:
        """Draining AND quiesced: nothing pending, nothing on the device."""
        return (self._draining and not self._inflight_execs
                and self.pending_count == 0)

    def resume_from_drain(self) -> None:
        """Serve again after a drain."""
        self._draining = False
        self._wakeup.set()

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._stop = False
        self._flusher = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stop = True
        self._wakeup.set()
        if self._flusher is not None:
            await self._flusher
        if self._inflight_execs:
            await asyncio.gather(*self._inflight_execs,
                                 return_exceptions=True)
        self._executor.shutdown(wait=True)
        if self._double:
            for pool in (self._h2d_pool, self._exec_pool, self._d2h_pool):
                pool.shutdown(wait=True)

    # -- flusher -----------------------------------------------------------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
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
            if self._draining:
                # Anything that raced in between the retire sweep and the
                # submit-side refusal is retired, not cut.
                retire_pending(self._pending)
                self._pending_gauge.set(self.pending_count)
                continue
            for model_name in list(self._pending):
                if not self._cut_ready(model_name, now):
                    continue
                # Take the window slot BEFORE cutting: while every slot is
                # busy, arrivals keep joining the queue, so the cut made
                # when one frees is as full as possible.
                await self._window.acquire()
                batch, bucket = self._take_batch(model_name)
                if not batch:
                    self._window.release()
                    continue
                task = loop.create_task(
                    self._execute(loop, model_name, batch, bucket))
                self._inflight_execs.add(task)
                self._inflight_gauge.set(len(self._inflight_execs))

                def _done(t: asyncio.Task) -> None:
                    self._inflight_execs.discard(t)
                    self._inflight_gauge.set(len(self._inflight_execs))
                    self._window.release()

                task.add_done_callback(_done)

    def _cut_ready(self, model_name: str, now: float) -> bool:
        """Full largest bucket, or the oldest request waited ``max_wait``
        (this model's own ladder and window only)."""
        queue = self._pending.get(model_name)
        if not queue:
            return False
        servable = self.runtime.models.get(model_name)
        if servable is not None and len(queue) >= servable.max_bucket:
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
        """Cut the oldest requests up to the largest bucket and choose their
        bucket, both from ONE snapshot of the servable's ladder: a ladder
        swap between the cut and the execution cannot shrink the bucket
        below the cut (the old bucket's program stays warm)."""
        queue = self._pending.get(model_name, [])
        if not queue:
            return [], 0
        queue = self._sweep_expired(model_name, queue)
        if not queue:
            return [], 0
        ladder = tuple(self.runtime.models[model_name].batch_buckets)
        if self._ladders is not None:
            # The demand before clamping: observing the clamped cut would
            # let a ladder that shrank never grow back.
            self._ladders.observe_cut(model_name, len(queue))
        take = min(len(queue), ladder[-1])
        if take < len(queue):
            # Interactive first; waiting ages a class away every
            # priority_aging_s, oldest first within a class.
            now, aging = time.perf_counter(), self.priority_aging_s

            def effective(p: _Pending) -> float:
                if aging <= 0:
                    return float(p.priority)
                return p.priority - (now - p.enqueued) / aging

            queue = sorted(queue, key=effective)
        batch, self._pending[model_name] = queue[:take], queue[take:]
        self._pending_gauge.set(self.pending_count)
        bucket = next((b for b in ladder if b >= take), ladder[-1])
        return batch, bucket

    def _sweep_expired(self, model_name: str,
                       queue: list[_Pending]) -> list[_Pending]:
        """Drop the pending entries whose deadline passed while they
        waited: their futures get ``DeadlineExceeded("batcher")``, so no
        expired example reaches the card. Without an expired entry the
        queue comes back as it was."""
        now = time.time()
        if not any(p.deadline_at and p.deadline_at <= now for p in queue):
            return queue
        live: list[_Pending] = []
        for p in queue:
            if (p.deadline_at and p.deadline_at <= now
                    and not p.future.done()):
                p.future.set_exception(
                    DeadlineExceeded("batcher", p.deadline_at))
                self._expired_total.inc(hop="batcher",
                                        priority=priority_name(p.priority))
            else:
                live.append(p)
        self._pending[model_name] = live
        self._pending_gauge.set(self.pending_count)
        return live

    # -- accounting --------------------------------------------------------

    def _note_phases(self, model_name: str, t_return: float,
                     phases: dict, batch: list[_Pending], token: int) -> None:
        """Account one fused-path batch (``run_batch_phases`` measures
        durations): back-to-back windows ending where the call returned in
        its executor thread. JAX lays them from the call's start; the
        port's executor threads may wait there for the runtime's device
        lock, while the three phases run back to back once it is held."""
        windows: dict[str, tuple[float, float]] = {}
        cursor = t_return
        for phase in ("d2h", "execute", "compile", "h2d"):
            dur = phases.get(phase)
            if dur is None:
                continue
            windows[phase] = (cursor - dur, cursor)
            cursor -= dur
        self._note_phase_windows(model_name, windows, batch, token)

    def _note_phase_windows(self, model_name: str,
                            windows: dict[str, tuple[float, float]],
                            batch: list[_Pending], token: int) -> None:
        """Phase histograms, the h2d window's overlap with OTHER batches'
        execute windows (``token`` is this batch's own entry in
        ``_exec_pending``), and the device events of the batch's ledgers."""
        now = time.perf_counter()
        for phase, (w0, w1) in windows.items():
            self._phase_hist.observe(w1 - w0, phase=phase, model=model_name)
        h2d_w = windows.get("h2d")
        exec_w = windows.get("execute", windows.get("compile"))
        with self._phase_lock:
            if h2d_w is not None and h2d_w[1] > h2d_w[0]:
                h2d = h2d_w[1] - h2d_w[0]
                overlap = sum(max(0.0, min(h2d_w[1], w1) - max(h2d_w[0], w0))
                              for w0, w1 in self._exec_windows)
                overlap += sum(max(0.0, min(h2d_w[1], now) - max(h2d_w[0], s))
                               for tok, s in self._exec_pending.items()
                               if tok != token)
                overlap = min(overlap, h2d)
                self._h2d_seconds += h2d
                self._h2d_overlap_seconds += overlap
                self._overlap_total.inc(overlap, model=model_name)
                self._overlap_ratio.set(
                    self._h2d_overlap_seconds / self._h2d_seconds)
            if exec_w is not None:
                self._exec_windows.append(exec_w)
        ledgers = _batch_ledgers(batch)
        if ledgers:
            epoch_off = time.time() - now
            for phase in ("h2d", "compile", "execute", "d2h"):
                w = windows.get(phase)
                if w is None:
                    continue
                for ledger in ledgers:
                    ledger.stamp(phase, "device", t=epoch_off + w[0],
                                 ms=(w[1] - w[0]) * 1e3)

    def _note_pad(self, model_name: str, n: int, bucket: int,
                  example_nbytes: int) -> None:
        """Cumulative padded/occupied slot ratio and padding bytes."""
        if not self._pad_enabled:
            return
        state = self._pad_state.setdefault(model_name, [0, 0])
        state[0] += bucket - n
        state[1] += n
        self._pad_ratio.set(state[0] / state[1], model=model_name)
        if bucket > n:
            self._pad_bytes.inc((bucket - n) * example_nbytes,
                                model=model_name)

    def _staging_buffer(self, model_name: str, bucket: int,
                        servable) -> np.ndarray:
        """Next host staging buffer from the (model, bucket) ring, pinned on
        the card (``runtime.host_buffer``). Rings of buckets a ladder swap
        retired are dropped on every call (a shrink-only swap allocates no
        new ring, so sweeping only at allocation would keep them); this
        call's own bucket is exempt, as a cut may still ride the old
        ladder."""
        key = (model_name, bucket)
        live = set(servable.batch_buckets)
        for stale in [k for k in self._staging
                      if k[0] == model_name and k[1] not in live
                      and k[1] != bucket]:
            del self._staging[stale]
            self._staging_idx.pop(stale, None)
        ring = self._staging.get(key)
        if ring is None:
            ring = [self.runtime.host_buffer((bucket, *servable.input_shape),
                                             servable.input_dtype)
                    for _ in range(self.pipeline_depth)]
            self._staging[key] = ring
            self._staging_idx[key] = 0
        idx = self._staging_idx[key]
        self._staging_idx[key] = (idx + 1) % len(ring)
        return ring[idx]

    # -- execution ---------------------------------------------------------

    async def _execute(self, loop, model_name: str, batch: list[_Pending],
                       bucket: int) -> None:
        """Run one cut batch padded to ``bucket`` (chosen at the cut, never
        re-derived here), then deliver each request's result."""
        servable = self.runtime.models[model_name]
        n = len(batch)
        now = time.perf_counter()
        for p in batch:
            self._queue_wait.observe(now - p.enqueued, model=model_name)
        if self._double:
            await self._execute_pipelined(loop, model_name, servable, batch,
                                          n, bucket)
            return
        padded = np.zeros((bucket, *servable.input_shape), servable.input_dtype)
        for i, p in enumerate(batch):
            padded[i] = p.example
        _stamp_batched(batch, n, bucket)
        self._note_pad(model_name, n, bucket, padded.nbytes // bucket)
        token = id(batch)
        t0 = time.perf_counter()
        if self.measure_phases:
            with self._phase_lock:
                self._exec_pending[token] = t0

        def run():
            out = self.runtime.run_batch_phases(model_name, padded)
            return out, time.perf_counter()

        try:
            (outputs, poisoned, phases), t_return = await loop.run_in_executor(
                self._executor, run)
        except Exception as exc:  # noqa: BLE001 — a device failure fails the batch
            log.exception("batch execution failed for %s", model_name)
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
            return
        finally:
            if self.measure_phases:
                with self._phase_lock:
                    self._exec_pending.pop(token, None)
        if self.measure_phases:
            self._note_phases(model_name, t_return, phases, batch, token)
        # A mesh's per-rank phases (the primary's staging of each
        # follower's rows, the SPMD execute), keyed by rank in the reason.
        drain = getattr(self.runtime, "drain_process_phases", None)
        for label, rank, dur in (drain() if drain is not None else ()):
            for ledger in _batch_ledgers(batch):
                ledger.stamp(label, "device", reason=f"proc={rank}",
                             ms=dur * 1e3)
        self._batch_latency.observe(time.perf_counter() - t0, model=model_name)
        self._batch_size_hist.observe(n, model=model_name)
        self._h2d_bytes.inc(padded.nbytes, model=model_name)
        self._d2h_bytes.inc(_tree_nbytes(outputs), model=model_name)
        await self._deliver(loop, servable, batch, outputs, poisoned)

    async def _execute_pipelined(self, loop, model_name: str, servable,
                                 batch: list[_Pending], n: int,
                                 bucket: int) -> None:
        """The double-buffered path: pad into the next staging buffer, then
        h2d -> execute -> d2h on three single-thread executors, so batch
        N+1's copy to the card runs while batch N executes and batch N's
        copy back while batch N+1 executes."""
        buf = self._staging_buffer(model_name, bucket, servable)
        for i, p in enumerate(batch):
            buf[i] = p.example
        _stamp_batched(batch, n, bucket)
        if n < bucket:
            buf[n:] = 0  # the previous batch's rows must not ride as padding
        self._note_pad(model_name, n, bucket, buf.nbytes // bucket)
        token = id(batch)
        t0 = time.perf_counter()
        try:
            device_batch, h2d_w = await loop.run_in_executor(
                self._h2d_pool, self.runtime.h2d_resident, model_name, buf)
            if self.measure_phases:
                with self._phase_lock:
                    self._exec_pending[token] = time.perf_counter()
            try:
                out, label, exec_w = await loop.run_in_executor(
                    self._exec_pool, self.runtime.execute_resident,
                    model_name, device_batch)
            finally:
                if self.measure_phases:
                    with self._phase_lock:
                        self._exec_pending.pop(token, None)
            outputs, d2h_w = await loop.run_in_executor(
                self._d2h_pool, self.runtime.fetch_resident, out)
        except Exception as exc:  # noqa: BLE001 — a device failure fails the batch
            log.exception("batch execution failed for %s", model_name)
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
            return
        if self.measure_phases:
            self._note_phase_windows(
                model_name, {"h2d": h2d_w, label: exec_w, "d2h": d2h_w},
                batch, token)
        self._batch_latency.observe(d2h_w[1] - t0, model=model_name)
        self._batch_size_hist.observe(n, model=model_name)
        self._h2d_bytes.inc(buf.nbytes, model=model_name)
        self._d2h_bytes.inc(_tree_nbytes(outputs), model=model_name)
        await self._deliver(loop, servable, batch, outputs)

    async def _deliver(self, loop, servable, batch: list[_Pending],
                       outputs, poisoned: frozenset = frozenset()) -> None:
        """Postprocess on the executor, not the event loop (a heavy one,
        PNG-encoding 64 class maps, would stall every other request), and
        only for examples whose futures are not done (cancelled). Rows a
        degraded mesh rank invalidated (``poisoned``) fail with
        ``RowPoisoned`` instead, so the worker redelivers their tasks."""
        if poisoned:
            from .mesh.redelivery import RowPoisoned
            log.error("batch for %s: %d of %d rows poisoned by a degraded "
                      "rank; failing those tasks", servable.name,
                      sum(1 for i in range(len(batch)) if i in poisoned),
                      len(batch))
            for i, p in enumerate(batch):
                if i in poisoned and not p.future.done():
                    p.future.set_exception(RowPoisoned())
        wanted = [i for i, p in enumerate(batch) if not p.future.done()]

        def _fan_out() -> list:
            results: list = []
            for i in wanted:
                try:
                    results.append(
                        (True, servable.postprocess(_tree_index(outputs, i))))
                except Exception as exc:  # noqa: BLE001; ai4e: noqa[AIL005] — the exception is delivered to the example's future below, not dropped
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


def _batch_ledgers(batch: list[_Pending]) -> list:
    """The distinct ledgers of a batch's requests, in batch order."""
    seen: dict[int, object] = {}
    for p in batch:
        if p.ledger is not None:
            seen.setdefault(id(p.ledger), p.ledger)
    return list(seen.values())


def _stamp_batched(batch: list[_Pending], n: int, bucket: int) -> None:
    """``batched`` at the cut, once a ledger."""
    for ledger in _batch_ledgers(batch):
        ledger.stamp("batched", "batcher", reason=f"size {n} bucket {bucket}")


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
