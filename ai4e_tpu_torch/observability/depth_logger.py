"""Periodic queue-depth gauges; a copy of
``ai4e_tpu/observability/depth_logger.py``.

Two timers sample the task store's per-endpoint depths into
``ai4e_task_depth{endpoint,status}``: the awaiting (``created``) depth
every ``queue_interval`` seconds (30 s by default, the scaling signal),
and the running/completed/failed totals every ``process_interval`` (300
s; they only trend). The JAX control plane always runs one; so does the
port's.
"""

from __future__ import annotations

import asyncio
import logging

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from ..taskstore import TaskStatus

log = logging.getLogger("ai4e_tpu_torch.depth")


class DepthLogger:
    """Samples per-endpoint task depths from a store into gauges.

    ``queue_interval`` covers the awaiting (= ``created``) depth — the scaling
    signal needs to be fresh (30 s in the reference); ``process_interval``
    covers the running/completed/failed totals (5 min — they only trend).
    """

    def __init__(self, store, metrics: MetricsRegistry | None = None,
                 queue_interval: float = 30.0,
                 process_interval: float = 300.0):
        self.store = store
        self.metrics = metrics or DEFAULT_REGISTRY
        self.queue_interval = queue_interval
        self.process_interval = process_interval
        self._depth = self.metrics.gauge(
            "ai4e_task_depth", "Tasks per endpoint per status")
        # HA visibility (stores with a replica role — FollowerTaskStore):
        # alert on role flips and on a fencing epoch that disagrees across
        # the pair (split-brain would show as two role=1 or epoch skew).
        self._role = self.metrics.gauge(
            "ai4e_store_role", "1 when this replica is the primary")
        self._epoch = self.metrics.gauge(
            "ai4e_store_epoch", "Fencing epoch of this store's lineage")
        self._tasks: list[asyncio.Task] = []

    # -- sampling ----------------------------------------------------------

    def sample_queue_depth(self) -> dict[str, int]:
        """Awaiting-dispatch depth per endpoint (TaskQueueLogger.cs:20-27)."""
        out = {}
        for path, by_status in self.store.depths().items():
            n = by_status.get(TaskStatus.CREATED, 0)
            self._depth.set(float(n), endpoint=path, status=TaskStatus.CREATED)
            out[path] = n
        role = getattr(self.store, "role", None)
        if role is not None:
            self._role.set(1.0 if role == "primary" else 0.0)
            self._epoch.set(float(getattr(self.store, "epoch", 0)))
        return out

    def sample_process_depths(self) -> dict[str, dict[str, int]]:
        """Running/completed/failed depths (TaskProcessLogger.cs:22-31)."""
        all_depths = self.store.depths()
        for path, by_status in all_depths.items():
            for status in (TaskStatus.RUNNING, TaskStatus.COMPLETED,
                           TaskStatus.FAILED):
                self._depth.set(float(by_status.get(status, 0)),
                                endpoint=path, status=status)
        return all_depths

    # -- timers ------------------------------------------------------------

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._tick(self.queue_interval,
                                        self.sample_queue_depth)),
            loop.create_task(self._tick(self.process_interval,
                                        self.sample_process_depths)),
        ]

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []

    async def _tick(self, interval: float, sample) -> None:
        while True:
            try:
                sample()
            except Exception:  # noqa: BLE001 — telemetry must not die
                log.exception("depth sample failed")
            await asyncio.sleep(interval)
