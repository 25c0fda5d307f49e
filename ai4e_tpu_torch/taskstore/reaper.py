"""Terminal retention — the eviction half of ``TaskReaper`` in
``ai4e_tpu/taskstore/reaper.py``.

Every ``interval`` seconds the reaper evicts completed/failed tasks older
than ``terminal_retention`` from the store (record, original body,
results), so a long-running control plane's memory stays bounded at about
completion rate x retention. The stuck-task rescue (republishing a task
left ``running`` by a dead worker) is not ported: ROADMAP A18.7.
"""

from __future__ import annotations

import asyncio
import logging

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from .store import InMemoryTaskStore

log = logging.getLogger("ai4e_tpu_torch.reaper")


class TaskReaper:
    def __init__(self, store: InMemoryTaskStore, terminal_retention: float,
                 interval: float = 30.0,
                 metrics: MetricsRegistry | None = None):
        self.store = store
        self.terminal_retention = terminal_retention
        self.interval = interval
        self.metrics = metrics or DEFAULT_REGISTRY
        self._reaped = self.metrics.counter(
            "ai4e_reaper_actions_total", "Stuck-task rescues by outcome")
        self._task: asyncio.Task | None = None
        self._stop = asyncio.Event()

    async def start(self) -> None:
        self._stop.clear()
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task
            self._task = None

    async def _run(self) -> None:
        while not self._stop.is_set():
            try:
                await asyncio.wait_for(self._stop.wait(), timeout=self.interval)
                return
            except asyncio.TimeoutError:
                pass
            try:
                await self.sweep()
            except Exception:  # noqa: BLE001 — the watchdog must not die
                log.exception("reaper sweep failed")

    async def sweep(self) -> int:
        """One eviction pass; returns the number of tasks evicted."""
        evicted = self.store.evict_terminal_older_than(self.terminal_retention)
        if evicted:
            log.info("evicted %d terminal tasks older than %.0fs", evicted,
                     self.terminal_retention)
            self._reaped.inc(evicted, outcome="evicted")
        return evicted
