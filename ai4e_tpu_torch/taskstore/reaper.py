"""Task reaper — ``TaskReaper`` of ``ai4e_tpu/taskstore/reaper.py``:
the stuck-task rescue and the terminal retention.

Every ``interval`` seconds the reaper:

- evicts completed/failed tasks older than ``terminal_retention`` from the
  store (record, original body, results, offloaded blobs), so a
  long-running control plane's memory stays bounded at about completion
  rate x retention (None keeps history forever);
- republishes a task left in ``running`` longer than ``running_timeout``
  (its worker died after adopting it): an empty body, so the store
  replays the original one, and the broker redelivers it under the same
  TaskId (None disables the rescue);
- fails such a task instead after ``max_requeues`` rescues (``failed - no
  progress after {n} rescues``), so a task that keeps killing workers
  ends; its budget is released only on a terminal outcome;
- leaves ``created`` tasks alone: their redelivery is the broker's.

Both actions are conditional (``requeue_if``, ``update_status_if``): a
task that completed between the scan and the action is never touched.

On a sharded store (``taskstore/sharding.py``) the scan runs shard by
shard (``shard_stores``), each over its own 1/N of the keyspace, and every
action routes through the facade. ``owns(task_id)`` (optional) is the
ownership filter of a reaper that serves one shard: a task whose slot
moved away between the scan and the rescue belongs to the new owner's
reaper and is skipped; the store's write fence (``NotOwnerError``) backs
it up.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from .store import InMemoryTaskStore
from .task import TaskStatus

log = logging.getLogger("ai4e_tpu_torch.reaper")


class TaskReaper:
    def __init__(self, store: InMemoryTaskStore,
                 running_timeout: float | None = 600.0,
                 interval: float = 30.0,
                 max_requeues: int = 3,
                 terminal_retention: float | None = None,
                 owns=None,
                 metrics: MetricsRegistry | None = None):
        self.store = store
        self.running_timeout = running_timeout
        self.interval = interval
        self.max_requeues = max_requeues
        self.terminal_retention = terminal_retention
        self.owns = owns
        self.metrics = metrics or DEFAULT_REGISTRY
        self._reaped = self.metrics.counter(
            "ai4e_reaper_actions_total", "Stuck-task rescues by outcome")
        # task_id -> rescues so far.
        self._requeues: dict[str, int] = {}
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
        """One scan; returns the number of tasks acted on. The rescue costs
        O(running tasks), through the per-endpoint ``running`` sets; the
        eviction O(terminal history), which it keeps bounded."""
        now = time.time()
        acted = 0
        if self.terminal_retention is not None:
            evict = getattr(self.store, "evict_terminal_older_than", None)
            if evict is not None:
                evicted = evict(self.terminal_retention)
                if evicted:
                    log.info("evicted %d terminal tasks older than %.0fs",
                             evicted, self.terminal_retention)
                    self._reaped.inc(evicted, outcome="evicted")
                    acted += evicted
        if self.running_timeout is None:
            return acted
        running = self._collect_running()
        running_ids = {t.task_id for t in running}
        # Budgets are released only on terminal outcomes: a rescued task
        # waiting in created keeps its count, or a poison task would cycle
        # forever.
        for tid in list(self._requeues):
            if tid in running_ids:
                continue
            try:
                status = self.store.get(tid).canonical_status
            except KeyError:
                del self._requeues[tid]
                continue
            if status in TaskStatus.TERMINAL:
                del self._requeues[tid]
        for task in running:
            age = now - task.timestamp
            if age < self.running_timeout:
                continue
            if not self._owned(task.task_id):
                # A rebalance moved the task's slot after the scan: the new
                # owner's sweep rescues it.
                continue
            count = self._requeues.get(task.task_id, 0)
            if count >= self.max_requeues:
                done = self.store.update_status_if(
                    task.task_id, TaskStatus.RUNNING,
                    f"failed - no progress after {count} rescues",
                    backend_status=TaskStatus.FAILED)
                if done is None:
                    continue
                log.warning("task %s stuck running after %d rescues; failed",
                            task.task_id, count)
                self._reaped.inc(outcome="failed")
            else:
                requeued = self.store.requeue_if(task.task_id,
                                                 TaskStatus.RUNNING)
                if requeued is None:
                    continue
                log.warning("task %s running %.0fs with no progress; "
                            "republished (rescue %d/%d)", task.task_id, age,
                            count + 1, self.max_requeues)
                self._requeues[task.task_id] = count + 1
                self._reaped.inc(outcome="requeued")
            acted += 1
        return acted

    def _collect_running(self) -> list:
        """A snapshot of every task in ``running``, shard by shard on a
        sharded store."""
        shards_fn = getattr(self.store, "shard_stores", None)
        sources = shards_fn() if shards_fn is not None else [self.store]
        running: list = []
        for source in sources:
            for path in source.endpoints():
                for task_id in source.set_members(path, TaskStatus.RUNNING):
                    try:
                        running.append(source.get(task_id))
                    except KeyError:
                        continue
        return running

    def _owned(self, task_id: str) -> bool:
        if self.owns is None:
            return True
        try:
            return bool(self.owns(task_id))
        except Exception:  # noqa: BLE001 — an ownership-probe fault must not kill the sweep
            log.exception("shard ownership probe failed for %s; skipping "
                          "rescue this sweep", task_id)
            return False
