"""Per-shard terminal-event change feed — ``ShardChangeFeed`` of
``ai4e_tpu/taskstore/feed.py``, the long-poll fan-out surface.

Each shard publishes its transitions into one feed (the sharded store's
relay, ``sharding.ShardedTaskStore._relay``); a gateway long-poll parks a
future on the feed keyed by TaskId and is woken with the terminal record
itself, so no wake re-reads the store and N feeds carry every watcher.

No wakeup is missed: ``publish`` records a terminal event in a bounded
replay map and collects its waiters under the same lock under which
``wait_terminal`` checks that map and registers, so an event is either
seen at attach (replay) or delivered to the registered future. A
non-terminal transition drops the task's replay entry, so a task that
runs again (a redrive, a rescue) never answers with its last run's
record.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from collections import OrderedDict
from dataclasses import replace

from .task import APITask, TaskStatus

log = logging.getLogger("ai4e_tpu_torch.taskstore.feed")


class ShardChangeFeed:
    """Terminal-transition fan-out for one shard of the task keyspace.

    ``publish`` may fire from any thread (store listeners run outside the
    store lock on whatever thread mutated); waiters may live on any event
    loop — wakes cross loops via ``call_soon_threadsafe`` and take the
    same-loop fast path when the publisher is already on the waiter's
    loop (the single-process assembly's common case).
    """

    def __init__(self, shard_index: int = 0, recent: int = 4096):
        self.shard_index = shard_index
        # Monotonic event counter — observability (the /shards endpoint
        # reports it as the feed's position).
        self.seq = 0
        self._recent_cap = recent
        # task_id -> terminal record: the bounded replay window that closes
        # the attach-vs-event race. Insertion-ordered; oldest evicted first.
        self._recent: OrderedDict[str, APITask] = OrderedDict()
        # task_id -> frozenset[(loop, future)] — copy-on-write like the
        # gateway's waiter map, for the same reason: publish iterates from
        # any thread while waiters attach/detach on their loops.
        self._waiters: dict[str, frozenset] = {}
        self._lock = threading.Lock()

    # -- publish side (the shard relay) ------------------------------------

    def publish(self, task: APITask) -> None:
        """Feed one store transition. Non-terminal transitions wake nobody,
        but they DO invalidate the task's replay entry: a terminal task
        re-entering the lifecycle (redrive, reaper requeue, client
        re-submission under the same TaskId) must not let the NEXT
        long-poll answer instantly with the previous run's record."""
        if task.canonical_status not in TaskStatus.TERMINAL:
            with self._lock:
                self._recent.pop(task.task_id, None)
            return
        if task.body:
            # Watchers only ever need the wire shape (to_dict carries no
            # body): holding request payloads in the replay map would pin
            # up to ``recent`` bodies per shard past store retention —
            # exactly the memory the retention sweep exists to bound.
            task = replace(task, body=b"")
        with self._lock:
            self.seq += 1
            self._recent[task.task_id] = task
            self._recent.move_to_end(task.task_id)
            while len(self._recent) > self._recent_cap:
                self._recent.popitem(last=False)
            waiters = self._waiters.pop(task.task_id, frozenset())
        for loop, fut in waiters:
            self._wake(loop, fut, task)

    def invalidate(self, task_ids) -> None:
        """Drop replay entries for a set of tasks — the rebalance handoff
        calls this on the SOURCE shard's feed: the moved range's future
        transitions publish to the destination's feed, so a stale terminal
        record here would outlive any later redrive of the task (and
        answer a long-poll with the previous run's result if the slot
        ever moves back)."""
        with self._lock:
            for task_id in task_ids:
                self._recent.pop(task_id, None)

    @staticmethod
    def _wake(loop, fut, record) -> None:
        def setter() -> None:
            if not fut.done():
                fut.set_result(record)
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if loop is running:
            setter()
        else:
            try:
                loop.call_soon_threadsafe(setter)
            except RuntimeError:  # waiter's loop already closed — it's gone
                log.debug("feed wake for %s dropped: waiter loop closed",
                          record.task_id)

    # -- watcher side (gateway long-poll) ----------------------------------

    async def wait_terminal(self, task_id: str,
                            timeout: float) -> APITask | None:
        """Park until ``task_id`` reaches a terminal status; returns the
        terminal record, or None when ``timeout`` expires first. The
        replay-map check and the waiter registration happen under the
        feed lock, so a terminal event concurrent with attach is either
        returned immediately or delivered to the future — never missed."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        entry = (loop, fut)
        with self._lock:
            found = self._recent.get(task_id)
            if found is None:
                self._waiters[task_id] = self._waiters.get(
                    task_id, frozenset()) | {entry}
        if found is not None:
            return found
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            return None
        finally:
            self._drop_waiter(task_id, entry)

    def _drop_waiter(self, task_id: str, entry) -> None:
        with self._lock:
            entries = self._waiters.get(task_id)
            if not entries:
                return
            remaining = frozenset(e for e in entries if e is not entry)
            if remaining:
                self._waiters[task_id] = remaining
            else:
                del self._waiters[task_id]

    # -- introspection ------------------------------------------------------

    def recent_terminal(self, task_id: str) -> APITask | None:
        """The task's terminal record if it terminated within the replay
        window — the attach-race check, also usable as a read-free probe."""
        with self._lock:
            return self._recent.get(task_id)

    @property
    def watcher_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._waiters.values())
