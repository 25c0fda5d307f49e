"""In-process task store — ``InMemoryTaskStore`` of
``ai4e_tpu/taskstore/store.py``: the state machine the control plane's
HTTP surface, gateway and dispatcher share.

- ``upsert`` creates a task (fresh GUID unless one was supplied) or
  transitions an existing one, moving it between per-endpoint,
  per-status sets under one lock;
- the original request body is kept per task and replayed when the task is
  republished with an empty body (a worker handing a saturated task back);
- a task upserted with ``publish=True`` goes to the publisher (the broker)
  after the lock is released; a publish failure fails the task;
- listeners (the gateway's long-poll waiters) hear every transition;
- ``append_ledger`` / ``get_ledger`` keep each task's hop-ledger timeline
  (``observability/ledger.py``) beside its record: observability state,
  capped at ``MAX_EVENTS`` with one ``truncated`` marker;
- ``evict_terminal_older_than`` forgets finished tasks (record, body,
  results and timeline), the terminal retention
  ``taskstore.reaper.TaskReaper`` runs;
- ``set_len`` and ``depths`` count an endpoint's tasks by status (the
  autoscaler's signal).

No journal, replication, sharding or result offload: those are ROADMAP A18.
``dump_ledgers``, the rig's collection surface, waits for the rig.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

from .task import APITask, TaskStatus, new_task_id

log = logging.getLogger("ai4e_tpu_torch.taskstore")

Publisher = Callable[[APITask], None]


class TaskNotFound(KeyError):
    pass


class InMemoryTaskStore:
    """Thread-safe in-process task store."""

    def __init__(self):
        self._lock = threading.RLock()
        self._tasks: dict[str, APITask] = {}
        # task_id -> (body, content_type): what a republish replays.
        self._orig_bodies: dict[str, tuple[bytes, str]] = {}
        # "{taskId}" or "{taskId}:{stage}" -> (payload, content_type)
        self._results: dict[str, tuple[bytes, str]] = {}
        # task_id -> its keys in _results, so an eviction never scans them.
        self._result_keys: dict[str, set[str]] = {}
        # (endpoint_path, canonical_status) -> {task_id: score}
        self._sets: dict[tuple[str, str], dict[str, float]] = {}
        self._publisher: Publisher | None = None
        # Called outside the lock after every transition, from any thread.
        self._listeners: list[Callable[[APITask], None]] = []
        # task_id -> hop-ledger events; never journaled, dropped with the
        # record at eviction.
        self._ledgers: dict[str, list[dict]] = {}

    def set_publisher(self, publisher: Publisher | None) -> None:
        self._publisher = publisher

    @property
    def has_publisher(self) -> bool:
        """Whether a republished task reaches a broker."""
        return self._publisher is not None

    def add_listener(self, listener: Callable[[APITask], None]) -> None:
        self._listeners.append(listener)

    def _notify(self, task: APITask) -> None:
        for listener in self._listeners:
            try:
                listener(task)
            except Exception:  # noqa: BLE001 — observers must not break the store
                log.exception("task listener failed for %s", task.task_id)

    def _publish_after(self, task: APITask, publisher: Publisher | None) -> None:
        if publisher is None:
            return
        try:
            publisher(task)
        except Exception as exc:  # noqa: BLE001 — recorded on the task itself
            self.update_status(task.task_id,
                               f"failed - could not publish task: {exc}",
                               backend_status=TaskStatus.FAILED)

    # -- core state machine ------------------------------------------------

    def upsert(self, task: APITask) -> APITask:
        """Create or transition a task; returns the stored record. TaskIds
        must not contain ``:``, the result stage separator."""
        with self._lock:
            if ":" in task.task_id:
                raise ValueError(
                    f"TaskId must not contain ':' (reserved as the result "
                    f"stage separator): {task.task_id!r}")
            prev = self._tasks.get(task.task_id)
            if prev is None:
                if not task.task_id:
                    task.task_id = new_task_id()
                if task.body:
                    self._orig_bodies[task.task_id] = (task.body,
                                                       task.content_type)
            else:
                # Admission and cache state survive requeues.
                task.cache_key = task.cache_key or prev.cache_key
                task.deadline_at = task.deadline_at or prev.deadline_at
                if task.priority == 1 and prev.priority != 1:
                    task.priority = prev.priority
                if not prev.durable:
                    # Memory-only stays memory-only: a full upsert (the
                    # HTTP surface's records are durable by default) must
                    # not promote a cache hit's record.
                    task.durable = False
                if not task.body and task.publish:
                    # A republish: replay the original body and its type.
                    task.body, task.content_type = self._orig_bodies.get(
                        task.task_id, (b"", task.content_type))
                elif task.body and task.publish:
                    self._orig_bodies[task.task_id] = (task.body,
                                                       task.content_type)
                self._remove_from_set(prev)
            task.timestamp = time.time()
            self._tasks[task.task_id] = task
            self._add_to_set(task)
            publisher = self._publisher if task.publish else None
        self._notify(task)
        self._publish_after(task, publisher)
        return task

    def update_status(self, task_id: str, status: str,
                      backend_status: str | None = None) -> APITask:
        """Atomic status transition by id."""
        with self._lock:
            task = self._apply_update(task_id, status, backend_status)
        self._notify(task)
        return task

    def update_status_if(self, task_id: str, expected_status: str,
                         status: str,
                         backend_status: str | None = None) -> APITask | None:
        """Status transition iff the canonical status is still
        ``expected_status``; None otherwise."""
        with self._lock:
            current = self._tasks.get(task_id)
            if current is None or current.canonical_status != expected_status:
                return None
            task = self._apply_update(task_id, status, backend_status)
        self._notify(task)
        return task

    def _apply_update(self, task_id: str, status: str,
                      backend_status: str | None) -> APITask:
        prev = self._tasks.get(task_id)
        if prev is None:
            raise TaskNotFound(task_id)
        task = prev.with_status(status, backend_status)
        task.publish = False
        self._remove_from_set(prev)
        self._tasks[task_id] = task
        self._add_to_set(task)
        return task

    def get(self, task_id: str) -> APITask:
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None:
                raise TaskNotFound(task_id)
            return task

    # -- hop ledger (observability/ledger.py) --------------------------------

    def append_ledger(self, task_id: str, events: list[dict]) -> int:
        """Append hop-ledger events to a known task's timeline; returns the
        events kept. Past ``MAX_EVENTS`` the overflow is dropped behind a
        single ``truncated`` marker. Raises ``TaskNotFound`` for an unknown
        id; callers (the observability hub, the HTTP surface) drop the
        stamp, as the ledger is fail-open telemetry."""
        # Imported here: the observability package imports the task store.
        from ..observability.ledger import MAX_EVENTS, TRUNCATED, ledger_event
        with self._lock:
            if task_id not in self._tasks:
                raise TaskNotFound(task_id)
            timeline = self._ledgers.setdefault(task_id, [])
            kept = 0
            for ev in events:
                if len(timeline) >= MAX_EVENTS:
                    if timeline[-1].get("e") != TRUNCATED:
                        timeline.append(ledger_event(TRUNCATED, "store"))
                    break
                timeline.append(ev)
                kept += 1
            return kept

    def get_ledger(self, task_id: str) -> list[dict]:
        """The task's timeline; empty for an unknown task or one nothing
        stamped (reads never raise)."""
        with self._lock:
            return list(self._ledgers.get(task_id, ()))

    # -- results -----------------------------------------------------------

    def set_result(self, task_id: str, result: bytes,
                   content_type: str = "application/json",
                   stage: str | None = None) -> None:
        """Store a task's result payload (``stage``: a pipeline stage's
        intermediate result, keyed ``{taskId}:{stage}``)."""
        key = task_id if stage is None else f"{task_id}:{stage}"
        with self._lock:
            if task_id not in self._tasks:
                raise TaskNotFound(task_id)
            self._results[key] = (result, content_type)
            self._result_keys.setdefault(task_id, set()).add(key)

    def get_result(self, task_id: str,
                   stage: str | None = None) -> tuple[bytes, str] | None:
        key = task_id if stage is None else f"{task_id}:{stage}"
        with self._lock:
            return self._results.get(key)

    # -- retention -----------------------------------------------------------

    def evict_terminal_older_than(self, age_s: float) -> int:
        """Forget terminal (completed/failed) tasks whose last transition
        is older than ``age_s`` seconds: record, status-set entry, original
        body, results and timeline. Returns the number evicted; costs O(terminal
        history), which the eviction itself keeps bounded."""
        cutoff = time.time() - age_s
        with self._lock:
            victims = [task_id
                       for (_path, status), members in self._sets.items()
                       if status in TaskStatus.TERMINAL
                       for task_id, score in members.items() if score < cutoff]
            for task_id in victims:
                task = self._tasks.pop(task_id)
                self._remove_from_set(task)
                self._orig_bodies.pop(task_id, None)
                self._ledgers.pop(task_id, None)
                for key in self._result_keys.pop(task_id, ()):
                    self._results.pop(key, None)
        return len(victims)

    # -- status-set queries --------------------------------------------------

    def set_len(self, endpoint_path: str, status: str) -> int:
        """Tasks of ``endpoint_path`` in canonical ``status`` (the
        autoscaler's signal)."""
        with self._lock:
            return len(self._sets.get((endpoint_path, status), {}))

    def depths(self) -> dict[str, dict[str, int]]:
        """Per-endpoint per-status depths (the autoscaling signal)."""
        with self._lock:
            out: dict[str, dict[str, int]] = {}
            for (path, status), members in self._sets.items():
                out.setdefault(path, {s: 0 for s in TaskStatus.ALL})[status] = len(members)
            return out

    def _add_to_set(self, task: APITask) -> None:
        key = (task.endpoint_path, task.canonical_status)
        self._sets.setdefault(key, {})[task.task_id] = task.timestamp

    def _remove_from_set(self, task: APITask) -> None:
        members = self._sets.get((task.endpoint_path, task.canonical_status))
        if members is not None:
            members.pop(task.task_id, None)
