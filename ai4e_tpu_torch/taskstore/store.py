"""In-process task store — the core of ``ai4e_tpu/taskstore/store.py``'s
``InMemoryTaskStore``: create/transition tasks atomically under one lock and
keep their results. No journal, replication or sharding."""

from __future__ import annotations

import threading
import time

from .task import APITask, new_task_id


class TaskNotFound(KeyError):
    pass


class InMemoryTaskStore:
    """Thread-safe in-process task store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tasks: dict[str, APITask] = {}
        # taskId -> (payload, content_type)
        self._results: dict[str, tuple[bytes, str]] = {}

    def upsert(self, task: APITask) -> APITask:
        """Create a task (fresh GUID unless one was supplied) or replace an
        existing one; returns the stored record. TaskIds must not contain
        ``:``, as in the JAX package's store, which keys pipeline-stage
        results ``{taskId}:{stage}``: an id the control plane would refuse
        is refused here too."""
        if ":" in task.task_id:
            raise ValueError(
                f"TaskId must not contain ':' (reserved as the result "
                f"stage separator): {task.task_id!r}")
        with self._lock:
            if not task.task_id:
                task.task_id = new_task_id()
            task.timestamp = time.time()
            self._tasks[task.task_id] = task
            return task

    def update_status(self, task_id: str, status: str,
                      backend_status: str | None = None) -> APITask:
        """Atomic status transition by id."""
        with self._lock:
            return self._apply_update(task_id, status, backend_status)

    def update_status_if(self, task_id: str, expected_status: str,
                         status: str,
                         backend_status: str | None = None) -> APITask | None:
        """Status transition iff the canonical status is still
        ``expected_status``; None otherwise."""
        with self._lock:
            current = self._tasks.get(task_id)
            if current is None or current.canonical_status != expected_status:
                return None
            return self._apply_update(task_id, status, backend_status)

    def _apply_update(self, task_id: str, status: str,
                      backend_status: str | None) -> APITask:
        prev = self._tasks.get(task_id)
        if prev is None:
            raise TaskNotFound(task_id)
        task = prev.with_status(status, backend_status)
        self._tasks[task_id] = task
        return task

    def get(self, task_id: str) -> APITask:
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None:
                raise TaskNotFound(task_id)
            return task

    def set_result(self, task_id: str, result: bytes,
                   content_type: str = "application/json") -> None:
        """Store a task's result payload."""
        with self._lock:
            if task_id not in self._tasks:
                raise TaskNotFound(task_id)
            self._results[task_id] = (result, content_type)

    def get_result(self, task_id: str) -> tuple[bytes, str] | None:
        with self._lock:
            return self._results.get(task_id)
