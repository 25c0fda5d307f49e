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
- with a result backend (``taskstore/results.py``), a result at or over
  the offload threshold is written there and the store keeps a pointer;
  ``set_result_ref`` registers a blob a worker wrote itself, and
  ``open_result`` streams either kind;
- ``requeue_if`` and ``update_status_if`` act only if the task is still
  in the status the caller saw (the reaper's rescue, the redrive route);
- ``evict_terminal_older_than`` forgets finished tasks (record, body,
  results, blobs and timeline), the terminal retention
  ``taskstore.reaper.TaskReaper`` runs;
- ``set_len``, ``set_members``, ``endpoints`` and ``depths`` read the
  status sets (the autoscaler's signal, the reaper's scan).

``StoreSideEffects`` holds the publisher and listener plumbing the native
store (``taskstore/native.py``) shares. No journal, replication or
sharding: those are ROADMAP A18.1 and A18.2. ``dump_ledgers``, the rig's
collection surface, waits for the rig.
"""

from __future__ import annotations

import io
import logging
import threading
import time
from typing import Callable

from .task import APITask, TaskStatus, new_task_id

log = logging.getLogger("ai4e_tpu_torch.taskstore")

Publisher = Callable[[APITask], None]


class TaskNotFound(KeyError):
    pass


class StoreSideEffects:
    """Publisher and listener plumbing shared by the Python store and the
    native one (``taskstore/native.py``): transitions notify observers
    outside any lock, and a publish failure fails the task."""

    _publisher: Publisher | None
    _listeners: list

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
        except Exception as exc:  # noqa: BLE001; ai4e: noqa[AIL005] — the failure is recorded ON the task itself (failed - could not publish)
            self.update_status(task.task_id,
                               f"failed - could not publish task: {exc}",
                               backend_status=TaskStatus.FAILED)

    def update_status(self, task_id, status, backend_status=None):
        raise NotImplementedError


class InMemoryTaskStore(StoreSideEffects):
    """Thread-safe in-process task store. With a ``result_backend``
    (``taskstore/results.py``), a result of ``result_offload_threshold``
    bytes or more is written there and only a pointer is kept."""

    def __init__(self, result_backend=None,
                 result_offload_threshold: int | None = None):
        self._lock = threading.RLock()
        self._tasks: dict[str, APITask] = {}
        # task_id -> (body, content_type): what a republish replays.
        self._orig_bodies: dict[str, tuple[bytes, str]] = {}
        # "{taskId}" or "{taskId}:{stage}" -> (payload, content_type); a
        # payload of None means the bytes live in the result backend.
        self._results: dict[str, tuple[bytes | None, str]] = {}
        # task_id -> its keys in _results, so an eviction never scans them.
        self._result_keys: dict[str, set[str]] = {}
        self._result_backend = result_backend
        self._result_offload_threshold = result_offload_threshold
        # (endpoint_path, canonical_status) -> {task_id: score}
        self._sets: dict[tuple[str, str], dict[str, float]] = {}
        self._publisher: Publisher | None = None
        # Called outside the lock after every transition, from any thread.
        self._listeners: list[Callable[[APITask], None]] = []
        # task_id -> hop-ledger events; never journaled, dropped with the
        # record at eviction.
        self._ledgers: dict[str, list[dict]] = {}

    # -- core state machine ------------------------------------------------

    def upsert(self, task: APITask) -> APITask:
        """Create or transition a task; returns the stored record. TaskIds
        must not contain ``:``, the result stage separator."""
        with self._lock:
            if ":" in task.task_id:
                raise ValueError(
                    f"TaskId must not contain ':' (reserved as the result "
                    f"stage separator): {task.task_id!r}")
            task = self._apply_upsert(task)
            publisher = self._publisher if task.publish else None
        self._notify(task)
        self._publish_after(task, publisher)
        return task

    def _apply_upsert(self, task: APITask) -> APITask:
        """The state mutation of ``upsert``. Caller holds ``self._lock``."""
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
                # Memory-only stays memory-only: a full upsert (the HTTP
                # surface's records are durable by default) must not
                # promote a cache hit's record.
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
        return task

    def update_status(self, task_id: str, status: str,
                      backend_status: str | None = None) -> APITask:
        """Atomic status transition by id."""
        with self._lock:
            task = self._apply_update(task_id, status, backend_status)
        self._notify(task)
        return task

    # Conditional transitions: the reaper and the redrive route decide from
    # a snapshot, and must not clobber a task that moved on meanwhile.

    def requeue_if(self, task_id: str, expected_status: str) -> APITask | None:
        """Republish the task (an empty body: the original is replayed) iff
        its canonical status is still ``expected_status``; None otherwise."""
        with self._lock:
            current = self._tasks.get(task_id)
            if current is None or current.canonical_status != expected_status:
                return None
            task = self._apply_upsert(APITask(
                task_id=task_id, endpoint=current.endpoint, body=b"",
                status=TaskStatus.CREATED, backend_status=TaskStatus.CREATED,
                content_type=current.content_type, publish=True))
            publisher = self._publisher if task.publish else None
        self._notify(task)
        self._publish_after(task, publisher)
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
        intermediate result, keyed ``{taskId}:{stage}``). A payload at or
        over the offload threshold goes to the result backend first, outside
        the lock, and only its pointer becomes visible: a reader that sees
        the pointer always finds the blob."""
        key = task_id if stage is None else f"{task_id}:{stage}"
        owner = self._tasks.get(task_id)
        offload = (self._result_backend is not None
                   and self._result_offload_threshold is not None
                   and len(result) >= self._result_offload_threshold
                   # A memory-only record (a cache hit) keeps its result
                   # inline: nothing would ever evict its blob.
                   and (owner is None or owner.durable))
        if offload:
            self._result_backend.put(key, result, content_type)
        try:
            with self._lock:
                if task_id not in self._tasks:
                    raise TaskNotFound(task_id)
                self._set_result_in_memory(key, None if offload else result,
                                           content_type)
        except Exception:
            # No visible pointer references the blob just written (an
            # unknown or evicted task): reap it, or it stays on the mount.
            with self._lock:
                now = self._results.get(key)
            if offload and not (now is not None and now[0] is None):
                self._delete_blob(key)
            raise

    def _set_result_in_memory(self, key: str, result: bytes | None,
                              content_type: str) -> None:
        """``result is None`` is an offloaded pointer. Caller holds
        ``self._lock``."""
        prev = self._results.get(key)
        self._results[key] = (result, content_type)
        self._result_keys.setdefault(key.split(":", 1)[0], set()).add(key)
        if prev is not None and prev[0] is None and result is not None:
            # An inline value superseded a pointer: its blob is unreachable.
            # (A pointer rewrite overwrites the same blob in ``put``.)
            self._delete_blob(key)

    def _delete_blob(self, key: str) -> None:
        if self._result_backend is None:
            return
        try:
            self._result_backend.delete(key)
        except Exception:  # noqa: BLE001 — cleanup must not mask the result path
            log.exception("could not delete result blob %s", key)

    def get_result(self, task_id: str,
                   stage: str | None = None) -> tuple[bytes, str] | None:
        """The payload and its content type, an offloaded one fetched from
        the backend outside the lock; None when there is none."""
        key = task_id if stage is None else f"{task_id}:{stage}"
        with self._lock:
            found = self._results.get(key)
        if found is None:
            return None
        body, content_type = found
        if body is None:
            if self._result_backend is None:
                return None
            return self._result_backend.get(key)
        return body, content_type

    def set_result_ref(self, task_id: str,
                       content_type: str = "application/json",
                       stage: str | None = None) -> None:
        """Register a result the caller already wrote to the shared backend
        under its key (a worker writing straight to the result mount). The
        blob must exist before the pointer becomes visible."""
        if self._result_backend is None:
            raise RuntimeError(
                "no result backend configured (set result_dir) — cannot "
                "register a direct-to-storage result")
        key = task_id if stage is None else f"{task_id}:{stage}"
        found = self._result_backend.open(key)
        if found is None:
            raise FileNotFoundError(
                f"result blob {key!r} not present in the backend — write "
                "it before registering the pointer")
        found[0].close()
        with self._lock:
            if task_id not in self._tasks:
                raise TaskNotFound(task_id)
            self._set_result_in_memory(key, None, content_type)

    def open_result(self, task_id: str, stage: str | None = None):
        """``(file_like, content_type, size)`` or None: an offloaded result
        streams from the backend, an inline one through ``BytesIO``."""
        key = task_id if stage is None else f"{task_id}:{stage}"
        with self._lock:
            found = self._results.get(key)
        if found is None:
            return None
        body, content_type = found
        if body is None:
            if self._result_backend is None:
                return None
            return self._result_backend.open(key)
        return io.BytesIO(body), content_type, len(body)

    # -- retention -----------------------------------------------------------

    def evict_terminal_older_than(self, age_s: float) -> int:
        """Forget terminal (completed/failed) tasks whose last transition
        is older than ``age_s`` seconds: record, status-set entry, original
        body, results, offloaded blobs and timeline. Returns the number
        evicted; costs O(terminal history), which the eviction itself
        keeps bounded."""
        cutoff = time.time() - age_s
        blob_keys: list[str] = []
        evicted = 0
        try:
            with self._lock:
                victims = [task_id
                           for (_path, status), members in self._sets.items()
                           if status in TaskStatus.TERMINAL
                           for task_id, score in members.items()
                           if score < cutoff]
                for task_id in victims:
                    task = self._tasks.pop(task_id)
                    self._remove_from_set(task)
                    self._orig_bodies.pop(task_id, None)
                    self._ledgers.pop(task_id, None)
                    for key in self._result_keys.pop(task_id, ()):
                        found = self._results.pop(key, None)
                        if found is not None and found[0] is None:
                            blob_keys.append(key)
                    evicted += 1
        finally:
            # Backend I/O outside the lock, and in a finally: a victim
            # already forgotten must not leave its blob behind.
            for key in blob_keys:
                self._delete_blob(key)
        return evicted

    # -- status-set queries --------------------------------------------------

    def set_len(self, endpoint_path: str, status: str) -> int:
        """Tasks of ``endpoint_path`` in canonical ``status`` (the
        autoscaler's signal)."""
        with self._lock:
            return len(self._sets.get((endpoint_path, status), {}))

    def set_members(self, endpoint_path: str, status: str) -> list[str]:
        """The TaskIds in one status set, oldest transition first (the
        reaper's and the redrive sweep's scan)."""
        with self._lock:
            members = self._sets.get((endpoint_path, status), {})
            return sorted(members, key=members.__getitem__)

    def endpoints(self) -> list[str]:
        with self._lock:
            return sorted({path for path, _ in self._sets})

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
