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
store (``taskstore/native.py``) shares.

``JournaledTaskStore`` adds crash durability: every mutation appends one
checksummed, hash-chained record (``taskstore/journal.py``) under the store
lock before it is acknowledged, with the fsync policy of
``AI4E_TASKSTORE_FSYNC``; a restart salvages a torn tail and replays the
file to the same state; a disk fault flips the store to read-only degraded
mode until ``recover()``; the journal compacts itself once it holds twice
the live records. ``FollowerTaskStore`` is the HA pair's replica: it absorbs
the primary's journal stream (``taskstore/replication.py``) into its own
journal and refuses writes with ``NotPrimaryError`` until ``promote()``
mints the next fencing epoch; a primary that learns of a newer epoch
demotes itself. Journal files are byte-compatible with the JAX package's
both ways.

For the sharded store (``taskstore/sharding.py``) every store takes a write
fence (``set_write_fence``): each task or result mutation checks, under the
store lock, that the hash ring still assigns the TaskId here, and a stale
owner raises ``NotOwnerError``. ``export_task_records`` and
``import_task_records`` carry a slot's range between shards in the
journal's full-record shape (journaled on the importer), and
``forget_tasks`` drops it from the old owner, journaled as ``Evict``
records with ``KeepBlobs``, so no replay deletes blobs the new owner's
pointers hold. ``dump_ledgers`` reads every resident hop ledger out at
once (a run's timeline export); the sharded store has no such fan-out, as
in JAX, and ``GET /v1/rig/ledgers``, which serves it, stays with the rig.
"""

from __future__ import annotations

import io
import logging
import os
import threading
import time
from dataclasses import replace
from typing import Callable

from .task import APITask, TaskStatus, new_task_id

log = logging.getLogger("ai4e_tpu_torch.taskstore")

Publisher = Callable[[APITask], None]


class TaskNotFound(KeyError):
    pass


class NotPrimaryError(RuntimeError):
    """A mutation reached a follower replica: only the primary takes
    writes (the HTTP surface answers 503 + ``X-Not-Primary``, so store
    clients rotate)."""


class StoreClosedError(RuntimeError):
    """A mutation reached a closed store."""


class NotOwnerError(RuntimeError):
    """A mutation reached a shard store for a TaskId the hash ring no longer
    assigns to it: the caller raced a rebalance handoff and holds the stale
    owner (``taskstore/sharding.py``). Checked under the store lock, which
    the ring flip also holds, so a stale write never slips through; the
    sharded facade re-routes through a fresh ring lookup (the HTTP surface
    answers 409 + ``X-Not-Owner``)."""


class StaleEpochError(ValueError):
    """A demotion carried an epoch no newer than the store's own: the
    caller is the stale side (the HTTP surface answers 409)."""


class JournalDegradedError(RuntimeError):
    """The journal hit a disk fault (ENOSPC, EIO on append or fsync) and
    the store is read-only until ``recover()``: reads serve, mutations
    refuse with this error (503 + ``X-Shed-Reason: journal-degraded``).

    ``rollback`` tells the append's caller whether to unwind its memory
    mutation: True when the write or flush failed (the record may be torn
    or absent on disk), False when only the fsync failed (the bytes are in
    the file, so memory keeps them and only the acknowledgment is
    refused)."""

    def __init__(self, message: str, rollback: bool = True):
        super().__init__(message)
        self.rollback = rollback


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

    # True while applying already-accepted history verbatim (journal
    # replay, follower absorb): no TaskId validation, and records keep
    # their own timestamps.
    _absorbing = False
    # A closed store refuses mutations (StoreClosedError); reads serve.
    _closed = False

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
        # The shard ownership fence (``set_write_fence``); None, as on every
        # unsharded store, checks nothing.
        self._write_fence: Callable[[str], bool] | None = None

    # -- core state machine ------------------------------------------------

    def upsert(self, task: APITask) -> APITask:
        """Create or transition a task; returns the stored record. TaskIds
        must not contain ``:``, the result stage separator."""
        with self._lock:
            if ":" in task.task_id and self._validates_task_ids():
                raise ValueError(
                    f"TaskId must not contain ':' (reserved as the result "
                    f"stage separator): {task.task_id!r}")
            task = self._apply_upsert(task)
            publisher = self._publisher if task.publish else None
        self._notify(task)
        self._publish_after(task, publisher)
        return task

    def _validates_task_ids(self) -> bool:
        """Whether ``upsert`` refuses reserved TaskIds: not while absorbing
        history, which must apply as it was accepted."""
        return not self._absorbing

    def set_write_fence(self, fence: Callable[[str], bool] | None) -> None:
        """Install (or clear) the shard ownership fence: ``fence(task_id)``
        answers whether this store owns the id now. It runs under the store
        lock on every mutation, so it must be cheap and take no other
        lock."""
        self._write_fence = fence

    def _check_owner(self, task_id: str) -> None:
        """The fence's gate for task and result mutations. Skipped while
        absorbing (history applies verbatim, and a rebalance import is the
        new owner receiving its range) and for an empty id (minted below,
        by a store that owns a fresh GUID). Eviction is not fenced: it can
        neither resurrect nor clobber a task, and a move's own cleanup
        runs as the non-owner."""
        fence = self._write_fence
        if fence is None or self._absorbing or not task_id:
            return
        if not fence(task_id):
            raise NotOwnerError(
                f"task {task_id} is no longer owned by this shard "
                "(rebalance moved its hash slot); route via the ring")

    def _apply_upsert(self, task: APITask) -> APITask:
        """The state mutation of ``upsert``. Caller holds ``self._lock``;
        the journaled store extends it."""
        self._check_open()
        self._check_owner(task.task_id)
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
        if not (self._absorbing and task.timestamp):
            # Absorbed history keeps its own timestamp, so set scores and
            # the reaper's age clock survive a restart or a failover.
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
        self._check_open()
        self._check_owner(task_id)
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

    def get_original_body(self, task_id: str) -> bytes:
        """The body a republish replays; empty when there is none."""
        with self._lock:
            return self._orig_bodies.get(task_id, (b"", ""))[0]

    # -- hop ledger (observability/ledger.py) --------------------------------

    def append_ledger(self, task_id: str, events: list[dict]) -> int:
        """Append hop-ledger events to a known task's timeline; returns the
        events kept. Past ``MAX_EVENTS`` the overflow is dropped behind a
        single ``truncated`` marker. Raises ``TaskNotFound`` for an unknown
        id; callers (the observability hub, the HTTP surface) drop the
        stamp, as the ledger is fail-open telemetry."""
        # Imported here: the observability package imports the task store.
        from ..observability.ledger import MAX_EVENTS, TRUNCATED, ledger_event
        check_writable = getattr(self, "_check_writable", None)
        with self._lock:
            self._check_open()
            if check_writable is not None:
                check_writable()
            self._check_owner(task_id)
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

    def dump_ledgers(self, limit: int = 5000) -> dict[str, list[dict]]:
        """Every resident timeline, the newest ``limit`` by first stamp:
        hop ledgers are memory-only, so a run's timeline export reads them
        out before the process ends. Reads never raise."""
        with self._lock:
            items = list(self._ledgers.items())
        if limit >= 0:
            items = items[-limit:] if limit else []
        return {tid: list(evs) for tid, evs in items}

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
                self._apply_set_result(key, None if offload else result,
                                       content_type)
        except Exception:
            # No visible pointer references the blob just written (an
            # unknown or evicted task): reap it, or it stays on the mount.
            with self._lock:
                now = self._results.get(key)
            if offload and not (now is not None and now[0] is None):
                self._delete_blob(key)
            raise

    def _apply_set_result(self, key: str, result: bytes | None,
                          content_type: str) -> None:
        """The result mutation (``result is None``: an offloaded pointer).
        Caller holds ``self._lock``; the journaled store extends it."""
        self._check_open()
        self._check_owner(key.split(":", 1)[0])
        self._set_result_in_memory(key, result, content_type)

    def _set_result_in_memory(self, key: str, result: bytes | None,
                              content_type: str) -> None:
        """The unchecked memory half of a result write, which the journaled
        store also applies after an fsync failure left the record in the
        file. Caller holds ``self._lock``."""
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
            self._apply_set_result(key, None, content_type)

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
                    blob_keys.extend(self._apply_evict(task_id))
                    evicted += 1
        finally:
            # Backend I/O outside the lock, and in a finally: a victim
            # already forgotten (and journaled) must not leave its blob
            # behind when a later one aborts the sweep.
            for key in blob_keys:
                self._delete_blob(key)
        return evicted

    def _apply_evict(self, task_id: str) -> list[str]:
        """Forget one task entirely; returns the offloaded result keys whose
        blobs the caller deletes, outside the lock. Caller holds
        ``self._lock``; the journaled store extends it."""
        task = self._tasks.pop(task_id, None)
        if task is None:
            return []
        self._remove_from_set(task)
        self._orig_bodies.pop(task_id, None)
        self._ledgers.pop(task_id, None)
        blob_keys = []
        for key in self._result_keys.pop(task_id, ()):
            found = self._results.pop(key, None)
            if found is not None and found[0] is None:
                blob_keys.append(key)
        return blob_keys

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

    def snapshot(self) -> list[APITask]:
        with self._lock:
            return list(self._tasks.values())

    def unfinished_tasks(self) -> list[APITask]:
        """Tasks not yet terminal, each with its original body: what a
        restarted or promoted control plane publishes again."""
        with self._lock:
            out = []
            for task in self._tasks.values():
                if task.canonical_status in TaskStatus.TERMINAL:
                    continue
                if not task.body:
                    body, ctype = self._orig_bodies.get(
                        task.task_id, (b"", task.content_type))
                    task = replace(task, body=body, content_type=ctype)
                out.append(task)
            return out

    # -- the journal's record shapes ---------------------------------------

    def _full_record(self, task: APITask) -> dict:
        """A task's full (non-slim) journal record, for appends and
        compaction alike."""
        rec = task.to_dict()
        rec["BodyHex"] = task.body.hex()
        orig = self._orig_bodies.get(task.task_id)
        if orig is not None:
            rec["OrigHex"] = orig[0].hex()
            rec["OrigContentType"] = orig[1]
        return rec

    def _result_record(self, key: str, body: bytes | None,
                       content_type: str) -> dict:
        """A result's journal record: the payload as hex, or for an
        offloaded one only the pointer."""
        rec = {"Result": True, "Key": key, "ContentType": content_type}
        if body is None:
            rec["Offloaded"] = True
        else:
            rec["ResultHex"] = body.hex()
        return rec

    # -- the rebalance handoff (``taskstore/sharding.py`` move_slot) --------

    def export_task_records(self, task_ids) -> list[dict]:
        """Full journal-shaped records (task with its original body, then
        its results) for the given ids: what the new owner imports. Task
        records come first, as in a compacted journal. Memory-only records
        (cache hits) are skipped: they are lost to a handoff as to a
        restart."""
        with self._lock:
            recs: list[dict] = []
            wanted = []
            for tid in task_ids:
                task = self._tasks.get(tid)
                if task is None or not task.durable:
                    continue
                wanted.append(tid)
                recs.append(self._full_record(task))
            for tid in wanted:
                for key in self._result_keys.get(tid, ()):
                    found = self._results.get(key)
                    if found is not None:
                        recs.append(self._result_record(key, found[0],
                                                        found[1]))
            return recs

    def import_task_records(self, recs: list[dict]) -> int:
        """Absorb a range migrated from another shard, as a replay applies
        history: no id validation, no publish, no listener (every
        transition notified on the exporting shard), and on a journaled
        store appended to this store's journal, so a restart keeps the
        range. Idempotent: the move's delta pass imports records again.
        Returns the records applied."""
        applied = 0
        with self._lock:
            self._check_open()
            prev_absorbing = self._absorbing
            self._absorbing = True
            # No auto-compaction inside the import: the delta pass runs
            # under the source shard's lock, and an O(all tasks) rewrite
            # here would stall the source's keyspace. The next ordinary
            # append compacts.
            prev_compact_at = getattr(self, "_next_compact_at", None)
            if prev_compact_at is not None:
                self._next_compact_at = float("inf")
            try:
                for rec in recs:
                    if self._apply_import(rec):
                        applied += 1
            finally:
                self._absorbing = prev_absorbing
                if prev_compact_at is not None:
                    self._next_compact_at = prev_compact_at
        return applied

    def _apply_import(self, rec: dict) -> bool:
        """Apply one migrated record. Caller holds ``self._lock`` with
        ``_absorbing`` set. Epoch markers are skipped: an epoch belongs to
        the exporting shard's lineage."""
        if "Epoch" in rec or rec.get("Evict") or rec.get("Slim"):
            return False  # a migration exports full state only
        if rec.get("Result"):
            body = (None if rec.get("Offloaded")
                    else bytes.fromhex(rec.get("ResultHex", "")))
            self._apply_set_result(rec["Key"], body,
                                   rec.get("ContentType",
                                           "application/json"))
            return True
        task = APITask.from_dict(rec)
        task.body = bytes.fromhex(rec.get("BodyHex", ""))
        # Never published again: the task's broker message exists already,
        # and the ring routes its writes here.
        task.publish = False
        self._apply_upsert(task)  # absorbing: the timestamp is kept
        orig = rec.get("OrigHex")
        if orig:
            self._orig_bodies[task.task_id] = (
                bytes.fromhex(orig),
                rec.get("OrigContentType", "application/json"))
        return True

    # True while ``forget_tasks`` drops a migrated range: the journaled
    # store's Evict records then carry KeepBlobs, so neither the drop nor a
    # later replay of it deletes blobs the importing shard's pointers own
    # (the shards share one result backend). Flipped only under the lock.
    _forgetting = False

    def forget_tasks(self, task_ids) -> int:
        """Drop the given tasks entirely: the old owner's cleanup after a
        rebalance handoff. Unlike eviction, their offloaded result blobs
        are kept (``_forgetting``). Returns the tasks dropped."""
        with self._lock:
            dropped = 0
            self._forgetting = True
            try:
                for tid in list(task_ids):
                    if tid in self._tasks:
                        self._apply_evict(tid)  # the blob keys stay unused
                        dropped += 1
            finally:
                self._forgetting = False
            return dropped

    def _check_open(self) -> None:
        if self._closed:
            raise StoreClosedError("task store is closed")

    def close(self) -> None:
        self._closed = True


class JournaledTaskStore(InMemoryTaskStore):
    """``InMemoryTaskStore`` and an append-only journal: a restarted store
    salvages a torn tail, replays the file and resumes with the same tasks,
    sets, bodies, results and fencing epoch (JAX ``store.py:866-1661``).

    ``fsync`` (None: ``AI4E_TASKSTORE_FSYNC``) is ``never`` (write and
    flush: survives a process kill), ``always`` (an fsync an append) or
    ``group:<ms>`` (at most one fsync a window, a timer completing it).
    ``metrics`` (default: the process registry) gets the eight
    ``ai4e_journal_*`` series. ``compact_every`` records past the live
    count, the journal is rewritten as one record a live task and result
    (``journal_generation`` counts the rewrites; followers resync on it).
    A journal that cannot be opened or replayed raises here."""

    _absorbing = False

    def __init__(self, journal_path: str, compact_every: int = 5000,
                 result_backend=None,
                 result_offload_threshold: int | None = None,
                 fsync: str | None = None, metrics=None):
        super().__init__(result_backend=result_backend,
                         result_offload_threshold=result_offload_threshold)
        from ..metrics import DEFAULT_REGISTRY
        from . import journal as journal_format

        self._journal_format = journal_format
        self._journal_path = journal_path
        self._journal = None  # journaling is off while replaying
        self._closed = False
        # A malformed policy fails here, at construction.
        self._fsync_kind, self._fsync_group_s = (
            journal_format.parse_fsync_policy(fsync))
        self._fsync_last = 0.0
        self._fsync_timer = None        # the pending group-commit timer
        self._fsync_dirty = False       # bytes flushed, not yet fsynced
        self.degraded = False
        self.degraded_reason: str | None = None
        # The hash-chain head of this store's own journal file.
        self.chain_head = journal_format.GENESIS
        metrics = metrics or DEFAULT_REGISTRY
        self._m_fsyncs = metrics.counter(
            "ai4e_journal_fsyncs_total",
            "Journal fsync calls, by fsync policy")
        self._m_appended = metrics.counter(
            "ai4e_journal_appended_bytes_total",
            "Bytes appended to task-store journals")
        self._m_salvages = metrics.counter(
            "ai4e_journal_salvages_total",
            "Torn journal tails truncated at open, by reason")
        self._m_verify_fail = metrics.counter(
            "ai4e_journal_verify_failures_total",
            "Journal records that failed checksum/chain verification")
        self._m_degraded = metrics.gauge(
            "ai4e_journal_degraded",
            "1 while the store refuses mutations after a journal disk "
            "fault (read-only degraded mode)")
        self._m_degraded_total = metrics.counter(
            "ai4e_journal_degraded_total",
            "Times a journal disk fault flipped the store to degraded "
            "mode, by errno name")
        self._m_compactions = metrics.counter(
            "ai4e_journal_compactions_total",
            "Journal compaction rewrites")
        self._m_append_s = metrics.histogram(
            "ai4e_journal_append_seconds",
            "Journal append wall time (write+flush+policy fsync)")
        # This store's own counts for ``journal_stats`` (the registry sums
        # over stores).
        self._stat_bytes = 0
        self._stat_fsyncs = 0
        self._stat_compactions = 0
        self._stat_salvages = 0
        self._append_times: list[float] = []
        self._compact_every = compact_every
        self._records = 0
        self._next_compact_at = compact_every
        self.journal_generation = 0
        # The split-brain fencing epoch: minted +1 at every promotion and
        # journaled, so it survives restarts and compactions.
        self.epoch = 0
        self.replayed_task_ids: set[str] = set()
        if os.path.exists(journal_path):
            # Salvage before the replay and before the append handle opens,
            # so the next append never lands on torn bytes; an interior
            # corrupt record raises here with its offset.
            report = journal_format.salvage(journal_path)
            if report is not None:
                log.warning(
                    "journal %s: salvaged torn tail — dropped %d bytes at "
                    "offset %d (%s); %d records kept, chain head %s "
                    "(report: %s.salvage.json)", journal_path,
                    report.dropped_bytes, report.truncated_at,
                    report.reason, report.records_kept, report.chain_head,
                    journal_path)
                self._m_salvages.inc(reason=report.reason)
                self._stat_salvages += 1
            self._replay()
            self.replayed_task_ids = set(self._tasks)
            if self._records > 2 * max(self._live_records(), 1):
                self._compact_locked()
        if self._journal is None:
            self._journal = open(journal_path, "a",  # noqa: SIM115
                                 encoding="utf-8")

    def _replay(self) -> None:
        chain = self._journal_format.GENESIS
        with open(self._journal_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec, chain, _legacy = self._journal_format.verify_line(
                    line, chain)
                self._records += 1
                self._apply_replay_record(rec)
        self.chain_head = chain

    def _apply_replay_record(self, rec: dict) -> APITask | None:
        """Apply one journal record to memory: the replay step, and what a
        follower applies for each streamed line. Journaling is off in both
        cases, so nothing is appended again. Returns the task of a slim
        transition (the follower notifies its listeners of it; a full
        upsert notifies inside ``upsert``), else None."""
        if "Epoch" in rec:
            self.epoch = max(self.epoch, int(rec["Epoch"]))
            return None
        if rec.get("Result"):
            if rec.get("Offloaded") and self._result_backend is None:
                # Replaying the pointer without its backend would answer
                # "completed" with no result.
                raise RuntimeError(
                    f"journal references offloaded result "
                    f"{rec['Key']!r} but no result backend is "
                    f"configured (set result_dir to the same mount "
                    f"it was written to)")
            body = (None if rec.get("Offloaded")
                    else bytes.fromhex(rec.get("ResultHex", "")))
            self._results[rec["Key"]] = (
                body, rec.get("ContentType", "application/json"))
            self._result_keys.setdefault(
                rec["Key"].split(":", 1)[0], set()).add(rec["Key"])
            return None
        if rec.get("Evict"):
            # The blob deletes run again: a crash between the Evict append
            # and the deletes leaked them. A rebalance's KeepBlobs record
            # leaves them to the new owner.
            keys = self._apply_evict(rec["TaskId"])
            if not rec.get("KeepBlobs"):
                for key in keys:
                    self._delete_blob(key)
            return None
        if rec.get("Slim"):
            # A status transition: body and original body untouched, the
            # journaled timestamp kept.
            prev = self._tasks.get(rec["TaskId"])
            if prev is None:
                return None  # a compacted-away predecessor
            task = prev.with_status(rec["Status"], rec.get("BackendStatus"))
            task.publish = False
            task.timestamp = float(rec.get("Timestamp") or task.timestamp)
            self._remove_from_set(prev)
            self._tasks[task.task_id] = task
            self._add_to_set(task)
            return task
        task = APITask.from_dict(rec)
        task.body = bytes.fromhex(rec.get("BodyHex", ""))
        # Never published here: the platform re-seeds its broker from
        # ``unfinished_tasks()`` afterwards.
        task.publish = False
        InMemoryTaskStore.upsert(self, task)
        # Keep the journaled timestamp: set scores and the reaper's clock
        # survive the restart.
        stored = self._tasks[task.task_id]
        ts = float(rec.get("Timestamp") or stored.timestamp)
        stored.timestamp = ts
        self._sets[(stored.endpoint_path,
                    stored.canonical_status)][stored.task_id] = ts
        orig = rec.get("OrigHex")
        if orig:
            self._orig_bodies[task.task_id] = (
                bytes.fromhex(orig),
                rec.get("OrigContentType", "application/json"))
        return None

    def _log(self, task: APITask, slim: bool = False) -> None:
        # Under self._lock: journal order is mutation order.
        if self._journal is None or not task.durable:
            return
        if slim:
            # A transition never changes the bodies: no hex payload again.
            rec = task.to_dict()
            rec["Slim"] = True
        else:
            rec = self._full_record(task)
        self._append(rec)

    def _append(self, rec: dict) -> None:
        """Append one record under ``self._lock``, with the fsync policy;
        a disk fault raises ``JournalDegradedError``."""
        if self._journal is None:
            return
        self._check_degraded()
        start = time.monotonic()
        line, chain = self._journal_format.encode_record(rec,
                                                         self.chain_head)
        data = line + "\n"
        try:
            self._journal.write(data)
            self._journal.flush()
        except OSError as exc:
            # The bytes may be torn or absent: the caller unwinds its
            # memory mutation (rollback=True).
            raise self._enter_degraded(exc, "append") from exc
        self.chain_head = chain
        nbytes = len(data.encode("utf-8"))
        self._stat_bytes += nbytes
        self._m_appended.inc(nbytes)
        self._fsync_dirty = True
        if self._fsync_kind == "always":
            self._fsync_journal()
        elif self._fsync_kind == "group":
            self._group_commit()
        self._record_append_time(time.monotonic() - start)
        self._records += 1
        if (self._records >= self._next_compact_at
                and self._records > 2 * self._live_records()):
            # The mutation is in the file already: a failed rewrite (a full
            # disk) must not fail it, nor retry on the very next append.
            before = self._records
            try:
                self._compact_locked()
                log.info("journal compacted: %d -> %d records (generation "
                         "%d)", before, self._records,
                         self.journal_generation)
            except OSError:
                log.exception("journal auto-compaction failed; continuing "
                              "on the append-only journal")
            self._next_compact_at = self._records + self._compact_every

    # -- degraded mode and the fsync policy ----------------------------------

    def _check_degraded(self) -> None:
        if self.degraded:
            raise JournalDegradedError(
                f"task store is journal-degraded ({self.degraded_reason}); "
                "mutations refused until recover()", rollback=False)

    def _enter_degraded(self, exc: OSError,
                        where: str) -> JournalDegradedError:
        """Flip to read-only degraded mode on a journal disk fault; returns
        the error for the caller to raise."""
        import errno as errno_mod

        name = errno_mod.errorcode.get(exc.errno or 0, "OSError")
        if not self.degraded:
            self.degraded = True
            self.degraded_reason = f"{name} on journal {where}: {exc}"
            self._m_degraded.set(1.0)
            self._m_degraded_total.inc(errno=name)
            log.error("journal %s hit %s on %s; store is now DEGRADED "
                      "(read-only) — mutations refuse with 503 "
                      "journal-degraded until recover()",
                      self._journal_path, name, where)
        return JournalDegradedError(
            self.degraded_reason or f"{name} on journal {where}",
            rollback=(where == "append"))

    def _fsync_journal(self) -> None:
        """Push flushed bytes to stable storage, under ``self._lock``. A
        failure is ``JournalDegradedError(rollback=False)``: the bytes are
        in the file, so memory keeps the mutation."""
        fh = self._journal
        if fh is None or not self._fsync_dirty:
            return
        try:
            # A fault-injecting wrapper offers fsync(); a file goes through
            # its descriptor.
            sync = getattr(fh, "fsync", None)
            if sync is not None:
                sync()
            else:
                os.fsync(fh.fileno())
        except OSError as exc:
            raise self._enter_degraded(exc, "fsync") from exc
        self._fsync_dirty = False
        self._fsync_last = time.monotonic()
        self._stat_fsyncs += 1
        self._m_fsyncs.inc(policy=self._fsync_kind)

    def _group_commit(self) -> None:
        """``group:<ms>``: an append past the window pays the fsync for
        every record since the last one; otherwise a timer syncs the tail
        within the window. Caller holds ``self._lock``."""
        now = time.monotonic()
        if now - self._fsync_last >= self._fsync_group_s:
            self._fsync_journal()
            return
        if self._fsync_timer is None:
            delay = max(self._fsync_group_s - (now - self._fsync_last),
                        0.001)
            t = threading.Timer(delay, self._timer_fsync)
            t.daemon = True
            self._fsync_timer = t
            t.start()

    def _timer_fsync(self) -> None:
        """The group window's end, on the timer thread: a fault flips
        degraded with no caller to refuse."""
        with self._lock:
            self._fsync_timer = None
            if self._closed or self.degraded or self._journal is None:
                return
            try:
                self._fsync_journal()
            except JournalDegradedError:
                pass  # _enter_degraded logged and metered it

    def _record_append_time(self, seconds: float) -> None:
        self._m_append_s.observe(seconds)
        self._append_times.append(seconds)
        if len(self._append_times) > 4096:
            del self._append_times[:2048]

    def recover(self) -> bool:
        """Leave degraded mode once the disk is healthy: drop the broken
        handle without flushing it (its buffer holds the refused record),
        salvage the torn tail the failed append may have left, reopen,
        probe an fsync. True when writable on return; False while the disk
        still faults."""
        with self._lock:
            if self._closed:
                return False
            if not self.degraded:
                return True
            # A follower keeps its append handle in ``_raw`` (a promotion
            # whose epoch mint faulted unwound to follower).
            follower = getattr(self, "role", "primary") == "follower"
            if follower:
                old, self._raw = self._raw, None
            else:
                old, self._journal = self._journal, None
            if old is not None:
                self._close_discarding(old)
            try:
                scan = self._journal_format.scan_journal(self._journal_path)
                report = self._journal_format.salvage(self._journal_path,
                                                      scan)
                fh = open(self._journal_path, "a",  # noqa: SIM115
                          encoding="utf-8")
                os.fsync(fh.fileno())
            except (OSError, self._journal_format.JournalCorruptError):
                log.exception("journal %s: recovery attempt failed; store "
                              "stays degraded", self._journal_path)
                return False
            if follower:
                self._raw = fh
            else:
                self._journal = fh
            if report is not None:
                # The truncated bytes were visible to replication readers:
                # the generation bump sends them back to offset 0.
                self.journal_generation += 1
            self.chain_head = scan.chain_head
            self._records = scan.records
            self._fsync_dirty = False
            self.degraded = False
            self.degraded_reason = None
            self._m_degraded.set(0.0)
            log.warning("journal %s: recovered from degraded mode; "
                        "mutations re-admitted at chain head %s",
                        self._journal_path, self.chain_head)
            return True

    def journal_stats(self) -> dict:
        """Append volume, fsync, compaction and salvage counts, the policy,
        append p99 (and, beyond JAX's keys, p50 and p95) over the last
        appends, and the chain head."""
        with self._lock:
            times = sorted(self._append_times)

            def pct(q: float) -> float:
                return times[int(len(times) * q)] if times else 0.0

            p99 = pct(0.99)
            return {
                "append_p50_ms": round(pct(0.50) * 1000, 3),
                "append_p95_ms": round(pct(0.95) * 1000, 3),
                "bytes_appended": self._stat_bytes,
                "fsyncs": self._stat_fsyncs,
                "compactions": self._stat_compactions,
                "salvages": self._stat_salvages,
                "fsync_policy": (self._fsync_kind
                                 if self._fsync_kind != "group" else
                                 f"group:{self._fsync_group_s * 1000:g}"),
                "append_p99_ms": round(p99 * 1000, 3),
                "degraded": self.degraded,
                "chain_head": self.chain_head,
            }

    def _compact_locked(self) -> None:
        """Rewrite the journal as the epoch, one full record a durable
        task, then one a result, under ``self._lock``. The new file is
        written, fsynced and its handle opened before the atomic rename, so
        a failure anywhere leaves the store on a valid journal."""
        tmp = self._journal_path + ".compact"
        new_journal = None
        # The rewrite is a new byte lineage: its chain restarts at genesis.
        chain = self._journal_format.GENESIS

        def emit(f, rec: dict) -> None:
            nonlocal chain
            line, chain = self._journal_format.encode_record(rec, chain)
            f.write(line + "\n")

        try:
            with open(tmp, "w", encoding="utf-8") as f:
                if self.epoch:
                    emit(f, {"Epoch": self.epoch})
                for task in self._tasks.values():
                    if task.durable:
                        emit(f, self._full_record(task))
                for key, (body, ctype) in self._results.items():
                    owner = self._tasks.get(key.split(":", 1)[0])
                    if owner is not None and not owner.durable:
                        continue
                    emit(f, self._result_record(key, body, ctype))
                f.flush()
                os.fsync(f.fileno())
            # The handle follows the inode through the rename.
            new_journal = open(tmp, "a", encoding="utf-8")  # noqa: SIM115
            os.replace(tmp, self._journal_path)
        except OSError:
            if new_journal is not None:
                new_journal.close()
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        old = self._journal
        self._journal = new_journal
        self._records = (len(self._tasks) + len(self._results)
                         + (1 if self.epoch else 0))
        self.journal_generation += 1
        self.chain_head = chain
        self._fsync_dirty = False
        self._stat_compactions += 1
        self._m_compactions.inc()
        if old is not None:
            old.close()

    def compact(self) -> None:
        """Rewrite the journal now."""
        with self._lock:
            self._check_open()
            self._compact_locked()

    def _live_records(self) -> int:
        return len(self._tasks) + len(self._results)

    def _check_open(self) -> None:
        # Degraded refuses before any memory mutation; reads never pass
        # here, so they keep serving.
        super()._check_open()
        if self.degraded:
            self._check_degraded()

    # -- the journaled mutations ---------------------------------------------

    def _apply_set_result(self, key: str, result: bytes | None,
                          content_type: str) -> None:
        # Append first, mutate second: the memory half may delete a
        # superseded blob, which must never happen for a record the journal
        # refused.
        self._check_open()
        tid = key.split(":", 1)[0]
        self._check_owner(tid)
        owner = self._tasks.get(tid)
        if owner is None or owner.durable:
            try:
                self._append(self._result_record(key, result, content_type))
            except JournalDegradedError as exc:
                if not exc.rollback:
                    # The fsync failed, the record is in the file: memory
                    # matches the file, the acknowledgment is refused.
                    self._set_result_in_memory(key, result, content_type)
                raise
        # A non-durable owner was never journaled, and neither is its
        # result.
        self._set_result_in_memory(key, result, content_type)

    def _apply_evict(self, task_id: str) -> list[str]:
        if task_id not in self._tasks:
            return []
        self._check_open()
        # What a failed Evict append must restore wholesale.
        task = self._tasks[task_id]
        durable = task.durable
        orig = self._orig_bodies.get(task_id)
        ledger = self._ledgers.get(task_id)
        keys = set(self._result_keys.get(task_id, ()))
        results = {key: self._results[key] for key in keys
                   if key in self._results}
        blob_keys = super()._apply_evict(task_id)
        if durable:
            rec = {"Evict": True, "TaskId": task_id}
            if self._forgetting:
                # A rebalance's forget: the blobs moved with the range, and
                # a replay of this record must not delete them.
                rec["KeepBlobs"] = True
            try:
                self._append(rec)
            except JournalDegradedError as exc:
                if exc.rollback:
                    self._tasks[task_id] = task
                    self._add_to_set(task)
                    if orig is not None:
                        self._orig_bodies[task_id] = orig
                    if ledger is not None:
                        self._ledgers[task_id] = ledger
                    if keys:
                        self._result_keys[task_id] = keys
                        self._results.update(results)
                    raise
                # The fsync failed with the Evict record in the file: the
                # eviction is complete, and the caller must get the blob
                # keys, or the blobs leak.
        return blob_keys

    def _apply_upsert(self, task: APITask) -> APITask:
        self._check_open()
        prev = self._tasks.get(task.task_id) if task.task_id else None
        had_orig = (task.task_id in self._orig_bodies
                    if task.task_id else False)
        prev_orig = self._orig_bodies.get(task.task_id) if had_orig else None
        stored = super()._apply_upsert(task)
        try:
            self._log(stored)
        except JournalDegradedError as exc:
            if exc.rollback:
                self._rollback_upsert(stored, prev, had_orig, prev_orig)
            raise
        return stored

    def _rollback_upsert(self, stored: APITask, prev: APITask | None,
                         had_orig: bool,
                         prev_orig: tuple[bytes, str] | None) -> None:
        """Unwind one upsert whose append failed with possibly torn bytes.
        Caller holds the lock."""
        self._remove_from_set(stored)
        if prev is None:
            self._tasks.pop(stored.task_id, None)
        else:
            self._tasks[prev.task_id] = prev
            self._add_to_set(prev)
        if had_orig:
            self._orig_bodies[stored.task_id] = prev_orig
        else:
            self._orig_bodies.pop(stored.task_id, None)

    def _apply_update(self, task_id: str, status: str,
                      backend_status: str | None) -> APITask:
        self._check_open()
        prev = self._tasks.get(task_id)
        task = super()._apply_update(task_id, status, backend_status)
        try:
            self._log(task, slim=True)
        except JournalDegradedError as exc:
            if exc.rollback and prev is not None:
                self._remove_from_set(task)
                self._tasks[task_id] = prev
                self._add_to_set(prev)
            raise
        return task

    def _validates_task_ids(self) -> bool:
        # Replay runs before the append handle opens, and a follower's
        # absorb sets ``_absorbing``: history applies as it was accepted.
        return self._journal is not None and not self._absorbing

    # -- close ---------------------------------------------------------------

    def _drain_fsync_on_close(self) -> None:
        """On a clean close: cancel the group timer and fsync the dirty
        tail, best effort. Caller holds ``self._lock``."""
        timer, self._fsync_timer = self._fsync_timer, None
        if timer is not None:
            timer.cancel()
        if (self._fsync_kind != "never" and self._fsync_dirty
                and not self.degraded and self._journal is not None):
            try:
                self._fsync_journal()
            except JournalDegradedError:
                pass  # _enter_degraded logged it; close proceeds

    @staticmethod
    def _close_discarding(fh) -> None:
        """Close a degraded handle without flushing its buffer, which holds
        a refused record. The descriptor is pointed at ``os.devnull``
        (dup2) before the close, so the close's flush lands there and never
        in a file that reused the freed descriptor number."""
        try:
            fd = fh.fileno()
        except (OSError, ValueError):
            fd = None
        if fd is not None:
            try:
                devnull = os.open(os.devnull, os.O_WRONLY)
            except OSError:
                devnull = None
            if devnull is not None:
                try:
                    os.dup2(devnull, fd)
                except OSError:
                    pass
                finally:
                    os.close(devnull)
        try:
            fh.close()
        except (OSError, ValueError):
            pass

    def close(self) -> None:
        with self._lock:
            if not self._closed and self._journal is not None:
                self._drain_fsync_on_close()
                if self.degraded:
                    self._close_discarding(self._journal)
                else:
                    self._journal.close()
            self._closed = True


class FollowerTaskStore(JournaledTaskStore):
    """The HA pair's replica (JAX ``store.py:1662-1970``). As a follower it
    absorbs the primary's journal stream (``replication.py``) line by line,
    each checksum- and chain-verified, into its own memory and its own
    journal, serves reads, and refuses writes with ``NotPrimaryError``.
    ``promote()`` makes it the primary under the next fencing epoch.
    ``start_as_primary`` builds the platform's journaled primary: a
    ``JournaledTaskStore`` that ``demote()`` and ``note_epoch()`` can
    depose when a promoted standby shows a newer epoch."""

    role = "primary"
    _absorbing = False
    # The primary stream's chain head verified so far; None until the
    # first enveloped line anchors it.
    _absorb_chain: str | None = None

    def __init__(self, journal_path: str, start_as_primary: bool = False,
                 **kwargs):
        super().__init__(journal_path, **kwargs)
        self._absorbing = False
        if start_as_primary:
            # Boot is not a failover: no epoch is minted.
            self._raw = None
            self.role = "primary"
        else:
            # The append handle takes absorbed lines; self-journaling is
            # off.
            self._raw = self._journal
            self._journal = None
            self.role = "follower"

    # -- the replication feed ------------------------------------------------

    def _write_own_line(self, fh, rec: dict) -> None:
        """Append one record to this replica's own journal, chained on its
        own head. Caller holds ``self._lock`` and flushes."""
        line, self.chain_head = self._journal_format.encode_record(
            rec, self.chain_head)
        fh.write(line + "\n")

    @property
    def replica_chain_head(self) -> str | None:
        """The primary-stream chain head this replica verified up to: equal
        to the primary's ``chain_head`` when caught up."""
        return self._absorb_chain

    def absorb_lines(self, lines: list[str]) -> None:
        """Verify, apply and journal lines streamed from the primary (one
        flush a call). The verified prefix is kept; a line that fails
        verification raises ``JournalCorruptError`` after it, and the
        replicator resyncs from offset 0. Replicated transitions notify
        this replica's own listeners."""
        transitions: list[APITask] = []
        error = None
        with self._lock:
            if self.role != "follower":
                raise RuntimeError("absorb after promote — replication "
                                   "must stop when the follower becomes "
                                   "primary")
            self._check_open()
            verified: list[dict] = []
            chain = self._absorb_chain
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec, chain, _legacy = (
                        self._journal_format.verify_line(line, chain))
                except self._journal_format.JournalCorruptError as exc:
                    self._m_verify_fail.inc()
                    error = exc
                    break
                verified.append(rec)
            self._absorbing = True
            try:
                for rec in verified:
                    task = self._apply_replay_record(rec)
                    if task is not None:
                        transitions.append(task)
                    self._write_own_line(self._raw, rec)
                    self._records += 1
            finally:
                self._absorbing = False
            self._raw.flush()
            self._absorb_chain = chain
        for task in transitions:
            self._notify(task)
        if error is not None:
            raise error

    def reset(self) -> None:
        """Drop all replicated state and truncate the journal (keeping the
        epoch): the primary compacted, or this follower resyncs, from
        offset 0 of the primary's file, a whole snapshot."""
        with self._lock:
            if self.role != "follower":
                raise RuntimeError("reset after promote — replication must "
                                   "stop when the follower becomes primary")
            self._check_open()
            self._tasks.clear()
            self._orig_bodies.clear()
            self._results.clear()
            self._result_keys.clear()
            self._sets.clear()
            self._records = 0
            self._raw.close()
            self._raw = open(self._journal_path, "w",  # noqa: SIM115
                             encoding="utf-8")
            self.chain_head = self._journal_format.GENESIS
            self._absorb_chain = self._journal_format.GENESIS
            if self.epoch:
                # A crash before the stream brings the epoch again must not
                # replay this node back to epoch 0.
                self._write_own_line(self._raw, {"Epoch": self.epoch})
                self._raw.flush()
                self._records = 1

    def promote(self) -> None:
        """Become the primary under the next epoch, journaled. The caller
        stops the replication feed first and then publishes
        ``unfinished_tasks()``, as a restart does."""
        with self._lock:
            if self.role == "primary":
                return
            self.role = "primary"
            self._journal = self._raw
            self.epoch += 1
            try:
                self._append({"Epoch": self.epoch})
            except JournalDegradedError as exc:
                if exc.rollback:
                    # The mint never reached the file: unwind it all, or a
                    # later promotion could mint this epoch again.
                    self.epoch -= 1
                    self._journal = None
                    self.role = "follower"
                    raise
                # Only the fsync failed: the promotion is in the file.

    def demote(self, epoch: int) -> None:
        """Step down for a strictly newer epoch: writes refuse from the
        moment this returns. ``StaleEpochError`` when ``epoch`` is not
        newer than ours. A follower only raises its epoch."""
        with self._lock:
            self._check_open()
            if self.role == "follower":
                self.epoch = max(self.epoch, epoch)
                return
            if epoch <= self.epoch:
                raise StaleEpochError(
                    f"demotion epoch {epoch} is not newer than ours "
                    f"({self.epoch}); refusing")
            self.epoch = epoch
            self.role = "follower"
            self._raw = self._journal
            self._journal = None
            # Journaled, so a restart never mints an epoch the new primary
            # holds.
            self._write_own_line(self._raw, {"Epoch": epoch})
            self._raw.flush()
            self._records += 1

    # Whether passive evidence (an ``X-Store-Epoch`` header, a journal
    # probe's epoch) may demote this node: the platform turns it off on a
    # primary without an HA peer, whom a forged header would only put out
    # of service. ``/demote`` is unaffected.
    passive_fencing = True
    # Passive evidence more than this many epochs ahead of ours is ignored
    # as implausible (epochs advance by one a promotion).
    PASSIVE_EPOCH_BOUND = 8

    def note_epoch(self, epoch: int) -> None:
        """Ingest fencing evidence carried by ordinary traffic: a newer
        epoch (within ``PASSIVE_EPOCH_BOUND``) demotes a primary."""
        if not self.passive_fencing:
            return
        if epoch > self.epoch + self.PASSIVE_EPOCH_BOUND:
            log.warning("ignoring implausible passive fencing epoch %d "
                        "(ours is %d, bound +%d); use the authenticated "
                        "/demote path if this is a real failover", epoch,
                        self.epoch, self.PASSIVE_EPOCH_BOUND)
            return
        if epoch > self.epoch and self.role == "primary":
            try:
                self.demote(epoch)
            except StaleEpochError:
                pass  # raced a concurrent demotion to a higher epoch

    # -- the follower's write fence ------------------------------------------

    def _check_writable(self) -> None:
        if self.role == "follower" and not self._absorbing:
            raise NotPrimaryError(
                "store replica is a follower; writes go to the primary")

    def _apply_upsert(self, task: APITask) -> APITask:
        self._check_writable()
        return super()._apply_upsert(task)

    def _apply_update(self, task_id: str, status: str,
                      backend_status: str | None) -> APITask:
        self._check_writable()
        return super()._apply_update(task_id, status, backend_status)

    def _apply_set_result(self, key: str, result: bytes | None,
                          content_type: str) -> None:
        self._check_writable()
        super()._apply_set_result(key, result, content_type)

    def _apply_evict(self, task_id: str) -> list[str]:
        self._check_writable()
        return super()._apply_evict(task_id)

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                if self.role == "follower" and self._raw is not None:
                    timer, self._fsync_timer = self._fsync_timer, None
                    if timer is not None:
                        timer.cancel()
                    self._raw.close()
                elif self._journal is not None:
                    self._drain_fsync_on_close()
                    if self.degraded:
                        self._close_discarding(self._journal)
                    else:
                        self._journal.close()
            self._closed = True
