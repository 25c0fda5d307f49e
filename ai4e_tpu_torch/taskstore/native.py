"""ctypes bindings for the native task-store core
(``ai4e_tpu_torch/native/taskstore_core.cpp``) — a copy of
``ai4e_tpu/taskstore/native.py``.

``NativeTaskStore`` has the surface of ``InMemoryTaskStore`` — upsert,
update_status, the conditional transitions, results, status-set queries —
backed by the C++ engine, which mutates under a C++ mutex without the GIL.
Publisher and listener side-effects stay in Python (``StoreSideEffects``),
driven from the record and publish flag the engine returns. The engine
has no eviction, no hop ledger, no result offload and no admission state;
``LocalPlatform`` refuses the options that need them. The library is built
from the source on first use (``utils/native_build.py``); a build or load
that fails raises: there is no fallback to the Python store.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Callable

from .store import Publisher, StoreSideEffects, TaskNotFound
from .task import APITask, TaskStatus

log = logging.getLogger("ai4e_tpu_torch.taskstore.native")

_SO_NAME = "libtaskstore_core.so"
_SEP = "\x1f"


class _TaskView(ctypes.Structure):
    _fields_ = [
        ("timestamp", ctypes.c_double),
        ("publish", ctypes.c_int32),
        ("task_id", ctypes.c_char_p),
        ("status", ctypes.c_char_p),
        ("backend_status", ctypes.c_char_p),
        ("endpoint", ctypes.c_char_p),
        ("content_type", ctypes.c_char_p),
        ("body", ctypes.POINTER(ctypes.c_uint8)),
        ("body_len", ctypes.c_uint64),
        ("owner", ctypes.c_void_p),
    ]


def build_library() -> str:
    from ..utils.native_build import build_native_library
    return build_native_library("taskstore_core.cpp", _SO_NAME)


def _load():
    lib = ctypes.CDLL(build_library())
    view = ctypes.POINTER(_TaskView)
    lib.tsc_create.restype = ctypes.c_void_p
    lib.tsc_destroy.argtypes = [ctypes.c_void_p]
    lib.tsc_upsert.restype = view
    lib.tsc_upsert.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_int]
    lib.tsc_update_status.restype = view
    lib.tsc_update_status.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.c_char_p]
    lib.tsc_update_status_if.restype = view
    lib.tsc_update_status_if.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p]
    lib.tsc_requeue_if.restype = view
    lib.tsc_requeue_if.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p]
    lib.tsc_get.restype = view
    lib.tsc_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tsc_get_original.restype = view
    lib.tsc_get_original.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tsc_set_result.restype = ctypes.c_int
    lib.tsc_set_result.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64, ctypes.c_char_p]
    lib.tsc_get_result.restype = view
    lib.tsc_get_result.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tsc_set_len.restype = ctypes.c_uint64
    lib.tsc_set_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p]
    lib.tsc_dump_sets.restype = ctypes.c_void_p  # freed by tsc_free_str
    lib.tsc_dump_sets.argtypes = [ctypes.c_void_p]
    lib.tsc_dump_members.restype = ctypes.c_void_p  # freed by tsc_free_str
    lib.tsc_dump_members.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p]
    lib.tsc_free_str.argtypes = [ctypes.c_void_p]
    lib.tsc_free_view.argtypes = [view]
    return lib


_lib = None


def get_lib():
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _buf(data: bytes):
    return ((ctypes.c_uint8 * len(data)).from_buffer_copy(data)
            if data else None)


class NativeTaskStore(StoreSideEffects):
    """``InMemoryTaskStore``'s surface over the C++ engine, with the same
    listener and publish-failure plumbing (``StoreSideEffects``)."""

    def __init__(self, publisher: Publisher | None = None):
        self._lib = get_lib()
        self._handle = self._lib.tsc_create()
        self._publisher = publisher
        self._listeners: list[Callable[[APITask], None]] = []
        # The C++ record has no CacheKey field, but the result cache's store
        # listener needs it on every task: kept here, keyed by TaskId. The
        # native store has no eviction, so this map grows with the store.
        self._cache_keys: dict[str, str] = {}

    def __del__(self):  # pragma: no cover - interpreter teardown ordering
        try:
            self._lib.tsc_destroy(self._handle)
        except Exception:  # noqa: BLE001; ai4e: noqa[AIL005] — __del__ during interpreter teardown; nothing to report to
            pass

    def _consume(self, view) -> APITask | None:
        if not view:
            return None
        v = view.contents
        body = bytes(ctypes.cast(
            v.body, ctypes.POINTER(ctypes.c_char * v.body_len)).contents) \
            if v.body_len else b""
        task = APITask(
            task_id=v.task_id.decode(),
            timestamp=v.timestamp,
            status=v.status.decode(),
            backend_status=v.backend_status.decode(),
            endpoint=v.endpoint.decode(),
            body=body,
            content_type=v.content_type.decode(),
            publish=bool(v.publish),
        )
        self._lib.tsc_free_view(view)
        task.cache_key = self._cache_keys.get(task.task_id, "")
        return task

    # -- core state machine --------------------------------------------------

    def upsert(self, task: APITask) -> APITask:
        if ":" in task.task_id:
            raise ValueError(
                f"TaskId must not contain ':' (reserved as the result "
                f"stage separator): {task.task_id!r}")
        stored = self._consume(self._lib.tsc_upsert(
            self._handle, task.task_id.encode(), task.endpoint.encode(),
            task.status.encode(), task.backend_status.encode(),
            _buf(task.body), len(task.body), task.content_type.encode(),
            1 if task.publish else 0))
        if task.cache_key:
            # Keyed by the stored id: the engine mints the GUID of a blank-id
            # create. An upsert without a key keeps the earlier one.
            self._cache_keys[stored.task_id] = task.cache_key
            stored.cache_key = task.cache_key
        publisher = self._publisher if stored.publish else None
        self._notify(stored)
        self._publish_after(stored, publisher)
        return stored

    def update_status(self, task_id: str, status: str,
                      backend_status: str | None = None) -> APITask:
        task = self._consume(self._lib.tsc_update_status(
            self._handle, task_id.encode(), status.encode(),
            None if backend_status is None else backend_status.encode()))
        if task is None:
            raise TaskNotFound(task_id)
        self._notify(task)
        return task

    def update_status_if(self, task_id: str, expected_status: str,
                         status: str,
                         backend_status: str | None = None) -> APITask | None:
        task = self._consume(self._lib.tsc_update_status_if(
            self._handle, task_id.encode(), expected_status.encode(),
            status.encode(),
            None if backend_status is None else backend_status.encode()))
        if task is not None:
            self._notify(task)
        return task

    def requeue_if(self, task_id: str, expected_status: str) -> APITask | None:
        task = self._consume(self._lib.tsc_requeue_if(
            self._handle, task_id.encode(), expected_status.encode()))
        if task is None:
            return None
        publisher = self._publisher if task.publish else None
        self._notify(task)
        self._publish_after(task, publisher)
        return task

    def get(self, task_id: str) -> APITask:
        task = self._consume(self._lib.tsc_get(self._handle,
                                               task_id.encode()))
        if task is None:
            raise TaskNotFound(task_id)
        return task

    def get_original_body(self, task_id: str) -> bytes:
        """The body the task was created with (b"" for none or an unknown
        task)."""
        blob = self._consume(self._lib.tsc_get_original(
            self._handle, task_id.encode()))
        return blob.body if blob is not None else b""

    # -- results -------------------------------------------------------------

    def set_result(self, task_id: str, result: bytes,
                   content_type: str = "application/json",
                   stage: str | None = None) -> None:
        key = task_id if stage is None else f"{task_id}:{stage}"
        ok = self._lib.tsc_set_result(
            self._handle, task_id.encode(), key.encode(),
            _buf(result), len(result), content_type.encode())
        if not ok:
            raise TaskNotFound(task_id)

    def get_result(self, task_id: str,
                   stage: str | None = None) -> tuple[bytes, str] | None:
        key = task_id if stage is None else f"{task_id}:{stage}"
        blob = self._consume(self._lib.tsc_get_result(self._handle,
                                                      key.encode()))
        if blob is None:
            return None
        return blob.body, blob.content_type

    # -- status-set queries --------------------------------------------------

    def set_len(self, endpoint_path: str, status: str) -> int:
        return int(self._lib.tsc_set_len(self._handle,
                                         endpoint_path.encode(),
                                         status.encode()))

    def _sets_rows(self) -> list[tuple[str, str, str]]:
        ptr = self._lib.tsc_dump_sets(self._handle)
        try:
            raw = ctypes.string_at(ptr).decode()
        finally:
            self._lib.tsc_free_str(ptr)
        rows = []
        for line in raw.splitlines():
            parts = line.split(_SEP)
            if len(parts) >= 3:
                rows.append((parts[0], parts[1], parts[2]))
        return rows

    def set_members(self, endpoint_path: str, status: str) -> list[str]:
        # One set per call: the reaper sweeps one set per endpoint.
        ptr = self._lib.tsc_dump_members(self._handle,
                                         endpoint_path.encode(),
                                         status.encode())
        try:
            raw = ctypes.string_at(ptr).decode()
        finally:
            self._lib.tsc_free_str(ptr)
        return [line.split(_SEP)[0] for line in raw.splitlines() if line]

    def endpoints(self) -> list[str]:
        return sorted({path for path, _, _ in self._sets_rows()})

    def depths(self) -> dict[str, dict[str, int]]:
        out: dict[str, dict[str, int]] = {}
        for path, status, tid in self._sets_rows():
            bucket = out.setdefault(path, {s: 0 for s in TaskStatus.ALL})
            if tid:
                bucket[status] += 1
        return out

    def snapshot(self) -> list[APITask]:
        """Every task the store holds."""
        return [self.get(tid) for _, _, tid in self._sets_rows() if tid]

    def unfinished_tasks(self) -> list[APITask]:
        """Tasks not yet terminal, each with its original body restored."""
        out = []
        for _path, status, tid in self._sets_rows():
            if not tid or status in TaskStatus.TERMINAL:
                continue
            task = self.get(tid)
            if not task.body:
                blob = self._consume(self._lib.tsc_get_original(
                    self._handle, tid.encode()))
                if blob is not None:
                    task.body, task.content_type = blob.body, blob.content_type
            out.append(task)
        return out
