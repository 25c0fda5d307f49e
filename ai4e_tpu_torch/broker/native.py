"""ctypes bindings for the native broker core
(``ai4e_tpu_torch/native/broker_core.cpp``) — a copy of
``ai4e_tpu/broker/native.py``.

``NativeBroker`` has the surface of ``InMemoryBroker`` (publish, receive,
complete, abandon, depths, the dead-letter handler), backed by the C++
engine: publishes and the queue bookkeeping run without the GIL, and a
blocking receive parks on a C++ condition variable in a worker thread
instead of an asyncio future, in a pool of ``RECEIVE_THREADS`` (JAX's 8
starves more delivery loops than that). Its messages carry no deadline,
priority, cache key or trace headers (the C++ message has no slot for
them), and a task's queue is its exact endpoint path. The library is built from the
source on first use (``utils/native_build.py``); a build or load that
fails raises: there is no fallback to the Python broker.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
from concurrent.futures import ThreadPoolExecutor

from ..taskstore import endpoint_path as canonical_path
from .queue import DeadLetterHandler, Message

log = logging.getLogger("ai4e_tpu_torch.broker.native")

_SO_NAME = "libbroker_core.so"


class _MessageView(ctypes.Structure):
    _fields_ = [
        ("seq", ctypes.c_uint64),
        ("delivery_count", ctypes.c_uint32),
        ("task_id", ctypes.c_char_p),
        ("endpoint", ctypes.c_char_p),
        ("content_type", ctypes.c_char_p),
        ("body", ctypes.POINTER(ctypes.c_uint8)),
        ("body_len", ctypes.c_uint64),
        ("owner", ctypes.c_void_p),
    ]


def build_library() -> str:
    from ..utils.native_build import build_native_library
    return build_native_library("broker_core.cpp", _SO_NAME)


def _load():
    lib = ctypes.CDLL(build_library())
    lib.bc_create.restype = ctypes.c_void_p
    lib.bc_create.argtypes = [ctypes.c_uint32, ctypes.c_double]
    lib.bc_close.argtypes = [ctypes.c_void_p]
    lib.bc_destroy.argtypes = [ctypes.c_void_p]
    lib.bc_register_queue.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bc_publish.restype = ctypes.c_uint64
    lib.bc_publish.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_uint64]
    lib.bc_receive.restype = ctypes.POINTER(_MessageView)
    lib.bc_receive.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int64]
    lib.bc_free_message.argtypes = [ctypes.POINTER(_MessageView)]
    lib.bc_complete.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint64]
    lib.bc_abandon.restype = ctypes.c_int
    lib.bc_abandon.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint64]
    lib.bc_pop_dead_letter.restype = ctypes.POINTER(_MessageView)
    lib.bc_pop_dead_letter.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bc_depth.restype = ctypes.c_uint64
    lib.bc_depth.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    return lib


_lib = None


def get_lib():
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _view_to_message(view) -> Message:
    v = view.contents
    body = bytes(ctypes.cast(
        v.body, ctypes.POINTER(ctypes.c_char * v.body_len)).contents) \
        if v.body_len else b""
    return Message(
        task_id=v.task_id.decode(),
        endpoint=v.endpoint.decode(),
        body=body,
        content_type=v.content_type.decode(),
        delivery_count=v.delivery_count,
        seq=v.seq,
    )


#: Threads that park blocking receives. Every delivery loop holds one for
#: up to its receive timeout (1 s) while its queue is empty, so a pool
#: smaller than the loops starves the rest: JAX's default of 8 against
#: routes.json's 12 starting loops (and up to 16 a route under the
#: autoscaler) delays deliveries by whole timeouts. The pool's threads
#: start on demand.
RECEIVE_THREADS = 64


class NativeBroker:
    """``InMemoryBroker``'s surface over the C++ engine."""

    def __init__(self, max_delivery_count: int = 1440,
                 lease_seconds: float = 300.0,
                 receive_threads: int = RECEIVE_THREADS):
        self._lib = get_lib()
        self._handle = self._lib.bc_create(max_delivery_count,
                                           float(lease_seconds))
        self.max_delivery_count = max_delivery_count
        self.lease_seconds = lease_seconds
        self._registered: set[str] = set()
        self._dead_letter_handler: DeadLetterHandler | None = None
        self._loop = None
        # Blocking receives park here, off the event loop and off the GIL.
        self._executor = ThreadPoolExecutor(max_workers=receive_threads,
                                            thread_name_prefix="native-broker")

    # -- lifecycle -----------------------------------------------------------

    def bind_loop(self, loop=None) -> None:
        self._loop = loop or asyncio.get_event_loop()

    def close(self) -> None:
        if not self._handle:
            return
        # Wake the blocked receivers first (queues stay allocated), join
        # their threads, then free the engine: destroying first would
        # delete mutexes those threads still wait on.
        self._lib.bc_close(self._handle)
        self._executor.shutdown(wait=True)
        self._lib.bc_destroy(self._handle)
        self._handle = None

    def _require_handle(self) -> None:
        if not self._handle:
            raise RuntimeError("NativeBroker is closed")

    def set_dead_letter_handler(self, handler: DeadLetterHandler | None) -> None:
        self._dead_letter_handler = handler

    def register_queue(self, name: str) -> None:
        self._registered.add(name)
        self._lib.bc_register_queue(self._handle, name.encode())

    def depths(self) -> dict[str, int]:
        return {n: self._lib.bc_depth(self._handle, n.encode())
                for n in sorted(self._registered)}

    # -- publish -------------------------------------------------------------

    def publish(self, task) -> None:
        self._require_handle()
        body = task.body or b""
        buf = (ctypes.c_uint8 * len(body)).from_buffer_copy(body) if body \
            else (ctypes.c_uint8 * 0)()
        self._lib.bc_publish(
            self._handle,
            canonical_path(task.endpoint).encode(),
            task.task_id.encode(),
            task.endpoint.encode(),
            getattr(task, "content_type", "application/json").encode(),
            buf, len(body))

    # -- consume -------------------------------------------------------------

    def _receive_blocking(self, queue_name: str,
                          timeout_ms: int) -> Message | None:
        if not self._handle:
            return None
        view = self._lib.bc_receive(self._handle, queue_name.encode(),
                                    timeout_ms)
        # Messages the C++ lease reaper dead-lettered surface here: the
        # dispatcher's periodic receive doubles as the drain tick.
        self._drain_dead_letters(queue_name)
        if not view:
            return None
        try:
            msg = _view_to_message(view)
            msg.queue_name = queue_name
            return msg
        finally:
            self._lib.bc_free_message(view)

    async def receive(self, queue_name: str,
                      timeout: float | None = None) -> Message | None:
        timeout_ms = -1 if timeout is None else int(timeout * 1000)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._executor, self._receive_blocking, queue_name, timeout_ms)

    def complete(self, msg: Message) -> None:
        self._lib.bc_complete(self._handle, msg.queue_name.encode(), msg.seq)

    def abandon(self, msg: Message) -> bool:
        """Return the message for redelivery; False once it is
        dead-lettered."""
        rc = self._lib.bc_abandon(self._handle, msg.queue_name.encode(),
                                  msg.seq)
        if rc == 0:
            self._drain_dead_letters(msg.queue_name)
            return False
        return True

    def _drain_dead_letters(self, queue_name: str) -> None:
        if self._dead_letter_handler is None:
            return
        while True:
            view = self._lib.bc_pop_dead_letter(self._handle,
                                                queue_name.encode())
            if not view:
                return
            try:
                msg = _view_to_message(view)
                msg.queue_name = queue_name
            finally:
                self._lib.bc_free_message(view)
            handler = self._dead_letter_handler
            try:
                # May run on an executor thread: hand it to the loop the
                # platform bound (its handler schedules coroutines).
                if self._loop is not None and not self._loop.is_closed():
                    self._loop.call_soon_threadsafe(handler, msg)
                else:
                    handler(msg)
            except Exception:  # noqa: BLE001 — dead-lettering must not throw
                log.exception("dead-letter handler failed for %s",
                              msg.task_id)
