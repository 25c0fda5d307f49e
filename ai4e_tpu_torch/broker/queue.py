"""Per-endpoint message queues with lease/redelivery semantics — a copy of
``ai4e_tpu/broker/queue.py`` without the tenant lanes (ROADMAP A18.10):

- one logical queue per endpoint path; with a sharded task store
  (``shard_router``), one physical sub-queue per shard,
  ``{path}#s{shard}``, so each shard's dispatchers drain on their own;
- at-least-once delivery: a consumer leases a message (``receive``), then
  ``complete``s it or ``abandon``s it for redelivery;
- a lease that expires without either is redelivered too;
- past ``max_delivery_count`` deliveries a message is dead-lettered and a
  callback can fail its task;
- a message carries the B3 headers of the span its publisher ran in (the
  gateway's ``create_task``), which JAX's messages do not: the port's
  dispatch span continues the gateway's trace instead of starting one;
- a message carries its task's deadline, priority class and result-cache
  key, as JAX's do.

Event-loop only, except ``publish``, which any thread may call.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from ..metrics import DEFAULT_REGISTRY
from ..observability import get_tracer
from ..taskstore import endpoint_path as canonical_path

log = logging.getLogger("ai4e_tpu_torch.broker")

# Shard sub-queue naming ("{path}#s{shard}"): '#' never appears in a queue
# path (``endpoint_path`` strips fragments), so the separator cannot collide.
SHARD_QUEUE_SEP = "#s"


def shard_queue_name(base: str, shard: int) -> str:
    return f"{base}{SHARD_QUEUE_SEP}{shard}"


def base_queue_name(name: str) -> str:
    """The endpoint path a (possibly shard-suffixed) queue name serves:
    what dispatch-target rebasing and depth attribution key on."""
    return name.split(SHARD_QUEUE_SEP, 1)[0]


@dataclass
class Message:
    task_id: str
    endpoint: str
    body: bytes = b""
    content_type: str = "application/json"
    enqueued_at: float = field(default_factory=time.time)
    delivery_count: int = 0
    seq: int = 0
    lease_expires: float = 0.0
    queue_name: str = ""  # resolved by the broker at publish time
    # B3 headers of the span active where the task was published (the
    # gateway's create_task): the dispatch span's parent, so gateway ->
    # dispatcher -> worker is one trace. Empty outside any span.
    trace_headers: dict = field(default_factory=dict)
    # Admission state copied from the task: the absolute deadline (unix
    # seconds; 0.0 = none) and the priority class, so the dispatcher drops
    # expired work at pop time without a store round trip and labels its
    # backend POST for the worker's own shedding.
    deadline_at: float = 0.0
    priority: int = 1
    # The task's result-cache key ("" when it has none or bypassed the
    # cache): the dispatcher completes a redelivery from the cache with it.
    cache_key: str = ""


DeadLetterHandler = Callable[[Message], None]


class EndpointQueue:
    """One endpoint's FIFO with leases. Not thread-safe — event-loop only."""

    def __init__(self, name: str, max_delivery_count: int = 1440,
                 lease_seconds: float = 300.0,
                 dead_letter_handler: DeadLetterHandler | None = None,
                 metrics=None):
        self.name = name
        self.max_delivery_count = max_delivery_count
        self.lease_seconds = lease_seconds
        self.dead_letter_handler = dead_letter_handler
        self._dead_letter_total = (metrics or DEFAULT_REGISTRY).counter(
            "ai4e_broker_dead_letters_total", "Messages dead-lettered per queue")
        self._ready: deque[Message] = deque()
        # Seqs logically ready: a message completed after its lease expired
        # (and was requeued) is retracted by dropping its seq here and
        # skipping it lazily at receive().
        self._ready_seqs: set[int] = set()
        self._leased: dict[int, Message] = {}
        self._waiters: deque[asyncio.Future] = deque()
        # Seqs of dead-lettered messages, so a late abandon tells the truth.
        self._dead_seqs: set[int] = set()

    def _dead_letter(self, msg: Message) -> None:
        self._dead_seqs.add(msg.seq)
        self._dead_letter_total.inc(queue=self.name)
        if self.dead_letter_handler is not None:
            try:
                self.dead_letter_handler(msg)
            except Exception:  # noqa: BLE001 — dead-lettering must not throw
                log.exception("dead-letter handler failed for task %s",
                              msg.task_id)

    def __len__(self) -> int:
        return len(self._ready_seqs)

    def _wake_one(self) -> None:
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                return

    def put(self, msg: Message) -> None:
        self._requeue(msg)
        self._wake_one()

    def _requeue(self, msg: Message) -> None:
        self._ready.append(msg)
        self._ready_seqs.add(msg.seq)

    def _pop_ready(self) -> Message | None:
        while self._ready:
            msg = self._ready.popleft()
            if msg.seq in self._ready_seqs:
                return msg
        return None

    async def receive(self, timeout: float | None = None) -> Message | None:
        """Lease the next message; None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._reap_expired_leases()
            msg = self._pop_ready()
            if msg is not None:
                self._ready_seqs.discard(msg.seq)
                msg.delivery_count += 1
                msg.lease_expires = time.time() + self.lease_seconds
                self._leased[msg.seq] = msg
                return msg
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._waiters.append(fut)
            try:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                await asyncio.wait_for(fut, remaining)
            except asyncio.TimeoutError:
                if fut in self._waiters:
                    self._waiters.remove(fut)
                return None

    def complete(self, msg: Message) -> None:
        if self._leased.pop(msg.seq, None) is None:
            # The lease expired mid-processing and the message was
            # requeued: retract it so it is not delivered again.
            self._ready_seqs.discard(msg.seq)

    def abandon(self, msg: Message) -> bool:
        """Return the message for redelivery. False (dead-lettered) once the
        delivery count is exhausted."""
        if self._leased.pop(msg.seq, None) is None:
            # The lease already expired and the message was requeued (or
            # dead-lettered): re-appending would deliver it twice.
            return msg.seq not in self._dead_seqs
        if msg.delivery_count >= self.max_delivery_count:
            self._dead_letter(msg)
            return False
        self.put(msg)
        return True

    def _reap_expired_leases(self) -> None:
        now = time.time()
        expired = [m for m in self._leased.values() if m.lease_expires <= now]
        for msg in expired:
            del self._leased[msg.seq]
            if msg.delivery_count >= self.max_delivery_count:
                self._dead_letter(msg)
            else:
                self._requeue(msg)


class InMemoryBroker:
    """One ``EndpointQueue`` per registered endpoint path.

    ``publish`` is the store's publisher hook; the store calls it after
    releasing its lock, on whatever thread ran the upsert, so the queue map
    is locked and the enqueue itself is handed to the broker's event loop.
    A task whose endpoint path extends a registered queue's path lands on
    the longest-prefix-matching queue.

    ``shard_router(task_id) -> shard index`` (a sharded store's
    ``shard_for``) puts each message on its task's sub-queue
    (``shard_queue_name``); a redelivery returns a message to the sub-queue
    it lives on. A message whose task was rebalanced in flight drains from
    the old shard's sub-queue once more: its store writes route by ring.
    """

    def __init__(self, max_delivery_count: int = 1440,
                 lease_seconds: float = 300.0, metrics=None,
                 shard_router=None):
        self.max_delivery_count = max_delivery_count
        self.lease_seconds = lease_seconds
        self._metrics = metrics
        self._shard_router = shard_router
        self._queues: dict[str, EndpointQueue] = {}
        self._queues_lock = threading.Lock()
        self._seq = itertools.count(1)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._dead_letter_handler: DeadLetterHandler | None = None

    def bind_loop(self, loop: asyncio.AbstractEventLoop | None = None) -> None:
        self._loop = loop or asyncio.get_event_loop()

    def set_dead_letter_handler(self, handler: DeadLetterHandler | None) -> None:
        """Callback for messages that exhaust their delivery budget."""
        self._dead_letter_handler = handler
        with self._queues_lock:
            for q in self._queues.values():
                q.dead_letter_handler = handler

    def register_queue(self, name: str) -> None:
        """Pre-create a queue so prefix routing can target it."""
        self.queue(name)

    def queue(self, name: str) -> EndpointQueue:
        with self._queues_lock:
            q = self._queues.get(name)
            if q is None:
                q = self._queues[name] = EndpointQueue(
                    name, self.max_delivery_count, self.lease_seconds,
                    dead_letter_handler=self._dead_letter_handler,
                    metrics=self._metrics)
            return q

    def resolve_queue_name(self, endpoint: str) -> str:
        """Longest registered queue path that prefixes the endpoint path;
        falls back to the exact path (a queue is created on demand). Shard
        sub-queues never match: ``publish`` appends the suffix itself."""
        path = canonical_path(endpoint)
        with self._queues_lock:
            candidates = [n for n in self._queues
                          if SHARD_QUEUE_SEP not in n
                          and (path == n
                               or path.startswith(n.rstrip("/") + "/"))]
        return max(candidates, key=len) if candidates else path

    def publish(self, task) -> None:
        """Store publisher hook: enqueue a dispatch message for the task.
        Callable from any thread; the enqueue runs on the broker's loop."""
        queue_name = self.resolve_queue_name(task.endpoint)
        if self._shard_router is not None:
            queue_name = shard_queue_name(queue_name,
                                          self._shard_router(task.task_id))
        msg = Message(task_id=task.task_id, endpoint=task.endpoint,
                      body=task.body, content_type=task.content_type,
                      seq=next(self._seq),
                      queue_name=queue_name,
                      trace_headers=get_tracer().headers(),
                      cache_key=getattr(task, "cache_key", ""),
                      deadline_at=getattr(task, "deadline_at", 0.0),
                      priority=getattr(task, "priority", 1))
        loop = self._loop
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if loop is None or loop is running:
            self.queue(msg.queue_name).put(msg)
        else:
            loop.call_soon_threadsafe(self.queue(msg.queue_name).put, msg)

    async def receive(self, queue_name: str,
                      timeout: float | None = None) -> Message | None:
        return await self.queue(queue_name).receive(timeout)

    def complete(self, msg: Message) -> None:
        self.queue(msg.queue_name).complete(msg)

    def abandon(self, msg: Message) -> bool:
        return self.queue(msg.queue_name).abandon(msg)
