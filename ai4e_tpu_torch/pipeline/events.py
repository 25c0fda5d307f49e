"""Per-task event hub — the streaming surface's fan-out core.
(A copy of ``ai4e_tpu/pipeline/events.py``.)

The long-poll contract (``GET /task/{id}?wait=``) answers exactly once,
with the terminal record. Pipelines produce *partial* results worth
delivering earlier — a stage's output is useful the moment the stage
finishes, and a token-producing stage can emit incremental chunks — so
the hub turns the task lifecycle into an ordered event stream:

- producers (``coordinator.PipelineCoordinator``, the store's change
  feed, token-streaming workers via the HTTP event surface) ``publish``
  typed events under a TaskId from any thread;
- consumers (the gateway's SSE handler, ``GET
  /v1/taskmanagement/task/{id}/events``) ``subscribe`` and receive the
  task's buffered history *then* live events, in publish order, ending
  at the ``terminal`` event.

The attach-vs-event race is closed the same way the shard change feed
closes it (``taskstore/feed.py``): a bounded per-task replay buffer is
written and the waiter set collected under ONE lock, so an event is
either replayed at attach or delivered live — never neither. Event
history is observability state, not durable truth: bounded per task and
across tasks (LRU), dropped on eviction, gone on restart.

Event vocabulary (docs/pipelines.md keeps the client table):

- ``status``   — root task status transition ({"Status", "BackendStatus"});
- ``stage``    — pipeline stage transition ({"stage", "state":
  dispatched|completed|cached|failed|expired, "resultAvailable",
  "result"? (inline when small), "detail"?});
- ``chunk``    — incremental partial output from a token-producing stage
  ({"stage", "index", "data"});
- ``terminal`` — the task's terminal record; closes every stream.
"""

from __future__ import annotations

import asyncio
import json
import threading
from collections import OrderedDict

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from ..taskstore import TaskStatus

# Inline-result bound for stage events: a stage result at or under this
# size rides in the event itself; larger ones are announced
# (resultAvailable) and fetched via GET /v1/taskstore/result?stage=.
INLINE_RESULT_BYTES = 64 * 1024

TERMINAL = "terminal"
STATUS = "status"
STAGE = "stage"
CHUNK = "chunk"


def sse_encode(event: dict) -> bytes:
    """One event in Server-Sent-Events wire format (``id``/``event``/
    ``data`` fields; data is a single JSON line, so no multi-line
    framing is ever needed)."""
    data = json.dumps(event.get("data", {}), separators=(",", ":"))
    return (f"id: {event.get('seq', 0)}\n"
            f"event: {event.get('event', 'message')}\n"
            f"data: {data}\n\n").encode("utf-8")


#: The synthetic event type a subscriber sees in place of chunk history
#: the bounded replay dropped (never published by producers; minted at
#: attach time from the drop accounting).
TRUNCATED = "truncated"


class TaskEventHub:
    """Bounded, thread-safe per-task event fan-out with replay.

    Chunk hardening (docs/streaming.md): CHUNK events — per-token
    partials, potentially hundreds per task — are bounded separately
    from the first-``replay`` buffer the other event types keep. The
    newest ``chunk_replay`` chunks are retained (a tail ring: a client
    attaching mid-stream wants the RECENT tokens), older ones are
    dropped, and a subscriber whose attach point falls inside the
    dropped range receives one synthetic ``truncated`` event carrying
    the cumulative drop count — a slow client can never hold unbounded
    token history. ``subscribe``/``replay`` take ``after_seq`` (the SSE
    ``Last-Event-ID`` resume contract): replay starts strictly after it.
    """

    def __init__(self, replay: int = 256, chunk_replay: int = 128,
                 max_tasks: int = 4096,
                 metrics: MetricsRegistry | None = None):
        self._replay_cap = replay
        self._chunk_cap = chunk_replay
        self._max_tasks = max_tasks
        self._lock = threading.Lock()
        # task_id -> {"seq": int, "events": [event dicts], "done": bool}
        # LRU-ordered; oldest tracked task evicted past max_tasks.
        self._tasks: "OrderedDict[str, dict]" = OrderedDict()
        # task_id -> frozenset[(loop, asyncio.Queue)] — copy-on-write like
        # the gateway's waiter map: publish iterates from any thread while
        # subscribers attach/detach on their loops.
        self._subscribers: dict[str, frozenset] = {}
        metrics = metrics or DEFAULT_REGISTRY
        self._published = metrics.counter(
            "ai4e_task_events_total",
            "Task events published to the streaming hub, by type")

    # -- producer side -------------------------------------------------------

    def track(self, task_id: str) -> None:
        """Start buffering events for a task even before any subscriber
        attaches (pipeline roots: a client that connects after stage 1
        completed must still see its partial)."""
        with self._lock:
            self._entry(task_id)

    def _entry(self, task_id: str) -> dict:
        entry = self._tasks.get(task_id)
        if entry is None:
            entry = self._tasks[task_id] = {
                "seq": 0, "events": [], "done": False,
                # Chunk-bound accounting: live chunk count in `events`,
                # cumulative dropped chunks, and the highest dropped seq
                # (the `truncated` marker's position at attach).
                "chunks": 0, "chunks_dropped": 0, "dropped_through": 0}
            while len(self._tasks) > self._max_tasks:
                self._tasks.popitem(last=False)
        else:
            self._tasks.move_to_end(task_id)
        return entry

    def publish(self, task_id: str, event_type: str, data: dict) -> None:
        """Append one event to the task's stream and wake subscribers.
        Thread-safe; events for tasks that are neither tracked nor
        subscribed are dropped (the hub must not grow with every task the
        platform ever serves)."""
        with self._lock:
            tracked = task_id in self._tasks
            has_subs = bool(self._subscribers.get(task_id))
            if not tracked and not has_subs:
                return
            entry = self._entry(task_id)
            if entry["done"]:
                return  # stream already closed by a terminal event
            entry["seq"] += 1
            event = {"seq": entry["seq"], "event": event_type, "data": data}
            if event_type == CHUNK:
                # Tail ring for token streams: keep the newest
                # chunk_replay chunks, evict the oldest past the cap —
                # the bounded-history contract (class docstring). The
                # scan for the oldest resident chunk starts at the last
                # eviction's index (everything before it is non-chunk
                # and a pop never moves those), so a long stream pays
                # O(chunk window), not O(buffer), per evicting publish.
                events = entry["events"]
                events.append(event)
                entry["chunks"] += 1
                if entry["chunks"] > self._chunk_cap:
                    floor = entry.get("chunk_floor", 0)
                    idx = next(i for i in range(floor, len(events))
                               if events[i]["event"] == CHUNK)
                    dropped = events.pop(idx)
                    entry["chunk_floor"] = idx
                    entry["chunks"] -= 1
                    entry["chunks_dropped"] += 1
                    entry["dropped_through"] = dropped["seq"]
            elif len(entry["events"]) < self._replay_cap:
                entry["events"].append(event)
            if event_type == TERMINAL:
                entry["done"] = True
            waiters = self._subscribers.get(task_id, frozenset())
        self._published.inc(type=event_type)
        for loop, queue in waiters:
            self._deliver(loop, queue, event)

    @staticmethod
    def _deliver(loop, queue, event) -> None:
        def put() -> None:
            # Runs ON the subscriber's loop (call_soon_threadsafe below),
            # so draining the queue here cannot race its consumer.
            try:
                queue.put_nowait(event)
            except asyncio.QueueFull:
                # Slow consumer: evict the OLDEST buffered event to admit
                # the newest — the terminal event (always last) is never
                # the one lost, and the seq numbering exposes the gap to
                # the consumer (ids skip).
                try:
                    queue.get_nowait()
                except asyncio.QueueEmpty:
                    pass
                try:
                    queue.put_nowait(event)
                except asyncio.QueueFull:
                    pass
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if loop is running:
            put()
        else:
            try:
                loop.call_soon_threadsafe(put)
            except RuntimeError:
                pass  # subscriber's loop closed — it is gone

    # -- store feed ----------------------------------------------------------

    def attach_store(self, store) -> None:
        """Subscribe to the store's change feed: every transition of a
        tracked/subscribed task becomes a ``status`` event, and terminal
        transitions close the stream with ``terminal`` — so the streaming
        surface works for ANY task, with stage/chunk events layered on by
        the pipeline coordinator for DAG runs."""

        def on_task_change(task) -> None:
            status = task.canonical_status
            self.publish(task.task_id, STATUS,
                         {"Status": task.status,
                          "BackendStatus": task.backend_status})
            if status in TaskStatus.TERMINAL:
                self.publish(task.task_id, TERMINAL, task.to_dict())

        store.add_listener(on_task_change)

    # -- consumer side -------------------------------------------------------

    @staticmethod
    def _replay_view(entry: dict, after_seq: int) -> list[dict]:
        """The replay a subscriber resuming after ``after_seq`` sees:
        buffered events strictly past it, preceded by ONE synthetic
        ``truncated`` event when dropped chunk history falls inside the
        requested range. Caller holds the lock."""
        view = [e for e in entry["events"] if e["seq"] > after_seq]
        through = entry["dropped_through"]
        if through > after_seq:
            marker = {"seq": through, "event": TRUNCATED,
                      "data": {"dropped_chunks": entry["chunks_dropped"],
                               "through_seq": through}}
            at = next((i for i, e in enumerate(view)
                       if e["seq"] > through), len(view))
            view.insert(at, marker)
        return view

    def subscribe(self, task_id: str, after_seq: int = 0
                  ) -> "TaskEventStream":
        """Attach a consumer: returns an async-iterable stream yielding the
        task's replay buffer then live events, under one lock so no event
        can fall between replay and registration. ``after_seq`` is the
        ``Last-Event-ID`` resume point: replay starts strictly after it
        (0 = from the beginning)."""
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue(maxsize=1024)
        entry_key = (loop, queue)
        with self._lock:
            entry = self._entry(task_id)
            replay = self._replay_view(entry, after_seq)
            done = entry["done"]
            if not done:
                self._subscribers[task_id] = self._subscribers.get(
                    task_id, frozenset()) | {entry_key}
        return TaskEventStream(self, task_id, entry_key, replay, done,
                               seen_seq=after_seq)

    def _unsubscribe(self, task_id: str, entry_key) -> None:
        with self._lock:
            entries = self._subscribers.get(task_id)
            if not entries:
                return
            remaining = frozenset(e for e in entries if e is not entry_key)
            if remaining:
                self._subscribers[task_id] = remaining
            else:
                del self._subscribers[task_id]

    def replay(self, task_id: str, after_seq: int = 0) -> list[dict]:
        """The task's buffered events past ``after_seq``, with the same
        ``truncated`` marker a subscriber would see (introspection, and
        the gateway's already-terminal fast path)."""
        with self._lock:
            entry = self._tasks.get(task_id)
            return self._replay_view(entry, after_seq) if entry else []

    @property
    def subscriber_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._subscribers.values())


class TaskEventStream:
    """Async iterator over one task's events: replay first, then live.
    Ends after the ``terminal`` event; ``aclose`` (or exiting the
    iterator) detaches the subscription."""

    def __init__(self, hub: TaskEventHub, task_id: str, entry_key,
                 replay: list[dict], done: bool, seen_seq: int = 0):
        self._hub = hub
        self.task_id = task_id
        self._entry_key = entry_key
        self._pending = list(replay)
        self._queue = entry_key[1]
        self._live = not done
        # Resume point (Last-Event-ID): live events at or under it are
        # duplicates of what the client already consumed.
        self._seen_seq = seen_seq

    def __aiter__(self):
        return self

    async def __anext__(self) -> dict:
        event = await self.next_event(timeout=None)
        if event is None:
            raise StopAsyncIteration
        return event

    async def next_event(self, timeout: float | None) -> dict | None:
        """Next event, or None when the stream ended (terminal delivered)
        — raises ``asyncio.TimeoutError`` when ``timeout`` expires first."""
        while True:
            if self._pending:
                event = self._pending.pop(0)
            elif not self._live:
                await self.aclose()
                return None
            else:
                event = await asyncio.wait_for(self._queue.get(), timeout)
            if event["seq"] <= self._seen_seq:
                continue  # replay/live overlap: already delivered
            self._seen_seq = event["seq"]
            if event["event"] == TERMINAL:
                self._live = False
                await self.aclose()
            return event

    async def aclose(self) -> None:
        self._hub._unsubscribe(self.task_id, self._entry_key)
