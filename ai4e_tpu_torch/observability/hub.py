"""Request-observability hub — the hop ledger, the flight recorder and the
per-route request telemetry the SLO engine reads; a copy of
``ai4e_tpu/observability/hub.py``. Its store is the control plane's own,
or the rig's ring-routed wire store (``rig/wire.py``), whose ledger verbs
are coroutines: a stamp then goes out fire-and-forget, and a flight
entry is recorded without the remote timeline.

One object per control plane (``PlatformConfig(observability=True)``),
shared by the gateway and every dispatcher. Everything here is
fail-open: a ledger stamp that cannot land (the task was evicted) is
dropped with a debug log — observability never turns a serving success
into an error.

- ``stamp(task_id, *events)`` appends hop-ledger events to the task's
  record in the store (``InMemoryTaskStore.append_ledger``);
- the store listener tracks each task's creation time per route; on a
  pipeline handoff (the task rewritten to ``created`` with a new
  endpoint) it stamps a ``stage`` event, and on the terminal transition
  it stamps ``completed``, observes ``ai4e_request_e2e_seconds{route}``
  (exemplar: the task id), counts ``ai4e_request_outcomes_total{route,
  outcome}`` (``ok`` / ``late`` / ``expired`` / ``failed``) and offers
  the finished timeline to the flight recorder;
- ``record_refusal`` / ``observe_sync`` feed the request shapes that
  never become tasks (gateway refusals, sync proxy calls) to the same
  counters and the flight recorder.
"""

from __future__ import annotations

import logging
import threading
import time

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from ..taskstore import TaskStatus
from .flight import FlightRecorder
from .ledger import COMPLETED, STAGE, ledger_event

log = logging.getLogger("ai4e_tpu_torch.observability")

# In-flight creation-timestamp table bound: tasks that never reach a
# terminal state (a bug this layer exists to surface) must not grow the
# table forever — beyond the cap the OLDEST entries drop, and their
# terminal transition simply records no e2e sample.
_MAX_TRACKED = 65536

# In-flight fire-and-forget wire-stamp bound: against a wedged or
# failing-over shard each append coroutine can live through seconds of
# retries, and an uncapped create_task() on the serving hot path would
# accumulate live tasks/sockets without bound. Beyond the cap the stamp
# is DROPPED — the same fail-open contract as every other ledger path.
_MAX_WIRE_STAMPS = 1024


class RequestObservability:
    def __init__(self, store, metrics: MetricsRegistry | None = None,
                 flight: FlightRecorder | None = None):
        self.store = store
        self.metrics = metrics or DEFAULT_REGISTRY
        self.flight = flight
        self._lock = threading.Lock()
        # Strong refs to in-flight fire-and-forget wire stamps (the loop
        # holds tasks weakly) — populated only when the store's
        # append_ledger is a coroutine function (the rig's ring client).
        self._wire_stamps: set = set()
        # task_id -> (created epoch seconds, route label, endpoint path)
        self._created: dict[str, tuple[float, str, str]] = {}
        # backend endpoint path -> published gateway prefix (map_route,
        # fed by the gateway). Task records carry the BACKEND endpoint;
        # without this map, async outcomes would count under the backend
        # path while sheds/sync calls count under the published prefix —
        # and an SLO objective on either label would see only half of
        # one route's traffic (goodput pinned at 0 or 1 during
        # shedding). Unmapped paths (internal pipeline stages,
        # direct-store tasks) keep their own path.
        self._route_map: dict[str, str] = {}
        self._e2e = self.metrics.histogram(
            "ai4e_request_e2e_seconds",
            "End-to-end request latency per route (async: create to "
            "terminal; sync: proxy wall time)")
        self._outcomes = self.metrics.counter(
            "ai4e_request_outcomes_total",
            "Terminal request outcomes per route: ok/late/expired/"
            "failed (tasks) and ok/failed/shed (sync)")
        self._ledger_events = self.metrics.counter(
            "ai4e_ledger_events_total", "Hop-ledger events stamped, by event")
        if hasattr(store, "add_listener"):
            store.add_listener(self._on_task_change)

    # -- route labeling ------------------------------------------------------

    def map_route(self, backend_path: str, public_prefix: str) -> None:
        """Register that tasks whose endpoint path is (or extends)
        ``backend_path`` belong to the published route
        ``public_prefix`` — the ONE label its SLO objectives, outcome
        counters, and e2e histogram all share."""
        with self._lock:
            self._route_map[backend_path] = public_prefix

    def _route_for(self, endpoint_path: str) -> str:
        with self._lock:
            mapped = self._route_map.get(endpoint_path)
            if mapped is not None:
                return mapped
            # Operation tails ('POST prefix/tail') extend the backend
            # path — longest mapped prefix wins, so tails neither
            # fragment the label space nor escape their route.
            best = None
            for backend, public in self._route_map.items():
                if endpoint_path.startswith(backend + "/"):
                    if best is None or len(backend) > len(best[0]):
                        best = (backend, public)
            return best[1] if best is not None else endpoint_path

    # -- ledger stamping -----------------------------------------------------

    def stamp(self, task_id: str, *events: dict) -> None:
        """Append events to the task's hop ledger; never raises."""
        if not events:
            return
        try:
            result = self.store.append_ledger(task_id, list(events))
        except Exception:  # noqa: BLE001 — observability is fail-open: an evicted task drops its stamp, serving is untouched
            log.debug("ledger stamp dropped for task %s", task_id,
                      exc_info=True)
            return
        if hasattr(result, "__await__"):
            # The wire store: a stamp never blocks the serving path it
            # documents, and the wire client treats every failure as a
            # droppable 0.
            import asyncio
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                result.close()  # no loop (teardown): drop the stamp
                return
            if len(self._wire_stamps) >= _MAX_WIRE_STAMPS:
                result.close()  # shard wedged: drop, never accumulate
                return
            task = loop.create_task(result)
            self._wire_stamps.add(task)
            task.add_done_callback(self._wire_stamps.discard)
        for ev in events:
            self._ledger_events.inc(event=ev.get("e", "?"))

    # -- store feed ----------------------------------------------------------

    def _on_task_change(self, task) -> None:
        status = task.canonical_status
        if status not in TaskStatus.TERMINAL:
            if task.status == TaskStatus.CREATED:
                # Stamped once at creation (requeues carry prose); the
                # route label resolves through the gateway's
                # backend→published map so async outcomes and edge
                # refusals share one SLO key.
                path = task.endpoint_path
                route = self._route_for(path)
                stage_from = None
                with self._lock:
                    entry = self._created.get(task.task_id)
                    if entry is None:
                        if len(self._created) >= _MAX_TRACKED:
                            self._created.pop(next(iter(self._created)))
                        self._created[task.task_id] = (time.time(), route,
                                                       path)
                    elif entry[2] != path:
                        # Pipeline handoff: the task was rewritten to
                        # `created` with a NEW endpoint (AddPipelineTask,
                        # service/task_manager.py). Keep the original
                        # creation time + route label (the e2e metric
                        # covers the whole composite) but remember the new
                        # stage path — and stamp the boundary below, so
                        # `trace` shows WHERE one stage ended and the next
                        # began instead of an indistinguishable `created`.
                        self._created[task.task_id] = (entry[0], entry[1],
                                                       path)
                        stage_from = entry[2]
                if stage_from is not None:
                    self.stamp(task.task_id,
                               ledger_event(STAGE, "store",
                                            reason=f"{stage_from} -> "
                                                   f"{path}"))
            return
        now = time.time()
        with self._lock:
            created = self._created.pop(task.task_id, None)
        # completed/failed/expired — one terminal stamp with the
        # canonical bucket as the reason (duplicate terminal transitions
        # are the chaos invariant's job, not the ledger's: re-stamps
        # just add a second completed event, visibly).
        self.stamp(task.task_id,
                   ledger_event(COMPLETED, "store", t=now, reason=status))
        route = (created[1] if created
                 else self._route_for(task.endpoint_path))
        duration_ms = None
        if created is not None:
            duration_s = max(0.0, now - created[0])
            duration_ms = duration_s * 1e3
            self._e2e.observe(duration_s, route=route,
                              exemplar={"task_id": task.task_id})
        deadline_at = getattr(task, "deadline_at", 0.0)
        if status == TaskStatus.COMPLETED:
            outcome = ("late" if deadline_at and now > deadline_at
                       else "ok")
        else:
            outcome = status  # failed | expired
        self._outcomes.inc(route=route, outcome=outcome)
        if self.flight is not None:
            events = []
            getter = getattr(self.store, "get_ledger", None)
            if getter is not None:
                try:
                    events = getter(task.task_id)
                except Exception:  # noqa: BLE001; ai4e: noqa[AIL005] — fail-open: a racing eviction loses the timeline, not the recording
                    events = []
                if hasattr(events, "__await__"):
                    # Wire store: this listener is synchronous; record
                    # the entry without the remote timeline (the shard
                    # node's own flight recorder keeps the full one).
                    events.close()
                    events = []
            self.flight.record(task.task_id, route, status=task.status,
                               duration_ms=duration_ms, events=events,
                               priority=getattr(task, "priority", None))

    # -- request shapes without a task record --------------------------------

    def record_refusal(self, route: str, reason: str,
                       priority: int | None = None) -> None:
        """A gateway shed/expiry that never created a task: counted as a
        terminal outcome for the route and always kept by the flight
        recorder (refusals are interesting by definition)."""
        outcome = "expired" if reason == "expired" else "shed"
        self._outcomes.inc(route=route, outcome=outcome)
        if self.flight is not None:
            self.flight.record(None, route, refusal=reason,
                               priority=priority)

    def observe_sync(self, route: str, duration_s: float,
                     status: int) -> None:
        """One sync-proxy round trip: e2e latency + outcome for the SLO
        engine; slow/failed/shed ones reach the flight recorder.

        Outcome classification mirrors the dispatcher's: 5xx (and the
        proxy's own 502) is a platform failure, 429 is the platform
        refusing (``shed`` — overload SHOULD burn the error budget),
        but any other 4xx is the CLIENT's error — one misbehaving
        client looping malformed POSTs must not page the route's SLO
        or feed brownout evidence (``client_error`` is not in the
        engine's bad set)."""
        self._e2e.observe(duration_s, route=route)
        if 200 <= status < 400:
            outcome = "ok"
        elif status == 429:
            outcome = "shed"
        elif 400 <= status < 500:
            outcome = "client_error"
        else:
            outcome = "failed"
        self._outcomes.inc(route=route, outcome=outcome)
        if self.flight is not None:
            self.flight.record(None, route,
                               status=("ok" if outcome == "ok"
                                       else f"{outcome} - HTTP {status}"),
                               duration_ms=duration_s * 1e3)
