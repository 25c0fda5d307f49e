"""Gateway — the platform's front door; a copy of
``ai4e_tpu/gateway/router.py`` cut to this slice.

Routes:

- ``POST {route.prefix}/…`` (async) -> a task {Status: created, Endpoint,
  Body, publish} in the store, which hands it to the broker; the task JSON
  comes back at once;
- ``ANY  {route.prefix}/…`` (sync) -> a reverse proxy to the backend;
- ``GET  /v1/taskmanagement/task/{taskId}`` -> the task record (404 when
  unknown); ``?wait=SECONDS`` long-polls until it is terminal;
  ``?ledger=1`` adds the task's hop-ledger timeline as ``Ledger`` (opt-in:
  without it the answer is byte-identical);
- ``GET  /v1/debug/flight`` -> the flight recorder's dump, once
  ``set_observability`` attached the hub;
- ``GET  /metrics``, ``GET /healthz``.

Every async request runs in a ``create_task`` span (parented by inbound B3
headers); with the hub it gets ``admitted`` (stamped at its arrival time)
and ``published`` ledger events, and each sync POST's round trip is
observed for the SLO engine.

With admission (``set_admission``) a request carries ``X-Deadline-Ms`` and
``X-Priority``: already-expired work answers 504 with ``X-Shed-Reason``
before any task exists; the async edge anchors the deadline on the task
(stream routes too) and sheds lowest priority first against the route's
created backlog, 429 with a Retry-After computed from the drain rate; the
sync proxy runs under the controller's adaptive in-flight cap (503 when
the class is shed) and forwards the absolute deadline. Not ported (ROADMAP
A18): subscription keys, rate limits and quotas, tenancy, the result
cache, orchestration's brownout and resilient proxying, event streams and
weighted backends.
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass

import aiohttp
from aiohttp import web

from ..admission.deadline import (SHED_REASON_HEADER, expired,
                                  parse_deadline_at, parse_priority,
                                  propagation_headers, shed_reason)
from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from ..observability import Tracer
from ..observability.ledger import ADMITTED, PUBLISHED, ledger_event
from ..taskstore import (APITask, InMemoryTaskStore, TaskNotFound, TaskStatus,
                         endpoint_path)
from ..utils.http import SessionHolder, read_body_limited


@dataclass
class Route:
    """One published API: ``prefix`` is the public path; async routes
    create tasks addressed to ``backend_uri``, sync routes proxy to it."""

    prefix: str
    mode: str  # "sync" | "async"
    backend_uri: str = ""
    # None = the gateway's cap at request time; 0 = explicitly unlimited.
    max_body_bytes: int | None = None


class Gateway:
    MAX_LONG_POLL = 60.0

    def __init__(self, store: InMemoryTaskStore,
                 metrics: MetricsRegistry | None = None,
                 max_body_bytes: int = 128 * 1024 * 1024):
        # Edge payload cap: an async POST over it is refused with 413 before
        # a task exists.
        self.max_body_bytes = max_body_bytes
        self.store = store
        self.metrics = metrics or DEFAULT_REGISTRY
        self.routes: list[Route] = []
        self._requests = self.metrics.counter(
            "ai4e_gateway_requests_total", "Gateway requests by route/outcome")
        # Spans land in this gateway's registry; exporter and sampling
        # follow configure_tracer live.
        self.tracer = Tracer("gateway", metrics=self.metrics)
        # Request-observability hub (set_observability); None: no ledger
        # stamps, no flight recorder, no per-route e2e telemetry.
        self._observability = None
        # Admission controller (set_admission); None: no deadlines, no
        # shedding, an unbounded sync proxy.
        self._admission = None
        # Proxy fan-out is bounded by inbound connections, not the pool.
        self._sessions = SessionHolder(limit=0)
        # Long-poll waiters: task_id -> [(loop, future)], woken by the
        # store's listener with the terminal record.
        self._waiters: dict[str, list] = {}
        store.add_listener(self._on_transition)
        # aiohttp's own cap is disabled: the edge cap is enforced per route,
        # incrementally, and 0 must mean unlimited.
        self.app = web.Application(client_max_size=1024**4)
        self.app.router.add_get("/v1/taskmanagement/task/{task_id}", self._task)
        self.app.router.add_get("/healthz", self._health)
        self.app.router.add_get("/metrics", self._metrics)
        self.app.on_cleanup.append(self._cleanup)

    def set_observability(self, hub) -> None:
        """Attach the request-observability hub: accepted async requests
        get ``admitted``/``published`` ledger stamps, sync POSTs feed the
        per-route e2e telemetry, async tasks count under their published
        prefix (the hub maps each route's backend path onto it), and ``GET
        /v1/debug/flight`` serves the flight recorder."""
        first = self._observability is None
        self._observability = hub
        for route in self.routes:
            if route.mode == "async":
                hub.map_route(endpoint_path(route.backend_uri), route.prefix)
        if first:
            # Added only with the hub, so a default gateway's route table
            # stays as it was.
            self.app.router.add_get("/v1/debug/flight", self._flight_dump)

    def set_admission(self, controller) -> None:
        """Enable (or clear with None) admission control on the published
        surface: deadlines and priorities parsed at the edge, expired work
        answered 504, the async edge shed lowest priority first against
        the backlog, the sync proxy run under the adaptive in-flight cap,
        and every Retry-After computed from the observed drain rate."""
        self._admission = controller

    def add_async_route(self, prefix: str, task_endpoint: str,
                        max_body_bytes: int | None = None) -> None:
        """Register an async API: requests become tasks addressed to
        ``task_endpoint``, the backend route the dispatcher POSTs to."""
        route = Route(prefix=prefix.rstrip("/"), mode="async",
                      backend_uri=task_endpoint,
                      max_body_bytes=max_body_bytes)
        self.routes.append(route)
        if self._observability is not None:
            self._observability.map_route(endpoint_path(route.backend_uri),
                                          route.prefix)
        handler = self._make_async_handler(route)
        self.app.router.add_post(route.prefix, handler)
        self.app.router.add_post(route.prefix + "/{tail:.*}", handler)

    def add_sync_route(self, prefix: str, backend_uri: str,
                       max_body_bytes: int | None = None) -> None:
        route = Route(prefix=prefix.rstrip("/"), mode="sync",
                      backend_uri=backend_uri.rstrip("/"),
                      max_body_bytes=max_body_bytes)
        self.routes.append(route)
        handler = self._make_sync_handler(route)
        for pattern in (route.prefix, route.prefix + "/{tail:.*}"):
            self.app.router.add_route("*", pattern, handler)

    def _route_limit(self, route: Route) -> int:
        return (self.max_body_bytes if route.max_body_bytes is None
                else route.max_body_bytes)

    def _payload_too_large(self, route: Route) -> web.Response:
        self._requests.inc(route=route.prefix, outcome="413")
        return web.Response(
            status=413,
            text=f"Payload exceeds {self._route_limit(route)} bytes.")

    # -- async: task created at the edge -----------------------------------

    def _make_async_handler(self, route: Route):
        async def handler(request: web.Request) -> web.Response:
            # The ledger's ``admitted`` carries the ARRIVAL time, so the
            # gateway's own time is the admitted -> published delta.
            arrival = time.time() if self._observability is not None else 0.0
            body = await read_body_limited(request, self._route_limit(route))
            if body is None:
                return self._payload_too_large(route)
            # Record the full target (backend + operation tail + query) so
            # the dispatcher reproduces the exact call.
            endpoint = route.backend_uri
            tail = request.match_info.get("tail", "")
            if tail:
                endpoint = endpoint.rstrip("/") + "/" + tail
            if request.query_string:
                endpoint += "?" + request.query_string
            # Admission: anchor the caller's relative budget, classify,
            # and refuse dead or shed work before any task exists. Off:
            # nothing parsed, nothing stamped.
            deadline_at = 0.0
            task_priority = 1
            if self._admission is not None:
                deadline_at = parse_deadline_at(request.headers)
                task_priority = parse_priority(request.headers)
                refusal = (self._admission_expired(route, task_priority,
                                                   deadline_at)
                           or self._admission_pressure(route, task_priority,
                                                       deadline_at))
                if refusal is not None:
                    return refusal
            with self.tracer.span("create_task", route=route.prefix,
                                  headers=request.headers) as span:
                task = self.store.upsert(APITask(
                    endpoint=endpoint, body=body,
                    content_type=request.content_type or "application/json",
                    publish=True, deadline_at=deadline_at,
                    priority=task_priority))
                span.task_id = task.task_id
            stored = self.store.get(task.task_id)
            if self._observability is not None:
                # The store published the task inside upsert, so it is on
                # the transport by now.
                self._observability.stamp(
                    task.task_id,
                    ledger_event(ADMITTED, "gateway", t=arrival,
                                 reason=route.prefix),
                    ledger_event(PUBLISHED, "gateway"))
            outcome = ("failed" if stored.canonical_status == "failed"
                       else "created")
            self._requests.inc(route=route.prefix, outcome=outcome)
            return web.json_response(stored.to_dict())

        return handler

    def _admission_expired(self, route: Route, priority: int,
                           deadline_at: float) -> web.Response | None:
        """504 for async work whose budget is already spent: a task would
        only carry it through the broker."""
        if not expired(deadline_at):
            return None
        self._admission.note_expired("gateway", priority)
        self._requests.inc(route=route.prefix, outcome="expired")
        if self._observability is not None:
            self._observability.record_refusal(route.prefix, "expired",
                                               priority=priority)
        return web.Response(
            status=504, text="Deadline already expired.",
            headers={SHED_REASON_HEADER: shed_reason("gateway", "deadline")})

    def _admission_pressure(self, route: Route, priority: int,
                            deadline_at: float) -> web.Response | None:
        """429, lowest priority first, when the route's created backlog
        says new work would queue past its class's share (or past its own
        deadline), with a Retry-After from the observed drain rate and
        ``X-Shed-Reason``."""
        adm = self._admission
        backlog = self.store.set_len(endpoint_path(route.backend_uri),
                                     TaskStatus.CREATED)
        decision = adm.shed_async(priority, backlog, deadline_at)
        if decision is None:
            return None
        retry_after, why = decision
        adm.note_shed("gateway", priority)
        self._requests.inc(route=route.prefix, outcome="shed")
        if self._observability is not None:
            self._observability.record_refusal(route.prefix, why,
                                               priority=priority)
        return web.json_response(
            {"error": f"request shed ({why}); retry later"},
            status=429,
            headers={"Retry-After": str(max(1, math.ceil(retry_after))),
                     SHED_REASON_HEADER: shed_reason("gateway", why)})

    # -- sync: reverse proxy -------------------------------------------------

    def _make_sync_handler(self, route: Route):
        async def handler(request: web.Request) -> web.Response:
            tail = request.match_info.get("tail", "")
            body = await read_body_limited(request, self._route_limit(route))
            if body is None:
                return self._payload_too_large(route)
            # Admission on POSTs (the inference requests): an expired one
            # answers 504 before the backend sees it; the others run under
            # the adaptive in-flight cap, acquired inside the try below.
            adm = self._admission if request.method == "POST" else None
            sync_scope = None
            priority = 1
            deadline_at = 0.0
            if adm is not None:
                deadline_at = parse_deadline_at(request.headers)
                priority = parse_priority(request.headers)
                if expired(deadline_at):
                    adm.note_expired("gateway_sync", priority)
                    self._requests.inc(route=route.prefix, outcome="expired")
                    if self._observability is not None:
                        self._observability.record_refusal(
                            route.prefix, "expired", priority=priority)
                    return web.Response(
                        status=504, text="Deadline already expired.",
                        headers={SHED_REASON_HEADER:
                                 shed_reason("gateway_sync", "deadline")})
                sync_scope = adm.scope(adm.SYNC_SCOPE)
            # Hop headers and the gateway credential never reach a backend;
            # under admission the relative deadline is replaced by the
            # absolute one (re-anchoring it at the worker would extend the
            # budget by the proxy's own time).
            dropped = ("host", "content-length", "ocp-apim-subscription-key",
                       "x-api-key")
            if sync_scope is not None:
                dropped += ("x-deadline-ms", "x-deadline-at", "x-priority")
            headers = {k: v for k, v in request.headers.items()
                       if k.lower() not in dropped}
            if sync_scope is not None:
                headers.update(propagation_headers(deadline_at, priority))
            target = route.backend_uri + (("/" + tail) if tail else "")
            if request.query_string:
                target += "?" + request.query_string
            # Sync POSTs (inference requests, not health probes) feed the
            # hub's per-route e2e latency and outcome.
            observe = (self._observability.observe_sync
                       if self._observability is not None
                       and request.method == "POST" else None)
            acquired = False
            t0 = time.perf_counter()
            try:
                if sync_scope is not None:
                    retry_after = sync_scope.try_acquire(priority)
                    if retry_after is not None:
                        adm.note_shed("gateway_sync", priority)
                        self._requests.inc(route=route.prefix,
                                           outcome="shed")
                        if self._observability is not None:
                            self._observability.record_refusal(
                                route.prefix, "pressure", priority=priority)
                        return web.Response(
                            status=503, text="Sync capacity exhausted.",
                            headers={"Retry-After":
                                     str(max(1, math.ceil(retry_after))),
                                     SHED_REASON_HEADER:
                                     shed_reason("gateway_sync",
                                                 "pressure")})
                    acquired = True
                session = await self._sessions.get()
                async with session.request(request.method, target,
                                           data=body,
                                           headers=headers) as resp:
                    payload = await resp.read()
                    self._requests.inc(route=route.prefix,
                                       outcome=str(resp.status))
                    if observe is not None:
                        observe(route.prefix, time.perf_counter() - t0,
                                resp.status)
                    return web.Response(status=resp.status, body=payload,
                                        content_type=resp.content_type)
            except aiohttp.ClientError as exc:
                self._requests.inc(route=route.prefix, outcome="unreachable")
                if observe is not None:
                    observe(route.prefix, time.perf_counter() - t0, 502)
                return web.Response(status=502,
                                    text=f"Backend unreachable: {exc}")
            finally:
                if acquired:
                    # Observe before the release, so the limiter's
                    # Little's-law clamp counts this request in flight;
                    # only requests that held a slot teach it an RTT.
                    sync_scope.observe(time.perf_counter() - t0)
                    sync_scope.release()

        return handler

    # -- task polling --------------------------------------------------------

    def _on_transition(self, task: APITask) -> None:
        """Store listener (any thread): wake the long-polls of a task that
        turned terminal, with its record."""
        if task.canonical_status not in TaskStatus.TERMINAL:
            return
        for loop, fut in self._waiters.pop(task.task_id, ()):
            loop.call_soon_threadsafe(_resolve, fut, task)

    async def _task(self, request: web.Request) -> web.Response:
        """Task status; ``?wait=SECONDS`` (at most 60) long-polls until the
        task is terminal or the wait expires; ``?ledger=1`` adds the task's
        hop-ledger timeline."""
        task_id = request.match_info["task_id"]
        try:
            task = self.store.get(task_id)
        except TaskNotFound:
            return web.Response(status=404, text="Task not found.")
        wait = 0.0
        if "wait" in request.query:
            try:
                wait = min(float(request.query["wait"]), self.MAX_LONG_POLL)
            except ValueError:
                return web.Response(status=400, text="Bad wait parameter.")
        if wait > 0 and task.canonical_status not in TaskStatus.TERMINAL:
            loop = asyncio.get_running_loop()
            entry = (loop, loop.create_future())
            self._waiters.setdefault(task_id, []).append(entry)
            try:
                # Re-read after registering: a transition between the first
                # read and the registration would otherwise be missed.
                task = self.store.get(task_id)
                if task.canonical_status not in TaskStatus.TERMINAL:
                    task = await asyncio.wait_for(entry[1], wait)
            except asyncio.TimeoutError:
                try:
                    task = self.store.get(task_id)
                except TaskNotFound:
                    return web.Response(status=404, text="Task not found.")
            finally:
                waiters = self._waiters.get(task_id)
                if waiters and entry in waiters:
                    waiters.remove(entry)
                    if not waiters:
                        del self._waiters[task_id]
        payload = task.to_dict()
        if request.query.get("ledger", "") not in ("", "0", "false"):
            payload["Ledger"] = self.store.get_ledger(task_id)
        return web.json_response(payload)

    async def _flight_dump(self, _: web.Request) -> web.Response:
        hub = self._observability
        if hub is None or hub.flight is None:
            return web.json_response(
                {"error": "flight recorder not enabled"}, status=404)
        return web.json_response(hub.flight.dump())

    async def _health(self, _: web.Request) -> web.Response:
        return web.json_response({"status": "healthy",
                                  "routes": len(self.routes)})

    async def _metrics(self, _: web.Request) -> web.Response:
        return web.Response(text=self.metrics.render_prometheus(),
                            content_type="text/plain")

    async def _cleanup(self, _app) -> None:
        await self._sessions.close()


def _resolve(fut: asyncio.Future, task: APITask) -> None:
    if not fut.done():
        fut.set_result(task)
