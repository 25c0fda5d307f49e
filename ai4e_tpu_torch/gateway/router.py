"""Gateway — the platform's front door; a copy of
``ai4e_tpu/gateway/router.py`` cut to this slice.

Routes:

- ``POST {route.prefix}/…`` (async) -> a task {Status: created, Endpoint,
  Body, publish} in the store, which hands it to the broker; the task JSON
  comes back at once;
- ``ANY  {route.prefix}/…`` (sync) -> a reverse proxy to the backend;
- ``GET  /v1/taskmanagement/task/{taskId}`` -> the task record (404 when
  unknown); ``?wait=SECONDS`` long-polls until it is terminal, parked on
  the task's change feed (``taskstore/feed.py``: the owning shard's on a
  sharded store, else one feed on the store's listeners), which wakes it
  with the terminal record; ``?ledger=1`` adds the task's hop-ledger
  timeline as ``Ledger`` (opt-in: without it the answer is
  byte-identical);
- ``GET  /v1/debug/flight`` -> the flight recorder's dump, once
  ``set_observability`` attached the hub;
- ``GET  /metrics``, ``GET /healthz``.

With subscription keys (``set_api_keys``) every request but ``/healthz``
and ``/metrics`` needs ``Ocp-Apim-Subscription-Key`` or ``X-Api-Key``
(401 under the constant ``route="unauthorized"`` label), the task-store
surface riding this app included. A rate limiter and a quota tracker
(``set_rate_limiter``, ``set_quota_tracker``; ``gateway/ratelimit.py``)
throttle everything but ``/v1/taskstore/*``, by the key when auth
validated it and by the caller's address otherwise: the quota is peeked
first (403 with the window's ``Retry-After``), then the rate (429 with
``Retry-After``), then the quota unit is consumed.

With the result cache (``set_result_cache``, ``rescache/``) an async
request is looked up before a task exists: a hit is a real task record
created already terminal (``completed - served from cache``, memory-only)
with the cached result; an identical request in flight gets the leader's
task record (single flight); a miss stamps the key on the task and
registers it as the key's leader, and the store listener fills the cache
when it completes. The sync proxy does the same for POSTs, the waiters
awaiting the leader's answer. Every answer of a cached route carries
``X-Cache: hit|miss|coalesced|bypass`` (``X-Cache-Bypass: 1`` or
``Cache-Control: no-cache`` opts out); each outcome is counted once, at
this edge.

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
the class is shed) and forwards the absolute deadline. The expiry 504
comes before the cache lookup, the pressure shed after it, so a free answer
is never shed.

On a standby control plane (a follower store) the async edge answers 503
with ``X-Not-Primary`` and a Retry-After (the drain rate's with
admission, else 2 s): task creation belongs to the primary; a
journal-degraded store answers 503 with ``X-Shed-Reason:
journal-degraded``. A cache hit on either falls through to that answer.

A route may name a weighted backend set (``utils/backends.py``, a canary
split): the sync proxy picks a backend for each request, and an async
route records the set's first backend as the task's endpoint (the
dispatcher picks for each delivery). Such a route is never cacheable: the
cache key hashes the shared endpoint path, not the chosen backend, so one
backend's answer would be replayed to all of the split's traffic.

With the shared health model (``set_resilience``) the sync proxy's pick is
health-aware, a connection that never reached the backend fails over to
another backend of the set within ``max_attempts`` and the proxy's retry
budget (a timeout or a broken response answers 502: the backend may have
run the request), every response's status feeds the breakers, and a
response carrying ``X-Draining`` ejects its backend for the drain TTL.
With the orchestrator (``set_orchestration``) an admitted POST is placed
on the cheapest backend predicted to finish within its budget, its round
trip feeding the estimator, and the degradation ladder's brownout refuses
a class: the sync proxy answers 503 before its occupancy check and after
the cache consult, so cache hits still answer; the async edge answers 429
inside the pressure shed. Both carry ``X-Shed-Reason: brownout at <hop>``.
``rng`` (the constructor's) seeds the proxy's picks and backoffs.

Not ported (ROADMAP A18): tenancy (the middleware's tenant branch,
A18.10) and event streams (A18.12).
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
from ..resilience.retry import backoff_s
from ..rescache.keys import (CACHE_STATUS_HEADER, cache_bypass_requested,
                             request_key)
from ..taskstore import (APITask, InMemoryTaskStore, JournalDegradedError,
                         NotPrimaryError, TaskNotFound, TaskStatus,
                         endpoint_path)
from ..taskstore.feed import ShardChangeFeed
from ..utils.backends import normalize_backends, pick_backend
from ..utils.http import SessionHolder, read_body_limited


@dataclass
class Route:
    """One published API: ``prefix`` is the public path; async routes
    create tasks addressed to ``backend_uri``, sync routes proxy to a
    backend of ``backends``."""

    prefix: str
    mode: str  # "sync" | "async"
    backend_uri: str = ""
    # The sync route's weighted backend set; [(backend_uri, 1.0)] for one.
    backends: list = None
    # None = the gateway's cap at request time; 0 = explicitly unlimited.
    max_body_bytes: int | None = None
    # Whether the result cache may serve and fill this route: False on a
    # weighted set, whose backends may serve different model versions.
    cacheable: bool = True


class Gateway:
    MAX_LONG_POLL = 60.0

    def __init__(self, store: InMemoryTaskStore,
                 metrics: MetricsRegistry | None = None,
                 max_body_bytes: int = 128 * 1024 * 1024, rng=None):
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
        # The shared health model (set_resilience) and its retry budget
        # for the sync proxy; None: one attempt, 502 on a connection error.
        self._resilience = None
        self._sync_retry_budget = None
        # The orchestrator (set_orchestration); None: health-aware picks
        # and no brownout.
        self._orchestration = None
        # The sync proxy's picks and backoffs draw from it (None: the
        # health model's own, else the module's).
        self._rng = rng
        # Subscription keys (set_api_keys); None: open.
        self._api_keys = None
        # Per-key rate limiter and quota tracker; None: unlimited.
        self._rate_limiter = None
        self._quota_tracker = None
        # Result cache (set_result_cache); None: every request executes.
        self._result_cache = None
        # Sync single flight: key -> (future of the leader's (status,
        # payload, content_type), or None when it errored; the family
        # generation the leader captured). Event-loop objects.
        self._sync_inflight: dict = {}
        # Proxy fan-out is bounded by inbound connections, not the pool.
        self._sessions = SessionHolder(limit=0)
        # The long polls' change feed (``_feed_for``) when the store has
        # none of its own (a sharded store has one a shard): one feed on
        # the store's listeners, attached here so that no transition
        # before the first long poll is missed.
        self._fallback_feed = None
        if getattr(store, "feed_for", None) is None:
            self._fallback_feed = ShardChangeFeed(0)
            store.add_listener(self._fallback_feed.publish)
        # aiohttp's own cap is disabled: the edge cap is enforced per route,
        # incrementally, and 0 must mean unlimited.
        self.app = web.Application(client_max_size=1024**4,
                                   middlewares=[self._auth_middleware])
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

    def set_api_keys(self, keys: set[str] | None) -> None:
        """Enable (or clear) subscription-key auth on this app."""
        self._api_keys = set(keys) if keys else None

    def set_rate_limiter(self, limiter) -> None:
        """Enable (or clear with None) per-key request-rate throttling
        (``gateway/ratelimit.RateLimiter``) on published APIs and task
        polling, never on the task-store surface riding this app
        (throttling workers' status writes would stall the data plane)."""
        self._rate_limiter = limiter

    def set_quota_tracker(self, tracker) -> None:
        """Enable (or clear with None) per-key request quotas
        (``gateway/ratelimit.QuotaTracker``), with the rate limiter's
        scope; exhaustion answers 403 with the window's reset as
        ``Retry-After``."""
        self._quota_tracker = tracker

    def set_result_cache(self, cache) -> None:
        """Enable (or clear with None) the result cache and single-flight
        coalescing on published APIs (``rescache.ResultCache``)."""
        self._result_cache = cache

    @web.middleware
    async def _auth_middleware(self, request: web.Request, handler):
        """The APIM front door: with keys set, everything but health and
        metrics needs one, the task-store surface on this port included;
        then the quota peek, the rate limit and the quota unit, except on
        ``/v1/taskstore/*``. A no-op while nothing is set."""
        exempt = request.path in ("/healthz", "/metrics")
        key = (request.headers.get("Ocp-Apim-Subscription-Key")
               or request.headers.get("X-Api-Key"))
        if self._api_keys is not None and not exempt:
            if key not in self._api_keys:
                # Constant label: the path is the caller's to choose.
                self._requests.inc(route="unauthorized", outcome="401")
                return web.json_response(
                    {"error": "missing or invalid subscription key"},
                    status=401)
        throttled = ((self._rate_limiter is not None
                      or self._quota_tracker is not None)
                     and not exempt
                     and not request.path.startswith("/v1/taskstore/"))
        if throttled:
            # The key is the identity only when auth validated it: with
            # auth off the header is the caller's to rotate.
            identity = (key if self._api_keys is not None
                        else (request.remote or "anonymous"))
            # Peek the quota first, so a 403 spends no rate token.
            if self._quota_tracker is not None:
                allowed, retry_after = self._quota_tracker.would_allow(
                    identity)
                if not allowed:
                    self._requests.inc(route="throttled", outcome="403")
                    return web.json_response(
                        {"error": "quota exceeded"}, status=403,
                        headers={"Retry-After":
                                 str(max(1, math.ceil(retry_after)))})
            if self._rate_limiter is not None:
                allowed, retry_after = self._rate_limiter.allow(identity)
                if not allowed:
                    # No quota consumed: the peek above counts nothing.
                    self._requests.inc(route="throttled", outcome="429")
                    return web.json_response(
                        {"error": "rate limit exceeded"}, status=429,
                        # RFC 7231 delta-seconds: integer, at least 1.
                        headers={"Retry-After":
                                 str(max(1, math.ceil(retry_after)))})
            if self._quota_tracker is not None:
                self._quota_tracker.allow(identity)  # consume the unit
        return await handler(request)

    def set_admission(self, controller) -> None:
        """Enable (or clear with None) admission control on the published
        surface: deadlines and priorities parsed at the edge, expired work
        answered 504, the async edge shed lowest priority first against
        the backlog, the sync proxy run under the adaptive in-flight cap,
        and every Retry-After computed from the observed drain rate."""
        self._admission = controller

    def set_resilience(self, health) -> None:
        """Enable (or clear with None) resilient sync proxying: health-aware
        picks, failover of a connection error to another backend on the
        proxy's retry budget, every status into the shared breakers and
        ``X-Draining`` into the drain ejection."""
        self._resilience = health
        self._sync_retry_budget = (health.new_budget()
                                   if health is not None else None)

    def set_orchestration(self, orchestrator) -> None:
        """Enable (or clear with None) deadline- and cost-aware placement of
        admitted sync POSTs, whose round trips feed the estimator; the
        ladder's brownout refuses classes beside the adaptive cap. Needs
        admission and resilience (the assembly enforces it)."""
        self._orchestration = orchestrator

    def add_async_route(self, prefix: str, task_endpoint,
                        max_body_bytes: int | None = None) -> None:
        """Register an async API: requests become tasks addressed to
        ``task_endpoint``, the backend route the dispatcher POSTs to (a URI,
        or a weighted set whose first backend is the recorded endpoint).
        The route is cacheable only with one backend."""
        backends = normalize_backends(task_endpoint)
        route = Route(prefix=prefix.rstrip("/"), mode="async",
                      backend_uri=backends[0][0],
                      max_body_bytes=max_body_bytes,
                      cacheable=len(backends) == 1)
        self.routes.append(route)
        if self._observability is not None:
            self._observability.map_route(endpoint_path(route.backend_uri),
                                          route.prefix)
        handler = self._make_async_handler(route)
        self.app.router.add_post(route.prefix, handler)
        self.app.router.add_post(route.prefix + "/{tail:.*}", handler)

    def add_sync_route(self, prefix: str, backend_uri,
                       max_body_bytes: int | None = None) -> None:
        """Register a sync API proxied to ``backend_uri`` (a URI, or a
        weighted set picked from for each request); cacheable only with
        one backend."""
        backends = [(u.rstrip("/"), w)
                    for u, w in normalize_backends(backend_uri)]
        route = Route(prefix=prefix.rstrip("/"), mode="sync",
                      backend_uri=backends[0][0], backends=backends,
                      max_body_bytes=max_body_bytes,
                      cacheable=len(backends) == 1)
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
            content_type = request.content_type or "application/json"
            # Admission: anchor the caller's relative budget, classify, and
            # refuse dead work before any task exists. The pressure shed
            # waits until the cache had its chance: a cached or coalesced
            # answer adds no backlog. Off: nothing parsed, nothing stamped.
            deadline_at = 0.0
            task_priority = 1
            if self._admission is not None:
                deadline_at = parse_deadline_at(request.headers)
                task_priority = parse_priority(request.headers)
                refusal = self._admission_expired(route, task_priority,
                                                  deadline_at)
                if refusal is not None:
                    return refusal
            # Result cache: a hit is served by a terminal task; an identical
            # request in flight gets the leader's record; a miss stamps the
            # key on the task, whose completion fills the cache.
            cache = self._result_cache if route.cacheable else None
            cache_key = ""
            xcache = None
            if cache is not None:
                if cache_bypass_requested(request.headers):
                    xcache = "bypass"
                else:
                    key = self._derive_cache_key(route, request, body,
                                                 content_type)
                    with self.tracer.span("cache_lookup", route=route.prefix,
                                          headers=request.headers) as span:
                        # count=False: the outcome is counted once, below,
                        # when it is known (a coalesced lookup is no miss).
                        found = cache.get(key, count=False)
                        leader = None if found else cache.leader_for(key)
                        span.attrs["outcome"] = ("hit" if found
                                                 else "coalesced" if leader
                                                 else "miss")
                    if found is not None:
                        answer = self._serve_cached_task(
                            route, endpoint, body, content_type, key, found)
                        if answer is not None:
                            cache.count_hit()
                            return answer
                    if leader is not None:
                        try:
                            record = self.store.get(leader)
                        except TaskNotFound:
                            # Leader evicted mid-flight: execute fresh.
                            cache.release_inflight(key, leader)
                        else:
                            cache.count_coalesced()
                            self._requests.inc(route=route.prefix,
                                               outcome="coalesced")
                            return web.json_response(
                                record.to_dict(),
                                headers={CACHE_STATUS_HEADER: "coalesced"})
                    cache_key = key
                    xcache = "miss"
            if self._admission is not None:
                refusal = self._admission_pressure(route, task_priority,
                                                   deadline_at)
                if refusal is not None:
                    return refusal
            with self.tracer.span("create_task", route=route.prefix,
                                  headers=request.headers) as span:
                try:
                    task = self.store.upsert(APITask(
                        endpoint=endpoint, body=body,
                        content_type=content_type, publish=True,
                        cache_key=cache_key, deadline_at=deadline_at,
                        priority=task_priority))
                except NotPrimaryError:
                    # A standby: task creation is on the primary. Clients
                    # with a replica list rotate on this header only.
                    self._requests.inc(route=route.prefix,
                                       outcome="not_primary")
                    return web.json_response(
                        {"error": "standby replica; task creation is on "
                                  "the primary"},
                        status=503,
                        headers={"Retry-After": self._standby_retry_after(),
                                 "X-Not-Primary": "1"})
                except JournalDegradedError as exc:
                    # Nothing was created or published; reads still serve
                    # here, so no X-Not-Primary.
                    self._requests.inc(route=route.prefix,
                                       outcome="journal_degraded")
                    if self._observability is not None:
                        self._observability.record_refusal(
                            route.prefix, "journal-degraded",
                            priority=task_priority)
                    return web.json_response(
                        {"error": f"journal degraded: {exc}"},
                        status=503,
                        headers={"Retry-After": self._standby_retry_after(),
                                 SHED_REASON_HEADER: "journal-degraded"})
                span.task_id = task.task_id
            if xcache is not None:
                # Counted once the record exists (hit and coalesced
                # returned above).
                (cache.count_miss if xcache == "miss"
                 else cache.count_bypass)()
            stored = self.store.get(task.task_id)
            if self._observability is not None:
                # The store published the task inside upsert, so it is on
                # the transport by now.
                self._observability.stamp(
                    task.task_id,
                    ledger_event(ADMITTED, "gateway", t=arrival,
                                 reason=route.prefix),
                    ledger_event(PUBLISHED, "gateway"))
            if (cache_key
                    and stored.canonical_status not in TaskStatus.TERMINAL):
                # This task now owns the key; the store listener releases
                # it on the terminal transition (``rescache/wiring.py``).
                # Nothing awaited since the lookup, so no identical request
                # slipped in between. A publish failure registers nothing.
                cache.register_inflight(cache_key, task.task_id)
            outcome = ("failed" if stored.canonical_status == "failed"
                       else "created")
            self._requests.inc(route=route.prefix, outcome=outcome)
            return web.json_response(
                stored.to_dict(),
                headers={CACHE_STATUS_HEADER: xcache} if xcache else None)

        return handler

    def _derive_cache_key(self, route: Route, request: web.Request,
                          body: bytes, content_type: str) -> str:
        """The result-cache key of a gateway request, one derivation for
        the async and the sync handler: family the backend's endpoint path,
        ``extra`` the operation tail and query."""
        tail = request.match_info.get("tail", "")
        return request_key(
            endpoint_path(route.backend_uri), body, content_type,
            extra=(tail + "?" + request.query_string
                   if request.query_string else tail))

    def _standby_retry_after(self) -> str:
        """Retry-After of the standby and journal-degraded 503s: the drain
        rate's estimate with admission, else 2 s."""
        if self._admission is None:
            return "2"
        return str(max(1, math.ceil(self._admission.retry_after_s())))

    def _serve_cached_task(self, route: Route, endpoint: str, body: bytes,
                           content_type: str, key: str,
                           found: tuple) -> web.Response | None:
        """Answer an async cache hit with a real task record, already
        terminal and never published, whose result is the cached payload:
        the client polls and fetches as for a miss. ``durable=False``: the
        answer already carries the terminal record, so a journal never
        holds it. None when this replica cannot create records (a standby,
        a degraded journal): the create path answers their 503."""
        payload, ctype = found
        try:
            task = self.store.upsert(APITask(
                endpoint=endpoint, body=body, content_type=content_type,
                status="completed - served from cache",
                backend_status=TaskStatus.COMPLETED,
                publish=False, cache_key=key, durable=False))
        except (NotPrimaryError, JournalDegradedError):
            return None
        try:
            self.store.set_result(task.task_id, payload, ctype)
        except TaskNotFound:
            pass  # reaped already (zero retention); the record answered
        except JournalDegradedError:
            return None  # degraded in between: the create path's 503
        self._requests.inc(route=route.prefix, outcome="cache_hit")
        return web.json_response(task.to_dict(),
                                 headers={CACHE_STATUS_HEADER: "hit"})

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
            # answers 504 before the cache or the backend see it; the
            # others run under the adaptive in-flight cap, acquired inside
            # the try below.
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
            # Result cache on POSTs: a hit answers here; an identical
            # request already proxying makes this one its waiter.
            cache = self._result_cache if route.cacheable else None
            key = None
            fut = None  # set when THIS request is the single-flight leader
            gen = 0  # the family's generation captured at leadership
            bypassed = False
            # A miss or bypass is counted only once admitted: a request
            # shed below never executed.
            miss_pending = False
            if cache is not None and request.method == "POST":
                if cache_bypass_requested(request.headers):
                    bypassed = True
                else:
                    key = self._derive_cache_key(route, request, body,
                                                 request.content_type or "")
                    found = cache.get(key, count=False)
                    if found is not None:
                        cache.count_hit()
                        self._requests.inc(route=route.prefix,
                                           outcome="cache_hit")
                        return web.Response(
                            body=found[0], content_type=found[1],
                            headers={CACHE_STATUS_HEADER: "hit"})
                    waiting = self._sync_inflight.get(key)
                    if waiting is not None:
                        leader_fut, leader_gen = waiting
                        settled = await leader_fut
                        if (settled is not None
                                and cache.generation(key) == leader_gen):
                            status, payload, ctype = settled
                            cache.count_coalesced()
                            self._requests.inc(route=route.prefix,
                                               outcome="coalesced")
                            return web.Response(
                                status=status, body=payload,
                                content_type=ctype,
                                headers={CACHE_STATUS_HEADER: "coalesced"})
                        # The leader errored, or a reload invalidated the
                        # family after it began: its answer is the old
                        # weights'. Proxy alone, unregistered.
                        miss_pending = True
                        key = None
                    else:
                        fut = asyncio.get_running_loop().create_future()
                        gen = cache.generation(key)
                        self._sync_inflight[key] = (fut, gen)
                        miss_pending = True
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
            # Sync POSTs (inference requests, not health probes) feed the
            # hub's per-route e2e latency and outcome.
            observe = (self._observability.observe_sync
                       if self._observability is not None
                       and request.method == "POST" else None)
            acquired = False
            t0 = time.perf_counter()
            # From the leader's registration on, every exit (an error, the
            # client going away) runs the finally, or the unresolved future
            # would wedge every later identical request.
            try:
                if sync_scope is not None:
                    # A declared brownout refuses the class before any
                    # occupancy math; cache hits answered above. Inside the
                    # try, so a refused leader resolves its future.
                    brown = adm.brownout_refusal(priority)
                    if brown is not None:
                        adm.note_shed("gateway_sync", priority)
                        self._requests.inc(route=route.prefix,
                                           outcome="shed")
                        if self._observability is not None:
                            self._observability.record_refusal(
                                route.prefix, "brownout", priority=priority)
                        return web.Response(
                            status=503, text="Service degraded (brownout).",
                            headers={"Retry-After":
                                     str(max(1, math.ceil(brown[0]))),
                                     SHED_REASON_HEADER:
                                     shed_reason("gateway_sync",
                                                 "brownout")})
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
                if cache is not None:
                    if miss_pending:
                        cache.count_miss()
                    elif bypassed:
                        cache.count_bypass()
                res = self._resilience
                # Placement for admitted POSTs only: a GET probe would
                # teach the estimator a service time no inference sees.
                orch = self._orchestration if sync_scope is not None else None
                tried: list[str] = []
                attempt = 0
                if self._sync_retry_budget is not None:
                    self._sync_retry_budget.on_request()
                while True:
                    attempt += 1
                    # A pick for each request (one backend makes no RNG
                    # call), health-aware under resilience, placed under
                    # orchestration.
                    if orch is not None:
                        base = orch.place(route.backends,
                                          deadline_at=deadline_at,
                                          priority=priority, rng=self._rng,
                                          exclude=tried)
                    elif res is not None:
                        base = res.pick(route.backends, self._rng,
                                        exclude=tried)
                    else:
                        base = pick_backend(route.backends, self._rng)
                    target = base + (("/" + tail) if tail else "")
                    if request.query_string:
                        target += "?" + request.query_string
                    session = await self._get_session()
                    attempt_t0 = time.perf_counter()
                    if orch is not None:
                        # Sync load counts as queue pressure too, released
                        # in the finally.
                        orch.begin(base)
                    try:
                        async with session.request(
                                request.method, target, data=body,
                                headers=headers) as resp:
                            payload = await resp.read()
                            if orch is not None and 200 <= resp.status < 300:
                                orch.observe(
                                    base, time.perf_counter() - attempt_t0)
                            if res is not None:
                                # A 5xx (not 503) is failure evidence; the
                                # answer still goes to the client: the
                                # backend ran the request.
                                res.observe_status(base, resp.status)
                                if resp.headers.get("X-Draining"):
                                    res.mark_draining(base)
                            self._requests.inc(route=route.prefix,
                                               outcome=str(resp.status))
                            if observe is not None:
                                observe(route.prefix,
                                        time.perf_counter() - t0,
                                        resp.status)
                            if fut is not None:
                                # Only a success fills, and only while the
                                # family's generation is the one captured
                                # at leadership (a reload mid-proxy makes
                                # this the old weights' answer); the
                                # waiters get whatever it is.
                                if resp.status == 200:
                                    cache.put(key, payload,
                                              resp.content_type,
                                              if_generation=gen)
                                fut.set_result((resp.status, payload,
                                                resp.content_type))
                            return web.Response(
                                status=resp.status, body=payload,
                                content_type=resp.content_type,
                                # Leader: miss; opted out: bypass; a waiter
                                # whose leader failed: none.
                                headers=({CACHE_STATUS_HEADER: "miss"}
                                         if fut is not None
                                         else {CACHE_STATUS_HEADER: "bypass"}
                                         if bypassed else None))
                    except (aiohttp.ClientError,
                            asyncio.TimeoutError) as exc:
                        # Under resilience every transport failure is
                        # breaker evidence, but only a connect failure
                        # retries: the request never reached the backend.
                        # A timeout or a broken response may have run it.
                        # Without resilience a timeout propagates, as
                        # before.
                        if res is not None:
                            res.record_failure(base)
                            if (isinstance(exc, aiohttp.ClientConnectorError)
                                    and attempt < res.policy.max_attempts
                                    and self._sync_retry_budget.try_retry()):
                                tried.append(base)
                                res.note_failover("gateway_sync")
                                await asyncio.sleep(backoff_s(
                                    attempt, res.policy.retry_base_s,
                                    res.policy.retry_cap_s, self._rng))
                                continue
                        elif isinstance(exc, asyncio.TimeoutError):
                            raise
                        self._requests.inc(route=route.prefix,
                                           outcome="unreachable")
                        if observe is not None:
                            observe(route.prefix, time.perf_counter() - t0,
                                    502)
                        return web.Response(
                            status=502, text=f"Backend unreachable: {exc}")
                    finally:
                        if orch is not None:
                            orch.end(base)
            finally:
                if acquired:
                    # Observe before the release, so the limiter's
                    # Little's-law clamp counts this request in flight;
                    # only requests that held a slot teach it an RTT.
                    sync_scope.observe(time.perf_counter() - t0)
                    sync_scope.release()
                if fut is not None:
                    self._sync_inflight.pop(key, None)
                    if not fut.done():
                        fut.set_result(None)  # the waiters proxy alone

        return handler

    async def _get_session(self) -> aiohttp.ClientSession:
        return await self._sessions.get()

    # -- task polling --------------------------------------------------------

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
            # Park on the task's change feed, which wakes with the terminal
            # record itself; its replay map closes the race between the
            # read above and the attach. Only the timeout reads the store
            # again, where a task evicted mid-wait answers 404.
            record = await self._feed_for(task_id).wait_terminal(task_id,
                                                                 wait)
            if record is not None:
                task = record
            else:
                try:
                    task = self.store.get(task_id)
                except TaskNotFound:
                    return web.Response(status=404, text="Task not found.")
        payload = task.to_dict()
        if request.query.get("ledger", "") not in ("", "0", "false"):
            # The native store carries no timeline.
            getter = getattr(self.store, "get_ledger", None)
            payload["Ledger"] = getter(task_id) if getter else []
        return web.json_response(payload)

    def _feed_for(self, task_id: str) -> ShardChangeFeed:
        """The change feed a long poll of ``task_id`` parks on: the store's
        own (the owning shard's, on a sharded store), else the gateway's
        one feed on the store's listeners. Either wakes alike whether the
        transition came from this gateway's dispatch, another gateway or a
        replication absorb."""
        feed_for = getattr(self.store, "feed_for", None)
        if feed_for is not None:
            return feed_for(task_id)
        return self._fallback_feed

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
