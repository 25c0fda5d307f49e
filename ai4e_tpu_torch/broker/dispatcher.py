"""Dispatcher — drains endpoint queues and pushes tasks to backend services;
a copy of ``ai4e_tpu/broker/dispatcher.py``. A route names one backend or
a weighted set (``utils/backends.py``, a canary split), and each delivery
picks its own backend from the set:

- backend 429 or 503 (the backend is at its cap) — the task reads
  "Awaiting service availability", the message goes back to the broker
  after a jittered exponential delay from ``retry_delay``, and is
  redelivered;
- backend unreachable — the same, bounded by the broker's patience;
- any other failure — the message completes and the task fails;
- success — the message completes; the backend drives the task from there.

Every status write that could land on a finished task is preceded by a
terminal probe, so a redelivery never reopens a completed task.

Deadlines: a message whose deadline passed while it queued is completed
off the broker at pop time and its task turns terminal ``expired`` (it
never reaches the worker); a live one carries ``X-Deadline-At`` and
``X-Priority`` on its backend POST. With an admission controller the
delivered round trips feed the queue's limiter, whose limit drives
``set_concurrency``, and a backend's 429/503 backs it off at once.

Each delivery attempt is a ``dispatch`` span keyed by TaskId, the child
of the span that published the task (the message's ``trace_headers``);
its B3 headers go on the backend POST, so the worker's endpoint span is
its child. With the observability hub it stamps the hop ledger where JAX's
does on this path: ``popped``, ``expired``, ``delivered``,
``backpressure`` and ``dead_letter``.

With a result cache (and a ``result_store`` to put the payload in), a
message whose task carries a cache key is checked against the cache before
the backend POST: a redelivery or requeue whose identical request already
completed finishes here, ``completed - served from cache``, without
reaching the card (``dispatch_total{outcome="cache_hit"}``).

With the shared health model (``resilience/``) each delivery's backend
is a health-aware pick (open and draining backends ejected), a connection
error retries on a different backend of the set and a 5xx (other than
503) retries too, both within ``max_attempts`` and the queue's retry
budget, before falling back to redelivery; a 503 with ``X-Draining``
ejects its backend for the drain TTL without counting against its
breaker; a breaker that opens backs the queue's admission limiter off at
once; and a message whose task is already terminal is completed off the
broker without a POST (``duplicate``). With the orchestrator
(``orchestration/``) the backend is the cheapest one predicted to finish
within the message's remaining deadline, and delivered round trips feed
its estimator. The ledger gets their ``placed``, ``probe``, ``retry``,
``failover`` and ``duplicate`` stamps. ``rng`` seeds every pick and
backoff. With tenancy beside the orchestrator, each delivery charges the
message's tenant the cost of the backend it ran on.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import time
from urllib.parse import urlparse

import aiohttp

from ..admission.deadline import expired_status, propagation_headers
from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from ..observability import Tracer
from ..observability import ledger as hop
from ..resilience.retry import backoff_s
from ..service.task_manager import TaskManagerBase
from ..taskstore import TaskStatus
from ..utils.backends import normalize_backends, pick_backend
from ..utils.http import SessionHolder
from .queue import InMemoryBroker, Message, base_queue_name

log = logging.getLogger("ai4e_tpu_torch.dispatcher")

# Backend saturation signals: 429 and the service shell's 503.
BACKPRESSURE_CODES = (429, 503)
AWAITING_STATUS = "Awaiting service availability"
REQUEST_TIMEOUT_S = 300.0  # one backend POST


def rebase_endpoint(endpoint: str, base_path: str, backend_uri: str) -> str:
    """Graft ``endpoint``'s operation tail and query onto ``backend_uri``, so
    the dispatch reproduces the exact call the client made against the
    registered backend."""
    parsed = urlparse(endpoint)  # handles bare paths too
    path = parsed.path
    base = base_path.rstrip("/")
    target = backend_uri
    if path != base and path.startswith(base + "/"):
        target = backend_uri.rstrip("/") + path[len(base):]
    if parsed.query:
        target += "?" + parsed.query
    return target


class Dispatcher:
    """Drains one endpoint queue, POSTing each task with a ``taskId`` header
    to ``backend_uri``, or, given a weighted backend list, to a backend
    picked from it for each delivery (a redelivered task may land on the
    other version: a canary that 503s does not strand its tasks)."""

    def __init__(self, broker: InMemoryBroker, queue_name: str,
                 backend_uri, task_manager: TaskManagerBase,
                 retry_delay: float = 60.0, concurrency: int = 1,
                 observability=None, admission=None,
                 metrics: MetricsRegistry | None = None,
                 result_cache=None, result_store=None, resilience=None,
                 orchestration=None, rng=None, tenancy=None,
                 request_timeout: float = REQUEST_TIMEOUT_S):
        self.broker = broker
        self.queue_name = queue_name
        self.route_path = base_queue_name(queue_name)
        self.backends = normalize_backends(backend_uri)
        # The primary backend, what single-backend readers see; the picks
        # use the whole set.
        self.backend_uri = self.backends[0][0]
        self.task_manager = task_manager
        self.retry_delay = retry_delay
        self.concurrency = concurrency
        self.metrics = metrics or DEFAULT_REGISTRY
        # Request-observability hub: None stamps nothing.
        self.observability = observability
        # The tenancy facade: with the orchestrator, a delivery charges the
        # message's tenant its backend's placement cost. None charges
        # nothing.
        self.tenancy = tenancy
        # Admission controller: None feeds no limiter. Deadline drops need
        # none: any message carrying a deadline is honoured.
        self.admission = admission
        # Result cache (rescache/): a message with a cache key whose
        # identical request already completed finishes from the cache; its
        # payload goes to ``result_store`` (anything with ``set_result``),
        # so the client's result fetch works as on the execute path.
        self.result_cache = result_cache
        self.result_store = result_store
        # The shared health model: None keeps one attempt a delivery, a
        # 5xx permanent and an unreachable backend redelivered.
        self.resilience = resilience
        # The orchestrator (needs resilience): None keeps the health
        # model's pick.
        self.orchestration = orchestration
        self._retry_budget = (resilience.new_budget()
                              if resilience is not None else None)
        # Every pick and backoff draws from it (None: the module's).
        self._rng = rng
        # Spans land in this dispatcher's registry; exporter and sampling
        # follow configure_tracer live.
        self.tracer = Tracer("dispatcher", metrics=self.metrics)
        self._dispatched = self.metrics.counter(
            "ai4e_dispatch_total", "Dispatch attempts by outcome")
        self._stop = asyncio.Event()
        self._workers: list[asyncio.Task] = []
        # Graceful scale-down debt (set_concurrency): how many delivery
        # loops exit at their next idle point instead of being cancelled
        # mid-POST. Event-loop-only state, like _workers.
        self._excess = 0
        # Resizes before start() (or after stop()) only record the level.
        self._started = False
        # Delivery loops mid-delivery: the concurrency in use, which the
        # admission limiter's Little's-law clamp compares its limit with.
        self._busy = 0
        # In-flight POSTs are bounded by the delivery loops.
        # A backend POST's bound (the rig's dispatchers take 30 s).
        self.request_timeout = request_timeout
        self._sessions = SessionHolder(timeout=request_timeout, limit=0)

    async def start(self) -> None:
        self._stop.clear()
        self._started = True
        self._workers = [w for w in self._workers if not w.done()]
        self._excess = 0
        loop = asyncio.get_running_loop()
        while len(self._workers) < self.concurrency:
            self._workers.append(loop.create_task(self._run()))

    async def stop(self) -> None:
        self._started = False
        self._stop.set()
        for w in self._workers:
            w.cancel()
        await asyncio.gather(*self._workers, return_exceptions=True)
        self._workers = []
        await self._sessions.close()

    def set_concurrency(self, n: int) -> None:
        """Resize the delivery loops live: the autoscaler's actuator.
        Before ``start()`` it records the level, which ``start()`` spawns
        to. Growing spawns loops (cancelling outstanding exit debt first);
        shrinking is graceful: a surplus loop finishes its delivery and
        exits at its next idle point (within the 1 s receive poll), never
        mid-POST, so a step down causes no redelivery. ``stop()`` still
        cancels outright."""
        n = max(0, n)
        if not self._started:
            self.concurrency = n
            self._excess = 0
            return
        loop = asyncio.get_running_loop()
        # Drop loops that already exited, so the live count is what moves.
        self._workers = [w for w in self._workers if not w.done()]
        live = len(self._workers) - self._excess
        if n > live:
            absorbed = min(self._excess, n - live)
            self._excess -= absorbed
            while len(self._workers) - self._excess < n:
                self._workers.append(loop.create_task(self._run()))
        elif n < live:
            self._excess += live - n
        self.concurrency = n

    async def _run(self) -> None:
        while not self._stop.is_set():
            if self._excess > 0:
                # Graceful scale-down: retire this loop at an idle point
                # (one event loop, so the decrement cannot race).
                self._excess -= 1
                return
            msg = await self.broker.receive(self.queue_name, timeout=1.0)
            if msg is None:
                continue
            self._busy += 1
            try:
                await self._dispatch_one(msg)
            except asyncio.CancelledError:
                # Shutdown mid-dispatch: hand the message back now.
                self.broker.abandon(msg)
                raise
            except Exception:  # noqa: BLE001 — a dispatcher must never die
                log.exception("dispatch of task %s crashed; redelivering",
                              msg.task_id)
                if not self.broker.abandon(msg):
                    self._dispatched.inc(outcome="dead_letter",
                                         queue=self.queue_name, backend="")
                    if not await self.task_manager.is_terminal(msg.task_id):
                        await self._try_update(
                            msg.task_id, TaskStatus.DEAD_LETTER,
                            TaskStatus.FAILED)
            finally:
                self._busy -= 1

    def _stamp(self, task_id: str, event: str,
               reason: str | None = None) -> None:
        """Hop-ledger stamp; a no-op without the hub, which is fail-open."""
        if self.observability is not None:
            self.observability.stamp(
                task_id, hop.ledger_event(event, "dispatcher", reason=reason))

    def _target_for(self, msg: Message, exclude=()) -> tuple[str, str]:
        """The delivery's backend, picked from the registered set (a
        journal-restored task may carry a stale host): placed by the
        orchestrator, else a health-aware pick, else a weighted one; and
        the target with the endpoint's operation tail and query grafted
        on. The base is the health model's key for the outcome."""
        if self.orchestration is not None:
            note = None
            if self.observability is not None:
                def note(outcome: str, uri: str, _tid=msg.task_id) -> None:
                    # A probe keeps its own event, reason the probed host;
                    # any other placement is ``placed``, "<outcome> <host>".
                    host = urlparse(uri).netloc or uri
                    self._stamp(_tid,
                                hop.PROBE if outcome == "probe"
                                else hop.PLACED,
                                reason=(host if outcome == "probe"
                                        else f"{outcome} {host}"))
            base = self.orchestration.place(
                self.backends, deadline_at=msg.deadline_at,
                priority=msg.priority, rng=self._rng, exclude=exclude,
                note=note)
        elif self.resilience is not None:
            base = self.resilience.pick(self.backends, self._rng,
                                        exclude=exclude)
        else:
            base = pick_backend(self.backends, self._rng)
        return base, rebase_endpoint(msg.endpoint, self.route_path, base)

    def _record_outcome(self, base: str, status: int | None = None,
                        failed: bool = False) -> None:
        """One delivery outcome into the health model. A breaker that opens
        here backs the queue's limiter off at once: a dead backend is
        stronger evidence than a window of latency samples."""
        if self.resilience is None:
            return
        opened = (self.resilience.record_failure(base) if failed
                  else self.resilience.observe_status(base, status))
        if opened and self.admission is not None:
            self.admission.scope("dispatch:" + self.queue_name).backoff()

    def _can_retry(self, attempt: int) -> bool:
        """Another attempt within this delivery: attempts left and the
        budget allows; past either, broker redelivery takes over."""
        return (self.resilience is not None
                and attempt < self.resilience.policy.max_attempts
                and self._retry_budget.try_retry())

    async def _retry_sleep(self, attempt: int) -> None:
        policy = self.resilience.policy
        await asyncio.sleep(backoff_s(attempt, policy.retry_base_s,
                                      policy.retry_cap_s, self._rng))

    async def _dispatch_one(self, msg: Message) -> None:
        self._stamp(msg.task_id, hop.POPPED,
                    reason=f"delivery {msg.delivery_count}")
        if await self._drop_expired(msg):
            return
        if self.resilience is not None and await self._suppress_duplicate(msg):
            return
        if await self._complete_from_cache(msg):
            return
        if self._retry_budget is not None:
            self._retry_budget.on_request()
        tried: list[str] = []
        attempt = 0
        while True:
            attempt += 1
            base, target = self._target_for(msg, exclude=tried)
            # The backend label splits each outcome by host, so a canary's
            # failures do not vanish into the fleet's counter.
            backend = urlparse(target).netloc
            session = await self._sessions.get()
            t0 = time.perf_counter()
            if self.orchestration is not None:
                # Queue pressure for the estimator, released in the finally
                # on every exit of this attempt.
                self.orchestration.begin(base)
            try:
                # One span per delivery attempt, the child of the
                # publisher's span (the message's B3 headers); its own B3
                # headers parent the backend's endpoint span, so gateway
                # -> dispatch -> execution is one trace.
                with self.tracer.span("dispatch", task_id=msg.task_id,
                                      headers=msg.trace_headers or None,
                                      queue=self.queue_name,
                                      attempt=msg.delivery_count) as span:
                    async with session.post(
                            target, data=msg.body,
                            headers={"taskId": msg.task_id,
                                     "Content-Type": msg.content_type,
                                     **self._admission_headers(msg),
                                     **self.tracer.headers()}) as resp:
                        status = resp.status
                        draining = resp.headers.get("X-Draining")
                        await resp.read()
                    span.attrs["http_status"] = status
                    if not (200 <= status < 300
                            or status in BACKPRESSURE_CODES):
                        span.status = "error"
                        span.error = f"backend returned {status}"
            except (aiohttp.ClientError, asyncio.TimeoutError) as exc:
                self._record_outcome(base, failed=True)
                if (self.resilience is not None
                        and await self._suppress_duplicate(msg)):
                    # The response was lost after the backend finished
                    # the task: a retry would run it again.
                    return
                if self._can_retry(attempt):
                    # Failover: the next pick excludes this backend (one
                    # backend retries in place after the backoff).
                    tried.append(base)
                    self.resilience.note_failover("dispatcher")
                    self._stamp(msg.task_id, hop.FAILOVER,
                                reason=f"connect_error {backend}")
                    await self._retry_sleep(attempt)
                    continue
                # Unreachable backend: the pod may be restarting; the
                # broker's patience bounds the retries.
                log.warning("backend %s unreachable (%s); will redeliver",
                            target, exc)
                await self._backpressure(msg, backend=backend)
                return
            finally:
                if self.orchestration is not None:
                    self.orchestration.end(base)
            if draining and self.resilience is not None:
                # The worker is leaving (a drain, not saturation): eject it
                # for the TTL so the redelivery lands on a peer. The 503
                # itself is neutral for its breaker.
                self.resilience.mark_draining(base)
            self._record_outcome(base, status=status)
            if 200 <= status < 300:
                self.broker.complete(msg)
                self._stamp(msg.task_id, hop.DELIVERED, reason=backend)
                self._dispatched.inc(outcome="delivered",
                                     queue=self.queue_name, backend=backend)
                if self.orchestration is not None:
                    # The delivered round trip is the estimator's
                    # service-time evidence.
                    self.orchestration.observe(base,
                                               time.perf_counter() - t0)
                    if self.tenancy is not None:
                        # On the backend it ran on: a failover bills the
                        # final host.
                        self.tenancy.charge(msg.tenant,
                                            self.orchestration.cost_of(base))
                if self.admission is not None:
                    # The delivered round trip feeds this queue's limiter:
                    # when the worker congests these stretch, and the
                    # fan-out narrows before the worker has to refuse.
                    self.admission.scope(
                        "dispatch:" + self.queue_name).observe(
                        time.perf_counter() - t0, inflight=self._busy)
                return
            if status in BACKPRESSURE_CODES:
                if self.admission is not None:
                    # Explicit saturation outranks latency: shrink now.
                    self.admission.scope(
                        "dispatch:" + self.queue_name).backoff()
                await self._backpressure(msg, backend=backend)
                return
            if self.resilience is not None and status >= 500:
                # A transient server error under resilience: retry, on
                # another backend when there is one, then redeliver. A 4xx
                # stays permanent: the backend is healthy, the request not.
                if self._can_retry(attempt):
                    tried.append(base)
                    self.resilience.note_retry("dispatcher")
                    self._stamp(msg.task_id, hop.RETRY,
                                reason=f"HTTP {status} {backend}")
                    await self._retry_sleep(attempt)
                    continue
                await self._backpressure(msg, backend=backend)
                return
            # Permanent failure: complete the message and fail the task,
            # unless a concurrent delivery finished it while this one was
            # in flight.
            self.broker.complete(msg)
            if await self.task_manager.is_terminal(msg.task_id):
                self._dispatched.inc(outcome="duplicate",
                                     queue=self.queue_name, backend=backend)
                return
            self._dispatched.inc(outcome="failed", queue=self.queue_name,
                                 backend=backend)
            await self._try_update(msg.task_id,
                                   f"failed - backend returned {status}",
                                   TaskStatus.FAILED)
            return

    def _admission_headers(self, msg: Message) -> dict:
        """The deadline and class onto the backend POST, for the worker's
        own expiry check and priority-classed batching. The absolute
        deadline, so time in the queue never re-extends the budget. With
        admission off and nothing stamped, none."""
        if (self.admission is None and not msg.deadline_at
                and msg.priority == 1):
            return {}
        return propagation_headers(msg.deadline_at, msg.priority)

    async def _drop_expired(self, msg: Message) -> bool:
        """Pop-time deadline check: work whose budget ran out while it
        queued is completed off the broker and its task turns terminal
        ``expired``; it never reaches the backend. True when dropped."""
        if not msg.deadline_at or time.time() < msg.deadline_at:
            return False
        self.broker.complete(msg)
        # Terminal probe before any accounting: a lease-expiry redelivery
        # of a task that already completed is a duplicate, not an expiry.
        if await self.task_manager.is_terminal(msg.task_id):
            self._dispatched.inc(outcome="duplicate", queue=self.queue_name,
                                 backend="")
            return True
        self._stamp(msg.task_id, hop.EXPIRED, reason="pop-time deadline")
        self._dispatched.inc(outcome="expired", queue=self.queue_name,
                             backend="")
        if self.admission is not None:
            self.admission.note_expired("dispatcher", msg.priority)
        await self._try_update(msg.task_id, expired_status("dispatcher"),
                               TaskStatus.EXPIRED)
        return True

    async def _complete_from_cache(self, msg: Message) -> bool:
        """Serve the task from the result cache instead of dispatching, when
        its identical request already completed: the redeliveries and
        requeues the gateway's own lookup cannot see. A bypassed request
        carries no key and always dispatches. True when served (or found a
        duplicate of a finished task)."""
        key = msg.cache_key
        if self.result_cache is None or not key:
            return False
        # count=False: the gateway counted this request's outcome; this
        # path counts as dispatch_total{outcome="cache_hit"}.
        found = self.result_cache.get(key, count=False)
        if found is None:
            return False
        # task_manager is None only in tests of the result path.
        if (self.task_manager is not None
                and await self.task_manager.is_terminal(msg.task_id)):
            # A redelivery of a finished task must not write a second
            # completion over the first.
            self.broker.complete(msg)
            self._dispatched.inc(outcome="duplicate", queue=self.queue_name,
                                 backend="")
            return True
        if self.result_store is None:
            # Nowhere to put the payload: a terminal task whose result
            # fetch returns nothing would be a lost output. Dispatch.
            return False
        payload, ctype = found
        try:
            res = self.result_store.set_result(msg.task_id, payload,
                                               content_type=ctype)
            if inspect.isawaitable(res):
                await res
        except Exception:  # noqa: BLE001 — a lost result is a failed serve
            log.exception("could not store cached result for task %s; "
                          "dispatching instead", msg.task_id)
            return False
        self.broker.complete(msg)
        if (self.task_manager is not None
                and await self.task_manager.is_terminal(msg.task_id)):
            # Re-check after the result write's suspension: another path
            # may have finished the task meanwhile; the status write is not
            # idempotent.
            self._dispatched.inc(outcome="duplicate", queue=self.queue_name,
                                 backend="")
            return True
        self._dispatched.inc(outcome="cache_hit", queue=self.queue_name,
                             backend="")
        await self._try_update(msg.task_id, "completed - served from cache",
                               TaskStatus.COMPLETED)
        return True

    async def _suppress_duplicate(self, msg: Message) -> bool:
        """Under resilience: a message whose task is already terminal (a
        lease-expiry redelivery racing a completion, a lost response after
        the backend finished) is completed off the broker without a POST,
        so the backend does not run it again and the client never sees a
        second completion. On a sharded store the terminal probe reads the
        owning shard and rides out a slot move as every store read does."""
        if await self.task_manager.is_terminal(msg.task_id):
            self.broker.complete(msg)
            self._stamp(msg.task_id, hop.DUPLICATE,
                        reason="redelivery of a terminal task")
            self._dispatched.inc(outcome="duplicate", queue=self.queue_name,
                                 backend="")
            return True
        return False

    def _redelivery_delay(self, msg: Message) -> float:
        """Jittered exponential backoff from the message's delivery count
        (base ``retry_delay``), capped at half the lease so a retry never
        outlives its own lease."""
        lease = float(getattr(self.broker, "lease_seconds", 300.0) or 300.0)
        return backoff_s(msg.delivery_count, self.retry_delay, lease / 2.0,
                         self._rng)

    async def _backpressure(self, msg: Message, backend: str) -> None:
        if self.resilience is not None and await self._suppress_duplicate(msg):
            # The task turned terminal between the POST and this decision
            # (the backend finished, then the response failed): the
            # awaiting write below would reopen it.
            return
        self._stamp(msg.task_id, hop.BACKPRESSURE, reason=backend)
        self._dispatched.inc(outcome="backpressure", queue=self.queue_name,
                             backend=backend)
        await self._try_update(msg.task_id, AWAITING_STATUS,
                               TaskStatus.CREATED)
        await asyncio.sleep(self._redelivery_delay(msg))
        if not self.broker.abandon(msg):
            # Out of delivery budget. Re-check after the sleep: the backend
            # may have completed the task meanwhile.
            if await self.task_manager.is_terminal(msg.task_id):
                self._dispatched.inc(outcome="duplicate",
                                     queue=self.queue_name, backend=backend)
                return
            self._stamp(msg.task_id, hop.DEAD_LETTER,
                        reason=f"after {msg.delivery_count} deliveries")
            self._dispatched.inc(outcome="dead_letter", queue=self.queue_name,
                                 backend=backend)
            await self._try_update(msg.task_id, TaskStatus.DEAD_LETTER,
                                   TaskStatus.FAILED)

    async def _try_update(self, task_id: str, status: str, backend: str) -> None:
        try:
            await self.task_manager.update_task_status(task_id, status,
                                                       backend_status=backend)
        except Exception:  # noqa: BLE001 — logged; the delivery goes on
            log.exception("could not update task %s to %r", task_id, status)


class DispatcherPool:
    """One dispatcher per registered endpoint queue."""

    def __init__(self, broker: InMemoryBroker, task_manager: TaskManagerBase,
                 retry_delay: float = 60.0, concurrency: int = 1,
                 observability=None, admission=None,
                 metrics: MetricsRegistry | None = None,
                 result_cache=None, result_store=None, resilience=None,
                 orchestration=None, tenancy=None):
        self.broker = broker
        self.task_manager = task_manager
        self.retry_delay = retry_delay
        self.concurrency = concurrency
        self.observability = observability
        self.metrics = metrics
        self.admission = admission
        self.result_cache = result_cache
        self.result_store = result_store
        self.resilience = resilience
        self.orchestration = orchestration
        self.tenancy = tenancy
        self.dispatchers: dict[str, Dispatcher] = {}

    def register(self, queue_name: str, backend_uri,
                 retry_delay: float | None = None,
                 concurrency: int | None = None) -> Dispatcher:
        d = Dispatcher(
            self.broker, queue_name, backend_uri, self.task_manager,
            retry_delay=self.retry_delay if retry_delay is None else retry_delay,
            concurrency=self.concurrency if concurrency is None else concurrency,
            observability=self.observability, admission=self.admission,
            metrics=self.metrics, result_cache=self.result_cache,
            result_store=self.result_store, resilience=self.resilience,
            orchestration=self.orchestration, tenancy=self.tenancy)
        self.dispatchers[queue_name] = d
        return d

    async def start(self) -> None:
        for d in self.dispatchers.values():
            await d.start()

    async def stop(self) -> None:
        await asyncio.gather(*(d.stop() for d in self.dispatchers.values()))
