"""The shared per-backend health model; a copy of
``ai4e_tpu/resilience/health.py``.

One ``BackendHealth`` a control plane, shared by the gateway's sync proxy
and every dispatcher, so a backend melting under queue deliveries is
ejected from sync picks too, and the other way round.

Routing (``pick``):

- every backend whose breaker admits traffic keeps its configured weight;
- an open backend is **ejected**: its weight goes to the remaining healthy
  set (a weighted pick over the survivors);
- a half-open backend competes at its weight, but its breaker bounds the
  probes in flight;
- **all open**: the least-recently-failed backend takes a forced probe, so
  a dark set probes its way back to life;
- a backend that answered 503 with ``X-Draining`` is ejected for
  ``drain_eject_ttl_s`` while any peer remains: a drain is orderly, so it
  is never a breaker event;
- with a ``CanaryWeights`` attached, the pool is rescaled so the canary
  generation holds its share.

Metrics: ``ai4e_resilience_*`` (breaker state by backend, transitions,
ejections, retries, failovers, probe outcomes) and
``ai4e_rollout_drain_ejections_total``, named and labelled as JAX's.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from urllib.parse import urlparse

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from ..utils.backends import Weighted, pick_backend
from .breaker import STATE_CODES, CircuitBreaker
from .retry import RetryBudget


@dataclass
class ResiliencePolicy:
    """The assembly-level knob set (``PlatformConfig`` mirrors these —
    ``resilience_*`` fields / ``AI4E_PLATFORM_*`` env vars)."""

    failure_threshold: int = 5       # consecutive failures that trip a breaker
    window: int = 16                 # rolling outcome window (error-rate trip)
    error_rate: float = 0.5          # window failure fraction that trips
    recovery_seconds: float = 30.0   # open → half-open cooldown
    half_open_probes: int = 1        # concurrent probes while half-open
    max_attempts: int = 3            # delivery attempts per POST (1 + retries)
    retry_base_s: float = 0.05       # first in-attempt retry delay (jittered)
    retry_cap_s: float = 1.0         # in-attempt retry delay ceiling
    retry_budget_ratio: float = 0.2  # retries per ordinary request, steady state
    drain_eject_ttl_s: float = 30.0  # placement eject per X-Draining mark (rollout/)


class BackendHealth:
    """Breaker registry + health-aware weighted pick (module docstring)."""

    def __init__(self, policy: ResiliencePolicy | None = None,
                 metrics: MetricsRegistry | None = None,
                 clock=time.monotonic, rng: random.Random | None = None):
        self.policy = policy or ResiliencePolicy()
        self.metrics = metrics or DEFAULT_REGISTRY
        self._clock = clock
        self._rng = rng
        self._breakers: dict[str, CircuitBreaker] = {}
        self._state_gauge = self.metrics.gauge(
            "ai4e_resilience_breaker_state",
            "Breaker state per backend: 0 closed, 1 half-open, 2 open")
        self._transitions = self.metrics.counter(
            "ai4e_resilience_transitions_total",
            "Breaker state transitions by backend and new state")
        self._ejections = self.metrics.counter(
            "ai4e_resilience_ejections_total",
            "Weighted picks that routed around an open backend")
        self._retries = self.metrics.counter(
            "ai4e_resilience_retries_total",
            "In-attempt retries by component")
        self._failovers = self.metrics.counter(
            "ai4e_resilience_failovers_total",
            "Retries that switched to a different backend, by component")
        self._probes = self.metrics.counter(
            "ai4e_resilience_probe_total",
            "Half-open/forced probe outcomes by backend")
        # Drain ejections (rollout/, docs/deployment.md#drain): a backend
        # that answered 503 + X-Draining told us it is LEAVING — eject it
        # from placement for a TTL. Deliberately NOT a breaker state:
        # draining is orderly, a breaker trip would smear a planned
        # upgrade as a failure in every dashboard keyed on breaker
        # transitions. uri -> monotonic deadline.
        self._draining: dict[str, float] = {}
        self._drain_ejections = self.metrics.counter(
            "ai4e_rollout_drain_ejections_total",
            "Weighted picks that routed around a draining backend")
        # Canary split policy (rollout/canary.py CanaryWeights), attached
        # by the assembly when a rollout is live; None = no reweighting.
        self._canary = None

    # -- registry -----------------------------------------------------------

    @staticmethod
    def _label(uri: str) -> str:
        """Metrics label for a backend URI — the host, matching the
        ``backend`` dimension ``ai4e_dispatch_total`` already exports."""
        return urlparse(uri).netloc or uri

    def breaker_for(self, uri: str) -> CircuitBreaker:
        br = self._breakers.get(uri)
        if br is None:
            p = self.policy
            br = self._breakers[uri] = CircuitBreaker(
                failure_threshold=p.failure_threshold, window=p.window,
                error_rate=p.error_rate,
                recovery_seconds=p.recovery_seconds,
                half_open_probes=p.half_open_probes, clock=self._clock)
            self._state_gauge.set(0, backend=self._label(uri))
        return br

    def state(self, uri: str) -> str:
        return self.breaker_for(uri).state

    def new_budget(self) -> RetryBudget:
        """A retry budget at this policy's ratio — one per retrying
        component (each dispatcher queue, the sync proxy)."""
        return RetryBudget(ratio=self.policy.retry_budget_ratio)

    # -- drain eject (rollout/) ---------------------------------------------

    def mark_draining(self, uri: str, ttl_s: float | None = None) -> None:
        """Eject ``uri`` from placement for ``ttl_s`` (default: the
        policy's ``drain_eject_ttl_s`` — AI4E_ROLLOUT_DRAIN_EJECT_TTL_S)
        — called when a response carried ``X-Draining`` (the worker's
        drain refusal) or by the rollout controller before it drains a
        worker. TTL-bounded so a worker that comes back (rollback
        resume, restart at the new generation) re-enters placement
        without an explicit clear."""
        if ttl_s is None:
            ttl_s = self.policy.drain_eject_ttl_s
        self._draining[uri] = self._clock() + max(0.0, ttl_s)

    def clear_draining(self, uri: str) -> None:
        self._draining.pop(uri, None)

    def reset(self, uri: str) -> None:
        """Forget a backend's breaker history and drain mark — the
        rollout controller's post-restart hook: a deliberately replaced
        process re-enters placement with a clean slate instead of
        inheriting the connect failures its own restart window minted
        (which would read as an open canary breaker and roll back a
        healthy upgrade)."""
        self._draining.pop(uri, None)
        if self._breakers.pop(uri, None) is not None:
            self._state_gauge.set(0, backend=self._label(uri))

    def is_draining(self, uri: str) -> bool:
        deadline = self._draining.get(uri)
        if deadline is None:
            return False
        if self._clock() >= deadline:
            del self._draining[uri]
            return False
        return True

    # -- canary split (rollout/) --------------------------------------------

    def attach_canary(self, canary) -> None:
        """Attach a ``CanaryWeights`` policy: both placement surfaces
        (``pick`` here, the orchestrator's in-tier choice) then split
        in-tier traffic between generations."""
        self._canary = canary

    @property
    def canary(self):
        return self._canary

    # -- routing ------------------------------------------------------------

    def pick(self, backends: Weighted, rng: random.Random | None = None,
             exclude=()) -> str:
        """Health-aware weighted pick. ``exclude``: backends already tried
        in THIS delivery attempt chain (failover must reach a *different*
        backend when one exists); ignored when it would empty the set."""
        now = self._clock()
        pool = [(u, w) for u, w in backends if u not in exclude and w > 0]
        if not pool:
            pool = [(u, w) for u, w in backends if w > 0]
        # Drain eject (rollout/): a draining backend told us it is
        # leaving — route around it while anyone else remains. When the
        # WHOLE pool is draining (single-replica shard mid-upgrade) keep
        # the pool: a drain refusal redelivers, a no-backend error loses.
        undrained = [(u, w) for u, w in pool if not self.is_draining(u)]
        if undrained and len(undrained) < len(pool):
            for uri, _ in pool:
                if self.is_draining(uri):
                    self._drain_ejections.inc(backend=self._label(uri))
            pool = undrained
        # Canary split (rollout/canary.py): rescale so the canary
        # generation holds its configured share of the pool's weight.
        if self._canary is not None:
            pool = self._canary.apply(pool)
        candidates = []
        ejected = []
        for uri, weight in pool:
            if self.breaker_for(uri).available(now):
                candidates.append((uri, weight))
            else:
                ejected.append(uri)
        if candidates and all(w <= 0 for _, w in candidates):
            # The canary rescale can zero a subset (share 0 or 1); when
            # breaker ejections leave ONLY that subset available, serve
            # it evenly rather than crash the pick — a zero-weight
            # survivor beats no backend at all.
            candidates = [(u, 1.0) for u, _ in candidates]
        if candidates:
            # Ejections counted only when somebody healthy absorbed the
            # traffic — an all-dark set's forced probe below routes INTO
            # the open backend, which is not an ejection.
            for uri in ejected:
                self._ejections.inc(backend=self._label(uri))
            chosen = pick_backend(candidates, rng or self._rng)
        else:
            # Fully dark: forced probe of the least-recently-failed
            # backend — the one most likely to have had time to recover.
            chosen = min((u for u, _ in pool),
                         key=lambda u: self.breaker_for(u).last_failure_at)
        self.commit_pick(chosen, now)
        return chosen

    def commit_pick(self, uri: str, now: float | None = None) -> None:
        """Account a routing decision made on this health model's state —
        by ``pick`` above or by an out-of-band placement policy (the
        orchestration scheduler): a non-closed breaker books the probe
        slot, so recovery traffic is bounded identically no matter who
        chose the backend."""
        br = self.breaker_for(uri)
        if br.state != "closed":
            br.begin_probe(self._clock() if now is None else now)
            self._set_state(uri, br)

    # -- outcome recording --------------------------------------------------

    def record_success(self, uri: str) -> None:
        br = self.breaker_for(uri)
        probing = br.state != "closed"
        br.record_success()
        if probing and br.state == "closed":
            # Actually recovered (half-open probe). A stale success
            # against a still-OPEN breaker is ignored by the state machine
            # and must not count a probe/transition either.
            self._probes.inc(backend=self._label(uri), outcome="success")
            self._transitions.inc(backend=self._label(uri), state="closed")
        self._set_state(uri, br)

    def record_failure(self, uri: str) -> bool:
        """Record a failure; True when the breaker opened on this call."""
        br = self.breaker_for(uri)
        probing = br.state != "closed"
        opened = br.record_failure(self._clock())
        if probing:
            self._probes.inc(backend=self._label(uri), outcome="failure")
        if opened:
            self._transitions.inc(backend=self._label(uri), state="open")
        self._set_state(uri, br)
        return opened

    def observe_status(self, uri: str, status: int) -> bool:
        """Classify an HTTP response for the breaker: 5xx (other than 503
        backpressure) is a failure, 429/503 is a *saturation* signal — the
        backend answered, it is alive, and ejecting it would shift load
        onto peers that are probably saturating too (admission control
        owns that signal) — and everything else is a success. Returns
        True when the breaker opened."""
        if status in (429, 503):
            # Neutral for open/close decisions, but it RESOLVES a probe:
            # without the release, one 503'd half-open probe would pin the
            # probe slot and eject the backend permanently.
            self.breaker_for(uri).record_neutral()
            return False
        if status >= 500:
            return self.record_failure(uri)
        self.record_success(uri)
        return False

    def note_retry(self, component: str) -> None:
        self._retries.inc(component=component)

    def note_failover(self, component: str) -> None:
        self._failovers.inc(component=component)

    def _set_state(self, uri: str, br: CircuitBreaker) -> None:
        self._state_gauge.set(STATE_CODES[br.state],
                              backend=self._label(uri))
