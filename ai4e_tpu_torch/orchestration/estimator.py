"""Per-backend completion estimator; a copy of
``ai4e_tpu/orchestration/estimator.py``.

The question every placement asks: **what is the probability that this
backend finishes this request within its remaining deadline budget?** It
is answered from signals the platform already produces:

- **RTT samples** — the delivered round trips the dispatcher (and the
  sync proxy) measure, one decayed sketch a backend
  (``DecayedQuantiles``): the newest ``window`` samples, any older than
  ``horizon_s`` ignored;
- **breaker state** — an open backend completes nothing (p = 0); a
  half-open one is discounted;
- **queue pressure** — deliveries in flight against the backend stretch
  the expected completion by ``p50 x inflight / parallelism``.

The estimate is the empirical fraction of recent RTTs at or under the
effective budget; a backend with no recent samples answers ``cold_p``.
"""

from __future__ import annotations

import time
from collections import deque
from urllib.parse import urlparse

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry


def backend_label(uri: str) -> str:
    """Metrics label for a backend URI — the host, matching the
    ``backend`` dimension the dispatch and resilience families export."""
    return urlparse(uri).netloc or uri


class DecayedQuantiles:
    """Bounded, time-decayed RTT sample sketch.

    Holds the newest ``size`` ``(t, value)`` samples; queries ignore
    samples older than ``horizon_s``. O(size·log size) per query at the
    default size (256) is microseconds — far cheaper than maintaining a
    streaming quantile structure, and exact, which keeps the placement
    tests deterministic."""

    def __init__(self, size: int = 256, horizon_s: float = 60.0,
                 clock=time.monotonic):
        self.horizon_s = horizon_s
        self._clock = clock
        self._samples: deque[tuple[float, float]] = deque(maxlen=max(1, size))

    def observe(self, value: float, now: float | None = None) -> None:
        if value < 0:
            return
        now = self._clock() if now is None else now
        self._samples.append((now, value))

    def _live(self, now: float) -> list[float]:
        horizon = now - self.horizon_s
        return [v for t, v in self._samples if t >= horizon]

    def count(self, now: float | None = None) -> int:
        return len(self._live(self._clock() if now is None else now))

    def quantile(self, q: float, now: float | None = None) -> float | None:
        """The q-quantile of the live window, None when empty."""
        live = sorted(self._live(self._clock() if now is None else now))
        if not live:
            return None
        idx = min(len(live) - 1, max(0, int(q * len(live))))
        return live[idx]

    def p_le(self, threshold: float, now: float | None = None
             ) -> float | None:
        """Empirical P(sample <= threshold) over the live window, None
        when the window is empty (the caller decides the cold prior)."""
        live = self._live(self._clock() if now is None else now)
        if not live:
            return None
        return sum(1 for v in live if v <= threshold) / len(live)


class CompletionEstimator:
    """One quantile sketch per backend, crossed with the shared breaker
    state (``resilience.BackendHealth``) and the in-flight count the
    dispatcher reports around each delivery."""

    #: Half-open probation: the backend is being probed back to life —
    #: its history predates the outage, so trust it half as much.
    HALF_OPEN_DISCOUNT = 0.5

    def __init__(self, health, window: int = 256, horizon_s: float = 60.0,
                 cold_p: float = 1.0, parallelism: int = 8,
                 metrics: MetricsRegistry | None = None,
                 clock=time.monotonic):
        self.health = health
        self.window = window
        self.horizon_s = horizon_s
        self.cold_p = cold_p
        self.parallelism = max(1, parallelism)
        self.metrics = metrics or DEFAULT_REGISTRY
        self._clock = clock
        self._sketches: dict[str, DecayedQuantiles] = {}
        self._inflight: dict[str, int] = {}
        self._p50_gauge = self.metrics.gauge(
            "ai4e_orchestration_backend_p50_seconds",
            "Decayed median delivered-RTT per backend (the estimator's "
            "service-time anchor)")

    def _sketch(self, uri: str) -> DecayedQuantiles:
        sk = self._sketches.get(uri)
        if sk is None:
            sk = self._sketches[uri] = DecayedQuantiles(
                size=self.window, horizon_s=self.horizon_s,
                clock=self._clock)
        return sk

    # -- signal feeds -------------------------------------------------------

    def observe(self, uri: str, rtt_s: float, now: float | None = None
                ) -> None:
        """One *delivered* (2xx) round trip. Failures and backpressure
        answers never feed the sketch — an instantly-refusing backend
        must not look like the fastest tier."""
        sk = self._sketch(uri)
        sk.observe(rtt_s, now)
        p50 = sk.quantile(0.5, now)
        if p50 is not None:
            self._p50_gauge.set(p50, backend=backend_label(uri))

    def begin(self, uri: str) -> None:
        """A delivery against ``uri`` started (queue-pressure input)."""
        self._inflight[uri] = self._inflight.get(uri, 0) + 1

    def end(self, uri: str) -> None:
        self._inflight[uri] = max(0, self._inflight.get(uri, 0) - 1)

    def inflight(self, uri: str) -> int:
        return self._inflight.get(uri, 0)

    # -- the estimate -------------------------------------------------------

    def p_within(self, uri: str, budget_s: float,
                 now: float | None = None) -> float:
        """P(this backend completes a request placed now within
        ``budget_s``). Infinite budget → 1.0 for any non-open backend.

        The breaker crossing here (open → 0, half-open discounted) is a
        BACKSTOP for direct estimator consumers: ``Orchestrator.place``
        routes available-but-non-closed candidates through its probe
        step before this walk and excludes unavailable ones entirely, so
        on the placement path every backend evaluated here has a closed
        breaker — tune placement's treatment of recovering backends in
        ``place``, not via ``HALF_OPEN_DISCOUNT``."""
        now = self._clock() if now is None else now
        state = self.health.state(uri)
        if state == "open":
            return 0.0
        if budget_s == float("inf"):
            return 1.0
        sk = self._sketch(uri)
        p50 = sk.quantile(0.5, now)
        if p50 is None:
            p = self.cold_p
        else:
            # Queue-pressure discount: in-flight deliveries ahead of this
            # one consume budget before its own service time starts. The
            # backend serves ``parallelism`` of them concurrently (the
            # micro-batcher behind a worker makes true per-request
            # serialization rare), so the wait estimate is p50-per-wave.
            wait = (self._inflight.get(uri, 0) / self.parallelism) * p50
            p = sk.p_le(budget_s - wait, now)
            if p is None:
                p = self.cold_p
        if state == "half_open":
            p *= self.HALF_OPEN_DISCOUNT
        return p
