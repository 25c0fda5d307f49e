"""Per-backend circuit breaker; a copy of ``ai4e_tpu/resilience/breaker.py``.

Every backend URI a dispatcher or the gateway's sync proxy can target
carries one breaker:

- **closed** — healthy; failures are counted (a consecutive run and a
  rolling outcome window) but traffic flows;
- **open** — tripped on ``failure_threshold`` consecutive failures or a
  window error rate at or above ``error_rate``; the backend is ejected
  from weighted picks (``health.BackendHealth.pick``) until
  ``recovery_seconds`` elapse;
- **half-open** — the cooldown elapsed; a bounded number of probes may
  flow. One success closes the breaker; one failure opens it again, the
  cooldown counted from that failure.

The clock is injectable, so tests drive the transitions without sleeps.
"""

from __future__ import annotations

import time
from collections import deque

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# Gauge encoding for ai4e_resilience_breaker_state (docs/METRICS.md).
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Single backend's failure state machine. Event-loop-only (no lock):
    every caller — dispatcher delivery loops, the gateway sync proxy —
    records outcomes from the platform's event loop."""

    def __init__(self, failure_threshold: int = 5, window: int = 16,
                 error_rate: float = 0.5, recovery_seconds: float = 30.0,
                 half_open_probes: int = 1, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if not (0.0 < error_rate <= 1.0):
            raise ValueError("error_rate must be in (0, 1]")
        self.failure_threshold = failure_threshold
        self.error_rate = error_rate
        self.recovery_seconds = recovery_seconds
        self.half_open_probes = max(1, half_open_probes)
        self._clock = clock
        self.state = CLOSED
        self._consecutive = 0
        # Rolling outcome window (True = success): catches the flapping
        # backend the consecutive counter misses — one that interleaves
        # enough successes to keep resetting the run but still fails half
        # its traffic.
        self._window: deque[bool] = deque(maxlen=max(1, window))
        self._opened_at = 0.0
        self._probes_inflight = 0
        self._probe_started_at = 0.0
        self.last_failure_at = 0.0
        # Monotone counters for observers (health.py mirrors them into the
        # metrics registry with the backend label).
        self.opened_count = 0

    # -- routing queries ----------------------------------------------------

    def available(self, now: float | None = None) -> bool:
        """May this backend receive ordinary (non-forced) traffic now?
        Pure query — no state change, so a weighted pick can test every
        candidate before choosing one."""
        if self.state == CLOSED:
            return True
        now = self._clock() if now is None else now
        if self.state == OPEN:
            return (now - self._opened_at >= self.recovery_seconds
                    and self._probes_inflight < self.half_open_probes)
        # Half-open: a free probe slot — OR a leaked one. A probe whose
        # delivery was cancelled/crashed before any outcome was recorded
        # (dispatcher stop mid-POST, client disconnect cancelling the sync
        # handler) never releases its slot; without this time-based escape
        # the backend would stay ejected forever. One cooldown of silence
        # after the last probe began re-opens the slot.
        return (self._probes_inflight < self.half_open_probes
                or now - self._probe_started_at >= self.recovery_seconds)

    def begin_probe(self, now: float | None = None) -> None:
        """The pick landed on this backend while it was open/half-open:
        transition open → half-open (cooldown elapsed, or a forced
        last-resort probe on a fully-dark set) and account the in-flight
        probe so a second pick doesn't stampede the recovering backend."""
        if self.state == CLOSED:
            return
        if self.state == OPEN:
            self.state = HALF_OPEN
            self._probes_inflight = 0
        self._probes_inflight += 1
        self._probe_started_at = (self._clock() if now is None else now)

    # -- outcome recording --------------------------------------------------

    def record_success(self) -> None:
        if self.state == CLOSED:
            self._consecutive = 0
            self._window.append(True)
            return
        if self.state == HALF_OPEN and self._probes_inflight > 0:
            # Probe succeeded (forced all-dark probes also travel through
            # begin_probe, so they land here too): the backend answered —
            # close.
            self._reset()
            return
        # OPEN — or half-open with NO probe in flight: a stale success
        # from a request dispatched BEFORE the trip (concurrent delivery
        # loops). Weak evidence — closing on it would let one straggler
        # 200 cancel the cooldown every time a flapping backend trips,
        # defeating ejection entirely. Ignore; recovery goes through an
        # actual probe's outcome.

    def record_neutral(self) -> None:
        """A backpressure answer (429/503): the backend is alive but
        saturated — neither success nor failure for the breaker, but a
        probe that drew it is RESOLVED (the slot must free, or a single
        503'd probe would eject the backend forever)."""
        if self.state == HALF_OPEN:
            self._probes_inflight = max(0, self._probes_inflight - 1)

    def record_failure(self, now: float | None = None) -> bool:
        """Record one failure. Returns True when THIS call tripped the
        breaker open (callers propagate the event — e.g. the dispatcher
        feeds it to the admission limiter's backoff)."""
        now = self._clock() if now is None else now
        self.last_failure_at = now
        if self.state == CLOSED:
            self._consecutive += 1
            self._window.append(False)
            window_full = len(self._window) == self._window.maxlen
            failures = sum(1 for ok in self._window if not ok)
            if (self._consecutive >= self.failure_threshold
                    or (window_full
                        and failures / len(self._window) >= self.error_rate)):
                self._trip(now)
                return True
            return False
        if self.state == HALF_OPEN:
            # Probe failed: back to open, cooldown restarts from NOW.
            self._trip(now)
            return True
        # Already open: a stale failure from a request dispatched before
        # the trip (staggered timeouts on concurrent loops can dribble in
        # for the whole request_timeout). Statistics only — refreshing the
        # cooldown anchor here would extend ejection far past
        # recovery_seconds on exactly the backends that hang rather than
        # refuse. (Forced probes travel through begin_probe → half-open,
        # so they never land in this branch.)
        return False

    # -- internals ----------------------------------------------------------

    def _trip(self, now: float) -> None:
        self.state = OPEN
        self._opened_at = now
        self._probes_inflight = 0
        self._consecutive = 0
        self._window.clear()
        self.opened_count += 1

    def _reset(self) -> None:
        self.state = CLOSED
        self._consecutive = 0
        self._window.clear()
        self._probes_inflight = 0
