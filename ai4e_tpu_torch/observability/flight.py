"""Tail-sampled flight recorder — the last N interesting request
timelines; a copy of ``ai4e_tpu/observability/flight.py``.

A bounded ring of recent request timelines that keeps every interesting
one (slow, failed, expired, shed, refused, redelivered) and a small
deterministic sample of the rest, so a healthy baseline is always there
for comparison. The gateway serves it at ``GET /v1/debug/flight``.

Tail sampling, not head sampling: the keep/drop decision happens at the
END of the request, when the outcome is known.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry

# Entry reasons, in evaluation order: the first matching reason is the
# one recorded (a failed request that was also slow records "failed").
REASON_FAILED = "failed"
REASON_EXPIRED = "expired"
REASON_SHED = "shed"
REASON_FAILOVER = "failover"
REASON_BACKPRESSURE = "backpressure"
REASON_SLOW = "slow"
REASON_SAMPLED = "sampled"

# Ledger events that make a request interesting, each under its OWN
# reason — an operator filtering reason="failover" must not receive
# saturation (backpressure) noise.
_EVENT_REASONS = {
    "shed": REASON_SHED,
    "expired": REASON_EXPIRED,
    "retry": REASON_FAILOVER,
    "failover": REASON_FAILOVER,
    "backpressure": REASON_BACKPRESSURE,
    "dead_letter": REASON_FAILED,
}


class FlightRecorder:
    """Bounded ring of request timelines with tail-sampling.

    ``capacity``: ring size (oldest entries fall off).
    ``sample``: fraction of UNINTERESTING requests kept (deterministic
    counter stride, not RNG — a seeded chaos run replays identically).
    ``slow_ms``: end-to-end latency at or above which a request is
    interesting regardless of outcome.
    """

    def __init__(self, capacity: int = 512, sample: float = 0.05,
                 slow_ms: float = 1000.0,
                 metrics: MetricsRegistry | None = None):
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.sample = min(1.0, max(0.0, sample))
        self.slow_ms = slow_ms
        self.metrics = metrics or DEFAULT_REGISTRY
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seen = 0
        self._boring_seen = 0
        self._kept_boring = 0
        self._recorded = self.metrics.counter(
            "ai4e_flight_recorded_total",
            "Flight-recorder entries kept, by reason")
        self._entries_gauge = self.metrics.gauge(
            "ai4e_flight_entries", "Flight-recorder ring occupancy")

    # -- classification ------------------------------------------------------

    def classify(self, status: str | None, duration_ms: float | None,
                 events: list[dict] | None,
                 refusal: str | None = None) -> str | None:
        """The keep-reason for this request, or None to (maybe-)sample.
        ``refusal`` marks requests that never became tasks (gateway
        sheds/expiries) — always interesting."""
        if refusal is not None:
            return REASON_EXPIRED if refusal == "expired" else REASON_SHED
        s = (status or "").lower()
        if "failed" in s:
            return REASON_FAILED
        if "expired" in s:
            return REASON_EXPIRED
        if s.startswith("shed"):
            # The sync proxy's 429 outcome ("shed - HTTP 429"); prefix
            # match, not substring — "finished" contains "shed".
            return REASON_SHED
        for ev in events or ():
            reason = _EVENT_REASONS.get(ev.get("e"))
            if reason is not None:
                return reason
        if duration_ms is not None and duration_ms >= self.slow_ms:
            return REASON_SLOW
        return None

    # -- recording -----------------------------------------------------------

    def record(self, task_id: str | None, route: str,
               status: str | None = None,
               duration_ms: float | None = None,
               events: list[dict] | None = None,
               trace_id: str | None = None,
               refusal: str | None = None,
               priority: int | None = None) -> bool:
        """Offer one finished request to the ring; returns True if kept.
        Interesting requests always keep; the rest keep at the sample
        stride (every ``1/sample``-th boring request)."""
        reason = self.classify(status, duration_ms, events, refusal=refusal)
        with self._lock:
            self._seen += 1
            if reason is None:
                # Deterministic stride over BORING requests only: boring
                # request k keeps iff floor(k*s) advanced — exactly a
                # ``sample`` fraction of uninteresting traffic,
                # replayable under a seeded chaos run. Striding over ALL
                # requests would inflate the boring keep-rate exactly
                # when most traffic is interesting (an incident), and
                # the sampled baseline would churn the very timelines
                # the ring exists to preserve.
                self._boring_seen += 1
                if self.sample <= 0.0:
                    return False
                kept_target = int(self._boring_seen * self.sample)
                if kept_target <= self._kept_boring:
                    return False
                self._kept_boring = kept_target
                reason = REASON_SAMPLED
            entry = {"ts": time.time(), "reason": reason, "route": route}
            if task_id:
                entry["task_id"] = task_id
            if trace_id:
                entry["trace_id"] = trace_id
            if status is not None:
                entry["status"] = status
            if duration_ms is not None:
                entry["duration_ms"] = round(duration_ms, 3)
            if refusal is not None:
                entry["refusal"] = refusal
            if priority is not None:
                entry["priority"] = priority
            if events:
                entry["events"] = list(events)
            self._ring.append(entry)
            self._entries_gauge.set(len(self._ring))
        self._recorded.inc(reason=reason)
        return True

    # -- dumping -------------------------------------------------------------

    def dump(self) -> dict:
        """The whole ring, newest last, plus accounting — the
        ``/v1/debug/flight`` payload and what the chaos harness writes
        on an invariant violation."""
        with self._lock:
            entries = list(self._ring)
            seen = self._seen
        by_reason: dict[str, int] = {}
        for e in entries:
            by_reason[e["reason"]] = by_reason.get(e["reason"], 0) + 1
        return {"capacity": self.capacity, "sample": self.sample,
                "slow_ms": self.slow_ms, "seen": seen,
                "entries": entries, "by_reason": by_reason}

    def entries(self, reason: str | None = None,
                task_id: str | None = None) -> list[dict]:
        with self._lock:
            out = list(self._ring)
        if reason is not None:
            out = [e for e in out if e["reason"] == reason]
        if task_id is not None:
            out = [e for e in out if e.get("task_id") == task_id]
        return out
