"""Deadlines and priority classes — the per-request admission state; a
copy of ``ai4e_tpu/admission/deadline.py``.

The vocabulary every hop shares: the gateway, the broker's dispatcher, the
batcher, the worker and the decode engine. Standard library only, so none
of them drags another in.

Headers:

- ``X-Deadline-Ms`` (public): the caller's RELATIVE budget in
  milliseconds, anchored to an absolute deadline where it is admitted;
- ``X-Deadline-At`` (hop to hop): the ABSOLUTE deadline in unix seconds,
  forwarded by the dispatcher and the sync proxy, so transport delay can
  never re-extend a budget the way re-anchoring a relative value would;
- ``X-Priority``: ``interactive`` | ``default`` | ``background`` (or the
  class's number); an unlabelled public request is ``default``;
- ``X-Shed-Reason`` (response): which hop refused a request and why.

The classes are the micro-batcher's integer priorities (0 interactive
fills batches first; higher classes age toward the front, one class per
``priority_aging_s``): interactive 0, default 1, background 2.
"""

from __future__ import annotations

import time

# Public request header: relative budget, milliseconds.
DEADLINE_MS_HEADER = "X-Deadline-Ms"
# Hop-to-hop header: absolute deadline, unix seconds (float).
DEADLINE_AT_HEADER = "X-Deadline-At"
PRIORITY_HEADER = "X-Priority"
SHED_REASON_HEADER = "X-Shed-Reason"

INTERACTIVE = 0
DEFAULT = 1
BACKGROUND = 2

PRIORITY_CLASSES = {
    "interactive": INTERACTIVE,
    "default": DEFAULT,
    "background": BACKGROUND,
}
_PRIORITY_NAMES = {v: k for k, v in PRIORITY_CLASSES.items()}


class DeadlineExceeded(RuntimeError):
    """Raised inside the serving path when work expires before it is done
    (the batcher sets it on a pending future at the batch cut; the decode
    engine on a sequence at its per-step sweep)."""

    def __init__(self, hop: str, deadline_at: float = 0.0):
        super().__init__(f"deadline exceeded at {hop}")
        self.hop = hop
        self.deadline_at = deadline_at


def priority_name(priority: int) -> str:
    """Label for metrics; out-of-range classes clamp to the nearest named
    one (priorities are ordered, not enumerated)."""
    if priority <= INTERACTIVE:
        return "interactive"
    if priority >= BACKGROUND:
        return "background"
    return _PRIORITY_NAMES.get(priority, "default")


def parse_priority(headers, default: int = DEFAULT) -> int:
    """``X-Priority`` as an integer class: a class name or a bare integer
    (clamped); anything else falls back to ``default`` — a malformed label
    never refuses a request that would otherwise serve."""
    raw = headers.get(PRIORITY_HEADER)
    if raw is None:
        return default
    value = raw.strip().lower()
    if value in PRIORITY_CLASSES:
        return PRIORITY_CLASSES[value]
    try:
        return max(INTERACTIVE, min(BACKGROUND, int(value)))
    except ValueError:
        return default


def parse_deadline_at(headers, now: float | None = None) -> float:
    """The request's absolute deadline (unix seconds), 0.0 when none.

    ``X-Deadline-At`` (absolute, stamped upstream) wins over
    ``X-Deadline-Ms`` (relative, anchored here at ``now``). Malformed or
    non-positive values mean no deadline, never an error."""
    raw = headers.get(DEADLINE_AT_HEADER)
    if raw is not None:
        try:
            at = float(raw)
        except ValueError:
            at = 0.0
        return at if at > 0 else 0.0
    raw = headers.get(DEADLINE_MS_HEADER)
    if raw is None:
        return 0.0
    try:
        budget_ms = float(raw)
    except ValueError:
        return 0.0
    if budget_ms <= 0:
        return 0.0
    return (time.time() if now is None else now) + budget_ms / 1000.0


def expired(deadline_at: float, now: float | None = None) -> bool:
    """True when the deadline exists and has passed."""
    if not deadline_at:
        return False
    return (time.time() if now is None else now) >= deadline_at


def remaining_s(deadline_at: float, now: float | None = None) -> float:
    """Seconds of budget left (may be negative); +inf when no deadline."""
    if not deadline_at:
        return float("inf")
    return deadline_at - (time.time() if now is None else now)


def drain_retry_after(excess: float, drain_rate: float) -> float:
    """THE Retry-After policy of every refusal: seconds for ``excess``
    backlog units to drain at the observed rate, clamped to [1, 60]; 2 s
    while no drain has been observed."""
    if drain_rate <= 1e-9:
        return 2.0
    return max(1.0, min(60.0, excess / drain_rate))


def expired_status(hop: str) -> str:
    """The terminal status of work shed on its deadline at ``hop``; it
    buckets to the terminal ``expired`` state."""
    return f"expired - deadline exceeded at {hop}"


def shed_reason(hop: str, why: str) -> str:
    """``X-Shed-Reason`` value: which hop refused, and why (``deadline``:
    the budget is spent; ``pressure``: the shedder refused the class to
    protect higher-priority work)."""
    return f"{why} at {hop}"


def propagation_headers(deadline_at: float, priority: int) -> dict:
    """Headers a hop attaches when it hands admitted work downstream (the
    dispatcher's backend POST, the gateway's sync proxy): the ABSOLUTE
    deadline and the class. The class is always explicit: a worker's
    no-header default is interactive, so omitting ``default`` would promote
    every default-class request at the next hop."""
    headers = {PRIORITY_HEADER: str(priority)}
    if deadline_at:
        headers[DEADLINE_AT_HEADER] = repr(deadline_at)
    return headers


def worker_admission_kwargs(headers) -> dict:
    """``{"deadline_at", "priority"}`` of a request reaching a worker. The
    default class here is INTERACTIVE (0): an unlabelled direct request to
    a worker batches as it always did; only traffic the gateway classified
    carries another class."""
    return {"deadline_at": parse_deadline_at(headers),
            "priority": parse_priority(headers, default=INTERACTIVE)}
