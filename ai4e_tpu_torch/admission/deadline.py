"""Deadlines and priority classes — a copy of the part of
``ai4e_tpu/admission/deadline.py`` that the decode path uses.

A request's deadline is an absolute unix time (0.0: none). The decode
engine's per-step sweep retires a sequence whose deadline passed
(``DeadlineExceeded``) and counts it by priority class (``priority_name``);
the worker answers such a task with ``expired_status``. The port's gateway
stamps no deadline yet (admission control, ROADMAP A18.5), so only a
caller of the engine that passes one meets these paths.
"""

from __future__ import annotations

import time

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
    """Raised inside the serving path when work expires before it is
    done."""

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


def expired(deadline_at: float, now: float | None = None) -> bool:
    """True when the deadline exists and has passed."""
    if not deadline_at:
        return False
    return (time.time() if now is None else now) >= deadline_at


def expired_status(hop: str) -> str:
    """The terminal status of work shed on its deadline at ``hop``; it
    buckets to the terminal ``expired`` state."""
    return f"expired - deadline exceeded at {hop}"
