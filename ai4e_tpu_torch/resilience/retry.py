"""Jittered exponential backoff — ``backoff_s`` of
``ai4e_tpu/resilience/retry.py``, the dispatcher's redelivery schedule."""

from __future__ import annotations

import random


def backoff_s(attempt: int, base: float, cap: float,
              rng: random.Random | None = None) -> float:
    """Jittered exponential delay for retry ``attempt`` (1-based): the
    schedule is ``base * 2**(attempt-1)`` capped at ``cap``; the delay is
    uniform in [schedule/2, schedule]. The exponent is clamped so that a
    large attempt count cannot overflow the float."""
    if base <= 0 or cap <= 0:
        return 0.0
    delay = min(cap, base * (2 ** min(63, max(0, attempt - 1))))
    return delay * (0.5 + 0.5 * (rng or random).random())
