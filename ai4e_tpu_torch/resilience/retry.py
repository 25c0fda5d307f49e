"""Retry budgets and jittered backoff; a copy of
``ai4e_tpu/resilience/retry.py``.

- ``RetryBudget`` is a token bucket: ordinary requests deposit ``ratio``
  tokens, each retry spends one, so steady-state retries cannot exceed
  about ``ratio`` of real traffic (a small reserve lets a cold start and a
  lone failure still retry) and cannot storm a browning-out backend;
- ``backoff_s`` spreads each delay uniformly over [d/2, d] (half jitter),
  so no two callers wake in lockstep. It is also the dispatcher's
  redelivery schedule.
"""

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


class RetryBudget:
    """Token-bucket retry budget (see the module docstring). Event-loop
    state, like the breaker: each retrying component (a dispatcher queue,
    the sync proxy) owns one, so a melting queue cannot spend another
    queue's retries."""

    def __init__(self, ratio: float = 0.2, reserve: float = 10.0,
                 cap: float = 100.0):
        self.ratio = max(0.0, ratio)
        self.cap = max(reserve, cap)
        self._tokens = min(float(reserve), self.cap)

    @property
    def tokens(self) -> float:
        return self._tokens

    def on_request(self) -> None:
        """One ordinary (non-retry) request happened: deposit."""
        self._tokens = min(self.cap, self._tokens + self.ratio)

    def try_retry(self) -> bool:
        """Spend one retry if the budget allows."""
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False
