"""Resilient routing under failure; the counterpart of
``ai4e_tpu/resilience``. On with ``PlatformConfig(resilience=True)`` /
``AI4E_PLATFORM_RESILIENCE=1``:

- ``breaker`` — the per-backend circuit breaker (closed -> open on a
  consecutive-failure or error-rate trip -> half-open probe -> closed);
- ``health``  — ``BackendHealth``, the registry the sync proxy and every
  dispatcher share: health-aware weighted picks that eject open and
  draining backends, forced probes of a dark set, and the
  ``ai4e_resilience_*`` metrics;
- ``retry``   — retry budgets and half-jittered exponential backoff.
"""

from .breaker import CLOSED, HALF_OPEN, OPEN, STATE_CODES, CircuitBreaker
from .health import BackendHealth, ResiliencePolicy
from .retry import RetryBudget, backoff_s

__all__ = [
    "BackendHealth", "CircuitBreaker", "ResiliencePolicy", "RetryBudget",
    "backoff_s", "CLOSED", "HALF_OPEN", "OPEN", "STATE_CODES",
]
