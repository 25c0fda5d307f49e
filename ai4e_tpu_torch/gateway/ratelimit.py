"""Per-subscription-key rate limits and quotas — a copy of
``ai4e_tpu/gateway/ratelimit.py``: the APIM product throttle and quota
beside the gateway's subscription-key auth (``gateway/router.py``).

- ``RateLimiter``: a token bucket per key, refilled continuously; a
  drained bucket answers ``(False, seconds until one token accrues)``, the
  gateway's 429 with ``Retry-After``;
- ``QuotaTracker``: a fixed-window request count per key; an exhausted
  window answers ``(False, seconds to its reset)``, the gateway's 403.
  ``would_allow`` peeks without consuming, so a quota refusal spends no
  rate token;
- ``parse_rate_limits``, ``parse_quota`` and ``parse_quotas``: the
  ``AI4E_GATEWAY_RATE_LIMITS``, ``_QUOTA`` and ``_QUOTAS`` specs, refused
  with JAX's messages.

The clock is injectable (``clock=``), so a test steps it by hand.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class RateLimit:
    """``rps`` sustained requests/second; ``burst`` bucket capacity (how far
    above the sustained rate a key may spike)."""

    rps: float
    burst: float = 0.0

    def __post_init__(self):
        if self.rps <= 0:
            raise ValueError(f"rps must be positive, got {self.rps}")
        if self.burst <= 0:
            self.burst = max(2.0 * self.rps, 1.0)


class RateLimiter:
    """Token buckets keyed by subscription key (or any caller identity).

    Single-threaded by design: the gateway's middleware calls ``allow`` on
    the event loop with no awaits in between, so no lock is needed. Buckets
    are created lazily per key and pruned when idle long enough to be full
    again (bounded memory under key churn).
    """

    def __init__(self, default: RateLimit,
                 per_key: dict[str, RateLimit] | None = None,
                 clock=time.monotonic):
        self.default = default
        self.per_key = dict(per_key or {})
        self._clock = clock
        # key -> [tokens, last_refill_ts]
        self._buckets: dict[str, list[float]] = {}
        self._last_prune = clock()

    def limit_for(self, key: str) -> RateLimit:
        return self.per_key.get(key, self.default)

    def allow(self, key: str) -> tuple[bool, float]:
        """Take one token from ``key``'s bucket. Returns ``(allowed,
        retry_after_seconds)`` — ``retry_after`` is 0 when allowed, else the
        time until one token accrues (the ``Retry-After`` header value)."""
        limit = self.limit_for(key)
        now = self._clock()
        if now - self._last_prune > 60.0:
            self._prune(now)
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = [limit.burst, now]
        tokens, last = bucket
        tokens = min(limit.burst, tokens + (now - last) * limit.rps)
        if tokens >= 1.0:
            bucket[0] = tokens - 1.0
            bucket[1] = now
            return True, 0.0
        bucket[0] = tokens
        bucket[1] = now
        return False, (1.0 - tokens) / limit.rps

    def _prune(self, now: float) -> None:
        """Drop buckets idle long enough to be full — indistinguishable from
        fresh ones, so dropping them changes nothing but memory."""
        self._last_prune = now
        full_after = {key: (self.limit_for(key).burst
                            / self.limit_for(key).rps)
                      for key in self._buckets}
        self._buckets = {
            key: bucket for key, bucket in self._buckets.items()
            if now - bucket[1] < full_after[key]}


@dataclass
class Quota:
    """``requests`` allowed per ``window_seconds`` — the APIM product
    *quota* (longer-horizon cap) beside the rate throttle (short-horizon
    smoothing). APIM renews quotas on fixed calendar windows; the fixed
    rolling-start window here is the standard approximation."""

    requests: int
    window_seconds: float = 3600.0

    def __post_init__(self):
        if self.requests <= 0:
            raise ValueError(f"quota must be positive, got {self.requests}")
        if self.window_seconds <= 0:
            raise ValueError(
                f"quota window must be positive, got {self.window_seconds}")


class QuotaTracker:
    """Fixed-window request counters keyed by subscription key.

    Same single-threaded contract as ``RateLimiter`` (called on the event
    loop, no awaits in between). ``allow`` returns ``(allowed,
    retry_after_seconds)`` — on exhaustion ``retry_after`` is the time to
    the window's reset (APIM answers 403 for quota vs 429 for rate; the
    gateway maps accordingly)."""

    def __init__(self, default: Quota | None,
                 per_key: dict[str, Quota] | None = None,
                 clock=time.monotonic):
        # default None = keys without a per-key quota are unlimited AND
        # untracked (no per-identity window entry — matters when the
        # identity is a client IP).
        self.default = default
        self.per_key = dict(per_key or {})
        self._clock = clock
        # key -> [count, window_start_ts]
        self._windows: dict[str, list[float]] = {}
        self._last_prune = clock()

    def quota_for(self, key: str) -> Quota | None:
        return self.per_key.get(key, self.default)

    def _window(self, key: str, quota: Quota, now: float) -> list[float]:
        if now - self._last_prune > 300.0:
            self._prune(now)
        window = self._windows.get(key)
        if window is None or now - window[1] >= quota.window_seconds:
            window = self._windows[key] = [0.0, now]
        return window

    def would_allow(self, key: str) -> tuple[bool, float]:
        """Non-consuming peek — lets the gateway refuse on quota BEFORE
        taking a rate-limiter token (a quota-403'd request must not burn
        rate tokens, or exhausted clients see short 429 Retry-Afters
        instead of the 403's window-reset backoff)."""
        quota = self.quota_for(key)
        if quota is None:
            return True, 0.0
        now = self._clock()
        window = self._window(key, quota, now)
        if window[0] < quota.requests:
            return True, 0.0
        return False, quota.window_seconds - (now - window[1])

    def allow(self, key: str) -> tuple[bool, float]:
        quota = self.quota_for(key)
        if quota is None:
            return True, 0.0
        now = self._clock()
        window = self._window(key, quota, now)
        if window[0] < quota.requests:
            window[0] += 1.0
            return True, 0.0
        return False, quota.window_seconds - (now - window[1])

    def _prune(self, now: float) -> None:
        """Drop expired windows — a fresh one is created on next use."""
        self._last_prune = now
        self._windows = {
            key: w for key, w in self._windows.items()
            if (q := self.quota_for(key)) is not None
            and now - w[1] < q.window_seconds}


def parse_quota(spec: str) -> Quota:
    """``"N/seconds"`` or bare ``"N"`` (hour window)."""
    n, _, window = (spec or "").strip().partition("/")
    try:
        return Quota(requests=int(n),
                     window_seconds=float(window) if window else 3600.0)
    except ValueError:
        raise ValueError(
            f"bad quota spec {spec!r}; expected N[/window_seconds]") from None


def parse_quotas(spec: str) -> dict[str, Quota]:
    """Per-key overrides: ``key=N[/seconds],...``
    (e.g. ``"partner-key=100000/86400,free-tier=100"``)."""
    out: dict[str, Quota] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        key, _, q = part.partition("=")
        if not key or not q:
            raise ValueError(f"bad quota entry {part!r}; "
                             "expected key=N[/window_seconds]")
        out[key.strip()] = parse_quota(q)
    return out


def parse_rate_limits(spec: str) -> dict[str, RateLimit]:
    """Parse per-key overrides from config: ``key=rps[:burst],...``
    (e.g. ``"partner-key=50:100,free-tier=2"``)."""
    out: dict[str, RateLimit] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        key, _, rate = part.partition("=")
        if not key or not rate:
            raise ValueError(f"bad rate-limit entry {part!r}; "
                             "expected key=rps[:burst]")
        rps, _, burst = rate.partition(":")
        out[key.strip()] = RateLimit(rps=float(rps),
                                     burst=float(burst) if burst else 0.0)
    return out
