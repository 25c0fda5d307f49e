"""Per-tenant token-bucket quotas — the admission tier of tenant isolation.
(A copy of ``ai4e_tpu/tenancy/quota.py``.)

This is the ``quota-by-key`` element of the reference's API-Management
product policy, lifted to the tenant scope: one bucket per *tenant* (all
of a customer's subscription keys draw from it), refilled at the tenant's
contracted ``rps``, capped at its ``burst``. It deliberately mirrors
``gateway/ratelimit.py``'s lazy-refill arithmetic — same burst default,
same retry-after derivation — so the two throttles compose predictably:
the per-key limiter protects the gateway from any single key, this bucket
enforces the *contract* across a tenant's whole key set.

Composition contract (docs/tenancy.md): the tenant bucket runs at the
gateway edge AFTER auth and the per-key limiter, BEFORE the admission
shedder. A refusal here is a 429 whose ``Retry-After`` is the max of the
bucket's own drain time and the admission controller's drain-derived
estimate — the client backs off for whichever bottleneck is slower. It
never *replaces* the priority shedder or brownout ladder: a tenant inside
its quota can still be shed by class when the platform is saturated.
"""

from __future__ import annotations

import threading
import time

from .registry import TenantRegistry


class TenantQuota:
    """Token buckets keyed by tenant id, policy read live from the
    registry on every decision so an operator's rps/burst update takes
    effect on the next request — no bucket rebuild, no restart."""

    def __init__(self, registry: TenantRegistry, now=time.monotonic):
        self._registry = registry
        self._now = now
        # tenant_id -> [tokens, last_refill]; created lazily on first
        # sight and pruned when full-and-idle so a churning key space
        # cannot grow this dict without bound.
        self._buckets: dict[str, list[float]] = {}
        self._lock = threading.Lock()
        self._last_prune = now()

    def admit(self, tenant_id: str) -> tuple[bool, float]:
        """Spend one token from the tenant's bucket.

        Returns ``(allowed, retry_after_seconds)``; ``retry_after`` is 0.0
        when allowed, else the time until one token has refilled — the
        same drain derivation the per-key limiter uses, so a client sees
        one coherent backoff story whichever throttle fired.
        """
        t = self._registry.get(tenant_id) or self._registry.resolve(None)
        rps = t.rps
        if rps <= 0:
            return True, 0.0  # unlimited tenant — quota-exempt by contract
        cap = t.bucket_capacity()
        now = self._now()
        with self._lock:
            bucket = self._buckets.get(tenant_id)
            if bucket is None:
                bucket = [cap, now]
                self._buckets[tenant_id] = bucket
            tokens, last = bucket
            tokens = min(cap, tokens + (now - last) * rps)
            if tokens >= 1.0:
                bucket[0] = tokens - 1.0
                bucket[1] = now
                self._maybe_prune(now)
                return True, 0.0
            bucket[0] = tokens
            bucket[1] = now
            return False, (1.0 - tokens) / rps

    def tokens(self, tenant_id: str) -> float:
        """Current (refilled) token count — introspection for tests and
        the bench per-tenant report, never on the request path."""
        t = self._registry.get(tenant_id)
        if t is None or t.rps <= 0:
            return float("inf")
        now = self._now()
        with self._lock:
            bucket = self._buckets.get(tenant_id)
            if bucket is None:
                return t.bucket_capacity()
            return min(t.bucket_capacity(), bucket[0] + (now - bucket[1]) * t.rps)

    def _maybe_prune(self, now: float, interval: float = 60.0) -> None:
        # Caller holds the lock. Drop buckets that have been idle long
        # enough to be full again — recreating one later is equivalent.
        if now - self._last_prune < interval:
            return
        self._last_prune = now
        for tid in list(self._buckets):
            t = self._registry.get(tid)
            if t is None or t.rps <= 0:
                del self._buckets[tid]
                continue
            tokens, last = self._buckets[tid]
            if tokens + (now - last) * t.rps >= t.bucket_capacity():
                del self._buckets[tid]
