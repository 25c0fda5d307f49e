"""Lane policy for the broker's weighted-fair (DRR) dequeue.
(A copy of ``ai4e_tpu/tenancy/lanes.py``.)

The mechanism lives in ``broker/queue.py`` (``EndpointQueue`` grows
per-tenant lanes and a deficit-round-robin ring when handed one of
these); this object is the *policy* half the queue consults per decision:

- ``lane_of(msg)`` — which lane a message parks in (its tenant id; ""
  is the shared default lane for tenantless traffic);
- ``quantum(lane)`` — the deficit credit a lane earns per ring visit,
  i.e. the tenant's live weight. Read per visit, not cached, so a weight
  update from ``TenantRegistry.update`` rebalances the very next pops
  without touching queue state (the queue-rebuild alternative is the
  lost-message race tests/test_race_regressions.py pins).

Keeping policy out of the queue keeps ``fair=None`` the true default:
the queue's hot path doesn't know tenants exist, it knows lane keys and
quanta.
"""

from __future__ import annotations

from .registry import TenantRegistry


class TenantLanes:
    def __init__(self, registry: TenantRegistry, min_quantum: float = 0.05):
        if min_quantum <= 0:
            raise ValueError("min_quantum must be > 0")
        self._registry = registry
        # Floor on the per-visit credit: a weight so small the lane would
        # take thousands of ring rotations per message is a configuration
        # foot-gun, not a policy (docs/tenancy.md quota math).
        self._min_quantum = min_quantum

    def lane_of(self, msg) -> str:
        return getattr(msg, "tenant", "") or ""

    def quantum(self, lane: str) -> float:
        return max(self._registry.weight(lane), self._min_quantum)
