"""The ``Tenancy`` facade — one object the assembly threads everywhere.
(A copy of ``ai4e_tpu/tenancy/core.py``.)

Binds the four parts (registry, quota, lanes, accounting) so each
consumer takes exactly one handle:

- the gateway calls ``resolve`` / ``admit`` / ``note_admitted`` /
  ``note_quota_shed`` at the edge;
- the broker takes ``.lanes`` as its ``fair=`` policy;
- the dispatcher calls ``charge`` after a successful delivery;
- the assembly calls ``attach_store`` once for the outcome feed.

Construction is pure (no I/O, no task spawned), matching every other
opt-in layer: ``tenancy=False`` assemblies never instantiate this and
stay byte-identical (asserted in tests/test_tenancy.py).
"""

from __future__ import annotations

from .accounting import TenantAccounting
from .lanes import TenantLanes
from .quota import TenantQuota
from .registry import Tenant, TenantRegistry, parse_tenants


class Tenancy:
    def __init__(self, registry: TenantRegistry, metrics=None,
                 goodput_target: float = 0.99, min_quantum: float = 0.05):
        self.registry = registry
        self.quota = TenantQuota(registry)
        self.lanes = TenantLanes(registry, min_quantum=min_quantum)
        self.accounting = TenantAccounting(
            registry, metrics=metrics, goodput_target=goodput_target)

    @classmethod
    def from_spec(cls, spec: str | None, metrics=None,
                  default_weight: float = 1.0, default_rps: float = 0.0,
                  default_burst: float = 0.0, label_top_n: int = 8,
                  goodput_target: float = 0.99,
                  min_quantum: float = 0.05) -> "Tenancy":
        tenants = parse_tenants(spec or "", default_weight=default_weight,
                                default_rps=default_rps,
                                default_burst=default_burst)
        registry = TenantRegistry(tenants, default_weight=default_weight,
                                  default_rps=default_rps,
                                  default_burst=default_burst,
                                  label_top_n=label_top_n)
        return cls(registry, metrics=metrics, goodput_target=goodput_target,
                   min_quantum=min_quantum)

    # -- gateway edge (thin delegations so the router holds one handle) -----

    def resolve(self, key: str | None) -> Tenant:
        return self.registry.resolve(key)

    def admit(self, tenant_id: str) -> tuple[bool, float]:
        return self.quota.admit(tenant_id)

    def note_admitted(self, tenant_id: str) -> None:
        self.accounting.note_admitted(tenant_id)

    def note_quota_shed(self, tenant_id: str) -> None:
        self.accounting.note_quota_shed(tenant_id)

    # -- dispatcher ---------------------------------------------------------

    def charge(self, tenant_id: str, cost: float) -> None:
        self.accounting.charge(tenant_id, cost)

    # -- assembly -----------------------------------------------------------

    def attach_store(self, store) -> None:
        self.accounting.attach_store(store)

    def tenant_label(self, tenant_id: str) -> str:
        return self.registry.tenant_label(tenant_id)
