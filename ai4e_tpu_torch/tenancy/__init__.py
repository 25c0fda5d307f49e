"""Multi-tenancy: per-tenant quotas, weighted-fair scheduling, isolation.
(A copy of ``ai4e_tpu/tenancy/__init__.py``.)

Opt-in via ``PlatformConfig(tenancy=True)`` / ``AI4E_TENANCY_ENABLED=1``
(docs/tenancy.md). Four parts behind one ``Tenancy`` facade:

- ``registry``   — subscription key → (tenant id, weight, rps, burst),
  resolved once at the gateway edge, plus the frozen bounded-cardinality
  ``tenant_label`` mapper (top-N + ``other``; AIL013's blessed path);
- ``quota``      — per-tenant token buckets at admission: 429 with a
  drain-derived ``Retry-After``, composed with (never replacing) the
  priority shedder and brownout ladder;
- ``lanes``      — the policy half of the broker's deficit-round-robin
  per-tenant lanes: a flooded tenant fills its own lane, never another's;
- ``accounting`` — per-tenant admissions/outcomes/cost/SLO-burn series.
"""

from .accounting import TenantAccounting
from .core import Tenancy
from .lanes import TenantLanes
from .quota import TenantQuota
from .registry import (DEFAULT_TENANT, OTHER_LABEL, Tenant, TenantRegistry,
                       parse_tenants)

__all__ = [
    "Tenancy", "TenantAccounting", "TenantLanes", "TenantQuota",
    "TenantRegistry", "Tenant", "parse_tenants", "DEFAULT_TENANT",
    "OTHER_LABEL",
]
