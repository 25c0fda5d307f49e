"""Tenant registry — subscription key → (tenant id, weight, quota, burst).
(A copy of ``ai4e_tpu/tenancy/registry.py``.)

The reference publishes every API behind an API-Management *product*
subscription: the key a caller presents IS its identity, and throttling/
quota policy hangs off the product, not the individual key
(``APIManagement/create_async_api_management_api.sh:52-80`` attaches each
API to a product whose policy XML carries the rate/quota elements). The
gateway's per-key token buckets (``gateway/ratelimit.py``) reproduce the
throttle but stop short of identity: every key is its own universe, so
nothing can say "these three keys are one customer" or "this customer is
entitled to 4× the scheduler share of that one".

This module is that missing identity tier. A ``Tenant`` bundles the
policy knobs every layer reads:

- ``weight`` — the deficit-round-robin quantum multiplier the broker's
  per-tenant lanes serve by (``broker/queue.py``; docs/tenancy.md);
- ``rps``/``burst`` — the admission token bucket (``tenancy/quota.py``);
  0 rps = unlimited (quota-exempt);

and the registry maps subscription keys onto tenants exactly once, at the
gateway edge — everything downstream (task record, broker message,
dispatcher, metrics) carries the resolved tenant id, never the key.

Cardinality policy: raw tenant ids are unbounded operator input and
subscription keys are secrets — neither may become a metric label. The
blessed mapper is ``tenant_label``: the first ``label_top_n`` registered
tenants keep their own id as the label, everything else (late
registrations included — the label set is FROZEN at construction so a
series never flips identity mid-scrape) collapses into ``other``. The
AIL013 analyzer rule enforces that identity-derived metric labels go
through this mapper (docs/analysis.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

#: The label every tenant outside the frozen top-N set maps to — including
#: the anonymous/default tenant when it was not explicitly registered.
OTHER_LABEL = "other"

#: Tenant id used for traffic that resolved to no registered key (auth
#: off, unknown key, or a keyless internal caller).
DEFAULT_TENANT = "default"


@dataclass
class Tenant:
    """One tenant's policy row. Immutable by convention — live updates go
    through ``TenantRegistry.update`` with a *replacement* row, so readers
    racing an update see either the old or the new row, never a torn one
    (the explore_interleavings regression in tests/test_race_regressions.py
    holds this to account)."""

    tenant_id: str
    #: DRR quantum multiplier for the broker lanes (docs/tenancy.md).
    weight: float = 1.0
    #: Admission token-bucket refill rate (requests/second); 0 = unlimited.
    rps: float = 0.0
    #: Bucket capacity; 0 → ``max(2 * rps, 1)`` (the ``RateLimit``
    #: convention in gateway/ratelimit.py, kept identical so operators
    #: reason about one burst rule).
    burst: float = 0.0
    #: Subscription keys resolving to this tenant.
    keys: tuple = field(default_factory=tuple)

    def bucket_capacity(self) -> float:
        return self.burst if self.burst > 0 else max(2.0 * self.rps, 1.0)


def parse_tenants(spec: str, default_weight: float = 1.0,
                  default_rps: float = 0.0,
                  default_burst: float = 0.0) -> list[Tenant]:
    """``"alpha=key-a1|key-a2:4:50:100,beta=key-b:1:10"`` → tenants.

    Entry shape: ``name=key[|key...][:weight[:rps[:burst]]]`` — positional
    numeric fields after the key list, omitted ones fall back to the
    configured defaults. Keys may not contain ``,`` ``:`` ``|`` or ``=``
    (the spec's own separators). Malformed entries raise ``ValueError``
    loudly at assembly time, never silently mid-request.
    """
    tenants: list[Tenant] = []
    seen_ids: set[str] = set()
    seen_keys: set[str] = set()
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, rest = entry.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"tenant entry {entry!r}: expected name=keys[:weight[:rps"
                f"[:burst]]]")
        if name in seen_ids:
            raise ValueError(f"tenant {name!r} declared twice")
        seen_ids.add(name)
        parts = rest.split(":")
        keys = tuple(k.strip() for k in parts[0].split("|") if k.strip())
        if not keys:
            raise ValueError(f"tenant {name!r}: no subscription keys")
        for k in keys:
            if k in seen_keys:
                raise ValueError(
                    f"subscription key {k!r} mapped to two tenants")
            seen_keys.add(k)
        numbers = []
        for raw in parts[1:4]:
            raw = raw.strip()
            try:
                numbers.append(float(raw)) if raw else numbers.append(None)
            except ValueError as e:
                raise ValueError(
                    f"tenant {name!r}: {raw!r} is not a number") from e
        weight = numbers[0] if len(numbers) > 0 and numbers[0] is not None \
            else default_weight
        rps = numbers[1] if len(numbers) > 1 and numbers[1] is not None \
            else default_rps
        burst = numbers[2] if len(numbers) > 2 and numbers[2] is not None \
            else default_burst
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        tenants.append(Tenant(tenant_id=name, weight=weight, rps=rps,
                              burst=burst, keys=keys))
    return tenants


class TenantRegistry:
    """Key → tenant resolution plus the frozen bounded-cardinality label
    map. Reads are lock-free dict lookups (GIL-atomic); ``update``
    replaces whole rows with single assignments, so a dequeue racing a
    weight update reads either generation consistently."""

    def __init__(self, tenants: list[Tenant] | None = None,
                 default_weight: float = 1.0, default_rps: float = 0.0,
                 default_burst: float = 0.0, label_top_n: int = 8):
        self._tenants: dict[str, Tenant] = {}
        self._by_key: dict[str, str] = {}
        #: The fallback row for unresolved traffic; its id is DEFAULT_TENANT
        #: unless the spec registered a tenant named "default" explicitly.
        self._default = Tenant(DEFAULT_TENANT, weight=default_weight,
                               rps=default_rps, burst=default_burst)
        for t in tenants or ():
            self._tenants[t.tenant_id] = t
            for k in t.keys:
                self._by_key[k] = t.tenant_id
            if t.tenant_id == DEFAULT_TENANT:
                self._default = t
        # Frozen label set (see module docstring): declaration order, not
        # traffic order — a scrape series must never flip between a real
        # id and "other" as load shifts.
        self._labeled = frozenset(
            list(self._tenants)[:max(0, int(label_top_n))])

    # -- resolution ---------------------------------------------------------

    def resolve(self, key: str | None) -> Tenant:
        """The tenant a subscription key belongs to; the default tenant
        for None/unknown keys (auth-off deployments still get quota and a
        lane — one shared one)."""
        if key:
            tid = self._by_key.get(key)
            if tid is not None:
                t = self._tenants.get(tid)
                if t is not None:
                    return t
        return self._default

    def get(self, tenant_id: str) -> Tenant | None:
        if tenant_id == self._default.tenant_id:
            return self._tenants.get(tenant_id, self._default)
        return self._tenants.get(tenant_id)

    def tenant_ids(self) -> list[str]:
        return list(self._tenants)

    def weight(self, tenant_id: str) -> float:
        """Live DRR weight for a lane key ("" = the default lane). Read
        per dequeue decision so a quota/weight update takes effect on the
        very next pop — no queue rebuild (the rebuild variant is the race
        the explorer regression catches)."""
        t = self._tenants.get(tenant_id) if tenant_id else None
        return (t.weight if t is not None else self._default.weight)

    # -- live updates -------------------------------------------------------

    def update(self, tenant: Tenant) -> None:
        """Install a replacement policy row (weight/rps/burst changes take
        effect on the next decision that reads them). Key bindings are
        append-only here: a key can be added to a tenant live, never
        silently stolen from another."""
        for k in tenant.keys:
            owner = self._by_key.get(k)
            if owner is not None and owner != tenant.tenant_id:
                raise ValueError(
                    f"subscription key {k!r} already belongs to {owner!r}")
        self._tenants[tenant.tenant_id] = tenant
        for k in tenant.keys:
            self._by_key[k] = tenant.tenant_id
        if tenant.tenant_id == self._default.tenant_id:
            self._default = tenant

    def set_weight(self, tenant_id: str, weight: float) -> None:
        """Convenience live-reweight (the rebalance an operator performs
        mid-incident): whole-row replacement, same atomicity story as
        ``update``."""
        if weight <= 0:
            raise ValueError("weight must be > 0")
        t = self.get(tenant_id)
        if t is None:
            raise KeyError(tenant_id)
        self.update(replace(t, weight=weight))

    # -- bounded-cardinality label (the AIL013 blessed mapper) --------------

    def tenant_label(self, tenant_id: str) -> str:
        """THE bounded-cardinality metric label for a tenant id: its own
        id when inside the frozen top-N set, ``other`` for everything
        else — never a raw subscription key, never an unbounded value
        (docs/tenancy.md; enforced by analyzer rule AIL013)."""
        return tenant_id if tenant_id in self._labeled else OTHER_LABEL
