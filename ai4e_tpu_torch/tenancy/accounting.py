"""Per-tenant accounting: admissions, outcomes, placement cost, SLO burn.
(A copy of ``ai4e_tpu/tenancy/accounting.py``.)

Four series, all labeled through the registry's bounded mapper
(``tenant_label`` — top-N ids + ``other``, never raw keys; AIL013):

- ``ai4e_tenant_admissions_total{tenant, decision}`` — gateway-edge
  decisions: ``admitted`` vs ``quota_shed`` (the tenant bucket's 429s;
  priority/brownout sheds stay on the admission layer's own series —
  attribution follows the layer that refused);
- ``ai4e_tenant_outcomes_total{tenant, outcome}`` — terminal transitions
  from the task store's change feed: ``ok`` (completed in budget),
  ``late`` (completed past deadline), ``expired``, ``failed``;
- ``ai4e_tenant_cost_total{tenant}`` — placement cost charged by the
  dispatcher at delivery through the orchestration layer's cost model
  (the per-workload charge 2503.20074 argues admission must see);
- ``ai4e_tenant_slo_burn{tenant}`` — gauge: windowed bad fraction over
  the allowed error budget ``(1 - goodput_target)``; 1.0 = burning
  exactly at budget, the noisy-neighbor chaos scenario's flatness check
  reads this per victim tenant.

The burn windows are ``DecayingRate`` pairs (admission/controller.py) —
the same exponential-decay arithmetic the drain estimator uses, so
"window" means the same thing on every dashboard (docs/tenancy.md
residual-windows section covers the decay tail after an incident ends).
"""

from __future__ import annotations

import threading
import time

from ..admission import DecayingRate
from .registry import TenantRegistry


class TenantAccounting:
    def __init__(self, registry: TenantRegistry, metrics=None,
                 goodput_target: float = 0.99, burn_tau_s: float = 30.0):
        if not (0.0 < goodput_target < 1.0):
            raise ValueError("goodput_target must be in (0, 1)")
        self._registry = registry
        self._goodput_target = goodput_target
        self._burn_tau_s = burn_tau_s
        # label -> (good_rate, bad_rate); keyed by the BOUNDED label so
        # this dict inherits the top-N + other cap, same as the series.
        self._windows: dict[str, tuple[DecayingRate, DecayingRate]] = {}
        # The notes come from the gateway's loop and from the store's
        # listeners, on whatever thread wrote (a worker's decode loop, a
        # shard's store): one lock makes each window update whole.
        self._lock = threading.Lock()
        self._admissions = None
        self._outcomes = None
        self._cost = None
        self._burn = None
        if metrics is not None:
            self._admissions = metrics.counter(
                "ai4e_tenant_admissions_total",
                "Gateway-edge tenant decisions (admitted / quota_shed)")
            self._outcomes = metrics.counter(
                "ai4e_tenant_outcomes_total",
                "Terminal task outcomes per tenant (ok/late/expired/failed)")
            self._cost = metrics.counter(
                "ai4e_tenant_cost_total",
                "Placement cost charged to each tenant at delivery")
            self._burn = metrics.gauge(
                "ai4e_tenant_slo_burn",
                "Windowed SLO burn rate per tenant (1.0 = at error budget)")

    # -- gateway edge -------------------------------------------------------

    def note_admitted(self, tenant_id: str) -> None:
        if self._admissions is not None:
            self._admissions.inc(
                tenant=self._registry.tenant_label(tenant_id),
                decision="admitted")

    def note_quota_shed(self, tenant_id: str) -> None:
        if self._admissions is not None:
            self._admissions.inc(
                tenant=self._registry.tenant_label(tenant_id),
                decision="quota_shed")
        # A quota refusal burns the tenant's own budget, nobody else's —
        # that asymmetry is exactly what the chaos scenario asserts.
        self._note_burn(tenant_id, good=False)

    # -- dispatcher ---------------------------------------------------------

    def charge(self, tenant_id: str, cost: float) -> None:
        """Charge placement cost at delivery (dispatcher calls this with
        ``orchestration.cost_of(backend)`` after a successful dispatch)."""
        if self._cost is not None and cost > 0:
            self._cost.inc(cost, tenant=self._registry.tenant_label(tenant_id))

    # -- task store feed ----------------------------------------------------

    def attach_store(self, store) -> None:
        """Subscribe to the same change feed admission's goodput scorer
        rides; independent of the observability layer so per-tenant
        outcome series exist even when that layer is off."""
        from ..taskstore import TaskStatus

        def on_task_change(task) -> None:
            status = task.canonical_status
            if status not in TaskStatus.TERMINAL:
                return
            deadline_at = getattr(task, "deadline_at", 0.0)
            tenant_id = getattr(task, "tenant", "")
            if status == TaskStatus.COMPLETED:
                late = bool(deadline_at) and time.time() > deadline_at
                outcome = "late" if late else "ok"
            elif status == TaskStatus.EXPIRED:
                outcome = "expired"
            else:
                outcome = "failed"
            if self._outcomes is not None:
                self._outcomes.inc(
                    tenant=self._registry.tenant_label(tenant_id),
                    outcome=outcome)
            self._note_burn(tenant_id, good=(outcome == "ok"))

        store.add_listener(on_task_change)

    # -- burn windows -------------------------------------------------------

    def _note_burn(self, tenant_id: str, good: bool) -> None:
        label = self._registry.tenant_label(tenant_id)
        with self._lock:
            pair = self._windows.get(label)
            if pair is None:
                pair = (DecayingRate(tau_s=self._burn_tau_s),
                        DecayingRate(tau_s=self._burn_tau_s))
                self._windows[label] = pair
            pair[0 if good else 1].on_event()
            burn = self._burn_rate(pair)
        if self._burn is not None:
            self._burn.set(burn, tenant=label)

    def burn_rate(self, label: str) -> float:
        """Bad fraction over the error budget: 0 = clean, 1 = burning at
        exactly ``1 - goodput_target``, >1 = eating into the budget faster
        than the SLO allows."""
        with self._lock:
            pair = self._windows.get(label)
            return 0.0 if pair is None else self._burn_rate(pair)

    def _burn_rate(self, pair: tuple[DecayingRate, DecayingRate]) -> float:
        good, bad = pair[0].rate(), pair[1].rate()
        total = good + bad
        if total <= 0:
            return 0.0
        return (bad / total) / (1.0 - self._goodput_target)
