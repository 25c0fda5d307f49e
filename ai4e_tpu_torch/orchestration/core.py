"""The orchestrator: cost- and deadline-aware placement; a copy of
``ai4e_tpu/orchestration/core.py``.

It replaces the dispatcher's and the sync proxy's health-weighted random
pick. ``place`` chooses for each request:

1. candidates = the route's backends whose breaker admits traffic (and
   not already tried in this delivery's failover chain; draining ones
   ejected while a peer remains; the canary split applied);
2. at ladder level 1 and above, background work is restricted to the
   cheapest live tier (``restrict_background``);
3. a candidate whose breaker is not closed but admits traffic (cooldown
   elapsed, probe slot free) takes the request outright (``probe``): the
   estimator would otherwise never pick it, and the probe is what closes
   its breaker. Its slot bounds the diversion;
4. otherwise cost tiers are walked cheapest first (cost from the policy's
   substring map) and the first tier with a candidate whose
   ``p_within(remaining budget)`` clears ``confidence`` wins, by a
   weighted pick among those that cleared (``confident``);
5. nobody clears: the candidate with the best p serves anyway
   (``fallback``) and the ladder is fed one predicted miss;
6. nothing available at all: the health model's forced probe
   (``forced``).

A request without a deadline has an infinite budget: every live backend
clears, so it takes the cheapest tier. A chosen backend whose breaker is
not closed is committed through the health model (``commit_pick``), so
probe accounting is the same whoever chose it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..admission.deadline import BACKGROUND, remaining_s
from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from ..utils.backends import pick_backend
from .estimator import CompletionEstimator, backend_label
from .ladder import DegradationLadder


@dataclass
class OrchestrationPolicy:
    """Assembly-level knob set (``PlatformConfig.orchestration_*`` /
    ``AI4E_PLATFORM_ORCHESTRATION*`` mirror the env-visible ones)."""

    confidence: float = 0.75      # p_within bar a backend must clear
    window: int = 256             # RTT samples per backend sketch
    horizon_s: float = 60.0       # sample age beyond which RTTs are ignored
    cold_p: float = 1.0           # estimate for a backend with no samples
    backend_parallelism: int = 8  # assumed concurrent service per backend
    # Cost per backend: substring → relative cost (first match wins, like
    # the fault injector's rules); unmatched backends cost 1.0. Lower is
    # cheaper; ties preserve configured weight order.
    costs: dict = field(default_factory=dict)
    # Ladder thresholds (ladder.py): predicted-miss pressure to step
    # up/down, and the sustain window per step.
    ladder_up: float = 0.3
    ladder_down: float = 0.1
    ladder_hold_s: float = 5.0
    # Predictive autoscaling projection window (scaling/autoscaler.py):
    # how far ahead the arrival/drain imbalance is integrated.
    scale_horizon_s: float = 10.0


def parse_costs(spec: str | None) -> dict:
    """``"tpu=3,cpu-fallback=1,remote=5"`` → substring→cost map (the
    config-string form of ``OrchestrationPolicy.costs``)."""
    costs: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, raw = part.partition("=")
        if not sep:
            raise ValueError(
                f"orchestration cost entry {part!r} is not substring=cost")
        costs[name.strip()] = float(raw)
    return costs


class Orchestrator:
    """One per assembly: estimator + ladder + the placement policy, shared
    by every dispatcher and the gateway sync proxy the same way the
    health model is."""

    def __init__(self, health, policy: OrchestrationPolicy | None = None,
                 metrics: MetricsRegistry | None = None,
                 clock=time.monotonic):
        self.health = health
        self.policy = policy or OrchestrationPolicy()
        self.metrics = metrics or DEFAULT_REGISTRY
        self._clock = clock
        self.estimator = CompletionEstimator(
            health, window=self.policy.window,
            horizon_s=self.policy.horizon_s, cold_p=self.policy.cold_p,
            parallelism=self.policy.backend_parallelism,
            metrics=self.metrics, clock=clock)
        self.ladder = DegradationLadder(
            up=self.policy.ladder_up, down=self.policy.ladder_down,
            hold_s=self.policy.ladder_hold_s, metrics=self.metrics,
            clock=clock)
        self._placements = self.metrics.counter(
            "ai4e_orchestration_placements_total",
            "Placement decisions by backend and outcome (confident/"
            "fallback/probe/forced)")

    # -- signal feeds (the dispatcher/proxy call these) ---------------------

    def observe(self, uri: str, rtt_s: float) -> None:
        self.estimator.observe(uri, rtt_s)

    def begin(self, uri: str) -> None:
        self.estimator.begin(uri)

    def end(self, uri: str) -> None:
        self.estimator.end(uri)

    # -- cost model ---------------------------------------------------------

    def cost_of(self, uri: str) -> float:
        for sub, cost in self.policy.costs.items():
            if sub in uri:
                return cost
        return 1.0

    # -- placement ----------------------------------------------------------

    def place(self, backends, deadline_at: float = 0.0, priority: int = 1,
              rng=None, exclude=(), note=None) -> str:
        """Choose the delivery target for one request (module docstring).
        ``backends``/``exclude`` carry the same contract as
        ``BackendHealth.pick`` — weighted set, failover exclusion ignored
        when it would empty the set. ``note`` (optional,
        ``note(outcome, uri)``) receives the placement outcome label AND
        the chosen backend — the observability layer stamps both onto
        the task's hop ledger (``placed``/``probe`` events; a probe
        event without the probed backend would carry no diagnostic
        value) without changing the return contract either call site
        depends on."""
        now = self._clock()

        def _tell(outcome: str, uri: str) -> None:
            if note is not None:
                try:
                    note(outcome, uri)
                except Exception:  # noqa: BLE001; ai4e: noqa[AIL005] — an observability sink must never fail a placement
                    pass
        pool = [(u, w) for u, w in backends if u not in exclude and w > 0]
        if not pool:
            pool = [(u, w) for u, w in backends if w > 0]
        # Drain eject (rollout/): route around a draining backend while
        # any peer remains — an eject-from-placement, not a breaker
        # event, so a planned upgrade never reads as a failure.
        undrained = [(u, w) for u, w in pool
                     if not self.health.is_draining(u)]
        if undrained:
            pool = undrained
        # Canary split (rollout/canary.py): rescale so the canary
        # generation's backends hold their configured traffic share; the
        # rescaled weights carry through the in-tier weighted pick below.
        if self.health.canary is not None:
            pool = [(u, w) for u, w in self.health.canary.apply(pool)
                    if w > 0] or pool
        avail = [(u, w) for u, w in pool
                 if self.health.breaker_for(u).available(now)]
        if not avail:
            # Fully dark (or fully excluded): the health model's forced
            # probe of the least-recently-failed backend — a dark set
            # must keep probing its way back to life.
            chosen = self.health.pick(backends, rng, exclude=exclude)
            self._placements.inc(backend=backend_label(chosen),
                                 outcome="forced")
            _tell("forced", chosen)
            return chosen
        if priority >= BACKGROUND and self.ladder.restrict_background():
            cheapest = min(self.cost_of(u) for u, _ in avail)
            avail = [(u, w) for u, w in avail
                     if self.cost_of(u) <= cheapest]
        # Cheapest-first; heavier configured weight breaks cost ties so a
        # weighted canary pair still skews toward its majority backend.
        order = sorted(range(len(avail)),
                       key=lambda i: (self.cost_of(avail[i][0]),
                                      -avail[i][1], i))
        # Recovery probe (docstring step 3): an available-but-non-closed
        # backend would never win the p walk (its estimate is 0/discounted
        # while any healthy peer clears), so route this request to it as
        # the probe that can close its breaker. Self-limiting: the slot
        # this commit_pick books makes the backend unavailable to the
        # next placement until the probe resolves. No ladder note — a
        # probe is not a prediction.
        for i in order:
            uri = avail[i][0]
            if self.health.state(uri) != "closed":
                self.health.commit_pick(uri, now)
                self._placements.inc(backend=backend_label(uri),
                                     outcome="probe")
                _tell("probe", uri)
                return uri
        budget = remaining_s(deadline_at)
        chosen = None
        outcome = "confident"
        best, best_p = avail[order[0]][0], -1.0
        tier_start = 0
        while tier_start < len(order):
            tier_cost = self.cost_of(avail[order[tier_start]][0])
            tier_end = tier_start
            while (tier_end < len(order)
                   and self.cost_of(avail[order[tier_end]][0]) == tier_cost):
                tier_end += 1
            clearing = []
            for i in order[tier_start:tier_end]:
                uri, weight = avail[i]
                p = self.estimator.p_within(uri, budget, now)
                if p > best_p:
                    best, best_p = uri, p
                if p >= self.policy.confidence:
                    clearing.append((uri, weight))
            if clearing:
                # Weighted pick over the tier's clearing members — an
                # equal-cost set keeps its configured canary split.
                chosen = pick_backend(clearing, rng)
                break
            tier_start = tier_end
        if chosen is None:
            # Nobody clears the bar: serve best-effort on the highest-p
            # tier and feed the ladder the predicted miss (only deadline
            # traffic can miss).
            chosen, outcome = best, "fallback"
            if budget != float("inf"):
                self.ladder.note(miss=True, now=now)
        elif budget != float("inf"):
            self.ladder.note(miss=False, now=now)
        self.health.commit_pick(chosen, now)
        self._placements.inc(backend=backend_label(chosen), outcome=outcome)
        _tell(outcome, chosen)
        return chosen
