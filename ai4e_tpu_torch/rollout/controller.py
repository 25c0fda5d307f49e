"""The rollout controller — SLO-burn-guarded canary promotion/rollback;
a copy of ``ai4e_tpu/rollout/controller.py``.

Upgrades a fleet one worker at a time with zero client-visible loss:
drain the worker (``drain.py``), restart it at the new generation, step
the canary traffic share up the configured ladder — holding each step
for a clean fast+slow burn window (the multi-window multi-burn shape the
SLO engine exports, ``observability/slo.py``) — and automatically roll
back (re-weight to the old generation, drain + revert the upgraded
replicas via the existing reload/restart path) when the canary
generation's burn rate or breaker state breaches. Every transition
stamps ``rollout``/``rollback`` evidence into the hop ledger through the
fleet adapter, so the trace CLI renders the upgrade like any other
timeline (docs/observability.md).

The controller is transport-agnostic: a ``fleet`` adapter supplies the
verbs (drain/upgrade/revert/weights/burn). The rig's adapter drives real
OS processes over HTTP (``rig/rollout.py``); tests drive an in-memory
fleet with an injected clock.
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
from dataclasses import dataclass, field

log = logging.getLogger("ai4e_tpu_torch.rollout")


def parse_steps(spec: str) -> list[float]:
    """``"5,25,50,100"`` → monotonically increasing percent ladder ending
    at 100 (a rollout that never reaches 100% would strand the fleet
    split across generations)."""
    steps: list[float] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        value = float(part)
        if not (0.0 < value <= 100.0):
            raise ValueError(
                f"canary step {part!r} must be in (0, 100] percent")
        if steps and value <= steps[-1]:
            raise ValueError(
                f"canary steps must increase: {part!r} after {steps[-1]}")
        steps.append(value)
    if not steps:
        raise ValueError("canary step ladder is empty")
    if steps[-1] != 100.0:
        raise ValueError("canary step ladder must end at 100")
    return steps


@dataclass
class RolloutPolicy:
    """Knob set mirrored by ``AI4E_ROLLOUT_*`` (docs/config.md)."""

    drain_timeout_ms: float = 30000.0   # per-worker drain budget
    canary_steps: str = "25,50,100"     # percent ladder (parse_steps)
    step_hold_s: float = 10.0           # clean-burn window per step
    guard_tick_s: float = 1.0           # burn sampling period in the hold
    burn_fast_max: float = 1.0          # fast-window burn bar
    burn_slow_max: float = 1.0          # slow-window burn bar
    drain_eject_ttl_s: float = 30.0     # placement eject TTL per drain mark

    @property
    def steps(self) -> list[float]:
        return parse_steps(self.canary_steps)

    @classmethod
    def from_config(cls, section) -> "RolloutPolicy":
        """Build from ``FrameworkConfig().rollout`` (config.py
        RolloutSection — the AI4E_ROLLOUT_* env surface)."""
        return cls(drain_timeout_ms=section.drain_timeout_ms,
                   canary_steps=section.canary_steps,
                   step_hold_s=section.step_hold_s,
                   guard_tick_s=section.guard_tick_s,
                   burn_fast_max=section.burn_fast_max,
                   burn_slow_max=section.burn_slow_max,
                   drain_eject_ttl_s=section.drain_eject_ttl_s)


@dataclass
class RolloutResult:
    outcome: str                        # "promoted" | "rolled_back"
    generation: int
    reason: str = ""
    upgraded: list = field(default_factory=list)
    reverted: list = field(default_factory=list)
    weight_history: list = field(default_factory=list)


class RolloutController:
    """One rollout of ``fleet`` from its current generation to
    ``generation``. The ``fleet`` adapter duck-types:

    - ``workers() -> list[str]``                 stable worker ids
    - ``await drain(worker) -> bool``            drain verb (bounded)
    - ``await upgrade(worker, generation)``      restart at generation
    - ``await revert(worker, generation)``       restart back (rollback)
    - ``await wait_healthy(worker) -> bool``     post-restart readiness
    - ``await set_split(generation, share)``     canary weight (0..1)
    - ``await burn(generation) -> {"fast": f, "slow": s}``
    - ``breaker_open(generation) -> bool``       canary breaker state
    - ``await stamp(event, reason)``             hop-ledger evidence
    """

    def __init__(self, fleet, generation: int,
                 old_generation: int | None = None,
                 policy: RolloutPolicy | None = None,
                 clock=time.monotonic):
        self.fleet = fleet
        self.generation = int(generation)
        self.old_generation = (int(old_generation)
                               if old_generation is not None
                               else self.generation - 1)
        self.policy = policy or RolloutPolicy()
        self._clock = clock

    async def run(self) -> RolloutResult:
        from ..observability.ledger import ROLLOUT
        policy = self.policy
        workers = list(self.fleet.workers())
        result = RolloutResult(outcome="promoted", generation=self.generation)
        await self.fleet.stamp(
            ROLLOUT, f"generation {self.generation} begin "
                     f"({len(workers)} workers, steps {policy.canary_steps})")
        for share_pct in policy.steps:
            # Upgrade enough workers — one at a time, drain first — that
            # the new generation can actually carry this step's share.
            target = max(1, math.ceil(share_pct / 100.0 * len(workers)))
            while len(result.upgraded) < target:
                worker = workers[len(result.upgraded)]
                clean = await self.fleet.drain(worker)
                await self.fleet.upgrade(worker, self.generation)
                healthy = await self.fleet.wait_healthy(worker)
                result.upgraded.append(worker)
                await self.fleet.stamp(
                    ROLLOUT,
                    f"{worker} -> generation {self.generation}"
                    + ("" if clean else " (drain timed out; stragglers "
                                        "redelivered)"))
                if not healthy:
                    await self._rollback(
                        result, f"{worker} unhealthy after upgrade")
                    return result
            await self.fleet.set_split(self.generation, share_pct / 100.0)
            result.weight_history.append(share_pct)
            await self.fleet.stamp(
                ROLLOUT, f"canary weight {share_pct:g}%")
            breach = await self._guard(policy.step_hold_s)
            if breach:
                await self._rollback(result, breach)
                return result
        await self.fleet.stamp(
            ROLLOUT, f"generation {self.generation} promoted")
        return result

    async def _guard(self, hold_s: float) -> str | None:
        """Hold the current weight for ``hold_s``, sampling the canary
        generation's burn + breaker state each tick; returns the breach
        reason, or None after a clean window."""
        policy = self.policy
        deadline = self._clock() + max(0.0, hold_s)
        while True:
            if self.fleet.breaker_open(self.generation):
                return "canary breaker open"
            burns = await self.fleet.burn(self.generation)
            fast = float(burns.get("fast", 0.0))
            slow = float(burns.get("slow", 0.0))
            # The multi-window shape: page (here: roll back) only when
            # BOTH windows burn — a blip doesn't roll back, a slow leak
            # doesn't hide (observability/slo.py).
            if fast > policy.burn_fast_max and slow > policy.burn_slow_max:
                return (f"canary burn fast={fast:.2f} slow={slow:.2f} "
                        f"over {policy.burn_fast_max:g}/"
                        f"{policy.burn_slow_max:g}")
            if self._clock() >= deadline:
                return None
            await asyncio.sleep(policy.guard_tick_s)

    async def _rollback(self, result: RolloutResult, reason: str) -> None:
        """Re-weight to the old generation, then drain + revert every
        upgraded replica via the existing restart/reload path."""
        from ..observability.ledger import ROLLBACK
        result.outcome, result.reason = "rolled_back", reason
        log.warning("rollout of generation %d rolling back: %s",
                    self.generation, reason)
        await self.fleet.set_split(self.generation, 0.0)
        await self.fleet.stamp(ROLLBACK, reason)
        for worker in list(result.upgraded):
            await self.fleet.drain(worker)
            await self.fleet.revert(worker, self.old_generation)
            await self.fleet.wait_healthy(worker)
            result.reverted.append(worker)
            await self.fleet.stamp(
                ROLLBACK, f"{worker} -> generation {self.old_generation}")
        await self.fleet.stamp(
            ROLLBACK, f"generation {self.generation} rolled back ({reason})")
