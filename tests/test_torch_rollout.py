"""The port's rollout controller (``ai4e_tpu_torch/rollout/controller.py``)
held against the JAX package's.

Both packages' ``RolloutController``s drive the same in-memory fleet: an
injected clock that moves one second a burn sample, scripted burn and
breaker series, and a record of every verb the controller issues (drain,
upgrade, revert, health wait, canary weight, ledger stamp). For a clean
promote, a bad canary that burns at the second step, a canary breaker
that opens, and a worker unhealthy after its upgrade, the two must issue
the same verbs in the same order and end with the same result at the
same step. ``parse_steps`` refuses the same ladders with the same words.
"""

from __future__ import annotations

import asyncio
import dataclasses

import pytest

import ai4e_tpu.rollout.controller as jax_controller
import ai4e_tpu_torch.rollout as port_rollout
import ai4e_tpu_torch.rollout.controller as port_controller

PACKAGES = {"jax": jax_controller, "port": port_controller}


class ScriptedFleet:
    """A fleet whose every verb is recorded. ``burns`` is the series of
    (fast, slow) samples the guard reads in order (the last repeats);
    ``breakers`` the series of breaker readings; ``unhealthy`` the
    workers whose post-upgrade health wait fails."""

    def __init__(self, n_workers: int, burns, breakers=(False,),
                 unhealthy=()):
        self._workers = [f"worker{i}" for i in range(n_workers)]
        self._burns = list(burns)
        self._breakers = list(breakers)
        self._unhealthy = set(unhealthy)
        self.upgraded: set[str] = set()
        self.now = 0.0
        self.verbs: list[tuple] = []

    def clock(self) -> float:
        return self.now

    def workers(self) -> list[str]:
        return list(self._workers)

    async def drain(self, worker: str) -> bool:
        self.verbs.append(("drain", worker))
        return True

    async def upgrade(self, worker: str, generation: int) -> None:
        self.upgraded.add(worker)
        self.verbs.append(("upgrade", worker, generation))

    async def revert(self, worker: str, generation: int) -> None:
        self.upgraded.discard(worker)
        self.verbs.append(("revert", worker, generation))

    async def wait_healthy(self, worker: str) -> bool:
        healthy = not (worker in self._unhealthy and worker in self.upgraded)
        self.verbs.append(("wait_healthy", worker, healthy))
        return healthy

    async def set_split(self, generation: int, share: float) -> None:
        self.verbs.append(("weight", generation, share))

    async def burn(self, generation: int) -> dict:
        fast, slow = (self._burns.pop(0) if len(self._burns) > 1
                      else self._burns[0])
        self.now += 1.0
        self.verbs.append(("burn", generation, fast, slow))
        return {"fast": fast, "slow": slow}

    def breaker_open(self, generation: int) -> bool:
        opened = (self._breakers.pop(0) if len(self._breakers) > 1
                  else self._breakers[0])
        self.verbs.append(("breaker", generation, opened))
        return opened

    async def stamp(self, event: str, reason: str) -> None:
        self.verbs.append(("stamp", event, reason))


SCENARIOS = {
    # Every window clean: each step holds 3 s, then 100%.
    "clean-promote": dict(n_workers=4, burns=[(0.2, 0.1)]),
    # The first step's window is clean; the second burns in both
    # windows at its second sample.
    "bad-canary": dict(n_workers=4,
                       burns=[(0.0, 0.0)] * 4 + [(0.5, 0.5), (3.0, 2.5)]),
    # A fast-only blip never rolls back; the breaker opening does.
    "breaker-opens": dict(n_workers=2, burns=[(5.0, 0.2)],
                          breakers=[False, False, True]),
    # The second worker does not come back healthy after its upgrade.
    "unhealthy-upgrade": dict(n_workers=3, burns=[(0.0, 0.0)],
                              unhealthy=("worker1",)),
}


def drive(pkg: str, scenario: str, steps: str = "25,50,100") -> dict:
    mod = PACKAGES[pkg]
    fleet = ScriptedFleet(**SCENARIOS[scenario])
    policy = mod.RolloutPolicy(canary_steps=steps, step_hold_s=3.0,
                               guard_tick_s=0.0, burn_fast_max=1.0,
                               burn_slow_max=1.0)
    controller = mod.RolloutController(fleet, generation=2, policy=policy,
                                       clock=fleet.clock)
    result = asyncio.run(controller.run())
    return {"result": dataclasses.asdict(result), "verbs": fleet.verbs,
            "clock": fleet.now}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_controllers_issue_the_same_verbs(scenario):
    got = {pkg: drive(pkg, scenario) for pkg in PACKAGES}
    assert got["port"] == got["jax"]
    result, verbs = got["port"]["result"], got["port"]["verbs"]
    stamps = [v[1] for v in verbs if v[0] == "stamp"]
    if scenario == "clean-promote":
        assert result["outcome"] == "promoted"
        assert result["weight_history"] == [25.0, 50.0, 100.0]
        assert result["upgraded"] == [f"worker{i}" for i in range(4)]
        assert "rollback" not in stamps
    else:
        assert result["outcome"] == "rolled_back"
        assert result["reverted"] == result["upgraded"]
        assert stamps.count("rollback") == 2 + len(result["upgraded"])
        # The rollback re-weights to the old generation first.
        first_back = verbs.index(("stamp", "rollback", result["reason"]))
        assert verbs[first_back - 1] == ("weight", 2, 0.0)
    want = {"bad-canary": (["worker0", "worker1"], [25.0, 50.0],
                           "canary burn fast=3.00 slow=2.50 over 1/1"),
            "breaker-opens": (["worker0"], [25.0], "canary breaker open"),
            "unhealthy-upgrade": (["worker0", "worker1"], [25.0],
                                  "worker1 unhealthy after upgrade")}
    if scenario in want:
        upgraded, weights, reason = want[scenario]
        assert (result["upgraded"], result["weight_history"],
                result["reason"]) == (upgraded, weights, reason)


def test_a_single_step_ladder_is_one_upgrade_wave():
    got = {pkg: drive(pkg, "clean-promote", steps="100") for pkg in PACKAGES}
    assert got["port"] == got["jax"]
    assert got["port"]["result"]["weight_history"] == [100.0]


@pytest.mark.parametrize("spec", [
    "", " , ", "0,100", "-5,100", "50,150", "50,50,100", "60,40,100",
    "25,50", "abc,100", "25,50,100", " 10 , 100 ", "100",
])
def test_parse_steps_refuses_with_jax_s_words(spec):
    def parse(mod):
        try:
            return mod.parse_steps(spec)
        except ValueError as exc:
            return f"{type(exc).__name__}: {exc}"

    assert parse(port_controller) == parse(jax_controller)


def test_the_package_exports_the_controller():
    for name in ("RolloutController", "RolloutPolicy", "RolloutResult",
                 "parse_steps"):
        assert getattr(port_rollout, name) is getattr(port_controller, name)
    assert (dataclasses.asdict(port_rollout.RolloutPolicy())
            == dataclasses.asdict(jax_controller.RolloutPolicy()))
