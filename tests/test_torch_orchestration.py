"""Deadline-aware orchestration in the port (``ai4e_tpu_torch/orchestration``)
against the JAX package's, mirroring ``tests/test_orchestration.py``: the
decayed quantile sketches, the completion estimator, placement (its six
outcomes, the canary branch, background restriction), the degradation
ladder under one fake clock, admission's brownout and its ladder feed, the
SLO engine's ladder feed, the predictive signal and scaler, the sharded
scaler's one actuator, the assembly's refusals and wiring, the gateway's
brownout answers, and one whole-platform scenario driven through JAX's
``LocalPlatform`` and the port's.

The two packages get the same inputs, one fake clock and equal
``random.Random`` streams, and are held equal: sketch answers and
estimates exactly, placement outcomes and chosen backends one by one,
ladder levels transition by transition, counters by label, and in the
whole-platform scenario terminal statuses and hop-ledger stamp sequences.
Nothing here sleeps to move a clock."""

import asyncio
import dataclasses
import random
import time

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu import orchestration as jax_orch
from ai4e_tpu import resilience as jax_res
from ai4e_tpu import scaling as jax_scaling
from ai4e_tpu.admission.controller import \
    AdmissionController as JaxAdmission
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu_torch import orchestration as port_orch
from ai4e_tpu_torch import resilience as port_res
from ai4e_tpu_torch import scaling as port_scaling
from ai4e_tpu_torch.admission.controller import AdmissionController
from ai4e_tpu_torch.admission.deadline import BACKGROUND, DEFAULT, INTERACTIVE
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
from ai4e_tpu_torch.taskstore import APITask, InMemoryTaskStore, TaskStatus

SIDES = {"jax": (jax_orch, jax_res, jax_scaling, JaxRegistry, JaxAdmission),
         "port": (port_orch, port_res, port_scaling, MetricsRegistry,
                  AdmissionController)}
ORCH_FAMILIES = ("ai4e_orchestration_placements", "ai4e_orchestration_ladder",
                 "ai4e_orchestration_brownout", "ai4e_resilience_",
                 "ai4e_rollout_drain")


def run(coro):
    return asyncio.run(coro)


async def serve(app):
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def series(registry, prefixes) -> dict:
    """``{"name{labels}": value}`` of every rendered sample whose family
    starts with one of ``prefixes``."""
    out = {}
    for line in registry.render_prometheus().splitlines():
        if line.startswith("#") or not line.startswith(tuple(prefixes)):
            continue
        key, value = line.rsplit(" ", 1)
        out[key] = float(value)
    return out


def health(side: str, clock=None, rng=None):
    _, res, _, registry, _ = SIDES[side]
    kw = {"clock": clock} if clock is not None else {}
    return res.BackendHealth(res.ResiliencePolicy(failure_threshold=2,
                                                  recovery_seconds=5.0),
                             metrics=registry(), rng=rng, **kw)


# -- decayed quantiles and the estimator -----------------------------------------

class TestDecayedQuantiles:
    def _trace(self, side, size, horizon, steps):
        clk = FakeClock()
        sk = SIDES[side][0].DecayedQuantiles(size=size, horizon_s=horizon,
                                             clock=clk)
        out = []
        for kind, value in steps:
            if kind == "t":
                clk.t = value
            elif kind == "obs":
                sk.observe(value)
            out.append((sk.count(), sk.quantile(0.5), sk.quantile(0.9),
                        sk.p_le(0.2), sk.p_le(1.0), sk.p_le(0.05)))
        return out

    def test_quantile_and_p_le_over_live_window(self):
        steps = [("obs", v) for v in (0.1, 0.2, 0.3, 0.4)]
        got = self._trace("port", 16, 10.0, steps)
        assert got == self._trace("jax", 16, 10.0, steps)
        assert got[-1][1] == 0.3 and got[-1][3] == 0.5

    def test_old_samples_age_out_of_queries(self):
        steps = [("obs", 5.0), ("t", 11.0), ("obs", 0.1), ("obs", -1.0)]
        got = self._trace("port", 16, 10.0, steps)
        assert got == self._trace("jax", 16, 10.0, steps)
        assert got[-1][:2] == (1, 0.1)

    @pytest.mark.parametrize("seed", range(4))
    def test_random_streams_match_jax(self, seed):
        rng = random.Random(seed)
        steps, t = [], 0.0
        for _ in range(200):
            if rng.random() < 0.2:
                t += rng.choice((0.5, 4.0, 30.0))
                steps.append(("t", t))
            else:
                steps.append(("obs", rng.choice((0.01, 0.05, 0.2, 0.5,
                                                 1.5, 3.0))))
        size = rng.choice((4, 16, 64))
        assert (self._trace("port", size, 20.0, steps)
                == self._trace("jax", size, 20.0, steps))


class TestCompletionEstimator:
    def _est(self, side, clock=None, **kw):
        mod, _, _, registry, _ = SIDES[side]
        h = health(side, clock=clock)
        extra = {"clock": clock} if clock is not None else {}
        return h, mod.CompletionEstimator(h, metrics=registry(), **kw,
                                          **extra)

    def test_empirical_probability(self):
        out = {}
        for side in SIDES:
            _, est = self._est(side)
            for v in (0.1, 0.1, 0.1, 0.9):
                est.observe("http://b", v)
            out[side] = (est.p_within("http://b", 0.5),
                         est.p_within("http://b", 1.0),
                         series(est.metrics,
                                ("ai4e_orchestration_backend_p50",)))
        assert out["port"] == out["jax"]
        assert out["port"][:2] == (0.75, 1.0)

    def test_open_breaker_is_zero_half_open_discounted(self):
        out = {}
        for side in SIDES:
            clk = FakeClock()
            h, est = self._est(side, clock=clk)
            for _ in range(4):
                est.observe("http://b", 0.01)
            h.record_failure("http://b")
            h.record_failure("http://b")
            trace = [est.p_within("http://b", 1.0)]
            clk.t = 6.0
            h.pick([("http://b", 1)])
            trace.append(est.p_within("http://b", 1.0))
            out[side] = trace
        assert out["port"] == out["jax"] == [0.0, 0.5]

    @pytest.mark.parametrize("cold_p", [1.0, 0.25])
    def test_cold_backend_answers_cold_prior(self, cold_p):
        for side in SIDES:
            _, est = self._est(side, cold_p=cold_p)
            assert est.p_within("http://new", 0.5) == cold_p

    def test_inflight_pressure_discounts_the_budget(self):
        out = {}
        for side in SIDES:
            _, est = self._est(side, parallelism=1)
            for _ in range(4):
                est.observe("http://b", 0.4)
            trace = [est.p_within("http://b", 0.5)]
            est.begin("http://b")
            trace.append(est.p_within("http://b", 0.5))
            est.end("http://b")
            trace.append(est.p_within("http://b", 0.5))
            est.end("http://b")
            trace.append(est.inflight("http://b"))
            out[side] = trace
        assert out["port"] == out["jax"] == [1.0, 0.0, 1.0, 0]

    def test_infinite_budget_always_clears_when_not_open(self):
        _, est = self._est("port")
        assert est.p_within("http://b", float("inf")) == 1.0


# -- placement -------------------------------------------------------------------

TPU = "http://tpu-1:9/v1/x"
CPU = "http://cpu-1:9/v1/x"
GPU = "http://gpu-1:9/v1/x"
BACKENDS = [(TPU, 1.0), (CPU, 1.0)]
COSTS = {"tpu": 3.0, "cpu": 1.0}


def orch(side: str, clock=None, rng=None, **policy_kw):
    mod, _, _, registry, _ = SIDES[side]
    clk = clock or FakeClock()
    policy = mod.OrchestrationPolicy(costs=dict(COSTS), **policy_kw)
    return mod.Orchestrator(health(side, clock=clk, rng=rng), policy=policy,
                            metrics=registry(), clock=clk)


def teach(o, uri, rtt, n=8):
    for _ in range(n):
        o.observe(uri, rtt)


def placed(o, backends, **kw) -> tuple:
    """The chosen backend and the outcome the placement reported."""
    seen = []
    chosen = o.place(backends, note=lambda outcome, uri: seen.append(
        (outcome, uri)), **kw)
    assert seen[0][1] == chosen
    return chosen, seen[0][0]


def both(setup, call):
    """``call`` on a JAX and a port orchestrator after the same ``setup``."""
    out = {}
    for side in SIDES:
        clk = FakeClock()
        o = orch(side, clock=clk, rng=random.Random(7))
        setup(o, clk)
        out[side] = (call(o, clk), series(o.metrics, ORCH_FAMILIES))
    assert out["port"] == out["jax"]
    return out["port"][0]


def _tpu_fast_cpu_slow(o, clk):
    teach(o, TPU, 0.01)
    teach(o, CPU, 2.0)


class TestPlacement:
    def test_no_deadline_takes_the_cheapest_tier(self):
        assert both(_tpu_fast_cpu_slow,
                    lambda o, c: placed(o, BACKENDS)) == (CPU, "confident")

    def test_tight_deadline_falls_through_to_the_fast_tier(self):
        assert both(_tpu_fast_cpu_slow, lambda o, c: placed(
            o, BACKENDS, deadline_at=time.time() + 1.0)) == (TPU,
                                                             "confident")

    def test_loose_deadline_stays_cheap(self):
        assert both(_tpu_fast_cpu_slow, lambda o, c: placed(
            o, BACKENDS, deadline_at=time.time() + 30.0)) == (CPU,
                                                              "confident")

    def test_nobody_clears_serves_best_p_and_notes_a_predicted_miss(self):
        def setup(o, clk):
            teach(o, TPU, 0.1, n=4)
            teach(o, TPU, 2.0, n=4)
            teach(o, CPU, 2.0)

        def call(o, clk):
            got = placed(o, BACKENDS, deadline_at=time.time() + 0.7)
            return got, o.ladder._miss.rate(0.0) > 0
        assert both(setup, call) == ((TPU, "fallback"), True)

    def test_exclude_reaches_a_different_backend(self):
        def setup(o, clk):
            teach(o, TPU, 0.01)
            teach(o, CPU, 0.01)
        assert both(setup, lambda o, c: (
            placed(o, BACKENDS, exclude=(CPU,)),
            placed(o, BACKENDS, exclude=(TPU,)),
            placed(o, BACKENDS, exclude=(TPU, CPU)))) == (
            (TPU, "confident"), (CPU, "confident"), (CPU, "confident"))

    def test_all_dark_delegates_to_the_forced_probe(self):
        def setup(o, clk):
            for uri in (TPU, CPU):
                o.health.record_failure(uri)
                o.health.record_failure(uri)
        chosen, outcome = both(setup, lambda o, c: placed(
            o, BACKENDS, deadline_at=time.time() + 1.0))
        assert outcome == "forced" and chosen in (TPU, CPU)

    def test_recovered_backend_gets_a_priority_probe(self):
        def setup(o, clk):
            teach(o, TPU, 0.01)
            teach(o, CPU, 0.01)
            o.health.record_failure(TPU)
            o.health.record_failure(TPU)
            clk.t = 6.0

        def call(o, clk):
            first = placed(o, BACKENDS, deadline_at=time.time() + 1.0)
            second = placed(o, BACKENDS, deadline_at=time.time() + 1.0)
            o.health.observe_status(TPU, 200)
            return first, second, o.health.state(TPU)
        assert both(setup, call) == ((TPU, "probe"), (CPU, "confident"),
                                     "closed")

    def test_open_backend_is_never_placed_on(self):
        def setup(o, clk):
            teach(o, CPU, 0.01)
            o.health.record_failure(CPU)
            o.health.record_failure(CPU)
        assert both(setup, lambda o, c: [placed(o, BACKENDS)
                                         for _ in range(5)]) == [
            (TPU, "confident")] * 5

    def test_brownout_restricts_background_to_the_cheap_tier(self):
        def setup(o, clk):
            teach(o, TPU, 0.01)
            teach(o, CPU, 0.05)
            o.ladder.level = 1
        assert both(setup, lambda o, c: (
            placed(o, BACKENDS, deadline_at=time.time() + 1.0,
                   priority=BACKGROUND),
            placed(o, BACKENDS, deadline_at=time.time() + 0.02,
                   priority=INTERACTIVE))) == ((CPU, "confident"),
                                               (TPU, "confident"))

    def test_equal_cost_tier_keeps_the_canary_split(self):
        pair = [(TPU, 9.0), (CPU, 1.0)]

        def setup(o, clk):
            o.policy.costs = {}
            teach(o, TPU, 0.01)
            teach(o, CPU, 0.01)

        def call(o, clk):
            rng = random.Random(7)
            return [o.place(pair, deadline_at=time.time() + 5.0, rng=rng)
                    for _ in range(300)]
        picks = both(setup, call)
        assert 10 <= picks.count(CPU) <= 90 < picks.count(TPU)

    def test_canary_split_and_drain_eject_in_placement(self):
        from ai4e_tpu.rollout.canary import CanaryWeights as JaxCanary
        from ai4e_tpu_torch.rollout.canary import CanaryWeights

        trio = [(TPU, 1.0), (GPU, 1.0), (CPU, 1.0)]
        out = {}
        for side, canary_cls in (("jax", JaxCanary),
                                 ("port", CanaryWeights)):
            clk = FakeClock()
            o = orch(side, clock=clk)
            o.policy.costs = {"cpu": 0.5}
            for uri in (TPU, GPU, CPU):
                teach(o, uri, 0.01)
            canary = canary_cls()
            canary.set_generation(TPU, 2)
            canary.set_split(2, 0.5)
            o.health.attach_canary(canary)
            rng = random.Random(5)
            picks = [o.place(trio, rng=rng) for _ in range(40)]
            o.health.mark_draining(CPU)
            picks += [o.place(trio, rng=rng) for _ in range(40)]
            out[side] = (picks, series(o.metrics, ORCH_FAMILIES))
        assert out["port"] == out["jax"]
        picks = out["port"][0]
        assert set(picks[:40]) == {CPU}
        assert set(picks[40:]) == {TPU, GPU}

    @pytest.mark.parametrize("seed", range(8))
    def test_random_placements_match_jax(self, seed):
        """Random sequences of RTT samples, in-flight counts, breaker
        outcomes, drain marks, ladder levels and placements with deadlines,
        classes and exclusions: the same backend and the same outcome,
        placement by placement, and the same counters."""
        uris = [TPU, CPU, GPU]
        rng = random.Random(seed)
        ops = []
        for _ in range(400):
            r = rng.random()
            uri = rng.choice(uris)
            if r < 0.3:
                ops.append(("obs", uri, rng.choice((0.01, 0.05, 0.2, 1.0))))
            elif r < 0.38:
                ops.append(("begin", uri))
            elif r < 0.45:
                ops.append(("end", uri))
            elif r < 0.5:
                ops.append(("fail", uri))
            elif r < 0.55:
                ops.append(("status", uri, rng.choice((200, 500, 503))))
            elif r < 0.58:
                ops.append(("drain", uri))
            elif r < 0.62:
                ops.append(("t", rng.choice((0.5, 2.0, 6.0))))
            elif r < 0.65:
                ops.append(("level", rng.randint(0, 4)))
            else:
                budget = rng.choice((None, 0.02, 0.1, 0.5, 3.0))
                backends = [(u, float(rng.randint(1, 3))) for u in uris
                            if rng.random() < 0.8] or [(TPU, 1.0)]
                exclude = tuple(u for u in uris if rng.random() < 0.15)
                ops.append(("place", backends, budget,
                            rng.choice((INTERACTIVE, DEFAULT, BACKGROUND)),
                            exclude))
        sides = {}
        for side in SIDES:
            clk = FakeClock()
            o = orch(side, clock=clk, rng=random.Random(seed))
            o.policy.costs = {"tpu": 3.0, "cpu": 1.0}
            sides[side] = (o, clk, random.Random(seed + 100))
        traces = {side: [] for side in SIDES}
        for op in ops:
            now = time.time()
            for side, (o, clk, prng) in sides.items():
                kind = op[0]
                if kind == "obs":
                    o.observe(op[1], op[2])
                elif kind == "begin":
                    if o.estimator.inflight(op[1]) < 3:
                        o.begin(op[1])
                elif kind == "end":
                    o.end(op[1])
                elif kind == "fail":
                    o.health.record_failure(op[1])
                elif kind == "status":
                    o.health.observe_status(op[1], op[2])
                elif kind == "drain":
                    o.health.mark_draining(op[1], ttl_s=3.0)
                elif kind == "t":
                    clk.t += op[1]
                elif kind == "level":
                    o.ladder.level = op[1]
                else:
                    _, backends, budget, priority, exclude = op
                    deadline = 0.0 if budget is None else now + budget
                    traces[side].append(placed(
                        o, backends, deadline_at=deadline, priority=priority,
                        rng=prng, exclude=exclude))
        assert traces["port"] == traces["jax"]
        assert len({outcome for _, outcome in traces["port"]}) >= 3
        assert (series(sides["port"][0].metrics, ORCH_FAMILIES)
                == series(sides["jax"][0].metrics, ORCH_FAMILIES))

    @pytest.mark.parametrize("spec", ["tpu=3, cpu-fallback=1", None, "",
                                      "tpu", "a=1,,b=2.5"])
    def test_parse_costs_as_jax(self, spec):
        try:
            want = jax_orch.parse_costs(spec)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                port_orch.parse_costs(spec)
            assert str(got.value) == str(exc)
            return
        assert port_orch.parse_costs(spec) == want

    def test_policy_defaults_are_jax_s(self):
        assert ([(f.name, f.default) for f in
                 dataclasses.fields(port_orch.OrchestrationPolicy)
                 if f.name != "costs"]
                == [(f.name, f.default) for f in
                    dataclasses.fields(jax_orch.OrchestrationPolicy)
                    if f.name != "costs"])


# -- the degradation ladder ------------------------------------------------------

def ladder(side, clk, **kw):
    mod, _, _, registry, _ = SIDES[side]
    defaults = dict(up=0.5, down=0.1, hold_s=5.0, min_rate=0.05, tau_s=5.0,
                    metrics=registry(), clock=clk)
    defaults.update(kw)
    return mod.DegradationLadder(**defaults)


def ladder_trace(side, script, **kw):
    """Run ``script(ladder, clock, log)`` and return its log and the
    ladder's counters."""
    clk = FakeClock()
    lad = ladder(side, clk, **kw)
    log = []
    script(lad, clk, log)
    return log, series(lad.metrics, ORCH_FAMILIES)


def both_ladders(script, **kw):
    got = ladder_trace("port", script, **kw)
    assert got == ladder_trace("jax", script, **kw)
    return got[0]


class TestDegradationLadder:
    def test_steps_up_only_after_sustained_pressure(self):
        def script(lad, clk, log):
            for t in (0.0, 1.0, 2.0, 3.0, 6.0):
                clk.t = t
                lad.note(miss=True)
                log.append((t, lad.level, lad.mode))
        log = both_ladders(script)
        assert log[3][1] == 0 and log[4][1:] == (1, "reroute_background")

    def test_one_level_per_hold_window(self):
        def script(lad, clk, log):
            for t in range(30):
                clk.t = float(t)
                lad.note(miss=True)
                log.append(lad.level)
        log = both_ladders(script)
        assert 2 <= log[-1] <= 6
        assert all(b - a <= 1 for a, b in zip(log, log[1:]))

    def test_steps_down_hysteretically_when_pressure_clears(self):
        def script(lad, clk, log):
            for t in range(12):
                clk.t = float(t)
                lad.note(miss=True)
            log.append(lad.level)
            clk.t = 12.1
            lad.note(miss=False)
            log.append(lad.level)
            for i in range(200):
                clk.t = 12.0 + i * 0.1
                lad.note(miss=False)
                log.append(lad.level)
        log = both_ladders(script)
        assert log[0] >= 1 and log[1] == log[0] and log[-1] < log[0]

    def test_idle_platform_decays_back_to_normal(self):
        def script(lad, clk, log):
            for t in range(12):
                clk.t = float(t)
                lad.note(miss=True)
                lad.note(miss=True)
            log.append(lad.level)
            for t in range(100):
                clk.t = 12.0 + t
                log.append(lad.evaluate())
        log = both_ladders(script, min_rate=0.5)
        assert log[0] >= 1 and log[-1] == 0

    def test_refusals_by_level(self):
        def script(lad, clk, log):
            for level in range(5):
                lad.level = level
                log.append([lad.refuse(p) for p in (INTERACTIVE, DEFAULT,
                                                    BACKGROUND)])
        log = both_ladders(script)
        assert log == [
            [None, None, None], [None, None, None],
            [None, None, "shed_background"],
            [None, "shed_default", "shed_default"],
            ["shed_interactive"] * 3]

    def test_full_brownout_unwedges_on_refusal_consults(self):
        def script(lad, clk, log):
            lad.level = 4
            for t in range(300):
                clk.t = float(t)
                log.append((lad.refuse(INTERACTIVE), lad.level))
        log = both_ladders(script, min_rate=0.5)
        assert log[0] == ("shed_interactive", 4) and log[-1] == (None, 0)

    @pytest.mark.parametrize("seed", range(6))
    def test_random_evidence_matches_jax(self, seed):
        rng = random.Random(seed)
        steps = [(rng.choice(("miss", "ok", "batch", "eval", "refuse")),
                  rng.choice((0.1, 0.5, 1.0, 3.0)), rng.randint(1, 40))
                 for _ in range(400)]

        def script(lad, clk, log):
            for kind, dt, n in steps:
                clk.t += dt
                if kind == "miss":
                    lad.note(miss=True)
                elif kind == "ok":
                    lad.note(miss=False)
                elif kind == "batch":
                    lad.note(miss=n % 2 == 0, n=float(n))
                elif kind == "eval":
                    lad.evaluate()
                else:
                    log.append(lad.refuse(n % 3))
                log.append((lad.level, round(lad.pressure(), 12)))
        log = both_ladders(script, up=0.3, down=0.1, hold_s=2.0,
                           min_rate=1.0, tau_s=10.0)
        assert len({entry[0] for entry in log
                    if isinstance(entry, tuple)}) >= 2

    @pytest.mark.parametrize("up,down", [(0.1, 0.3), (0.3, 0.3),
                                         (1.5, 0.1), (0.3, -0.1)])
    def test_threshold_validation(self, up, down):
        with pytest.raises(ValueError) as want:
            jax_orch.DegradationLadder(up=up, down=down,
                                       metrics=JaxRegistry())
        with pytest.raises(ValueError) as got:
            port_orch.DegradationLadder(up=up, down=down,
                                        metrics=MetricsRegistry())
        assert str(got.value) == str(want.value)

    def test_levels_are_the_documented_five(self):
        assert port_orch.LEVELS == jax_orch.LEVELS == (
            "normal", "reroute_background", "shed_background",
            "shed_default", "shed_interactive")


# -- admission's brownout and its ladder feed ------------------------------------

def admission_with_ladder(side, level):
    mod, _, _, registry, adm_cls = SIDES[side]
    adm = adm_cls(metrics=registry())
    lad = ladder(side, FakeClock())
    lad.level = level
    adm.set_ladder(lad)
    return adm


class TestAdmissionBrownout:
    @pytest.mark.parametrize("level", range(5))
    def test_shed_async_refuses_brownout_first(self, level):
        out = {}
        for side in SIDES:
            adm = admission_with_ladder(side, level)
            out[side] = [(d[1] if d else None) for d in (
                adm.shed_async(p, backlog=b)
                for p in (INTERACTIVE, DEFAULT, BACKGROUND)
                for b in (0, 700, 1100))]
        assert out["port"] == out["jax"]
        assert ("brownout" in out["port"]) == (level >= 2)

    def test_brownout_refusal_for_the_sync_proxy(self):
        adm = admission_with_ladder("port", 4)
        retry_after, mode = adm.brownout_refusal(INTERACTIVE)
        assert retry_after >= 1.0 and mode == "shed_interactive"
        assert AdmissionController(
            metrics=MetricsRegistry()).brownout_refusal(INTERACTIVE) is None

    def test_arrival_rate_counts_created_tasks_only(self):
        adm = AdmissionController(metrics=MetricsRegistry())
        store = InMemoryTaskStore()
        adm.attach_store(store)
        t = store.upsert(APITask(endpoint="/v1/x", publish=False))
        assert adm.arrival_rate() > 0
        before = adm._arrivals.rate()
        store.update_status(t.task_id, "Awaiting service availability",
                            "created")
        store.update_status(t.task_id, "completed", "completed")
        assert adm._arrivals.rate() <= before

    def test_per_route_rates_do_not_cross_routes(self):
        adm = AdmissionController(metrics=MetricsRegistry())
        store = InMemoryTaskStore()
        adm.attach_store(store)
        for _ in range(5):
            t = store.upsert(APITask(endpoint="/v1/flooded/x",
                                     publish=False))
            store.update_status(t.task_id, "completed", "completed")
        assert adm.arrival_rate(route="/v1/flooded/x") > 0
        assert adm.route_drain_rate("/v1/flooded/x") > 0
        assert adm.arrival_rate(route="/v1/idle/x") == 0.0
        assert adm.route_drain_rate("/v1/idle/x") == 0.0
        assert adm.metrics.gauge("ai4e_admission_arrival_rate",
                                 "").value() > 0

    def test_terminal_outcomes_feed_the_ladder(self):
        from ai4e_tpu.taskstore import APITask as JaxTask
        from ai4e_tpu.taskstore import InMemoryTaskStore as JaxStore

        out = {}
        for side, store_cls, task_cls in (("jax", JaxStore, JaxTask),
                                          ("port", InMemoryTaskStore,
                                           APITask)):
            adm = admission_with_ladder(side, 0)
            lad = adm._ladder
            store = store_cls()
            adm.attach_store(store)
            trace = []
            for deadline, status, backend in (
                    (-5.0, "completed", "completed"),
                    (60.0, "completed", "completed"),
                    (-1.0, "expired - deadline", "expired"),
                    (0.0, "completed", "completed"),
                    (0.0, "failed", "failed")):
                t = store.upsert(task_cls(
                    endpoint="/v1/x", publish=False,
                    deadline_at=time.time() + deadline if deadline else 0.0))
                store.update_status(t.task_id, status, backend)
                trace.append((lad._miss.rate(0.0), lad._total.rate(0.0)))
            out[side] = trace
        assert out["port"] == out["jax"]
        miss = [m for m, _ in out["port"]]
        assert miss[0] > 0 and miss[1] == miss[0] and miss[2] > miss[1]

    def test_journaled_store_feeds_the_ladder(self, tmp_path):
        """The journaled store's listeners feed it as the in-memory one's
        do; its replay fires none, so a restarted ladder starts at 0."""
        from ai4e_tpu_torch.taskstore.store import FollowerTaskStore

        adm = admission_with_ladder("port", 0)
        store = FollowerTaskStore(str(tmp_path / "j.jsonl"),
                                  start_as_primary=True)
        adm.attach_store(store)
        for deadline in (-1.0, -1.0, 60.0):
            t = store.upsert(APITask(endpoint="/v1/x", publish=False,
                                     deadline_at=time.time() + deadline))
            store.update_status(t.task_id, "completed", "completed")
        lad = adm._ladder
        assert lad._miss.rate(0.0) == pytest.approx(2 / lad._miss.tau)
        assert lad._total.rate(0.0) == pytest.approx(3 / lad._total.tau)
        store.close()
        again = admission_with_ladder("port", 0)
        restored = FollowerTaskStore(str(tmp_path / "j.jsonl"),
                                     start_as_primary=True)
        again.attach_store(restored)
        assert len(restored.replayed_task_ids) == 3
        assert again._ladder._total.rate(0.0) == 0.0
        restored.close()

    def test_sharded_store_feeds_the_ladder_from_every_shard(self):
        from ai4e_tpu_torch.taskstore.sharding import ShardedTaskStore

        adm = admission_with_ladder("port", 0)
        store = ShardedTaskStore(4)
        adm.attach_store(store)
        shards = set()
        for _ in range(40):
            t = store.upsert(APITask(endpoint="/v1/x", publish=False,
                                     deadline_at=time.time() - 1.0))
            shards.add(store.shard_for(t.task_id))
            store.update_status(t.task_id, "completed", "completed")
        assert shards == {0, 1, 2, 3}
        assert adm._ladder._miss.rate(0.0) == pytest.approx(
            40 / adm._ladder._miss.tau)


class TestWirePriority:
    """``APITask.from_dict`` reads ``Priority`` 0 back as 1 in both
    packages: a task that went through the store's wire is placed and
    refused as the default class, alike."""

    def _wired(self, side):
        if side == "jax":
            from ai4e_tpu.taskstore import APITask as task_cls
        else:
            task_cls = APITask
        task = task_cls(endpoint="/v1/x", priority=INTERACTIVE)
        return task_cls.from_dict(task.to_dict())

    def test_priority_zero_reads_back_as_default(self):
        assert self._wired("port").priority == self._wired(
            "jax").priority == DEFAULT

    @pytest.mark.parametrize("level", range(5))
    def test_wired_task_is_refused_and_placed_alike(self, level):
        out = {}
        for side in SIDES:
            wired = self._wired(side)
            clk = FakeClock()
            o = orch(side, clock=clk, rng=random.Random(1))
            teach(o, TPU, 0.01)
            teach(o, CPU, 0.05)
            o.ladder.level = level
            out[side] = (o.ladder.refuse(wired.priority),
                         placed(o, BACKENDS, priority=wired.priority,
                                deadline_at=time.time() + 0.02))
        assert out["port"] == out["jax"]
        assert out["port"][0] == (None if level < 3 else
                                  "shed_default" if level == 3
                                  else "shed_interactive")


# -- the SLO engine's ladder feed --------------------------------------------------

class TestSloLadder:
    def test_breaches_feed_the_ladder_as_jax_s(self):
        from ai4e_tpu.observability import slo as jax_slo
        from ai4e_tpu_torch.observability import slo as port_slo

        out = {}
        for side, slo_mod in (("jax", jax_slo), ("port", port_slo)):
            registry = SIDES[side][3]()
            clk = FakeClock()
            lad = ladder(side, clk, up=0.3, hold_s=2.0, min_rate=1.0)
            engine = slo_mod.SloEngine(
                slo_mod.parse_objectives("/v1/x=goodput:99"),
                metrics=registry, fast_window_s=10.0, slow_window_s=30.0,
                tick_s=1.0, clock=clk)
            engine.attach_ladder(lad)
            outcomes = registry.counter(slo_mod.OUTCOMES_COUNTER, "")
            trace = []
            for t in range(40):
                clk.t = float(t)
                outcomes.inc(20, route="/v1/x",
                             outcome="ok" if t >= 25 else "late")
                engine.tick(now=clk.t)
                trace.append((lad.level, lad._miss.rate(clk.t),
                              lad._total.rate(clk.t)))
            out[side] = trace
        assert out["port"] == out["jax"]
        assert max(level for level, *_ in out["port"]) >= 2


# -- predictive scaling ----------------------------------------------------------

class FakeTarget:
    def __init__(self, replicas=1):
        self._n = replicas

    @property
    def replicas(self):
        return self._n

    def scale_to(self, n):
        self._n = n


class RampSim:
    """The JAX test's deterministic overload ramp: arrivals climb past
    capacity; each replica drains 5 tasks a second; a task misses its 2 s
    deadline when the backlog at its arrival exceeds 2 s of drain."""

    PER_REPLICA = 5.0
    DEADLINE_S = 2.0

    def __init__(self, rate_cls):
        self.arrivals = rate_cls(tau_s=5.0)
        self.drains = rate_cls(tau_s=5.0)
        self.depth = 0.0

    @staticmethod
    def arrival_at(t: float) -> float:
        return 2.0 if t < 10 else min(20.0, 2.0 + 2.0 * (t - 10))

    def step(self, t: float, replicas: int) -> bool:
        arrival = self.arrival_at(t)
        capacity = replicas * self.PER_REPLICA
        processed = min(self.depth + arrival, capacity)
        self.depth = self.depth + arrival - processed
        self.arrivals.on_event(n=arrival, now=t)
        if processed:
            self.drains.on_event(n=processed, now=t)
        wait = self.depth / capacity if capacity else float("inf")
        return wait > self.DEADLINE_S


class TestPredictiveSignal:
    @pytest.mark.parametrize("depth,arrival,drain", [
        (4.0, 12.0, 2.0), (4.0, 1.0, 9.0), (0.0, 0.0, 0.0),
        (7.5, 3.25, 3.0)])
    def test_projection_math(self, depth, arrival, drain):
        got = port_scaling.predictive_signal(
            lambda: depth, lambda: arrival, lambda: drain, horizon_s=10.0)()
        assert got == jax_scaling.predictive_signal(
            lambda: depth, lambda: arrival, lambda: drain, horizon_s=10.0)()
        assert got == depth + max(0.0, arrival - drain) * 10.0


class TestPredictiveScaler:
    POLICY = dict(min_replicas=1, max_replicas=20, target_per_replica=10.0,
                  stabilization_seconds=30.0)

    def _drive(self, side, predictive: bool) -> tuple:
        from ai4e_tpu.admission.controller import DecayingRate as JaxRate
        from ai4e_tpu_torch.admission.controller import DecayingRate

        scaling = SIDES[side][2]
        sim = RampSim(JaxRate if side == "jax" else DecayingRate)
        clk = FakeClock()
        target = FakeTarget()
        signal = (scaling.predictive_signal(
            lambda: sim.depth, lambda: sim.arrivals.rate(clk.t),
            lambda: sim.drains.rate(clk.t), horizon_s=10.0)
            if predictive else (lambda: sim.depth))
        ctrl = scaling.AutoscaleController(
            None, "/v1/x", target,
            policy=scaling.AutoscalePolicy(**self.POLICY), signal=signal,
            metrics=SIDES[side][3](), clock=clk)
        replicas, first_up, first_miss = [], None, None
        for t in range(60):
            clk.t = float(t)
            if sim.step(float(t), target.replicas) and first_miss is None:
                first_miss = float(t)
            before = target.replicas
            ctrl.tick()
            if target.replicas > before and first_up is None:
                first_up = float(t)
            replicas.append(target.replicas)
        return replicas, first_up, first_miss

    @pytest.mark.parametrize("predictive", [True, False],
                             ids=["predictive", "depth_only"])
    def test_trajectories_match_jax(self, predictive):
        assert (self._drive("port", predictive)
                == self._drive("jax", predictive))

    def test_scales_up_before_the_first_deadline_miss(self):
        from ai4e_tpu_torch.admission.controller import DecayingRate

        sim = RampSim(DecayingRate)
        baseline_miss = next(float(t) for t in range(60)
                             if sim.step(float(t), replicas=1))
        _, first_up, first_miss = self._drive("port", predictive=True)
        assert first_up is not None and first_up < baseline_miss
        assert first_miss is None or first_up < first_miss

    def test_predictive_beats_depth_only(self):
        _, pred_up, _ = self._drive("port", True)
        _, react_up, _ = self._drive("port", False)
        assert pred_up is not None and react_up is not None
        assert pred_up <= react_up


class TestShardScaleTarget:
    class D:
        def __init__(self, n=1):
            self.concurrency = n

        def set_concurrency(self, n):
            self.concurrency = n

    @pytest.mark.parametrize("n,shards", [(8, 3), (0, 2), (5, 5), (1, 4),
                                          (-3, 2)])
    def test_even_split_with_remainder_low(self, n, shards):
        out = {}
        for side in SIDES:
            ds = [self.D() for _ in range(shards)]
            target = SIDES[side][2].ShardScaleTarget(ds)
            target.scale_to(n)
            out[side] = ([d.concurrency for d in ds], target.replicas)
        assert out["port"] == out["jax"]
        assert out["port"][1] == max(0, n)

    def test_per_shard_decisions_one_actuator(self):
        out = {}
        for side in SIDES:
            scaling = SIDES[side][2]
            ds = [self.D(), self.D()]
            clk = FakeClock()
            signals = {"hot": 40.0, "cold": 1.0}
            ctrl = scaling.ShardedAutoscaleController(
                [("/q#s0", lambda: signals["hot"]),
                 ("/q#s1", lambda: signals["cold"])],
                scaling.ShardScaleTarget(ds),
                policy=scaling.AutoscalePolicy(**TestPredictiveScaler.POLICY),
                metrics=SIDES[side][3](), clock=clk)
            trace = []
            for t, hot in enumerate((40.0, 40.0, 80.0, 5.0, 1.0, 0.0)):
                clk.t = float(t * 20)
                signals["hot"] = hot
                ctrl.tick()
                trace.append([d.concurrency for d in ds])
            out[side] = (trace, series(ctrl.metrics, ("ai4e_autoscale_",)))
        assert out["port"] == out["jax"]
        assert out["port"][0][0][0] > 1 and out["port"][0][0][1] == 1

    def test_misaligned_signals_refused(self):
        with pytest.raises(ValueError) as want:
            jax_scaling.ShardedAutoscaleController(
                [("/q#s0", lambda: 0.0)],
                jax_scaling.ShardScaleTarget([self.D(), self.D()]),
                metrics=JaxRegistry())
        with pytest.raises(ValueError) as got:
            port_scaling.ShardedAutoscaleController(
                [("/q#s0", lambda: 0.0)],
                port_scaling.ShardScaleTarget([self.D(), self.D()]),
                metrics=MetricsRegistry())
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="at least one"):
            port_scaling.ShardScaleTarget([])


# -- the assembly ----------------------------------------------------------------

def jax_refusal(config_kw: dict, autoscale: bool = False) -> str:
    from ai4e_tpu.platform_assembly import LocalPlatform as JaxPlatform
    from ai4e_tpu.platform_assembly import PlatformConfig as JaxConfig
    from ai4e_tpu.scaling import AutoscalePolicy as JaxPolicy

    with pytest.raises(ValueError) as want:
        p = JaxPlatform(JaxConfig(**config_kw), metrics=JaxRegistry())
        if autoscale:
            p.publish_async_api("/v1/p/x", "http://b:1/v1/p/x",
                                autoscale=JaxPolicy())
    return str(want.value)


REFUSALS = {
    "orchestration_alone": dict(orchestration=True),
    "orchestration_without_resilience": dict(orchestration=True,
                                             admission=True),
    "orchestration_without_admission": dict(orchestration=True,
                                            resilience=True),
    "slo_ladder_alone": dict(slo_ladder=True),
    "slo_ladder_without_orchestration": dict(
        slo_ladder=True, observability=True,
        slo_objectives="/v1/x=goodput:99"),
    "slo_ladder_without_objectives": dict(
        slo_ladder=True, orchestration=True, admission=True,
        resilience=True),
    "orchestration_on_the_native_store": dict(
        orchestration=True, admission=True, resilience=True,
        native_store=True),
}


class TestAssembly:
    @pytest.mark.parametrize("name", list(REFUSALS))
    def test_refusals_are_jax_s_words(self, name):
        kw = REFUSALS[name]
        with pytest.raises(ValueError) as got:
            LocalPlatform(PlatformConfig(**kw), metrics=MetricsRegistry())
        assert str(got.value) == jax_refusal(kw)

    def test_sharded_autoscale_is_refused_only_without_orchestration(self):
        kw = dict(task_shards=2)
        p = LocalPlatform(PlatformConfig(**kw), metrics=MetricsRegistry())
        with pytest.raises(ValueError) as got:
            p.publish_async_api("/v1/p/x", "http://b:1/v1/p/x",
                                autoscale=port_scaling.AutoscalePolicy())
        assert str(got.value) == jax_refusal(kw, autoscale=True)
        p2 = LocalPlatform(PlatformConfig(
            task_shards=2, orchestration=True, admission=True,
            resilience=True), metrics=MetricsRegistry())
        p2.publish_async_api("/v1/p/x", "http://b:1/v1/p/x",
                             autoscale=port_scaling.AutoscalePolicy())
        (ctrl,) = p2.autoscalers
        assert isinstance(ctrl, port_scaling.ShardedAutoscaleController)
        assert [name for name, _ in ctrl.shards] == ["/v1/p/x#s0",
                                                     "/v1/p/x#s1"]
        ctrl.tick()

    def test_sharded_scaler_reads_each_shard_at_every_tick(self):
        """The depth each shard's signal reads is the shard's store at the
        tick: after a promotion the replica's, not the dead primary's."""
        p = LocalPlatform(PlatformConfig(
            task_shards=2, orchestration=True, admission=True,
            resilience=True), metrics=MetricsRegistry())
        p.publish_async_api("/v1/p/x", "http://b:1/v1/p/x",
                            autoscale=port_scaling.AutoscalePolicy())
        (ctrl,) = p.autoscalers
        # Rates at 0: the signal is the depth alone.
        p.admission.arrival_rate = lambda route=None: 0.0
        p.admission.route_drain_rate = lambda route: 0.0
        stores = p.store.shard_stores()
        for _ in range(20):
            p.store.upsert(APITask(endpoint="/v1/p/x", publish=False))
        depths = [signal() for _, signal in ctrl.shards]
        assert sum(depths) == 20
        swapped = InMemoryTaskStore()
        p.store.shard_stores = lambda: [swapped, stores[1]]
        assert ctrl.shards[0][1]() == 0.0
        assert ctrl.shards[1][1]() == depths[1]

    def test_orchestration_off_is_identity(self):
        platform = LocalPlatform(PlatformConfig(), metrics=MetricsRegistry())
        assert platform.orchestration is None
        assert platform.gateway._orchestration is None
        platform.publish_async_api("/v1/p/x", "http://b:1/v1/p/x")
        assert platform.dispatchers.dispatchers[
            "/v1/p/x"].orchestration is None
        p2 = LocalPlatform(PlatformConfig(admission=True, resilience=True),
                           metrics=MetricsRegistry())
        assert p2.orchestration is None and p2.admission._ladder is None

    def test_orchestration_assembly_wires_everything(self):
        platform = LocalPlatform(
            PlatformConfig(orchestration=True, admission=True,
                           resilience=True, observability=True,
                           slo_objectives="/v1/x=goodput:99",
                           slo_ladder=True,
                           orchestration_costs="tpu=3,cpu=1"),
            metrics=MetricsRegistry())
        platform.publish_async_api("/v1/p/x", "http://b:1/v1/p/x")
        d = platform.dispatchers.dispatchers["/v1/p/x"]
        assert d.orchestration is platform.orchestration
        assert d.resilience is platform.resilience
        assert platform.gateway._orchestration is platform.orchestration
        assert platform.admission._ladder is platform.orchestration.ladder
        assert platform.slo._ladder is platform.orchestration.ladder
        assert platform.orchestration.health is platform.resilience
        assert platform.orchestration.cost_of("http://tpu-9") == 3.0
        assert platform.orchestration.cost_of("http://other") == 1.0

    def test_unsharded_autoscale_gets_the_predictive_signal(self):
        p = LocalPlatform(
            PlatformConfig(orchestration=True, admission=True,
                           resilience=True), metrics=MetricsRegistry())
        p.publish_async_api("/v1/p/x", "http://b:1/v1/p/x",
                            autoscale=port_scaling.AutoscalePolicy())
        ctrl = p.autoscalers[0]
        assert ctrl.signal != ctrl._default_signal
        for _ in range(3):
            p.store.upsert(APITask(endpoint="/v1/p/x", publish=False))
        assert ctrl.signal() >= 3.0
        ctrl.tick()
        plain = LocalPlatform(PlatformConfig(), metrics=MetricsRegistry())
        plain.publish_async_api("/v1/p/x", "http://b:1/v1/p/x",
                                autoscale=port_scaling.AutoscalePolicy())
        assert plain.autoscalers[0].signal == plain.autoscalers[
            0]._default_signal

    def test_env_knobs_round_trip(self):
        from ai4e_tpu_torch.config import FrameworkConfig

        env = {"AI4E_PLATFORM_ORCHESTRATION": "1",
               "AI4E_PLATFORM_ADMISSION": "1",
               "AI4E_PLATFORM_RESILIENCE": "1",
               "AI4E_PLATFORM_ORCHESTRATION_CONFIDENCE": "0.9",
               "AI4E_PLATFORM_ORCHESTRATION_WINDOW": "64",
               "AI4E_PLATFORM_ORCHESTRATION_HORIZON_S": "30",
               "AI4E_PLATFORM_ORCHESTRATION_COSTS": "tpu=3,cpu=1",
               "AI4E_PLATFORM_ORCHESTRATION_LADDER_UP": "0.4",
               "AI4E_PLATFORM_ORCHESTRATION_LADDER_DOWN": "0.05",
               "AI4E_PLATFORM_ORCHESTRATION_LADDER_HOLD_S": "2.5",
               "AI4E_PLATFORM_ORCHESTRATION_SCALE_HORIZON_S": "15"}
        p = LocalPlatform(FrameworkConfig.from_env(env).to_platform_config(),
                          metrics=MetricsRegistry())
        pol = p.orchestration.policy
        assert (pol.confidence, pol.window, pol.horizon_s, pol.costs,
                pol.ladder_up, pol.ladder_down, pol.ladder_hold_s,
                pol.scale_horizon_s) == (0.9, 64, 30.0,
                                         {"tpu": 3.0, "cpu": 1.0}, 0.4, 0.05,
                                         2.5, 15.0)
        lad = p.orchestration.ladder
        assert (lad.up, lad.down, lad.hold_s) == (0.4, 0.05, 2.5)

    def test_orchestration_metrics_land_in_the_assembly_registry(self):
        reg = MetricsRegistry()
        platform = LocalPlatform(
            PlatformConfig(orchestration=True, admission=True,
                           resilience=True), metrics=reg)
        platform.publish_async_api("/v1/p/x", "http://b:1/v1/p/x")
        platform.orchestration.place(
            platform.dispatchers.dispatchers["/v1/p/x"].backends)
        rendered = reg.render_prometheus()
        assert "ai4e_orchestration_placements_total" in rendered
        assert "ai4e_orchestration_ladder_level" in rendered

    def test_the_layers_import_and_assemble_without_torch_or_jax(self):
        """The control plane's process imports neither torch nor JAX, with
        resilience, orchestration and a sharded autoscale route on."""
        import os
        import subprocess
        import sys

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = (
            "import sys\n"
            "for name in ('torch', 'jax', 'jaxlib', 'flax', 'ai4e_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import ai4e_tpu_torch.resilience, ai4e_tpu_torch.orchestration\n"
            "from ai4e_tpu_torch.cli import build_control_plane\n"
            "from ai4e_tpu_torch.config import FrameworkConfig\n"
            "env = {'AI4E_PLATFORM_' + k: '1' for k in (\n"
            "    'ADMISSION', 'RESILIENCE', 'ORCHESTRATION')}\n"
            "env['AI4E_PLATFORM_TASK_SHARDS'] = '2'\n"
            "p = build_control_plane(FrameworkConfig.from_env(env), {'apis': [\n"
            "    {'prefix': '/v1/a', 'backend': 'http://w/v1/m/a',\n"
            "     'autoscale': {'max_replicas': 4}}]})\n"
            "print(type(p.autoscalers[0]).__name__)\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["ShardedAutoscaleController"]

    def test_startup_line_names_resilience_and_orchestration(self, tmp_path):
        """The control plane's startup line says what JAX's says."""
        import json
        import os
        import signal
        import socket
        import subprocess
        import sys

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        routes = tmp_path / "routes.json"
        routes.write_text(json.dumps({"apis": [
            {"prefix": "/v1/a", "backend": "http://127.0.0.1:9/v1/m/a"}]}))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {**os.environ, "PYTHONPATH": root,
               "AI4E_PLATFORM_ADMISSION": "1",
               "AI4E_PLATFORM_RESILIENCE": "1",
               "AI4E_PLATFORM_ORCHESTRATION": "1"}
        log_path = tmp_path / "cp.log"
        with open(log_path, "wb") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ai4e_tpu_torch", "control-plane",
                 "--routes", str(routes), "--port", str(port)],
                cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                text = log_path.read_text(errors="replace")
                if "control plane on" in text or proc.poll() is not None:
                    break
                time.sleep(0.1)
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=30)
        line = next(x for x in log_path.read_text().splitlines()
                    if "control plane on" in x)
        assert ("admission control ON, resilience ON, orchestration ON"
                in line), line


# -- the gateway's brownout --------------------------------------------------------

def orch_platform(**extra) -> LocalPlatform:
    return LocalPlatform(PlatformConfig(
        orchestration=True, admission=True, resilience=True,
        retry_delay=0.01, resilience_retry_base_s=0.001, **extra),
        metrics=MetricsRegistry())


class TestGatewayBrownout:
    def test_async_edge_sheds_brownout_with_reason(self):
        async def main():
            platform = orch_platform()
            platform.publish_async_api("/v1/pub/x", "http://b:1/v1/be/x")
            platform.orchestration.ladder.level = 2
            gw = await serve(platform.gateway.app)
            try:
                resp = await gw.post("/v1/pub/x", data=b"p",
                                     headers={"X-Priority": "background"})
                assert resp.status == 429
                assert resp.headers["X-Shed-Reason"] == "brownout at gateway"
                assert int(resp.headers["Retry-After"]) >= 1
                resp2 = await gw.post("/v1/pub/x", data=b"p",
                                      headers={"X-Priority": "interactive"})
                assert resp2.status == 200
                refusals = platform.metrics.counter(
                    "ai4e_orchestration_brownout_refusals_total", "")
                assert refusals.value(priority="background",
                                      mode="shed_background") == 1
            finally:
                await gw.close()

        run(main())

    def test_sync_proxy_sheds_brownout_503(self):
        async def main():
            platform = orch_platform()

            async def handler(request):
                return web.Response(text="ok")

            app = web.Application()
            app.router.add_post("/v1/be/s", handler)
            be = await serve(app)
            platform.publish_sync_api("/v1/pub/s",
                                      str(be.make_url("/v1/be/s")))
            platform.orchestration.ladder.level = 4
            gw = await serve(platform.gateway.app)
            try:
                resp = await gw.post("/v1/pub/s", data=b"p")
                assert resp.status == 503
                assert resp.headers["X-Shed-Reason"] == (
                    "brownout at gateway_sync")
                resp_get = await gw.get("/v1/pub/s")
                assert resp_get.status == 405
            finally:
                await gw.close()
                await be.close()

        run(main())

    def test_sync_get_rtts_never_feed_the_estimator(self):
        async def main():
            platform = orch_platform()

            async def get_handler(request):
                return web.Response(text="healthy")

            app = web.Application()
            app.router.add_get("/v1/be/g", get_handler)
            be = await serve(app)
            platform.publish_sync_api("/v1/pub/g",
                                      str(be.make_url("/v1/be/g")))
            gw = await serve(platform.gateway.app)
            try:
                for _ in range(3):
                    resp = await gw.get("/v1/pub/g")
                    assert resp.status == 200
                assert not platform.orchestration.estimator._sketches
            finally:
                await gw.close()
                await be.close()

        run(main())

    def test_cache_hits_still_serve_under_full_brownout(self):
        async def main():
            platform = orch_platform(result_cache=True)

            async def handler(request):
                tid = request.headers["taskId"]
                platform.store.set_result(tid, b"cached-answer",
                                          "text/plain")
                platform.store.update_status_if(
                    tid, "created", "completed", TaskStatus.COMPLETED)
                return web.Response(text="ok")

            async def sync_handler(request):
                return web.Response(text="sync-answer")

            app = web.Application()
            app.router.add_post("/v1/be/c", handler)
            app.router.add_post("/v1/be/s", sync_handler)
            be = await serve(app)
            platform.publish_async_api("/v1/pub/c",
                                       str(be.make_url("/v1/be/c")))
            platform.publish_sync_api("/v1/pub/s",
                                      str(be.make_url("/v1/be/s")))
            gw = await serve(platform.gateway.app)
            await platform.start()
            try:
                resp = await gw.post("/v1/pub/c", data=b"same")
                tid = (await resp.json())["TaskId"]
                r = await gw.get(f"/v1/taskmanagement/task/{tid}",
                                 params={"wait": "10"})
                assert "completed" in (await r.json())["Status"]
                sync_fill = await gw.post("/v1/pub/s", data=b"same")
                assert sync_fill.headers["X-Cache"] == "miss"
                platform.orchestration.ladder.level = 4
                hit = await gw.post("/v1/pub/c", data=b"same")
                assert hit.status == 200 and hit.headers["X-Cache"] == "hit"
                miss = await gw.post("/v1/pub/c", data=b"different")
                assert miss.status == 429
                assert miss.headers["X-Shed-Reason"] == "brownout at gateway"
                sync_hit = await gw.post("/v1/pub/s", data=b"same")
                assert sync_hit.status == 200
                assert sync_hit.headers["X-Cache"] == "hit"
                sync_miss = await gw.post("/v1/pub/s", data=b"other")
                assert sync_miss.status == 503
            finally:
                await platform.stop()
                await gw.close()
                await be.close()

        run(main())


# -- one scenario through JAX's platform and the port's ------------------------------

class ScenarioBackends:
    """Loopback backends shared by both runs, so host labels are equal: a
    live one, a stalled one (slow) and a fast one, each completing the
    task in the platform under test; and a dead address."""

    STALL_S = 0.3
    FAST_S = 0.15

    def __init__(self):
        self.platform = None
        self.servers = {}

    async def start(self):
        for name, delay in (("live", 0.0), ("stall", self.STALL_S),
                            ("fast", self.FAST_S)):
            self.servers[name] = await serve(self._app(delay))
        self.urls = {
            "dead": "http://127.0.0.1:9",
            **{n: f"http://127.0.0.1:{s.port}"
               for n, s in self.servers.items()}}

    def _app(self, delay: float):
        async def complete(request):
            await asyncio.sleep(delay)
            self.platform.store.update_status_if(
                request.headers["taskId"], "created", "completed",
                "completed")
            return web.Response(text="ok")

        async def pong(request):
            return web.Response(text="pong")

        app = web.Application()
        app.router.add_post("/v1/be/x", complete)
        app.router.add_post("/v1/be/y", complete)
        app.router.add_post("/v1/be/zs", pong)
        app.router.add_post("/v1/be/xs", pong)
        return app

    async def close(self):
        for s in self.servers.values():
            await s.close()


WHOLE_FAMILIES = ("ai4e_dispatch_total", "ai4e_resilience_",
                  "ai4e_orchestration_placements",
                  "ai4e_orchestration_ladder_transitions",
                  "ai4e_orchestration_brownout", "ai4e_admission_shed",
                  "ai4e_admission_goodput", "ai4e_gateway_requests",
                  "ai4e_rollout_drain")


async def whole_platform(side: str, be: ScenarioBackends) -> dict:
    """One platform (JAX's or the port's) through the scenario: a dead and
    a live backend (failovers, a trip, a probe), then a cheap backend and a
    stalled dear one under deadlines no backend meets (the cold dear tier
    placed confidently once, then fallbacks and late completions that
    climb the ladder, brownout refusals), then idle knocks that step the
    ladder down. The deadline (100 ms) is below both backends' service
    times (150 and 300 ms) by a margin no scheduling jitter closes. Every clock the layers read is one fake clock,
    advanced only between requests."""
    if side == "jax":
        from ai4e_tpu.platform_assembly import LocalPlatform as cls
        from ai4e_tpu.platform_assembly import PlatformConfig as cfg_cls
    else:
        cls, cfg_cls = LocalPlatform, PlatformConfig
    platform = cls(cfg_cls(
        admission=True, resilience=True, orchestration=True,
        observability=True, retry_delay=0.01,
        resilience_retry_base_s=0.001, resilience_failure_threshold=2,
        resilience_recovery_seconds=5.0, orchestration_ladder_hold_s=0.5),
        metrics=SIDES[side][3]())
    be.platform = platform
    clock = FakeClock(1000.0)
    orch = platform.orchestration
    for obj in (platform.resilience, orch, orch.estimator, orch.ladder):
        obj._clock = clock
    u = be.urls
    orch.policy.costs = {u["dead"] + "/": 1.0, u["live"] + "/": 3.0,
                         u["fast"] + "/": 1.0, u["stall"] + "/": 3.0}
    platform.publish_async_api("/v1/pub/x", [(u["dead"] + "/v1/be/x", 1.0),
                                             (u["live"] + "/v1/be/x", 1.0)])
    platform.publish_async_api("/v1/pub/y", [(u["stall"] + "/v1/be/y", 1.0),
                                             (u["fast"] + "/v1/be/y", 1.0)])
    platform.publish_sync_api("/v1/pub/xs", [(u["dead"] + "/v1/be/xs", 1.0),
                              (u["live"] + "/v1/be/xs", 1.0)])
    platform.publish_sync_api("/v1/pub/zs", u["live"] + "/v1/be/zs")
    for d in platform.dispatchers.dispatchers.values():
        d._rng = random.Random(0)
    gw = await serve(platform.gateway.app)
    await platform.start()
    out = {"requests": [], "tasks": [], "levels": []}

    async def request(kind: str, path: str, headers=None, step=0.25):
        clock.t += step
        headers = dict(headers or {})
        resp = await gw.post(path, data=b"payload", headers=headers)
        body = await resp.read()
        out["requests"].append((kind, path, resp.status,
                                resp.headers.get("X-Shed-Reason")))
        if kind == "async" and resp.status == 200:
            import json
            tid = json.loads(body)["TaskId"]
            end = time.monotonic() + 10
            while time.monotonic() < end:
                if platform.store.get(tid).canonical_status in \
                        TaskStatus.TERMINAL:
                    break
                await asyncio.sleep(0.005)
            # The dispatcher's bookkeeping after the backend's answer.
            await asyncio.sleep(0.02)
            record = platform.store.get(tid)
            out["tasks"].append((
                path, record.canonical_status,
                [(e["e"], e["h"], e.get("r"))
                 for e in platform.store.get_ledger(tid)]))
        out["levels"].append(orch.ladder.level)

    try:
        await request("sync", "/v1/pub/xs")
        for _ in range(3):
            await request("async", "/v1/pub/x")
        await request("async", "/v1/pub/x", step=6.0)  # the cooldown: probe
        for _ in range(2):
            await request("async", "/v1/pub/y")  # cheapest tier: fast
        for _ in range(14):
            await request("async", "/v1/pub/y",
                          {"X-Deadline-Ms": "100",
                           "X-Priority": "interactive"})
            await request("sync", "/v1/pub/zs",
                          {"X-Priority": "background"}, step=0.0)
        for _ in range(30):
            await request("sync", "/v1/pub/zs",
                          {"X-Priority": "interactive"}, step=1.0)
        out["counters"] = series(platform.metrics, WHOLE_FAMILIES)
        out["breakers"] = {n: platform.resilience.state(u[n] + "/v1/be/x")
                           for n in ("dead", "live")}
    finally:
        await platform.stop()
        await gw.close()
    return out


class TestWholePlatform:
    def test_scenario_matches_jax(self):
        async def main():
            be = ScenarioBackends()
            await be.start()
            try:
                return (await whole_platform("jax", be),
                        await whole_platform("port", be))
            finally:
                await be.close()

        want, got = run(main())
        assert got["requests"] == want["requests"]
        assert got["levels"] == want["levels"]
        assert got["tasks"] == want["tasks"]
        assert got["counters"] == want["counters"]
        assert got["breakers"] == want["breakers"]
        statuses = {status for _, status, _ in got["tasks"]}
        assert statuses == {"completed"}
        levels = got["levels"]
        assert max(levels) == 4 and levels[-1] == 0
        reasons = {r for *_, r in got["requests"] if r}
        assert reasons == {"brownout at gateway", "brownout at gateway_sync"}
        stamps = {e for _, _, ledger in got["tasks"] for e, _, _ in ledger}
        assert {"failover", "probe", "placed"} <= stamps
