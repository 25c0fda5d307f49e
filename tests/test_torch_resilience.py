"""Resilient routing in the port (``ai4e_tpu_torch/resilience``) against the
JAX package's, mirroring ``tests/test_resilience.py``'s classes: the
circuit breaker under one fake clock, retry budgets and jittered backoff
under one seeded ``random.Random``, the health model's picks, ejections,
drain ejection and canary split, the dispatcher's failover, 5xx retry,
duplicate suppression and redelivery backoff, and the gateway's sync
proxy failing over instead of answering 502.

Where the two packages meet the same inputs they are held equal: breaker
state sequences transition by transition, pick sequences pick by pick,
and counters by label (``ai4e_resilience_*``,
``ai4e_rollout_drain_ejections_total``, ``ai4e_dispatch_total``). No
test sleeps on the wall clock to move a breaker; the dispatcher tests
wait only for real HTTP round trips on loopback."""

import asyncio
import random

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu import resilience as jax_res
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu.rollout.canary import CanaryWeights as JaxCanary
from ai4e_tpu_torch import resilience as port_res
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
from ai4e_tpu_torch.rollout.canary import CanaryWeights
from ai4e_tpu_torch.taskstore import TaskStatus

SIDES = {"jax": (jax_res, JaxRegistry, JaxCanary),
         "port": (port_res, MetricsRegistry, CanaryWeights)}
RESILIENCE_FAMILIES = ("ai4e_resilience_", "ai4e_rollout_drain_ejections")


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


# -- the breaker ---------------------------------------------------------------

#: (breaker kwargs, ops, expected final (state, available)): each mirrors a
#: test of ``tests/test_resilience.py``'s ``TestCircuitBreaker``. An op is
#: "fail", "ok", "neutral", "probe", "avail" or a float (the clock's new
#: time).
BREAKER_SCENARIOS = {
    "opens_on_consecutive_failures": (
        dict(failure_threshold=3), ["fail", "fail", "fail", "avail"],
        ("open", False)),
    "success_resets_the_consecutive_run": (
        dict(failure_threshold=3), ["fail", "fail", "ok", "fail"],
        ("closed", True)),
    "opens_on_window_error_rate": (
        dict(failure_threshold=10, window=6, error_rate=0.5),
        ["fail", "fail", "ok"] * 10, ("open", False)),
    "half_open_probe_success_closes": (
        dict(failure_threshold=1, recovery_seconds=10.0),
        ["fail", "avail", 11.0, "avail", "probe", "avail", "ok", "avail"],
        ("closed", True)),
    "stale_success_does_not_cancel_an_open_cooldown": (
        dict(failure_threshold=2, recovery_seconds=10.0),
        ["fail", "fail", "ok", "avail"], ("open", False)),
    "backpressured_probe_releases_the_slot": (
        dict(failure_threshold=1, recovery_seconds=10.0),
        ["fail", 11.0, "probe", "avail", "neutral", "avail"],
        ("half_open", True)),
    "stale_failures_do_not_extend_an_open_cooldown": (
        dict(failure_threshold=1, recovery_seconds=10.0),
        ["fail", 9.0, "fail", 10.5, "avail"], ("open", True)),
    "leaked_probe_slot_escapes_after_a_cooldown": (
        dict(failure_threshold=1, recovery_seconds=10.0),
        ["fail", 11.0, "probe", "avail", 22.0, "avail"],
        ("half_open", True)),
    "stale_success_without_inflight_probe_does_not_close": (
        dict(failure_threshold=1, recovery_seconds=10.0),
        ["fail", 11.0, "probe", "neutral", "ok"], ("half_open", True)),
    "half_open_probe_failure_reopens_with_fresh_cooldown": (
        dict(failure_threshold=1, recovery_seconds=10.0),
        ["fail", 11.0, "probe", "fail", 20.0, "avail", 21.5, "avail"],
        ("open", True)),
}


def breaker_trace(mod, kwargs: dict, ops: list) -> list:
    """Each op's return value and the breaker's state after it."""
    clock = FakeClock()
    br = mod.CircuitBreaker(clock=clock, **kwargs)
    out = []
    for op in ops:
        if isinstance(op, float):
            clock.t = op
            got = None
        elif op == "fail":
            got = br.record_failure()
        elif op == "ok":
            got = br.record_success()
        elif op == "neutral":
            got = br.record_neutral()
        elif op == "probe":
            got = br.begin_probe()
        else:
            got = br.available()
        out.append((op, got, br.state, br.opened_count))
    return out


class TestCircuitBreaker:
    @pytest.mark.parametrize("name", list(BREAKER_SCENARIOS))
    def test_breaker_sequence_matches_jax(self, name):
        kwargs, ops, (state, available) = BREAKER_SCENARIOS[name]
        want = breaker_trace(jax_res, kwargs, ops + ["avail"])
        got = breaker_trace(port_res, kwargs, ops + ["avail"])
        assert got == want
        assert got[-1][1:3] == (available, state)

    @pytest.mark.parametrize("seed", range(6))
    def test_random_walks_match_jax(self, seed):
        """Random op sequences with time steps: the two breakers agree
        transition by transition."""
        rng = random.Random(seed)
        ops, t = [], 0.0
        for _ in range(300):
            r = rng.random()
            if r < 0.15:
                t += rng.choice((0.5, 3.0, 11.0))
                ops.append(t)
            else:
                ops.append(rng.choice(("fail", "fail", "ok", "neutral",
                                       "probe", "avail")))
        kwargs = dict(failure_threshold=rng.randint(1, 4),
                      window=rng.randint(2, 8), error_rate=0.5,
                      recovery_seconds=10.0,
                      half_open_probes=rng.randint(1, 2))
        assert (breaker_trace(port_res, kwargs, ops)
                == breaker_trace(jax_res, kwargs, ops))

    @pytest.mark.parametrize("kwargs", [dict(failure_threshold=0),
                                        dict(error_rate=0.0),
                                        dict(error_rate=1.5)],
                             ids=["threshold", "rate0", "rate_high"])
    def test_invalid_policies_refuse_as_jax(self, kwargs):
        with pytest.raises(ValueError) as want:
            jax_res.CircuitBreaker(**kwargs)
        with pytest.raises(ValueError) as got:
            port_res.CircuitBreaker(**kwargs)
        assert str(got.value) == str(want.value)


# -- retry budgets and backoff ---------------------------------------------------

class TestRetry:
    def test_backoff_doubles_jitters_and_caps(self):
        rngs = {side: random.Random(7) for side in SIDES}
        for attempt, ceiling in ((1, 0.1), (2, 0.2), (3, 0.4), (9, 1.0)):
            got = {side: SIDES[side][0].backoff_s(attempt, base=0.1, cap=1.0,
                                                  rng=rngs[side])
                   for side in SIDES}
            assert got["port"] == got["jax"]
            assert ceiling / 2 <= got["port"] <= ceiling
        assert port_res.backoff_s(1, base=0.0, cap=1.0) == 0.0
        huge = port_res.backoff_s(1440, base=60.0, cap=150.0,
                                  rng=random.Random(7))
        assert huge == jax_res.backoff_s(1440, base=60.0, cap=150.0,
                                         rng=random.Random(7))
        assert 75.0 <= huge <= 150.0

    def test_budget_limits_retries_to_a_fraction_of_requests(self):
        traces = {}
        for side, (mod, _, _) in SIDES.items():
            budget = mod.RetryBudget(ratio=0.2, reserve=2.0)
            trace = [budget.try_retry() for _ in range(3)]
            for _ in range(10):
                budget.on_request()
            trace += [budget.try_retry(), budget.try_retry(), budget.tokens]
            traces[side] = trace
        assert traces["port"] == traces["jax"]
        assert traces["port"][:5] == [True, True, False, True, False]

    @pytest.mark.parametrize("ratio,reserve,cap", [(0.0, 0.0, 0.0),
                                                   (0.5, 3.0, 4.0),
                                                   (-1.0, 10.0, 100.0)])
    def test_budget_bounds_match_jax(self, ratio, reserve, cap):
        out = {}
        for side, (mod, _, _) in SIDES.items():
            budget = mod.RetryBudget(ratio=ratio, reserve=reserve, cap=cap)
            steps = []
            for i in range(40):
                (budget.on_request if i % 3 else budget.try_retry)()
                steps.append(budget.tokens)
            out[side] = steps
        assert out["port"] == out["jax"]


# -- the health model ------------------------------------------------------------

A, B, C = "http://a:1/v1/x", "http://b:1/v1/x", "http://c:1/v1/x"
BACKENDS = [(A, 1.0), (B, 1.0)]


def health(side: str, clock=None, **policy):
    mod, registry, _ = SIDES[side]
    return mod.BackendHealth(policy=mod.ResiliencePolicy(**policy),
                             metrics=registry(), clock=clock or FakeClock(),
                             rng=random.Random(3))


def pick_trace(side: str, setup, backends, n: int = 200, exclude=(),
               **policy) -> tuple[list, dict]:
    clock = FakeClock()
    h = health(side, clock, **policy)
    setup(h, clock, SIDES[side][2])
    picks = [h.pick(backends, exclude=exclude) for _ in range(n)]
    return picks, series(h.metrics, RESILIENCE_FAMILIES)


def _one_open(h, clock, _):
    h.record_failure(A)


def _all_open(h, clock, _):
    clock.t = 1.0
    h.record_failure(A)
    clock.t = 2.0
    h.record_failure(B)


def _recovering(h, clock, _):
    h.record_failure(A)
    clock.t = 31.0


def _draining(h, clock, _):
    h.mark_draining(A, ttl_s=5.0)


def _all_draining(h, clock, _):
    h.mark_draining(A)
    h.mark_draining(B)


def _canary(h, clock, canary_cls):
    canary = canary_cls()
    canary.set_generation(A, 1)
    canary.set_generation(B, 2)
    canary.set_generation(C, 2)
    canary.set_split(2, 0.25)
    h.attach_canary(canary)


def _canary_all_or_nothing(h, clock, canary_cls):
    canary = canary_cls()
    canary.set_generation(A, 1)
    canary.set_generation(B, 2)
    canary.set_split(2, 1.0)
    h.attach_canary(canary)
    h.record_failure(B)  # only the zero-weight generation survives


PICK_CASES = {
    "healthy": (lambda h, c, k: None, BACKENDS, ()),
    "one_open_is_ejected": (_one_open, BACKENDS, ()),
    "all_open_probes_least_recently_failed": (_all_open, BACKENDS, ()),
    "recovering_gets_its_probe": (_recovering, BACKENDS, ()),
    "exclude_reaches_a_different_backend": (lambda h, c, k: None, BACKENDS,
                                            (A,)),
    "exclude_everything_keeps_the_set": (lambda h, c, k: None, BACKENDS,
                                         (A, B)),
    "draining_is_ejected": (_draining, BACKENDS, ()),
    "all_draining_keeps_the_pool": (_all_draining, BACKENDS, ()),
    "canary_split": (_canary, [(A, 1.0), (B, 1.0), (C, 2.0)], ()),
    "canary_zeroed_survivor_serves": (_canary_all_or_nothing, BACKENDS, ()),
    "weighted_zero_dropped": (lambda h, c, k: None, [(A, 1.0), (B, 0.0)],
                              ()),
}


class TestBackendHealth:
    @pytest.mark.parametrize("name", list(PICK_CASES))
    def test_picks_and_counters_match_jax(self, name):
        setup, backends, exclude = PICK_CASES[name]
        kw = dict(failure_threshold=1)
        want = pick_trace("jax", setup, backends, exclude=exclude, **kw)
        got = pick_trace("port", setup, backends, exclude=exclude, **kw)
        assert got == want

    def test_open_backend_is_ejected_and_weight_redistributes(self):
        picks, counters = pick_trace("port", _one_open, BACKENDS, n=20,
                                     failure_threshold=1)
        assert set(picks) == {B}
        assert counters[
            'ai4e_resilience_ejections_total{backend="a:1"}'] == 20

    def test_all_open_probes_least_recently_failed(self):
        clock = FakeClock()
        h = health("port", clock, failure_threshold=1,
                   recovery_seconds=1000.0)
        _all_open(h, clock, None)
        assert h.pick(BACKENDS) == A
        h.record_success(A)
        assert h.state(A) == "closed"

    def test_observe_status_classifies_as_jax(self):
        statuses = [200, 204, 404, 429, 503, 500, 502, 500, 200, 503, 504]
        traces = {}
        for side in SIDES:
            h = health(side, failure_threshold=2)
            traces[side] = [(h.observe_status(A, s), h.state(A))
                            for s in statuses]
        assert traces["port"] == traces["jax"]
        assert ("open" in {s for _, s in traces["port"]})

    def test_breaker_open_transition_counted_once(self):
        h = health("port", failure_threshold=2)
        assert not h.record_failure(A)
        assert h.record_failure(A)
        assert not h.record_failure(A)
        tr = h.metrics.counter("ai4e_resilience_transitions_total", "")
        assert tr.value(backend="a:1", state="open") == 1

    def test_drain_mark_expires_with_its_ttl_and_never_trips(self):
        traces = {}
        for side in SIDES:
            clock = FakeClock()
            h = health(side, clock, drain_eject_ttl_s=30.0)
            trace = []
            h.mark_draining(A)
            for t in (0.0, 29.9, 30.0, 31.0):
                clock.t = t
                trace.append((t, h.is_draining(A), h.state(A)))
            h.mark_draining(B, ttl_s=2.0)
            h.clear_draining(B)
            trace.append(h.is_draining(B))
            h.mark_draining(A, ttl_s=-1.0)
            trace.append(h.is_draining(A))
            h.record_failure(A)
            h.mark_draining(A)
            h.reset(A)
            trace.append((h.is_draining(A), h.state(A)))
            traces[side] = (trace, series(h.metrics, RESILIENCE_FAMILIES))
        assert traces["port"] == traces["jax"]
        assert traces["port"][0][:3] == [(0.0, True, "closed"),
                                         (29.9, True, "closed"),
                                         (30.0, False, "closed")]

    def test_commit_pick_books_the_probe_slot(self):
        traces = {}
        for side in SIDES:
            clock = FakeClock()
            h = health(side, clock, failure_threshold=1,
                       recovery_seconds=5.0)
            h.record_failure(A)
            clock.t = 6.0
            h.commit_pick(A)
            traces[side] = (h.state(A), h.breaker_for(A).available(),
                            series(h.metrics, RESILIENCE_FAMILIES))
        assert traces["port"] == traces["jax"]
        assert traces["port"][:2] == ("half_open", False)

    def test_new_budget_takes_the_policy_ratio(self):
        h = health("port", retry_budget_ratio=0.5)
        budget = h.new_budget()
        assert isinstance(budget, port_res.RetryBudget)
        assert budget.ratio == 0.5
        h.note_retry("dispatcher")
        h.note_failover("gateway_sync")
        assert series(h.metrics, ("ai4e_resilience_retries",
                                  "ai4e_resilience_failovers")) == {
            'ai4e_resilience_retries_total{component="dispatcher"}': 1.0,
            'ai4e_resilience_failovers_total{component="gateway_sync"}': 1.0}


class TestCanaryWeights:
    POOLS = [
        [(A, 1.0), (B, 1.0)],
        [(A, 3.0), (B, 1.0), (C, 1.0)],
        [(B, 1.0), (C, 2.0)],
        [(A, 1.0)],
        [],
    ]

    @pytest.mark.parametrize("share", [0.0, 0.1, 0.5, 1.0, 1.7, -0.2])
    def test_apply_matches_jax(self, share):
        out = {}
        for side, (_, _, canary_cls) in SIDES.items():
            canary = canary_cls()
            canary.set_generation(A, 1)
            canary.set_generation(B, 2)
            canary.set_generation(C, 2)
            before = [canary.apply(p) for p in self.POOLS]
            canary.set_split(2, share)
            during = [canary.apply(p) for p in self.POOLS]
            split = canary.split
            canary.clear_split()
            out[side] = (before, during, split,
                         [canary.apply(p) for p in self.POOLS],
                         canary.generation_of(B), canary.generation_of("x"))
        assert out["port"] == out["jax"]

    def test_canary_holds_its_share_as_a_group(self):
        canary = CanaryWeights()
        canary.set_generation(B, 2)
        canary.set_generation(C, 2)
        canary.set_split(2, 0.25)
        pool = canary.apply([(A, 3.0), (B, 1.0), (C, 1.0)])
        total = sum(w for _, w in pool)
        assert sum(w for u, w in pool if u != A) == pytest.approx(
            0.25 * total)


# -- the dispatcher --------------------------------------------------------------

def resilient_platform(**kw) -> LocalPlatform:
    cfg = dict(resilience=True, retry_delay=0.01,
               resilience_retry_base_s=0.001,
               resilience_recovery_seconds=0.05)
    cfg.update(kw)
    return LocalPlatform(PlatformConfig(**cfg), metrics=MetricsRegistry())


def completing_app(platform, calls, fail_first=0, status=500,
                   headers=None):
    """A backend that records each POST's task and completes it
    conditionally, after answering ``status`` (with ``headers``) to the
    first ``fail_first`` POSTs."""
    async def handler(request):
        calls.append(request.headers["taskId"])
        if len(calls) <= fail_first:
            return web.Response(status=status, headers=headers)
        platform.store.update_status_if(
            request.headers["taskId"], "created", "completed",
            TaskStatus.COMPLETED)
        return web.Response(text="ok")

    app = web.Application()
    app.router.add_post("/v1/be/x", handler)
    return app


async def post_and_wait(platform, gw, path="/v1/pub/x", timeout=5.0):
    resp = await gw.post(path, data=b"payload")
    assert resp.status == 200
    tid = (await resp.json())["TaskId"]
    end = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < end:
        record = platform.store.get(tid)
        if record.canonical_status in TaskStatus.TERMINAL:
            return tid, record
        await asyncio.sleep(0.01)
    return tid, platform.store.get(tid)


def seed_that_picks_first(backends, uri: str) -> int:
    """The smallest seed whose first weighted pick over ``backends`` is
    ``uri``, so the test's first delivery meets it whatever the draw."""
    from ai4e_tpu_torch.utils.backends import pick_backend

    return next(s for s in range(100)
                if pick_backend(backends, random.Random(s)) == uri)


class TestDispatcherResilience:
    def test_connection_error_fails_over_to_live_backend(self):
        async def main():
            calls = []
            platform = resilient_platform(observability=True)
            be = await serve(completing_app(platform, calls))
            live = str(be.make_url("/v1/be/x"))
            dead = "http://127.0.0.1:9/v1/be/x"
            backends = [(dead, 1.0), (live, 1.0)]
            platform.publish_async_api("/v1/pub/x", backends)
            # The first pick meets the dead host: the failover is certain,
            # not one draw's luck.
            d = platform.dispatchers.dispatchers["/v1/be/x"]
            d._rng = random.Random(seed_that_picks_first(backends, dead))
            gw = await serve(platform.gateway.app)
            await platform.start()
            try:
                tids = []
                for _ in range(6):
                    tid, record = await post_and_wait(platform, gw)
                    assert record.canonical_status == "completed", record
                    tids.append(tid)
                failovers = platform.metrics.counter(
                    "ai4e_resilience_failovers_total", "")
                assert failovers.value(component="dispatcher") >= 1
                events = [e["e"] for e in platform.store.get_ledger(tids[0])]
                assert "failover" in events
                failover = next(e for e in platform.store.get_ledger(tids[0])
                                if e["e"] == "failover")
                assert failover["r"] == "connect_error 127.0.0.1:9"
                assert len(calls) == 6
            finally:
                await platform.stop()
                await gw.close()
                await be.close()

        run(main())

    def test_transient_500_is_retried_not_terminal(self):
        async def main():
            platform = resilient_platform()
            calls = []
            be = await serve(completing_app(platform, calls, fail_first=1))
            platform.publish_async_api("/v1/pub/x",
                                       str(be.make_url("/v1/be/x")))
            gw = await serve(platform.gateway.app)
            await platform.start()
            try:
                _, record = await post_and_wait(platform, gw)
                assert record.canonical_status == "completed", record
                assert len(calls) == 2
                retries = platform.metrics.counter(
                    "ai4e_resilience_retries_total", "")
                assert retries.value(component="dispatcher") == 1
            finally:
                await platform.stop()
                await gw.close()
                await be.close()

        run(main())

    def test_500_without_resilience_stays_permanent(self):
        async def main():
            platform = LocalPlatform(PlatformConfig(retry_delay=0.01),
                                     metrics=MetricsRegistry())
            calls = []
            be = await serve(completing_app(platform, calls, fail_first=99))
            platform.publish_async_api("/v1/pub/x",
                                       str(be.make_url("/v1/be/x")))
            gw = await serve(platform.gateway.app)
            await platform.start()
            try:
                _, record = await post_and_wait(platform, gw)
                assert record.canonical_status == "failed", record
                assert len(calls) == 1
            finally:
                await platform.stop()
                await gw.close()
                await be.close()

        run(main())

    def test_duplicate_message_for_terminal_task_is_suppressed(self):
        async def main():
            platform = resilient_platform(observability=True)
            calls = []
            be = await serve(completing_app(platform, calls))
            platform.publish_async_api("/v1/pub/x",
                                       str(be.make_url("/v1/be/x")))
            gw = await serve(platform.gateway.app)
            await platform.start()
            try:
                tid, record = await post_and_wait(platform, gw)
                assert record.canonical_status == "completed"
                executed = len(calls)
                platform.broker.publish(platform.store.get(tid))
                for _ in range(100):
                    if "duplicate" in [e["e"] for e in
                                       platform.store.get_ledger(tid)]:
                        break
                    await asyncio.sleep(0.01)
                assert len(calls) == executed
                dup = platform.metrics.counter("ai4e_dispatch_total", "")
                assert dup.value(outcome="duplicate", queue="/v1/be/x",
                                 backend="") == 1
                stamp = [e for e in platform.store.get_ledger(tid)
                         if e["e"] == "duplicate"]
                assert stamp[0]["h"] == "dispatcher"
                assert stamp[0]["r"] == "redelivery of a terminal task"
            finally:
                await platform.stop()
                await gw.close()
                await be.close()

        run(main())

    def test_redelivery_delay_is_jittered_exponential_capped_by_lease(self):
        from ai4e_tpu.broker import InMemoryBroker as JaxBroker
        from ai4e_tpu.broker.dispatcher import Dispatcher as JaxDispatcher
        from ai4e_tpu.broker.queue import Message as JaxMessage
        from ai4e_tpu.service import LocalTaskManager as JaxManager
        from ai4e_tpu.taskstore import InMemoryTaskStore as JaxStore
        from ai4e_tpu_torch.broker import Dispatcher, InMemoryBroker
        from ai4e_tpu_torch.broker.queue import Message
        from ai4e_tpu_torch.service import LocalTaskManager
        from ai4e_tpu_torch.taskstore import InMemoryTaskStore

        jd = JaxDispatcher(JaxBroker(lease_seconds=10.0), "/v1/q",
                           "http://b/v1/q", JaxManager(JaxStore()),
                           retry_delay=1.0, metrics=JaxRegistry(),
                           rng=random.Random(0))
        pd = Dispatcher(InMemoryBroker(lease_seconds=10.0), "/v1/q",
                        "http://b/v1/q", LocalTaskManager(InMemoryTaskStore()),
                        retry_delay=1.0, metrics=MetricsRegistry(),
                        rng=random.Random(0))
        by_count = {}
        for count in (1, 2, 3, 4, 10):
            want = [jd._redelivery_delay(JaxMessage(
                task_id="t", endpoint="/v1/q", delivery_count=count))
                for _ in range(50)]
            got = [pd._redelivery_delay(Message(
                task_id="t", endpoint="/v1/q", delivery_count=count))
                for _ in range(50)]
            assert got == want
            ceiling = min(5.0, 1.0 * 2 ** (count - 1))
            assert all(ceiling / 2 <= x <= ceiling for x in got)
            by_count[count] = sum(got) / len(got)
        assert by_count[1] < by_count[2] < by_count[3]

    def test_breaker_open_backs_off_admission_limiter(self):
        async def main():
            platform = resilient_platform(
                admission=True, resilience_failure_threshold=2,
                admission_initial_limit=64)
            platform.publish_async_api("/v1/pub/x",
                                       "http://127.0.0.1:9/v1/be/x")
            gw = await serve(platform.gateway.app)
            await platform.start()
            scope = platform.admission.scope("dispatch:/v1/be/x")
            before = scope.limit
            try:
                resp = await gw.post("/v1/pub/x", data=b"p")
                assert resp.status == 200
                for _ in range(200):
                    if scope.limit < before:
                        break
                    await asyncio.sleep(0.01)
                assert scope.limit < before
                assert platform.resilience.state(
                    "http://127.0.0.1:9/v1/be/x") in ("open", "half_open")
            finally:
                await platform.stop()
                await gw.close()

        run(main())

    def test_draining_backend_is_ejected_without_a_breaker_event(self):
        """A 503 with ``X-Draining`` ejects its backend for the TTL; the
        redelivery lands on the peer and the drained backend's breaker
        stays closed."""
        async def main():
            platform = resilient_platform(resilience_failure_threshold=1,
                                          rollout_drain_eject_ttl_s=30.0)
            drained_calls, live_calls = [], []
            drained = await serve(completing_app(
                platform, drained_calls, fail_first=99, status=503,
                headers={"X-Draining": "1"}))
            live = await serve(completing_app(platform, live_calls))
            d_uri = str(drained.make_url("/v1/be/x"))
            backends = [(d_uri, 1.0), (str(live.make_url("/v1/be/x")), 1.0)]
            platform.publish_async_api("/v1/pub/x", backends)
            platform.dispatchers.dispatchers["/v1/be/x"]._rng = (
                random.Random(seed_that_picks_first(backends, d_uri)))
            gw = await serve(platform.gateway.app)
            await platform.start()
            try:
                for _ in range(4):
                    _, record = await post_and_wait(platform, gw)
                    assert record.canonical_status == "completed"
                assert len(drained_calls) == 1 and len(live_calls) == 4
                assert platform.resilience.state(d_uri) == "closed"
                assert platform.resilience.is_draining(d_uri)
                ej = platform.metrics.counter(
                    "ai4e_rollout_drain_ejections_total", "")
                assert ej.value(backend=drained.make_url("/").host + ":"
                                + str(drained.port)) >= 3
                tr = platform.metrics.counter(
                    "ai4e_resilience_transitions_total", "")
                assert not list(tr.collect())
            finally:
                await platform.stop()
                await gw.close()
                await drained.close()
                await live.close()

        run(main())

    def test_duplicate_check_survives_a_slot_move(self):
        """On a sharded store the terminal probe reads the owning shard,
        also after the task's slot moved to another shard."""
        async def main():
            platform = resilient_platform(task_shards=2)
            calls = []
            be = await serve(completing_app(platform, calls))
            platform.publish_async_api("/v1/pub/x",
                                       str(be.make_url("/v1/be/x")))
            gw = await serve(platform.gateway.app)
            await platform.start()
            try:
                tid, record = await post_and_wait(platform, gw)
                assert record.canonical_status == "completed"
                store = platform.store
                slot = store.ring.slot_for(tid)
                owner = store.ring.shard_for(tid)
                store.move_slot(slot, 1 - owner)
                assert store.ring.shard_for(tid) == 1 - owner
                platform.broker.publish(store.get(tid))
                dup = platform.metrics.counter("ai4e_dispatch_total", "")
                for _ in range(200):
                    if sum(v for *_, labels, v in dup.collect()
                           if labels.get("outcome") == "duplicate"):
                        break
                    await asyncio.sleep(0.01)
                assert sum(v for *_, labels, v in dup.collect()
                           if labels.get("outcome") == "duplicate") == 1
                assert len(calls) == 1
                assert store.get(tid).canonical_status == "completed"
            finally:
                await platform.stop()
                await gw.close()
                await be.close()

        run(main())


# -- the gateway's sync proxy ----------------------------------------------------

def pong_app(hits: list, status: int = 200, headers=None):
    async def ok(request):
        hits.append(1)
        return web.Response(text="pong", status=status, headers=headers)

    app = web.Application()
    app.router.add_post("/v1/be/x", ok)
    return app


class TestGatewaySyncResilience:
    def test_sync_proxy_fails_over_instead_of_502(self):
        async def main():
            platform = resilient_platform()
            hits = []
            be = await serve(pong_app(hits))
            live = str(be.make_url("/v1/be/x"))
            dead = "http://127.0.0.1:9/v1/be/x"
            backends = [(dead, 1.0), (live, 1.0)]
            platform.publish_sync_api("/v1/pub/x", backends)
            platform.gateway._rng = random.Random(
                seed_that_picks_first(backends, dead))
            gw = await serve(platform.gateway.app)
            try:
                for _ in range(8):
                    resp = await gw.post("/v1/pub/x", data=b"ping")
                    assert resp.status == 200, await resp.text()
                assert len(hits) == 8
                failovers = platform.metrics.counter(
                    "ai4e_resilience_failovers_total", "")
                assert failovers.value(component="gateway_sync") >= 1
            finally:
                await gw.close()
                await be.close()

        run(main())

    def test_sync_proxy_all_dead_still_answers_502(self):
        async def main():
            platform = resilient_platform(resilience_max_attempts=3)
            platform.publish_sync_api("/v1/pub/x",
                                      "http://127.0.0.1:9/v1/be/x")
            gw = await serve(platform.gateway.app)
            try:
                resp = await gw.post("/v1/pub/x", data=b"ping")
                assert resp.status == 502
                failovers = platform.metrics.counter(
                    "ai4e_resilience_failovers_total", "")
                # max_attempts bounds the attempts: two failovers.
                assert failovers.value(component="gateway_sync") == 2
            finally:
                await gw.close()

        run(main())

    def test_sync_proxy_single_attempt_without_resilience(self):
        async def main():
            platform = LocalPlatform(PlatformConfig(),
                                     metrics=MetricsRegistry())
            platform.publish_sync_api("/v1/pub/x",
                                      "http://127.0.0.1:9/v1/be/x")
            gw = await serve(platform.gateway.app)
            try:
                resp = await gw.post("/v1/pub/x", data=b"ping")
                assert resp.status == 502
                assert platform.gateway._resilience is None
            finally:
                await gw.close()

        run(main())

    def test_sync_retry_budget_bounds_failovers(self):
        """Past its reserve, the proxy's budget allows about ``ratio``
        retries a request: an all-dead route answers 502 without
        failing over."""
        async def main():
            platform = resilient_platform(resilience_retry_budget_ratio=0.0,
                                          resilience_failure_threshold=1000)
            platform.publish_sync_api("/v1/pub/x",
                                      "http://127.0.0.1:9/v1/be/x")
            gw = await serve(platform.gateway.app)
            try:
                for _ in range(8):
                    resp = await gw.post("/v1/pub/x", data=b"ping")
                    assert resp.status == 502
                failovers = platform.metrics.counter(
                    "ai4e_resilience_failovers_total", "")
                assert failovers.value(component="gateway_sync") == 10
                assert platform.gateway._sync_retry_budget.tokens < 1.0
            finally:
                await gw.close()

        run(main())

    def test_sync_drain_answer_marks_the_backend_draining(self):
        async def main():
            platform = resilient_platform()
            hits = []
            be = await serve(pong_app(hits, status=503,
                                      headers={"X-Draining": "1"}))
            uri = str(be.make_url("/v1/be/x"))
            platform.publish_sync_api("/v1/pub/x", uri)
            gw = await serve(platform.gateway.app)
            try:
                resp = await gw.post("/v1/pub/x", data=b"ping")
                assert resp.status == 503
                assert platform.resilience.is_draining(uri)
                assert platform.resilience.state(uri) == "closed"
            finally:
                await gw.close()
                await be.close()

        run(main())

    def test_sync_5xx_answers_the_client_and_trips_the_breaker(self):
        async def main():
            platform = resilient_platform(resilience_failure_threshold=2)
            hits = []
            be = await serve(pong_app(hits, status=500))
            uri = str(be.make_url("/v1/be/x"))
            platform.publish_sync_api("/v1/pub/x", uri)
            gw = await serve(platform.gateway.app)
            try:
                for _ in range(2):
                    resp = await gw.post("/v1/pub/x", data=b"ping")
                    assert resp.status == 500
                # A 5xx is not replayed: the backend ran the request.
                assert len(hits) == 2
                assert platform.resilience.state(uri) == "open"
            finally:
                await gw.close()
                await be.close()

        run(main())


# -- configuration -----------------------------------------------------------------

class TestConfigSurface:
    def test_env_knobs_reach_the_policy(self):
        from ai4e_tpu_torch.config import FrameworkConfig

        cfg = FrameworkConfig.from_env({
            "AI4E_PLATFORM_RESILIENCE": "1",
            "AI4E_PLATFORM_RESILIENCE_FAILURE_THRESHOLD": "9",
            "AI4E_PLATFORM_RESILIENCE_RECOVERY_SECONDS": "2.5",
            "AI4E_PLATFORM_RESILIENCE_WINDOW": "7",
            "AI4E_PLATFORM_RESILIENCE_ERROR_RATE": "0.75",
            "AI4E_PLATFORM_RESILIENCE_MAX_ATTEMPTS": "4",
            "AI4E_PLATFORM_RESILIENCE_RETRY_BASE_S": "0.2",
            "AI4E_PLATFORM_RESILIENCE_RETRY_BUDGET_RATIO": "0.3",
            "AI4E_ROLLOUT_DRAIN_EJECT_TTL_S": "4"}).to_platform_config()
        platform = LocalPlatform(cfg, metrics=MetricsRegistry())
        policy = platform.resilience.policy
        assert (policy.failure_threshold, policy.recovery_seconds,
                policy.window, policy.error_rate, policy.max_attempts,
                policy.retry_base_s, policy.retry_budget_ratio,
                policy.drain_eject_ttl_s) == (9, 2.5, 7, 0.75, 4, 0.2, 0.3,
                                              4.0)
        assert platform.gateway._resilience is platform.resilience
        platform.publish_async_api("/v1/pub/x", "http://b:1/v1/be/x")
        d = platform.dispatchers.dispatchers["/v1/be/x"]
        assert d.resilience is platform.resilience
        assert d._retry_budget.ratio == 0.3

    def test_default_platform_has_no_resilience_state(self):
        platform = LocalPlatform(PlatformConfig(), metrics=MetricsRegistry())
        assert platform.resilience is None
        assert platform.gateway._resilience is None
        assert platform.dispatchers.resilience is None
        platform.publish_async_api("/v1/pub/x", "http://b:1/v1/be/x")
        d = platform.dispatchers.dispatchers["/v1/be/x"]
        assert d.resilience is None and d._retry_budget is None

    def test_resilience_policy_defaults_are_jax_s(self):
        import dataclasses

        assert ([(f.name, f.default) for f in
                 dataclasses.fields(port_res.ResiliencePolicy)]
                == [(f.name, f.default) for f in
                    dataclasses.fields(jax_res.ResiliencePolicy)])


# -- a worker that will be killed is still counted -----------------------------------

class TestLaunchReport:
    def test_sigusr1_logs_the_launches_so_far(self, tmp_path):
        """SIGUSR1 makes a worker log its kernel launches so far, in the
        two lines it logs at SIGTERM, ``so far`` for ``while serving``;
        serving goes on, and SIGTERM still stops it cleanly."""
        import json
        import os
        import signal
        import socket
        import subprocess
        import sys
        import time

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = tmp_path / "models.json"
        spec.write_text(json.dumps({"models": [{"family": "echo",
                                                "name": "echo"}]}))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        log_path = tmp_path / "worker.log"
        with open(log_path, "wb") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ai4e_tpu_torch", "worker", "--models",
                 str(spec), "--device", "cpu", "--host", "127.0.0.1",
                 "--port", str(port)],
                cwd=root, env={**os.environ, "PYTHONPATH": root},
                stdout=out, stderr=subprocess.STDOUT)

        def wait_for(text: str, count: int = 1) -> str:
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                body = log_path.read_text(errors="replace")
                if body.count(text) >= count or proc.poll() is not None:
                    return body
                time.sleep(0.05)
            return log_path.read_text(errors="replace")

        try:
            assert "worker on " in wait_for("worker on "), log_path.read_text()
            for n in (1, 2):
                proc.send_signal(signal.SIGUSR1)
                body = wait_for("kernel launches by model so far ", n)
                assert body.count("kernel launches so far ") == n, body
            assert proc.poll() is None
        finally:
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=60)
        body = log_path.read_text()
        assert code == 0, body
        line = next(x for x in body.splitlines()
                    if "kernel launches so far " in x)
        assert json.loads(line.split("kernel launches so far ", 1)[1]) == {
            "normalize_image": 0, "fused_seg_postprocess": 0,
            "flash_attention": 0}
        assert "kernel launches while serving " in body
        assert "kernel launches by model while serving " in body
