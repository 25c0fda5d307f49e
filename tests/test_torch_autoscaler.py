"""The port's autoscaler (``ai4e_tpu_torch.scaling``) against the JAX
package's: the HPA decision rule on a frozen clock, the controller's tick
on a fake store and target, and the dispatcher's live resize, which it
actuates, growing and shrinking without cancelling a delivery in flight;
the loops' lifecycle with the port's platform. (``deploy/specs/routes.json``
through both control planes: ``tests/test_torch_control_plane.py``.)"""

import asyncio

import pytest

from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu.scaling import autoscaler as jax_as
from ai4e_tpu_torch.broker import Dispatcher, InMemoryBroker
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry
from ai4e_tpu_torch.scaling import autoscaler as port_as
from ai4e_tpu_torch.taskstore import APITask

SIDES = {"jax": (jax_as, JaxRegistry), "port": (port_as, PortRegistry)}


class FrozenClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


# (policy fields, [(seconds since the last decision, signal)]): each
# decision's result is the next decision's current replica count.
DECIDER_CASES = {
    # Signals at, just inside and just outside the 10% band around
    # replicas * target, from 4 replicas of target 4.
    "tolerance-band": (
        {"target_per_replica": 4, "tolerance": 0.1, "max_replicas": 16},
        [(1, 16.0), (1, 17.6), (1, 17.7), (1, 14.4), (1, 14.3), (1, 16.0)]),
    "tolerance-zero": (
        {"target_per_replica": 4, "tolerance": 0.0, "max_replicas": 16},
        [(1, 16.1), (1, 15.9), (1, 16.0)]),
    "tolerance-wide": (
        {"target_per_replica": 1, "tolerance": 0.5, "max_replicas": 16},
        [(1, 5.9), (1, 6.1), (1, 2.1), (1, 1.9)]),
    # Scale up at once; a dip inside the window holds the window's max;
    # past the window the lower recommendation wins.
    "stabilisation-window": (
        {"target_per_replica": 1, "stabilization_seconds": 30.0,
         "max_replicas": 16},
        [(0, 12.0), (5, 2.0), (10, 1.0), (10, 0.0), (6, 0.0), (31, 0.0)]),
    "stabilisation-none": (
        {"target_per_replica": 1, "stabilization_seconds": 0.0},
        [(0, 8.0), (1, 2.0), (1, 0.0)]),
    "stabilisation-rising-dips": (
        {"target_per_replica": 2, "stabilization_seconds": 10.0,
         "max_replicas": 20},
        [(0, 30.0), (3, 10.0), (3, 40.0), (3, 4.0), (3, 4.0), (11, 4.0)]),
    # The clamps: a flood against max, an empty queue against min.
    "clamp-max": (
        {"min_replicas": 1, "max_replicas": 16, "target_per_replica": 4,
         "stabilization_seconds": 0.0},
        [(1, 3000.0), (1, 3000.0), (1, 10.0)]),
    "clamp-min": (
        {"min_replicas": 3, "max_replicas": 8, "stabilization_seconds": 0.0},
        [(1, 0.0), (1, 100.0), (1, 0.0), (1, 0.0)]),
    "clamp-min-above-current": (
        {"min_replicas": 5, "max_replicas": 6},
        [(1, 0.0), (1, 1.0)]),
}


def decisions(side: str, policy: dict, steps, start: int = 4) -> list[int]:
    module, _ = SIDES[side]
    clock = FrozenClock()
    decider = module.HPADecider(module.AutoscalePolicy(**policy), clock=clock)
    current, out = start, []
    for dt, signal in steps:
        clock.now += dt
        current = decider.desired(current, signal)
        out.append(current)
    return out


@pytest.mark.parametrize("case", sorted(DECIDER_CASES))
def test_hpa_decider_is_jax_s(case):
    policy, steps = DECIDER_CASES[case]
    want = decisions("jax", policy, steps)
    assert decisions("port", policy, steps) == want


def test_policy_fields_and_defaults_are_jax_s():
    import dataclasses

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(port_as.AutoscalePolicy) == fields(jax_as.AutoscalePolicy)


class FakeStore:
    def __init__(self):
        self.depth = {}

    def set_len(self, endpoint_path: str, status: str) -> int:
        return self.depth.get((endpoint_path, status), 0)


class FakeTarget:
    def __init__(self, replicas: int):
        self.replicas = replicas
        self.calls = []

    def scale_to(self, n: int) -> None:
        self.calls.append(n)
        self.replicas = n


# (seconds since the last tick, created, running)
TICKS = [(5, 3000, 4), (5, 2000, 16), (5, 40, 16), (5, 0, 10), (5, 0, 0),
         (31, 0, 0), (5, 9, 1)]


def controller_run(side: str) -> dict:
    module, registry_cls = SIDES[side]
    path = "/v1/models/classify-async"
    store, target, clock = FakeStore(), FakeTarget(4), FrozenClock()
    metrics = registry_cls()
    ctl = module.AutoscaleController(
        store, path, target,
        policy=module.AutoscalePolicy(min_replicas=1, max_replicas=16,
                                      target_per_replica=4),
        metrics=metrics, clock=clock)
    record = []
    for dt, created, running in TICKS:
        clock.now += dt
        store.depth = {(path, "created"): created, (path, "running"): running}
        desired = ctl.tick()
        record.append((desired, target.replicas,
                       metrics.gauge("ai4e_autoscale_replicas").value(
                           endpoint=path),
                       metrics.gauge("ai4e_autoscale_signal").value(
                           endpoint=path)))
    decisions_total = metrics.counter("ai4e_autoscale_decisions_total")
    return {"ticks": record, "calls": target.calls,
            "up": decisions_total.value(endpoint=path, direction="up"),
            "down": decisions_total.value(endpoint=path, direction="down")}


def test_controller_tick_is_jax_s():
    """Seven ticks of a land-cover backlog that floods, drains and
    returns: the same decisions, actuations, gauges and counters."""
    want = controller_run("jax")
    got = controller_run("port")
    assert got == want
    assert want["up"] >= 1 and want["down"] >= 1
    assert max(r for _, r, _, _ in want["ticks"]) == 16


def test_dispatcher_target_reads_and_resizes():
    broker = InMemoryBroker()
    broker.register_queue("/v1/q")
    d = Dispatcher(broker, "/v1/q", "http://w/v1/q", task_manager=None,
                   concurrency=2)
    target = port_as.DispatcherScaleTarget(d)
    assert target.replicas == 2
    target.scale_to(5)  # before start(): the level is recorded
    assert target.replicas == d.concurrency == 5 and not d._workers


class HeldDispatcher(Dispatcher):
    """A dispatcher whose deliveries wait until the test releases them;
    it records each delivery that started, finished or was cancelled."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.release = asyncio.Event()
        self.started, self.finished, self.cancelled = [], [], []

    async def _dispatch_one(self, msg) -> None:
        self.started.append(msg.task_id)
        try:
            await self.release.wait()
        except asyncio.CancelledError:
            self.cancelled.append(msg.task_id)
            raise
        self.broker.complete(msg)
        self.finished.append(msg.task_id)


def live_loops(d: Dispatcher) -> int:
    return sum(not w.done() for w in d._workers)


def test_set_concurrency_grows_and_shrinks_without_cancelling():
    """Before ``start()`` the level is recorded; after it, growing spawns
    loops that take queued work at once, and shrinking lets every
    delivery in flight finish (none cancelled, none redelivered) before
    the surplus loops exit at their next idle point."""

    async def run():
        broker = InMemoryBroker()
        broker.bind_loop(asyncio.get_running_loop())
        broker.register_queue("/v1/q")
        d = HeldDispatcher(broker, "/v1/q", "http://w/v1/q",
                           task_manager=None, concurrency=1)
        d.set_concurrency(2)
        assert d.concurrency == 2 and not d._workers
        await d.start()
        assert live_loops(d) == 2
        for i in range(6):
            broker.publish(APITask(task_id=f"t{i}", endpoint="/v1/q"))
        await asyncio.sleep(0.05)
        assert len(d.started) == 2
        d.set_concurrency(5)  # grow: three more loops take three more
        await asyncio.sleep(0.05)
        assert live_loops(d) == 5 and len(d.started) == 5
        d.set_concurrency(1)  # shrink with five deliveries in flight
        await asyncio.sleep(0.05)
        assert d.cancelled == [] and live_loops(d) == 5
        d.release.set()
        for _ in range(100):
            await asyncio.sleep(0.02)
            if len(d.finished) == 6 and live_loops(d) == 1:
                break
        assert sorted(d.finished) == [f"t{i}" for i in range(6)]
        assert d.cancelled == [] and live_loops(d) == 1
        assert d.concurrency == 1
        assert len(broker.queue("/v1/q")) == 0
        d.set_concurrency(3)  # and up again after the exits
        await asyncio.sleep(0.05)
        assert live_loops(d) == 3
        await d.stop()
        assert live_loops(d) == 0

    asyncio.run(run())


def test_shrink_then_grow_absorbs_the_exit_debt():
    """A shrink's surplus loops that have not exited yet count against a
    later grow: the live count lands on the asked level, no extra loop."""

    async def run():
        broker = InMemoryBroker()
        broker.bind_loop(asyncio.get_running_loop())
        broker.register_queue("/v1/q")
        d = HeldDispatcher(broker, "/v1/q", "http://w/v1/q",
                           task_manager=None, concurrency=4)
        await d.start()
        for i in range(4):
            broker.publish(APITask(task_id=f"t{i}", endpoint="/v1/q"))
        await asyncio.sleep(0.05)
        d.set_concurrency(1)
        d.set_concurrency(3)
        assert len(d._workers) == 4 and d._excess == 1
        d.release.set()
        for _ in range(100):
            await asyncio.sleep(0.02)
            if live_loops(d) == 3 and len(d.finished) == 4:
                break
        assert live_loops(d) == 3 and d.cancelled == []
        await d.stop()

    asyncio.run(run())


def test_autoscaler_runs_with_the_platform():
    """The loops start and stop with the port's platform; a tick on a
    backlog grows the dispatcher live and shows on /metrics' registry."""
    from ai4e_tpu_torch.platform_assembly import LocalPlatform

    async def run():
        metrics = PortRegistry()
        p = LocalPlatform(metrics=metrics)
        p.publish_async_api(
            "/v1/pub/x", "http://127.0.0.1:9/v1/models/x-async",
            concurrency=2, autoscale=port_as.AutoscalePolicy(
                max_replicas=6, target_per_replica=1),
            autoscale_interval=0.05)
        (scaler,) = p.autoscalers
        d = p.dispatchers.dispatchers["/v1/models/x-async"]
        await p.start()
        try:
            assert scaler._task is not None
            for i in range(10):
                p.store.upsert(APITask(task_id=f"t{i}",
                                       endpoint="/v1/models/x-async"))
            for _ in range(100):
                await asyncio.sleep(0.02)
                if d.concurrency == 6:
                    break
            assert d.concurrency == 6 and live_loops(d) == 6
            assert metrics.gauge("ai4e_autoscale_replicas").value(
                endpoint="/v1/models/x-async") == 6
        finally:
            await p.stop()
        assert scaler._task is None and live_loops(d) == 0

    asyncio.run(run())


@pytest.mark.parametrize("env,item", [
    ({"AI4E_PLATFORM_TASK_SHARDS": "2"}, "autoscale policies are"),
    ({"AI4E_PLATFORM_ORCHESTRATION": "1"}, "requires admission=True")],
    ids=["sharded", "orchestrated"])
def test_sharded_or_orchestrated_autoscale_names_its_item(env, item):
    """An ``autoscale`` route on a sharded platform without orchestration,
    and orchestration without admission and resilience, are refused with
    the JAX package's own texts (orchestration itself is served now)."""
    from ai4e_tpu_torch.cli import build_control_plane
    from ai4e_tpu_torch.config import FrameworkConfig

    routes = {"apis": [
        {"prefix": "/v1/pub/x", "backend": "http://w/v1/models/x",
         "autoscale": {"max_replicas": 8}}]}
    with pytest.raises(ValueError, match=item) as got:
        build_control_plane(FrameworkConfig.from_env(env), routes)
    from ai4e_tpu.config import FrameworkConfig as JaxConfig
    from ai4e_tpu.platform_assembly import LocalPlatform as JaxPlatform
    from ai4e_tpu.scaling import AutoscalePolicy as JaxPolicy

    with pytest.raises(ValueError) as want:
        jax_platform = JaxPlatform(
            JaxConfig.from_env(env).to_platform_config(),
            metrics=JaxRegistry())
        jax_platform.publish_async_api(
            "/v1/pub/x", "http://w/v1/models/x",
            autoscale=JaxPolicy(max_replicas=8))
    assert str(got.value) == str(want.value)
