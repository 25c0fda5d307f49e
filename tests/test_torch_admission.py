"""Admission control in the port (``ai4e_tpu_torch/admission``) across its
control plane and worker, mirroring ``tests/test_admission.py``'s classes:
the vocabulary, the gradient limiter, the priority shedder, the
controller's wiring, the gateway's async edge and sync proxy, the
dispatcher, batcher and worker hops (sync, async and stream), end to end,
and ``Dispatcher.set_concurrency`` resizing under load.

Where the two packages are interchangeable the port is held to JAX: the
same headers give the same deadline, class and propagation headers; the
same RTT sequence gives the same limit trajectory in both limiters; the
same occupancies the same shed decisions; JAX's admission-enabled control
plane and JAX's Python client are answered by the port's worker and
gateway."""

import asyncio
import importlib.util
import io
import os
import time

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu.admission import GradientLimiter as JaxLimiter
from ai4e_tpu.admission import PriorityShedder as JaxShedder
from ai4e_tpu.admission import deadline as jax_deadline
from ai4e_tpu_torch.admission import (AdmissionController, DeadlineExceeded,
                                      GradientLimiter, PriorityShedder)
from ai4e_tpu_torch.admission import deadline
from ai4e_tpu_torch.broker import Dispatcher, InMemoryBroker
from ai4e_tpu_torch.broker.queue import Message
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
from ai4e_tpu_torch.service import APIService, LocalTaskManager
from ai4e_tpu_torch.taskstore import APITask, InMemoryTaskStore, TaskStatus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(coro):
    return asyncio.run(coro)


async def serve(app):
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


PAST = lambda: time.time() - 5.0  # noqa: E731
FUTURE = lambda: time.time() + 60.0  # noqa: E731


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


# -- the vocabulary -----------------------------------------------------------

HEADER_CASES = [
    {}, {"X-Deadline-Ms": "1500"}, {"X-Deadline-Ms": "soon"},
    {"X-Deadline-Ms": "-5"}, {"X-Deadline-Ms": "0"},
    {"X-Deadline-At": "123.5", "X-Deadline-Ms": "999999"},
    {"X-Deadline-At": "nope"}, {"X-Deadline-At": "-1"},
    {"X-Priority": "interactive"}, {"X-Priority": " Background "},
    {"X-Priority": "2"}, {"X-Priority": "99"}, {"X-Priority": "-3"},
    {"X-Priority": "???"}, {"X-Priority": "default", "X-Deadline-Ms": "20"},
]


class TestVocabulary:
    @pytest.mark.parametrize("headers", HEADER_CASES,
                             ids=lambda h: ",".join(f"{k}={v}" for k, v in
                                                    h.items()) or "none")
    def test_headers_parse_as_jax_s(self, headers):
        assert (deadline.parse_deadline_at(headers, now=1000.0)
                == jax_deadline.parse_deadline_at(headers, now=1000.0))
        for default in (0, 1, 2):
            assert (deadline.parse_priority(headers, default=default)
                    == jax_deadline.parse_priority(headers, default=default))
        got = deadline.worker_admission_kwargs(headers)
        want = jax_deadline.worker_admission_kwargs(headers)
        assert got["priority"] == want["priority"]
        assert got["deadline_at"] == pytest.approx(want["deadline_at"],
                                                   abs=0.5)

    @pytest.mark.parametrize("deadline_at,priority", [
        (99.5, 2), (0.0, 1), (1.0e9 + 0.123456789, 0), (0.0, 2)])
    def test_propagation_headers_are_jax_s(self, deadline_at, priority):
        got = deadline.propagation_headers(deadline_at, priority)
        assert got == jax_deadline.propagation_headers(deadline_at, priority)
        assert got["X-Priority"] == str(priority)
        # The absolute deadline survives the hop exactly.
        assert deadline.parse_deadline_at(got) == deadline_at

    def test_names_reasons_and_statuses_are_jax_s(self):
        for p in range(-2, 5):
            assert deadline.priority_name(p) == jax_deadline.priority_name(p)
        for hop in ("gateway", "dispatcher", "batcher", "worker", "decode"):
            assert (deadline.expired_status(hop)
                    == jax_deadline.expired_status(hop))
            assert (deadline.shed_reason(hop, "pressure")
                    == jax_deadline.shed_reason(hop, "pressure"))
        for excess, rate in ((21, 10.0), (1, 0.0), (5000, 1.0), (0.1, 50)):
            assert (deadline.drain_retry_after(excess, rate)
                    == jax_deadline.drain_retry_after(excess, rate))
        for name in ("DEADLINE_MS_HEADER", "DEADLINE_AT_HEADER",
                     "PRIORITY_HEADER", "SHED_REASON_HEADER",
                     "PRIORITY_CLASSES"):
            assert getattr(deadline, name) == getattr(jax_deadline, name)
        assert deadline.remaining_s(0.0) == float("inf")
        assert deadline.remaining_s(10.0, now=4.0) == 6.0
        assert deadline.expired(10.0, now=10.0) and not deadline.expired(0.0)

    def test_expired_is_a_terminal_canonical_bucket(self):
        assert TaskStatus.EXPIRED in TaskStatus.TERMINAL
        assert TaskStatus.canonical(
            deadline.expired_status("dispatcher")) == "expired"
        assert TaskStatus.canonical("failed - expired thing") == "failed"

    def test_task_wire_shape_round_trips_and_stays_clean_by_default(self):
        plain = APITask(endpoint="/v1/x").to_dict()
        assert "DeadlineAt" not in plain and "Priority" not in plain
        d = APITask(endpoint="/v1/x", deadline_at=42.5, priority=2).to_dict()
        back = APITask.from_dict(d)
        assert back.deadline_at == 42.5 and back.priority == 2


# -- the limiter and the shedder -----------------------------------------------

def rtt_sequence(kind: str, n: int = 400) -> list[tuple[float, int]]:
    rng = np.random.default_rng(len(kind))
    if kind == "headroom":
        return [(0.01 + 0.001 * rng.random(), 8) for _ in range(n)]
    if kind == "latency-cliff":
        return ([(0.01, 16)] * (n // 2)
                + [(0.5 + rng.random(), 64) for _ in range(n // 2)])
    if kind == "idle-scope":
        return [(0.01, 2)] * n
    return [(float(rng.lognormal(-4, 1)), int(rng.integers(0, 100)))
            for _ in range(n)]


class TestGradientLimiter:
    @pytest.mark.parametrize("kind", ["headroom", "latency-cliff",
                                      "idle-scope", "noisy"])
    @pytest.mark.parametrize("window", [1, 4, 16])
    def test_same_rtts_same_trajectory_as_jax(self, kind, window):
        kw = dict(initial=8, min_limit=1, max_limit=128, window=window)
        port, ref = GradientLimiter(**kw), JaxLimiter(**kw)
        trajectory = []
        for i, (rtt, inflight) in enumerate(rtt_sequence(kind)):
            assert (port.observe(rtt, inflight)
                    == ref.observe(rtt, inflight)), i
            if i % 97 == 96:
                assert port.backoff() == ref.backoff()
            assert port.limit == ref.limit, i
            trajectory.append(port.limit)
        assert len(set(trajectory)) > 1  # the sequence moved the limit

    def test_raises_under_headroom_and_backs_off_under_latency(self):
        lim = GradientLimiter(initial=8, min_limit=1, max_limit=64, window=4)
        for _ in range(48):
            lim.observe(0.01, inflight=lim.limit)
        grown = lim.limit
        assert grown > 8
        for _ in range(48):
            lim.observe(1.0, inflight=lim.limit)
        assert lim.limit < grown

    def test_littles_law_clamp_bounds_idle_growth(self):
        lim = GradientLimiter(initial=8, min_limit=1, max_limit=512, window=4)
        for _ in range(200):
            lim.observe(0.01, inflight=2)
        assert lim.limit <= 2 * 2 + 10

    def test_bounds_respected(self):
        lim = GradientLimiter(initial=4, min_limit=2, max_limit=6, window=2)
        for _ in range(100):
            lim.observe(0.001, inflight=100)
        assert lim.limit <= 6
        for _ in range(100):
            lim.observe(5.0, inflight=100)
        assert lim.limit >= 2

    def test_backoff_is_immediate_multiplicative(self):
        lim = GradientLimiter(initial=100, min_limit=1, max_limit=200)
        assert lim.backoff()
        assert lim.limit == 80

    @pytest.mark.parametrize("triple", [(0, 8, 256), (4, 2, 256),
                                        (1, 300, 256)])
    def test_inconsistent_limits_refused_as_jax_s(self, triple):
        lo, init, hi = triple
        with pytest.raises(ValueError):
            JaxLimiter(initial=init, min_limit=lo, max_limit=hi)
        with pytest.raises(ValueError):
            GradientLimiter(initial=init, min_limit=lo, max_limit=hi)
        with pytest.raises(ValueError, match="admission limits"):
            AdmissionController(metrics=MetricsRegistry(), min_limit=lo,
                                initial_limit=init, max_limit=hi)


class TestPriorityShedder:
    def test_same_decisions_as_jax_on_a_grid(self):
        port, ref = PriorityShedder(), JaxShedder()
        for capacity in (1, 2, 10, 64, 1024):
            for occupancy in range(0, capacity + 3, max(1, capacity // 16)):
                for priority in (-1, 0, 1, 2, 5):
                    for rate in (0.0, 0.5, 40.0):
                        assert (port.check(priority, occupancy, capacity,
                                           drain_rate=rate)
                                == ref.check(priority, occupancy, capacity,
                                             drain_rate=rate))

    def test_lowest_class_sheds_first(self):
        shed = PriorityShedder()
        assert shed.check(2, 7, 10) is not None
        assert shed.check(1, 7, 10) is None
        assert shed.check(0, 7, 10) is None
        assert shed.check(1, 9, 10) is not None
        assert shed.check(0, 9, 10) is None
        assert shed.check(0, 10, 10) is not None

    def test_retry_after_scales_with_drain_rate(self):
        shed = PriorityShedder()
        assert shed.check(2, 26, 10, drain_rate=10.0) == pytest.approx(2.1)
        assert shed.check(2, 26, 10, drain_rate=0.0) == 2.0

    def test_every_class_keeps_at_least_one_slot(self):
        assert PriorityShedder().check(2, 0, 1) is None


# -- the controller ------------------------------------------------------------

class TestControllerWiring:
    def test_limit_changes_drive_targets(self):
        adm = AdmissionController(metrics=MetricsRegistry(),
                                  initial_limit=8, max_limit=64)
        applied = []
        adm.add_target("s", applied.append)
        assert applied == [8]  # applied at registration
        sc = adm.scope("s")
        for _ in range(64):
            sc.inflight = sc.limit
            sc.observe(0.01)
        sc.inflight = 0
        assert applied[-1] > 8
        gauge = adm.metrics.gauge("ai4e_admission_limit", "")
        assert gauge.value(scope="s") == sc.limit

    def test_goodput_drain_and_arrivals_from_the_store_feed(self):
        reg = MetricsRegistry()
        adm = AdmissionController(metrics=reg)
        store = InMemoryTaskStore()
        adm.attach_store(store)
        good = store.upsert(APITask(endpoint="/v1/x", deadline_at=FUTURE()))
        store.update_status(good.task_id, "completed", "completed")
        late = store.upsert(APITask(endpoint="/v1/x", deadline_at=PAST()))
        store.update_status(late.task_id, "completed", "completed")
        free = store.upsert(APITask(endpoint="/v1/x"))
        store.update_status(free.task_id, "completed", "completed")
        exp = store.upsert(APITask(endpoint="/v1/x", deadline_at=PAST()))
        store.update_status(exp.task_id, deadline.expired_status(
            "dispatcher"), TaskStatus.EXPIRED)
        counter = reg.counter("ai4e_admission_goodput_total", "")
        assert counter.value(outcome="in_deadline") == 1
        assert counter.value(outcome="late") == 1
        assert counter.value(outcome="no_deadline") == 1
        assert adm.drain_rate() > 0
        assert reg.gauge("ai4e_admission_arrival_rate", "").value() > 0
        assert {"ai4e_admission_shed_total", "ai4e_admission_expired_total",
                "ai4e_admission_limit", "ai4e_admission_goodput_total",
                "ai4e_admission_drain_rate",
                "ai4e_admission_arrival_rate"} <= set(reg._metrics)

    def test_retry_after_clamps_and_cold_fallback(self):
        adm = AdmissionController(metrics=MetricsRegistry())
        assert adm.retry_after_s() == 2.0
        for _ in range(500):
            adm.on_drain_event()
        assert adm.retry_after_s() == 1.0

    def test_async_edge_refuses_a_deadline_the_queue_cannot_meet(self):
        adm = AdmissionController(metrics=MetricsRegistry())
        for _ in range(20):
            adm.on_drain_event()  # about 2 terminal transitions a second
        assert adm.shed_async(0, 50, deadline_at=time.time() + 1.0)[1] == \
            "deadline"
        assert adm.shed_async(0, 50, deadline_at=time.time() + 600) is None
        assert adm.shed_async(0, 4, deadline_at=time.time() + 0.1) is None


# -- the gateway ---------------------------------------------------------------

def _admission_platform(**kw):
    cfg = dict(admission=True, retry_delay=0.05)
    cfg.update(kw)
    return LocalPlatform(PlatformConfig(**cfg), metrics=MetricsRegistry())


class TestGatewayAsyncEdge:
    def test_expired_request_answers_504_before_any_task_exists(self):
        async def main():
            platform = _admission_platform()
            platform.publish_async_api("/v1/pub/x",
                                       "http://127.0.0.1:9/v1/be/x")
            gw = await serve(platform.gateway.app)
            try:
                resp = await gw.post("/v1/pub/x", data=b"p",
                                     headers={"X-Deadline-At": str(PAST())})
                assert resp.status == 504
                assert resp.headers["X-Shed-Reason"] == "deadline at gateway"
                assert platform.store.depths() == {}
                expired = platform.metrics.counter(
                    "ai4e_admission_expired_total", "")
                assert expired.value(hop="gateway", priority="default") == 1
            finally:
                await gw.close()

        run(main())

    @pytest.mark.parametrize("route", ["/v1/pub/x", "/v1/pub/lm-stream"])
    def test_admitted_request_stamps_deadline_and_priority(self, route):
        """An async route, a stream route among them: the task and its
        broker message carry the anchored deadline and the class."""
        async def main():
            platform = _admission_platform()
            backend = "http://127.0.0.1:9/v1/be" + route[len("/v1/pub"):]
            platform.publish_async_api(route, backend)
            gw = await serve(platform.gateway.app)
            try:
                before = time.time()
                resp = await gw.post(route, data=b"p",
                                     headers={"X-Deadline-Ms": "60000",
                                              "X-Priority": "background"})
                assert resp.status == 200
                task = platform.store.get((await resp.json())["TaskId"])
                assert task.priority == 2
                assert task.deadline_at >= before + 59
                msg = await platform.broker.queue(
                    "/v1/be" + route[len("/v1/pub"):]).receive(timeout=1.0)
                assert msg.deadline_at == task.deadline_at
                assert msg.priority == 2
            finally:
                await gw.close()

        run(main())

    def test_backlog_sheds_lowest_priority_first_with_provenance(self):
        async def main():
            platform = _admission_platform(admission_max_backlog=10)
            platform.publish_async_api("/v1/pub/x",
                                       "http://127.0.0.1:9/v1/be/x")
            for _ in range(8):
                platform.store.upsert(APITask(endpoint="/v1/be/x",
                                              body=b"q"))
            gw = await serve(platform.gateway.app)
            try:
                shed = await gw.post("/v1/pub/x", data=b"p",
                                     headers={"X-Priority": "background"})
                assert shed.status == 429
                assert shed.headers["X-Shed-Reason"] == "pressure at gateway"
                assert int(shed.headers["Retry-After"]) >= 1
                ok = await gw.post("/v1/pub/x", data=b"p",
                                   headers={"X-Priority": "default"})
                assert ok.status == 200
                top = await gw.post("/v1/pub/x", data=b"p",
                                    headers={"X-Priority": "interactive"})
                assert top.status == 200
                shed_total = platform.metrics.counter(
                    "ai4e_admission_shed_total", "")
                assert shed_total.value(hop="gateway",
                                        priority="background") == 1
                assert platform.metrics.counter(
                    "ai4e_gateway_requests_total", "").value(
                        route="/v1/pub/x", outcome="shed") == 1
            finally:
                await gw.close()

        run(main())


class TestGatewaySyncProxy:
    def test_deadline_504_cap_shed_ordering_and_propagation(self):
        async def main():
            seen = []

            async def handler(request):
                seen.append(dict(request.headers))
                return web.json_response({"ok": True})

            app = web.Application()
            app.router.add_post("/v1/be/echo", handler)
            be = await serve(app)
            platform = _admission_platform()
            platform.publish_sync_api("/v1/pub/echo",
                                      str(be.make_url("/v1/be/echo")))
            gw = await serve(platform.gateway.app)
            try:
                resp = await gw.post("/v1/pub/echo", data=b"p",
                                     headers={"X-Deadline-At": str(PAST())})
                assert resp.status == 504
                assert resp.headers["X-Shed-Reason"] == \
                    "deadline at gateway_sync"
                assert seen == []
                resp = await gw.post("/v1/pub/echo", data=b"p",
                                     headers={"X-Deadline-Ms": "60000"})
                assert resp.status == 200
                assert "X-Deadline-At" in seen[0]
                assert "X-Deadline-Ms" not in seen[0]
                assert seen[0]["X-Priority"] == "1"
                sc = platform.admission.scope("gateway_sync")
                assert sc.inflight == 0  # released after the proxy call
                sc.inflight = max(1, int(sc.limit * 0.7))
                resp = await gw.post("/v1/pub/echo", data=b"p",
                                     headers={"X-Priority": "background"})
                assert resp.status == 503
                assert resp.headers["X-Shed-Reason"] == \
                    "pressure at gateway_sync"
                assert int(resp.headers["Retry-After"]) >= 1
                resp = await gw.post("/v1/pub/echo", data=b"p",
                                     headers={"X-Priority": "interactive"})
                assert resp.status == 200
                # GETs pass untouched by admission.
                sc.inflight = sc.limit
                assert (await gw.get("/v1/pub/echo")).status == 405
            finally:
                await gw.close()
                await be.close()

        run(main())

    def test_limiter_learns_from_proxied_round_trips(self):
        async def main():
            async def handler(request):
                return web.json_response({"ok": True})

            app = web.Application()
            app.router.add_post("/v1/be/echo", handler)
            be = await serve(app)
            platform = _admission_platform(admission_initial_limit=4)
            platform.publish_sync_api("/v1/pub/echo",
                                      str(be.make_url("/v1/be/echo")))
            gw = await serve(platform.gateway.app)
            try:
                for _ in range(48):
                    resp = await gw.post("/v1/pub/echo", data=b"p",
                                         headers={"X-Priority": "0"})
                    assert resp.status == 200
                sc = platform.admission.scope("gateway_sync")
                assert sc.inflight == 0
                assert sc.limiter._min_rtt is not None  # windows completed
                # One request in flight at a time: Little's law holds the
                # limit near twice that.
                assert sc.limit <= 2 * 1 + 4
            finally:
                await gw.close()
                await be.close()

        run(main())


# -- the dispatcher -------------------------------------------------------------

class TestDispatcherHop:
    def test_expired_message_never_reaches_the_backend(self):
        async def main():
            store = InMemoryTaskStore()
            broker = InMemoryBroker()
            adm = AdmissionController(metrics=MetricsRegistry())
            d = Dispatcher(broker, "/v1/be/x", "http://127.0.0.1:9/v1/be/x",
                           LocalTaskManager(store), retry_delay=0.01,
                           admission=adm, metrics=MetricsRegistry())
            task = store.upsert(APITask(endpoint="/v1/be/x", body=b"p",
                                        deadline_at=PAST(), priority=2))
            broker.queue("/v1/be/x").put(Message(
                task_id=task.task_id, endpoint="/v1/be/x", body=b"p", seq=1,
                queue_name="/v1/be/x", deadline_at=task.deadline_at,
                priority=2))
            msg = await broker.receive("/v1/be/x", timeout=1.0)
            await d._dispatch_one(msg)
            stored = store.get(task.task_id)
            assert stored.canonical_status == "expired"
            assert stored.status == "expired - deadline exceeded at dispatcher"
            q = broker.queue("/v1/be/x")
            assert len(q) == 0 and not q._leased
            assert d.metrics.counter("ai4e_dispatch_total", "").value(
                outcome="expired", queue="/v1/be/x", backend="") == 1
            assert adm.metrics.counter(
                "ai4e_admission_expired_total", "").value(
                    hop="dispatcher", priority="background") == 1

        run(main())

    def test_expired_redelivery_of_a_completed_task_is_a_duplicate(self):
        async def main():
            store = InMemoryTaskStore()
            broker = InMemoryBroker()
            d = Dispatcher(broker, "/q", "http://127.0.0.1:9/q",
                           LocalTaskManager(store), metrics=MetricsRegistry())
            task = store.upsert(APITask(endpoint="/q", deadline_at=PAST()))
            store.update_status(task.task_id, "completed - x", "completed")
            broker.queue("/q").put(Message(
                task_id=task.task_id, endpoint="/q", seq=1, queue_name="/q",
                deadline_at=task.deadline_at))
            await d._dispatch_one(await broker.receive("/q", timeout=1.0))
            assert store.get(task.task_id).status == "completed - x"
            assert d.metrics.counter("ai4e_dispatch_total", "").value(
                outcome="duplicate", queue="/q", backend="") == 1

        run(main())

    @pytest.mark.parametrize("with_admission", [False, True])
    def test_live_message_carries_deadline_and_priority_headers(
            self, with_admission):
        async def main():
            seen = []

            async def handler(request):
                seen.append(dict(request.headers))
                return web.Response(text="ok")

            app = web.Application()
            app.router.add_post("/v1/be/x", handler)
            be = await serve(app)
            broker = InMemoryBroker()
            adm = (AdmissionController(metrics=MetricsRegistry())
                   if with_admission else None)
            d = Dispatcher(broker, "/v1/be/x", str(be.make_url("/v1/be/x")),
                           LocalTaskManager(InMemoryTaskStore()),
                           retry_delay=0.01, admission=adm,
                           metrics=MetricsRegistry())
            at = FUTURE()
            for i, (dl, prio) in enumerate([(at, 2), (0.0, 1)]):
                broker.queue("/v1/be/x").put(Message(
                    task_id=f"t{i}", endpoint="/v1/be/x", body=b"p",
                    seq=i + 1, queue_name="/v1/be/x", deadline_at=dl,
                    priority=prio))
                await d._dispatch_one(await broker.receive("/v1/be/x",
                                                           timeout=1.0))
            await d._sessions.close()
            await be.close()
            return seen, adm

        seen, adm = run(main())
        assert seen[0]["X-Deadline-At"] == repr(seen and float(
            seen[0]["X-Deadline-At"]))
        assert seen[0]["X-Priority"] == "2"
        # Nothing stamped: the header set is the pre-admission one unless
        # a controller runs (then the class is explicit).
        assert "X-Deadline-At" not in seen[1]
        assert ("X-Priority" in seen[1]) is with_admission
        if with_admission:
            assert adm.scope("dispatch:/v1/be/x").limiter._samples

    def test_backpressure_backs_the_limiter_off(self):
        async def main():
            async def handler(request):
                return web.Response(status=503, headers={"Retry-After": "1"})

            app = web.Application()
            app.router.add_post("/q", handler)
            be = await serve(app)
            broker = InMemoryBroker(max_delivery_count=1)
            adm = AdmissionController(metrics=MetricsRegistry(),
                                      initial_limit=10)
            d = Dispatcher(broker, "/q", str(be.make_url("/q")),
                           LocalTaskManager(InMemoryTaskStore()),
                           retry_delay=0.001, admission=adm,
                           metrics=MetricsRegistry())
            applied = []
            adm.add_target("dispatch:/q", applied.append)
            broker.queue("/q").put(Message(task_id="t", endpoint="/q", seq=1,
                                           queue_name="/q"))
            await d._dispatch_one(await broker.receive("/q", timeout=1.0))
            await d._sessions.close()
            await be.close()
            return applied

        assert run(main()) == [10, 8]


# -- the batcher and the worker -------------------------------------------------

def _echo_worker(store=None, metrics=None):
    from ai4e_tpu_torch.runtime.batcher import MicroBatcher
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime
    from ai4e_tpu_torch.runtime.worker import InferenceWorker

    reg = metrics or MetricsRegistry()
    runtime = ModelRuntime(device="cpu")
    servable = runtime.register(build_servable("echo", name="double", size=4,
                                               buckets=(1, 2, 4)))
    batcher = MicroBatcher(runtime, max_wait_ms=1.0, metrics=reg)
    tm = LocalTaskManager(store) if store is not None else None
    worker = InferenceWorker("w", runtime, batcher, task_manager=tm,
                             prefix="v1", store=store, metrics=reg)
    worker.serve_model(servable)
    return worker, batcher, reg


class TestBatcherHop:
    def test_expired_entry_dropped_at_cut_live_entry_executes(self):
        async def main():
            worker, batcher, reg = _echo_worker()
            rows = []
            run_batch = worker.runtime.run_batch_phases
            worker.runtime.run_batch_phases = lambda name, batch: (
                rows.append(len(batch)) or run_batch(name, batch))
            await batcher.start()
            try:
                x = np.ones(4, np.float32)
                dead = asyncio.ensure_future(
                    batcher.submit("double", x, deadline_at=PAST()))
                live = asyncio.ensure_future(
                    batcher.submit("double", x, deadline_at=FUTURE()))
                with pytest.raises(DeadlineExceeded) as exc:
                    await dead
                assert exc.value.hop == "batcher"
                assert (await live) == {"echo": [1.0] * 4}
                counter = reg.counter("ai4e_admission_expired_total", "")
                assert counter.value(hop="batcher",
                                     priority="interactive") == 1
                assert rows == [1]  # the dead example never reached a batch
            finally:
                await batcher.stop()

        run(main())

    def test_all_expired_cut_runs_nothing(self):
        async def main():
            worker, batcher, reg = _echo_worker()
            await batcher.start()
            try:
                futs = [asyncio.ensure_future(batcher.submit(
                    "double", np.ones(4, np.float32), priority=2,
                    deadline_at=PAST())) for _ in range(3)]
                for f in futs:
                    with pytest.raises(DeadlineExceeded):
                        await f
                assert batcher.pending_count == 0
                assert reg.counter("ai4e_admission_expired_total", "").value(
                    hop="batcher", priority="background") == 3
                assert "ai4e_batch_size" not in reg.render_prometheus() or \
                    'ai4e_batch_size_count{model="double"}' not in \
                    reg.render_prometheus()
            finally:
                await batcher.stop()

        run(main())


class _StubBackend:
    name = "lm"
    max_len = 32
    servable = None


class _StubEngine:
    """The decode engine's surface ``serve_stream`` reads; ``submit``
    records its arguments and raises what the test sets."""

    def __init__(self, raise_exc=None):
        self.backend = _StubBackend()
        self.pending_count = 0
        self.max_pending = 8
        self.active_count = 0
        self.calls = []
        self.raise_exc = raise_exc

    async def submit(self, prompt, max_new, on_token=None, priority=0,
                     deadline_at=0.0, ledger=None):
        self.calls.append((prompt, max_new, priority, deadline_at))
        if self.raise_exc is not None:
            raise self.raise_exc
        return [1, 2]


async def _wait_terminal(store, task_id):
    for _ in range(300):
        if store.get(task_id).canonical_status in TaskStatus.TERMINAL:
            break
        await asyncio.sleep(0.01)
    return store.get(task_id)


class TestWorkerHop:
    def test_expired_async_task_transitions_terminal_without_batching(self):
        async def main():
            store = InMemoryTaskStore()
            worker, batcher, reg = _echo_worker(store)
            task = store.upsert(APITask(endpoint="/v1/double-async"))
            wc = await serve(worker.service.app)
            try:
                resp = await wc.post(
                    "/v1/double-async", data=npy(np.ones(4, np.float32)),
                    headers={"taskId": task.task_id,
                             "X-Deadline-At": str(PAST()),
                             "X-Priority": "2"})
                assert resp.status == 200
                stored = await _wait_terminal(store, task.task_id)
                assert stored.status == "expired - deadline exceeded at worker"
                assert batcher.pending_count == 0
                assert reg.counter("ai4e_admission_expired_total", "").value(
                    hop="worker", priority="background") == 1
            finally:
                await wc.close()

        run(main())

    def test_async_task_expiring_in_the_batcher_ends_expired(self):
        async def main():
            store = InMemoryTaskStore()
            worker, batcher, reg = _echo_worker(store)
            task = store.upsert(APITask(endpoint="/v1/double-async"))
            wc = await serve(worker.service.app)
            try:
                # Live at the worker's check, dead by the batch cut: the
                # flusher is not running until after the deadline.
                resp = await wc.post(
                    "/v1/double-async", data=npy(np.ones(4, np.float32)),
                    headers={"taskId": task.task_id,
                             "X-Deadline-Ms": "150"})
                assert resp.status == 200
                await asyncio.sleep(0.3)
                await batcher.start()
                stored = await _wait_terminal(store, task.task_id)
                assert stored.status == \
                    "expired - deadline exceeded at batcher"
                assert reg.counter("ai4e_admission_expired_total", "").value(
                    hop="batcher", priority="interactive") == 1
            finally:
                await batcher.stop()
                await wc.close()

        run(main())

    def test_sync_request_expired_and_queued_past_its_deadline(self):
        async def main():
            worker, batcher, _ = _echo_worker()
            wc = await serve(worker.service.app)
            try:
                resp = await wc.post(
                    "/v1/double", data=npy(np.ones(4, np.float32)),
                    headers={"X-Deadline-At": str(PAST())})
                assert resp.status == 504
                assert resp.headers["X-Shed-Reason"] == "deadline at worker"
                pending = asyncio.ensure_future(wc.post(
                    "/v1/double", data=npy(np.ones(4, np.float32)),
                    headers={"X-Deadline-Ms": "100"}))
                await asyncio.sleep(0.25)
                await batcher.start()
                resp = await pending
                assert resp.status == 504
                assert resp.headers["X-Shed-Reason"] == "deadline at batcher"
                ok = await wc.post("/v1/double",
                                   data=npy(np.ones(4, np.float32)),
                                   headers={"X-Deadline-Ms": "60000",
                                            "X-Priority": "background"})
                assert ok.status == 200
            finally:
                await batcher.stop()
                await wc.close()

        run(main())

    @pytest.mark.parametrize("case", ["expired", "live", "engine-expiry"])
    def test_stream_requests_shed_and_expire(self, case):
        async def main():
            store = InMemoryTaskStore()
            worker, _, reg = _echo_worker(store)
            engine = _StubEngine(
                DeadlineExceeded("decode") if case == "engine-expiry"
                else None)
            worker.serve_stream(engine)
            task = store.upsert(APITask(endpoint="/v1/lm-stream-async"))
            wc = await serve(worker.service.app)
            headers = {"taskId": task.task_id, "X-Priority": "background",
                       "X-Deadline-At": str(PAST() if case == "expired"
                                            else FUTURE())}
            try:
                resp = await wc.post("/v1/lm-stream-async",
                                     data=b'{"prompt": [1, 2, 3]}',
                                     headers=headers)
                assert resp.status == 200
                return await _wait_terminal(store, task.task_id), engine, reg
            finally:
                await wc.close()

        stored, engine, reg = run(main())
        if case == "expired":
            assert stored.status == "expired - deadline exceeded at worker"
            assert engine.calls == []
            assert reg.counter("ai4e_admission_expired_total", "").value(
                hop="worker", priority="background") == 1
        elif case == "live":
            assert stored.status == "completed - 2 tokens"
            (_, _, priority, at), = engine.calls
            assert priority == 2 and at > time.time()
        else:
            assert stored.status == "expired - deadline exceeded at decode"


# -- end to end ------------------------------------------------------------------

class TestEndToEnd:
    def test_task_expiring_in_the_broker_is_shed_not_executed(self):
        async def main():
            platform = _admission_platform()
            executed = []
            svc = APIService("slow", prefix="v1/slow",
                             task_manager=platform.task_manager,
                             metrics=MetricsRegistry())

            @svc.api_async_func("/work")
            async def work(taskId, body, content_type):
                executed.append(taskId)
                await platform.task_manager.complete_task(taskId, "completed")

            svc_client = await serve(svc.app)
            platform.publish_async_api(
                "/v1/pub/work", str(svc_client.make_url("/v1/slow/work")))
            gw = await serve(platform.gateway.app)
            try:
                resp = await gw.post("/v1/pub/work", data=b"p",
                                     headers={"X-Deadline-Ms": "120"})
                assert resp.status == 200
                tid = (await resp.json())["TaskId"]
                await asyncio.sleep(0.25)
                await platform.start()
                stored = await _wait_terminal(platform.store, tid)
                assert stored.canonical_status == "expired"
                assert executed == []
                resp = await gw.get(f"/v1/taskmanagement/task/{tid}",
                                    params={"wait": "5"})
                assert "expired" in (await resp.json())["Status"]
                assert platform.metrics.counter(
                    "ai4e_admission_expired_total", "").value(
                        hop="dispatcher", priority="default") == 1
            finally:
                await platform.stop()
                await gw.close()
                await svc_client.close()

        run(main())

    def test_admission_off_leaves_everything_untouched(self):
        async def main():
            platform = LocalPlatform(PlatformConfig(retry_delay=0.05),
                                     metrics=MetricsRegistry())
            platform.publish_async_api("/v1/pub/x",
                                       "http://127.0.0.1:9/v1/be/x")
            gw = await serve(platform.gateway.app)
            try:
                resp = await gw.post(
                    "/v1/pub/x", data=b"p",
                    headers={"X-Deadline-At": str(PAST()),
                             "X-Priority": "background"})
                assert resp.status == 200
                task = platform.store.get((await resp.json())["TaskId"])
                assert task.deadline_at == 0.0 and task.priority == 1
                assert "DeadlineAt" not in task.to_dict()
                msg = await platform.broker.queue("/v1/be/x").receive(
                    timeout=1.0)
                assert msg.deadline_at == 0.0 and msg.priority == 1
                assert platform.admission is None
                assert platform.gateway._admission is None
                assert all(d.admission is None
                           for d in platform.dispatchers.dispatchers.values())
            finally:
                await gw.close()

        run(main())

    def test_control_plane_from_config_wires_every_hop(self):
        """``AI4E_PLATFORM_ADMISSION=1`` through ``build_control_plane``:
        the gateway and every dispatcher share one controller; a plain
        route's fan-out is its queue limiter's, an ``autoscale`` route's
        stays the autoscaler's."""
        from ai4e_tpu_torch.cli import build_control_plane
        from ai4e_tpu_torch.config import FrameworkConfig

        config = FrameworkConfig.from_env({
            "AI4E_PLATFORM_ADMISSION": "1",
            "AI4E_PLATFORM_ADMISSION_INITIAL_LIMIT": "3",
            "AI4E_PLATFORM_ADMISSION_MAX_BACKLOG": "77"})
        platform = build_control_plane(config, {"apis": [
            {"prefix": "/v1/pub/a", "backend": "http://w/v1/be/a"},
            {"prefix": "/v1/pub/b", "backend": "http://w/v1/be/b",
             "autoscale": {"min_replicas": 2, "max_replicas": 6}}]})
        adm = platform.admission
        assert adm is not None and platform.gateway._admission is adm
        assert adm.initial_limit == 3 and adm.max_backlog == 77
        pool = platform.dispatchers.dispatchers
        assert all(d.admission is adm for d in pool.values())
        assert pool["/v1/be/a"].concurrency == 3
        assert "dispatch:/v1/be/a" in adm._scopes
        assert "dispatch:/v1/be/b" not in adm._scopes

    def test_jax_control_plane_with_admission_is_answered_by_the_port(self):
        """JAX's admission-enabled platform in front of the port's worker:
        its dispatcher's absolute deadline and class reach the port's
        batcher (a live task completes; one that outlives its budget in
        the port's batcher ends ``expired`` at the batcher)."""
        from ai4e_tpu.metrics import MetricsRegistry as JaxMetrics
        from ai4e_tpu.platform_assembly import LocalPlatform as JaxPlatform
        from ai4e_tpu.platform_assembly import \
            PlatformConfig as JaxPlatformConfig

        async def main():
            platform = JaxPlatform(JaxPlatformConfig(admission=True,
                                                     retry_delay=0.05),
                                   metrics=JaxMetrics())
            worker, batcher, reg = _echo_worker(platform.store)
            seen = []
            submit = batcher.submit

            async def recording(name, example, **kw):
                seen.append(kw)
                return await submit(name, example, **kw)

            batcher.submit = recording
            wc = await serve(worker.service.app)
            platform.publish_async_api(
                "/v1/pub/double", str(wc.make_url("/v1/double-async")))
            gw = await serve(platform.gateway.app)
            await platform.start()
            await batcher.start()
            try:
                resp = await gw.post("/v1/pub/double",
                                     data=npy(np.ones(4, np.float32)),
                                     headers={"X-Deadline-Ms": "60000",
                                              "X-Priority": "background"})
                assert resp.status == 200
                tid = (await resp.json())["TaskId"]
                r = await gw.get(f"/v1/taskmanagement/task/{tid}",
                                 params={"wait": "10"})
                record = await r.json()
                assert record["Status"].startswith("completed"), record
                assert seen[0]["priority"] == 2
                assert seen[0]["deadline_at"] == pytest.approx(
                    platform.store.get(tid).deadline_at)
                result = platform.store.get_result(tid)
                assert result is not None
            finally:
                await batcher.stop()
                await platform.stop()
                await gw.close()
                await wc.close()

        run(main())


class TestJaxClientOnThePortGateway:
    def test_run_derives_deadline_from_timeout_and_wait_raises_expired(self):
        spec = importlib.util.spec_from_file_location(
            "ai4e_client",
            os.path.join(ROOT, "clients", "python", "ai4e_client.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        async def main():
            platform = _admission_platform()
            platform.publish_async_api("/v1/pub/x",
                                       "http://127.0.0.1:9/v1/be/x")
            gw = await serve(platform.gateway.app)
            base = str(gw.make_url("/")).rstrip("/")
            try:
                client = mod.AI4EClient(base, retries=0)
                before = time.time()
                tid = await asyncio.to_thread(
                    client.submit, "/v1/pub/x", b"p",
                    deadline_ms=45000, priority="background")
                task = platform.store.get(tid)
                assert task.priority == 2
                assert task.deadline_at == pytest.approx(before + 45.0,
                                                         abs=5.0)
                platform.store.update_status(
                    tid, deadline.expired_status("dispatcher"),
                    TaskStatus.EXPIRED)
                with pytest.raises(mod.TaskExpired):
                    await asyncio.to_thread(client.wait, tid, 5.0, 1.0)
            finally:
                await gw.close()

        run(main())


# -- Dispatcher.set_concurrency under load ------------------------------------------

class TestSetConcurrencyResize:
    def test_shrink_and_grow_while_busy_loses_and_duplicates_nothing(self):
        async def main():
            gate = asyncio.Event()
            hits: dict[str, int] = {}

            async def handler(request):
                tid = request.headers["taskId"]
                hits[tid] = hits.get(tid, 0) + 1
                await gate.wait()
                return web.Response(text="ok")

            app = web.Application()
            app.router.add_post("/v1/be/x", handler)
            be = await serve(app)
            broker = InMemoryBroker()
            broker.bind_loop(asyncio.get_running_loop())
            d = Dispatcher(broker, "/v1/be/x", str(be.make_url("/v1/be/x")),
                           LocalTaskManager(InMemoryTaskStore()),
                           retry_delay=0.01, concurrency=3,
                           metrics=MetricsRegistry())
            for i in range(6):
                broker.publish(APITask(task_id=f"t{i}", endpoint="/v1/be/x",
                                       body=b"p"))
            await d.start()
            q = broker.queue("/v1/be/x")
            try:
                for _ in range(300):
                    if len(hits) == 3:
                        break
                    await asyncio.sleep(0.01)
                assert len(hits) == 3 and d._busy == 3
                d.set_concurrency(1)
                gate.set()
                for _ in range(500):
                    if len(hits) == 6:
                        break
                    await asyncio.sleep(0.01)
                assert len(hits) == 6 and set(hits.values()) == {1}
                for _ in range(300):
                    if len([w for w in d._workers if not w.done()]) == 1:
                        break
                    await asyncio.sleep(0.01)
                assert len([w for w in d._workers if not w.done()]) == 1
                d.set_concurrency(4)
                assert len([w for w in d._workers if not w.done()]) == 4
                for i in range(6, 10):
                    broker.publish(APITask(task_id=f"t{i}",
                                           endpoint="/v1/be/x", body=b"p"))
                for _ in range(500):
                    if len(hits) == 10 and len(q) == 0 and not q._leased:
                        break
                    await asyncio.sleep(0.01)
                assert len(hits) == 10 and set(hits.values()) == {1}
                assert len(q) == 0 and not q._leased and d._busy == 0
            finally:
                await d.stop()
                await be.close()

        run(main())

    def test_resize_before_start_only_records_the_level(self):
        d = Dispatcher(InMemoryBroker(), "/q", "http://127.0.0.1:9/q",
                       LocalTaskManager(InMemoryTaskStore()), concurrency=2,
                       metrics=MetricsRegistry())
        d.set_concurrency(7)
        assert d.concurrency == 7 and d._workers == []

    def test_shrink_to_zero_then_grow(self):
        async def main():
            broker = InMemoryBroker()
            broker.bind_loop(asyncio.get_running_loop())
            d = Dispatcher(broker, "/q", "http://127.0.0.1:9/q",
                           LocalTaskManager(InMemoryTaskStore()),
                           concurrency=2, metrics=MetricsRegistry())
            await d.start()
            try:
                d.set_concurrency(0)
                for _ in range(300):
                    if not [w for w in d._workers if not w.done()]:
                        break
                    await asyncio.sleep(0.01)
                assert not [w for w in d._workers if not w.done()]
                d.set_concurrency(3)
                assert len([w for w in d._workers if not w.done()]) == 3
            finally:
                await d.stop()

        run(main())
