"""The hop ledger end to end, on the CPU: the JAX package's control plane
and worker, and the port's, each pair over HTTP on loopback ports with
``AI4E_PLATFORM_OBSERVABILITY`` and ``AI4E_OBSERVABILITY_HOP_LEDGER`` on,
serve the same scripted requests (async, sync, retired by a drain and
redelivered, refused with 503 while the worker drains). Each task's
timeline, as ``(event, hop, reason)`` with ``t`` and ``ms`` left out and
the worker's loopback address masked, must be equal on both sides; so must
the gateway's outcome counters. The same holds for the land-cover UNet at
a small width.

One test, the span log, holds the port alone: its gateway, dispatcher and
worker spans of a task share one trace id, each parented by the span
before it (JAX's dispatch span starts a trace of its own)."""

import asyncio
import copy
import io
import socket

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu.cli import build_control_plane as jax_build_control_plane
from ai4e_tpu.cli import build_worker as jax_build_worker
from ai4e_tpu.config import FrameworkConfig as JaxConfig
from ai4e_tpu.observability import InMemoryExporter as JaxInMemoryExporter
from ai4e_tpu.observability import configure_tracer as jax_configure_tracer
from ai4e_tpu_torch.cli import build_control_plane, build_worker
from ai4e_tpu_torch.config import FrameworkConfig
from ai4e_tpu_torch.observability import InMemoryExporter, configure_tracer

PREFIX = "v1/w"
#: The worker's async batching window: long enough that the drain test's
#: request is still uncut when the drain begins, short against the test.
MAX_WAIT_MS = 300
RETRY_DELAY = 0.5  # s: the first redelivery waits 0.25-0.5 s
ENV = {"AI4E_PLATFORM_OBSERVABILITY": "1",
       "AI4E_PLATFORM_RETRY_DELAY": str(RETRY_DELAY),
       "AI4E_PLATFORM_FLIGHT_SAMPLE": "1.0",
       "AI4E_OBSERVABILITY_HOP_LEDGER": "1",
       "AI4E_RUNTIME_BATCH_MAX_WAIT_MS": str(MAX_WAIT_MS)}
#: One bucket of 8: the JAX worker's runtime rounds buckets up to a
#: multiple of the devices it sees, 8 on the tests' virtual CPU mesh.
ECHO = {"family": "echo", "name": "echo", "size": 4, "buckets": [8],
        "sync_path": "/echo", "async_path": "/echo-async"}
UNET = {"family": "unet", "name": "landcover", "tile": 16,
        "widths": [4, 8], "num_classes": 4, "buckets": [8],
        "sync_path": "/classify", "async_path": "/classify-async"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def masked(events: list[dict], worker_netloc: str) -> list[tuple]:
    """``(e, h, r)`` of each event, the worker's address as ``WORKER``."""
    return [(ev["e"], ev["h"],
             None if "r" not in ev
             else ev["r"].replace(worker_netloc, "WORKER"))
            for ev in events]


class Side:
    """One package's control plane and worker over HTTP, started and
    stopped around a scripted drive."""

    def __init__(self, side: str, model: dict, example):
        self.side, self.model, self.example = side, model, example

    async def __aenter__(self):
        cp_port, wk_port = free_port(), free_port()
        self.worker_netloc = f"127.0.0.1:{wk_port}"
        worker_url = f"http://{self.worker_netloc}"
        name = self.model["name"]
        public = f"/v1/public/{name}"
        self.routes = {"async": public + "-async", "sync": public}
        routes = {"apis": [
            {"prefix": public + "-async", "mode": "async",
             "backend": f"{worker_url}/{PREFIX}{self.model['async_path']}"},
            {"prefix": public, "mode": "sync",
             "backend": f"{worker_url}/{PREFIX}{self.model['sync_path']}"}]}
        spec = {"service_name": "w", "prefix": PREFIX,
                "taskstore": f"http://127.0.0.1:{cp_port}",
                "models": [copy.deepcopy(self.model)]}
        if self.side == "jax":
            config = JaxConfig.from_env(ENV)
            self.platform = jax_build_control_plane(config, routes)
            self.worker, self.batcher, _ = jax_build_worker(config, spec)
        else:
            config = FrameworkConfig.from_env(ENV)
            self.platform = build_control_plane(config, routes)
            self.worker, self.batcher, _ = build_worker(
                spec, device="cpu", config=config)
        self.gw = TestClient(TestServer(self.platform.gateway.app,
                                        port=cp_port))
        await self.gw.start_server()
        await self.platform.start()
        await self.batcher.start()
        self.svc = TestClient(TestServer(self.worker.service.app,
                                         port=wk_port))
        await self.svc.start_server()
        return self

    async def __aexit__(self, *exc):
        await self.platform.stop()
        await self.batcher.stop()
        for client in (self.worker.service.task_manager, self.worker.store):
            await client.close()
        await self.svc.close()
        await self.gw.close()

    # -- the drive -----------------------------------------------------------

    async def submit(self) -> str:
        resp = await self.gw.post(
            self.routes["async"], data=npy(self.example),
            headers={"Content-Type": "application/octet-stream"})
        assert resp.status == 200, await resp.text()
        return (await resp.json())["TaskId"]

    async def record(self, task_id: str) -> dict:
        resp = await self.gw.get(f"/v1/taskmanagement/task/{task_id}",
                                 params={"wait": "30", "ledger": "1"})
        return await resp.json()

    async def until(self, task_id: str, predicate, what: str) -> None:
        for _ in range(1500):
            ledger = self.platform.store.get_ledger(task_id)
            status = self.platform.store.get(task_id).status
            if predicate(status, [ev["e"] for ev in ledger]):
                return
            await asyncio.sleep(0.01)
        raise AssertionError(f"{self.side}: {what} never came: {ledger}")

    async def worker_verb(self, verb: str) -> None:
        resp = await self.svc.post(f"/{PREFIX}/worker/{verb}")
        assert resp.status == 200, await resp.text()

    async def drive(self) -> dict:
        """The script: an async request; a sync one; an async request
        retired from the batcher by a drain, refused with 503 while the
        worker drains, served after the resume; an async request refused
        with 503 by a worker drained before it came, served after the
        resume."""
        out = {}
        # JAX's control plane counts into its process-wide registry, which
        # an earlier test in the process may have used: count the drive's
        # own outcomes.
        before = self.outcome_counts()
        plain = await self.submit()
        out["async"] = await self.record(plain)
        resp = await self.gw.post(
            self.routes["sync"], data=npy(self.example),
            headers={"Content-Type": "application/octet-stream"})
        assert resp.status == 200, await resp.text()

        retired = await self.submit()
        await self.until(retired, lambda s, _: s.startswith("running"),
                         "adoption")
        await self.worker_verb("drain")
        await self.until(retired, lambda _, evs: "backpressure" in evs,
                         "a backpressure after the drain")
        await self.worker_verb("resume")
        out["drain_redelivered"] = await self.record(retired)

        await self.worker_verb("drain")
        refused = await self.submit()
        await self.until(refused, lambda _, evs: "backpressure" in evs,
                         "a backpressure from the drained worker")
        await self.worker_verb("resume")
        out["backpressured"] = await self.record(refused)
        out["outcomes"] = sorted(
            (route, outcome, value - before.get((route, outcome), 0.0))
            for (route, outcome), value in self.outcome_counts().items()
            if value != before.get((route, outcome), 0.0))
        return out

    def outcome_counts(self) -> dict:
        metrics = self.platform.metrics.counter(
            "ai4e_request_outcomes_total", "")
        return {(labels["route"], labels["outcome"]): value
                for _, _, labels, value in metrics.collect()}


def drive(side: str, model: dict, example) -> dict:
    async def main():
        async with Side(side, model, example) as s:
            out = await s.drive()
            out["timelines"] = {
                k: masked(out[k]["Ledger"], s.worker_netloc)
                for k in ("async", "drain_redelivered", "backpressured")}
            return out

    return asyncio.run(main())


EXAMPLES = {
    "echo": (ECHO, np.arange(4, dtype=np.float32)),
    "landcover": (UNET, np.random.default_rng(0).integers(
        0, 256, (16, 16, 3), dtype=np.uint8)),
}


@pytest.fixture(scope="module", params=sorted(EXAMPLES))
def both(request):
    model, example = EXAMPLES[request.param]
    return (request.param, drive("jax", model, example),
            drive("port", model, example))


class TestTimelines:
    @pytest.mark.parametrize("case", ["async", "drain_redelivered",
                                      "backpressured"])
    def test_same_events_as_jax(self, both, case):
        _, jax_out, port_out = both
        assert port_out["timelines"][case] == jax_out["timelines"][case]
        assert port_out[case]["Status"] == jax_out[case]["Status"]

    def test_timelines_are_whole(self, both):
        """Every hop stamped: the gateway's, the dispatcher's, the
        batcher's and the device's, then the store's completion."""
        _, _, port_out = both
        want = ["admitted", "published", "popped", "delivered", "batched",
                "h2d", "execute", "d2h", "completed"]
        for case in ("async", "drain_redelivered", "backpressured"):
            events = [e for e, _, _ in port_out["timelines"][case]]
            assert [e for e in events if e in want][-7:] == want[2:], events
            assert events[:2] == ["admitted", "published"]
            assert events.count("backpressure") == (0 if case == "async"
                                                    else 1)
        events = [e for e, _, _ in port_out["timelines"]["drain_redelivered"]]
        assert ("retry", "worker", "draining") in \
            port_out["timelines"]["drain_redelivered"], events

    def test_same_outcome_counters(self, both):
        _, jax_out, port_out = both
        assert port_out["outcomes"] == jax_out["outcomes"]
        assert ("/v1/public/echo", "ok", 1.0) in port_out["outcomes"] or \
            ("/v1/public/landcover", "ok", 1.0) in port_out["outcomes"]


class TestSpans:
    def test_gateway_dispatcher_worker_share_one_trace(self):
        """The port's spans of one async task: create_task (gateway) ->
        dispatch (dispatcher) -> the endpoint's span (worker), one trace id,
        each the parent of the next; a sync request's worker span is a
        root."""
        exporter = InMemoryExporter()
        configure_tracer(exporter=exporter)
        try:
            async def main():
                model, example = EXAMPLES["echo"]
                async with Side("port", model, example) as s:
                    task_id = await s.submit()
                    await s.record(task_id)
                    return task_id

            task_id = asyncio.run(main())
        finally:
            configure_tracer(exporter=None)
        spans = {s.service: s for s in exporter.by_task(task_id)}
        assert set(spans) == {"gateway", "dispatcher", "w"}
        gw, disp, wk = spans["gateway"], spans["dispatcher"], spans["w"]
        assert gw.name == "create_task" and gw.parent_id is None
        assert disp.name == "dispatch" and disp.parent_id == gw.span_id
        assert wk.name == "/echo-async" and wk.parent_id == disp.span_id
        assert gw.trace_id == disp.trace_id == wk.trace_id

    def test_jax_dispatch_starts_its_own_trace(self):
        """What the port changes: JAX's dispatch span is a root (its
        message carries no trace context), its worker span its child."""
        exporter = JaxInMemoryExporter()
        jax_configure_tracer(exporter=exporter)
        try:
            async def main():
                model, example = EXAMPLES["echo"]
                async with Side("jax", model, example) as s:
                    task_id = await s.submit()
                    await s.record(task_id)
                    return task_id

            task_id = asyncio.run(main())
        finally:
            jax_configure_tracer(exporter=None)
        spans = {s.service: s for s in exporter.by_task(task_id)}
        assert spans["dispatcher"].parent_id is None
        assert spans["gateway"].trace_id != spans["dispatcher"].trace_id
        assert spans["w"].parent_id == spans["dispatcher"].span_id


def test_masking_is_only_the_worker_address():
    events = [{"e": "delivered", "h": "dispatcher", "t": 1.0,
               "r": "127.0.0.1:5"},
              {"e": "h2d", "h": "device", "t": 2.0, "ms": 1.5},
              {"e": "admitted", "h": "gateway", "t": 0.5, "r": "/v1/a"}]
    assert masked(events, "127.0.0.1:5") == [
        ("delivered", "dispatcher", "WORKER"), ("h2d", "device", None),
        ("admitted", "gateway", "/v1/a")]
