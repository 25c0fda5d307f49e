"""The port's control plane (``ai4e_tpu_torch``: task store and its HTTP
surface, broker, dispatcher, gateway, the HTTP store clients) held against
the JAX package's, in process behind aiohttp test servers: the same request
sequences give the same statuses, JSON bodies and task records, and each
side's clients work against the other side's store."""

import asyncio
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu import platform_assembly as jax_pa
from ai4e_tpu.service import task_manager as jax_tm
from ai4e_tpu.taskstore import APITask as JaxTask
from ai4e_tpu.taskstore import InMemoryTaskStore as JaxStore
from ai4e_tpu.taskstore.http import make_app as jax_make_app
from ai4e_tpu_torch import platform_assembly as port_pa
from ai4e_tpu_torch.service import task_manager as port_tm
from ai4e_tpu_torch.taskstore import APITask as PortTask
from ai4e_tpu_torch.taskstore import InMemoryTaskStore as PortStore
from ai4e_tpu_torch.taskstore.http import make_app as port_make_app

ROOT = Path(__file__).resolve().parent.parent
SIDES = {
    "jax": (JaxStore, jax_make_app, jax_pa, jax_tm),
    "port": (PortStore, port_make_app, port_pa, port_tm),
}
TASKS = {"jax": JaxTask, "port": PortTask}
# What may differ between two runs of one sequence.
VOLATILE = ("Timestamp",)


def masked(body):
    if isinstance(body, dict):
        return {k: ("*" if k in VOLATILE else masked(v))
                for k, v in body.items()}
    if isinstance(body, list):
        return [masked(v) for v in body]
    return body


async def answer(resp) -> tuple:
    raw = await resp.read()
    try:
        body = json.loads(raw) if raw else None
    except json.JSONDecodeError:
        body = raw
    return resp.status, masked(body)


# -- the task store's HTTP surface -------------------------------------------

STORE_SEQUENCE = [
    ("post", "/v1/taskstore/upsert",
     {"json": {"TaskId": "t1", "Endpoint": "http://w/v1/m/classify-async",
               "Body": "tile", "ContentType": "application/octet-stream"}}),
    ("get", "/v1/taskstore/task", {"params": {"taskId": "t1"}}),
    ("get", "/v1/taskstore/task/t1", {}),
    ("post", "/v1/taskstore/update",
     {"json": {"TaskId": "t1", "Status": "running - landcover inference"}}),
    ("post", "/v1/taskstore/update",
     {"json": {"TaskId": "t1", "Status": "late", "ExpectedStatus": "created"}}),
    ("post", "/v1/taskstore/result",
     {"params": {"taskId": "t1"}, "data": b'{"class_histogram": {"0": 4}}',
      "headers": {"Content-Type": "application/json"}}),
    ("post", "/v1/taskstore/update",
     {"json": {"TaskId": "t1", "Status": "completed - class_histogram",
               "BackendStatus": "completed", "ExpectedStatus": "running"}}),
    ("get", "/v1/taskstore/result", {"params": {"taskId": "t1"}}),
    ("get", "/v1/taskstore/depths", {}),
    ("post", "/v1/taskstore/upsert",
     {"json": {"TaskId": "t2", "Endpoint": "/v1/m/score-async",
               "DeadlineAt": 5.0, "Priority": 2, "Tenant": "a"}}),
    ("post", "/v1/taskstore/upsert",
     {"json": {"TaskId": "t2", "Endpoint": "/v1/m/score-async",
               "Status": "failed - x", "BackendStatus": "failed"}}),
    ("get", "/v1/taskstore/depths", {}),
    ("post", "/v1/taskstore/update",
     {"json": {"TaskId": "nope", "Status": "running"}}),
    ("post", "/v1/taskstore/update",
     {"json": {"TaskId": "nope", "Status": "x", "ExpectedStatus": "created"}}),
    ("post", "/v1/taskstore/update", {"json": {"TaskId": "t1"}}),
    ("get", "/v1/taskstore/task", {"params": {"taskId": "nope"}}),
    ("get", "/v1/taskstore/task", {}),
    ("post", "/v1/taskstore/result", {"params": {"taskId": "nope"},
                                      "data": b"x"}),
    ("get", "/v1/taskstore/result", {"params": {"taskId": "t2"}}),
    ("post", "/v1/taskstore/upsert", {"json": {"TaskId": "a:b"}}),
    ("post", "/v1/taskstore/upsert", {"json": {"TaskId": "a~b"}}),
    ("post", "/v1/taskstore/upsert", {"data": b"{not json"}),
]


class TestTaskStoreSurface:
    def test_same_sequence_same_answers(self):
        async def run(side: str) -> list:
            store_cls, make_app, _, _ = SIDES[side]
            async with TestClient(TestServer(make_app(store_cls()))) as client:
                out = []
                for method, path, kw in STORE_SEQUENCE:
                    resp = await getattr(client, method)(path, **kw)
                    out.append(await answer(resp))
                    if path == "/v1/taskstore/result" and method == "get":
                        out.append(resp.headers.get("Content-Type"))
                return out

        jax_out, port_out = asyncio.run(run("jax")), asyncio.run(run("port"))
        assert port_out == jax_out
        assert jax_out[4][0] == 409 and jax_out[6][0] == 200  # sanity

    @pytest.mark.parametrize("path", [
        "/v1/taskstore/role", "/v1/taskstore/journal", "/v1/taskstore/shards"])
    def test_unported_routes_are_404(self, path):
        async def run():
            async with TestClient(TestServer(port_make_app(PortStore()))) as c:
                return (await c.get(path, params={"taskId": "t"})).status

        assert asyncio.run(run()) == 404


# -- terminal retention ------------------------------------------------------


def retention_sequence(side: str) -> list:
    """Three tasks, two of them finished, one with a staged result: what
    ``evict_terminal_older_than`` leaves of the store."""
    store, task_cls = SIDES[side][0](), TASKS[side]
    for tid in ("done", "failed", "running"):
        store.upsert(task_cls(task_id=tid, endpoint="/v1/m/x-async",
                              body=b"body"))
    store.set_result("done", b"{}")
    store.set_result("done", b"[]", stage="a")
    store.update_status("done", "completed - a", backend_status="completed")
    store.update_status("failed", "failed - x", backend_status="failed")
    store.update_status("running", "running - x")
    out = [store.evict_terminal_older_than(60.0),
           store.evict_terminal_older_than(0.0)]
    for tid in ("done", "failed", "running"):
        try:
            out.append(store.get(tid).status)
        except KeyError:
            out.append(None)
    out += [store.get_result("done"), store.get_result("done", stage="a"),
            store.depths()]
    return out


class TestTerminalRetention:
    def test_eviction_leaves_what_jax_s_leaves(self):
        got = retention_sequence("port")
        assert got == retention_sequence("jax")
        assert got[:5] == [0, 2, None, None, "running - x"]
        assert got[5] is None and got[6] is None

    @pytest.mark.parametrize("retention", [None, 0.0, 60.0, -1.0])
    def test_platform_retention_is_jax_s(self, retention):
        """None keeps finished tasks 900 s, a negative value forever."""
        def kept(pa):
            platform = pa.LocalPlatform(pa.PlatformConfig(
                reaper_terminal_retention=retention))
            return (None if platform.reaper is None
                    else platform.reaper.terminal_retention)

        assert kept(port_pa) == kept(jax_pa)

    def test_platform_evicts_a_finished_task(self):
        """Retention 0, swept every 20 ms: a completed task's record and
        result are gone from the gateway soon after it finishes, on both
        sides."""
        async def run(side):
            _, _, pa, _ = SIDES[side]
            box: dict = {}
            backend_app, _calls = fake_backend(box, refusals=0)
            backend = TestServer(backend_app)
            await backend.start_server()
            platform = pa.LocalPlatform(pa.PlatformConfig(
                retry_delay=0.01, reaper_terminal_retention=0.0,
                reaper_interval=0.02))
            box["platform"] = platform
            platform.publish_async_api(
                "/v1/pub/detect",
                f"http://127.0.0.1:{backend.port}/v1/be/detect")
            await platform.start()
            try:
                async with TestClient(TestServer(platform.gateway.app)) as c:
                    task_id = (await (await c.post(
                        "/v1/pub/detect", data=b"x")).json())["TaskId"]
                    final = await (await c.get(
                        f"/v1/taskmanagement/task/{task_id}",
                        params={"wait": "10"})).json()
                    for _ in range(500):
                        status = (await c.get(
                            f"/v1/taskmanagement/task/{task_id}")).status
                        if status == 404:
                            break
                        await asyncio.sleep(0.01)
            finally:
                await platform.stop()
                await backend.close()
            return (final["BackendStatus"], status,
                    platform.store.get_result(task_id))

        assert asyncio.run(run("port")) == asyncio.run(run("jax")) == (
            "completed", 404, None)


# -- gateway + broker + dispatcher in front of one backend -------------------


def fake_backend(platform_box: dict, refusals: int = 2):
    """A backend that answers 503 ``refusals`` times, then 200; on the 200 it
    runs the task through the platform's own task manager as a worker
    would. Also a sync route that echoes its body."""
    calls = {"n": 0}

    async def detect(request: web.Request) -> web.Response:
        calls["n"] += 1
        if calls["n"] <= refusals:
            return web.Response(status=503, text="busy",
                                headers={"Retry-After": "1"})
        task_id = request.headers["taskId"]
        body = await request.read()
        platform = platform_box["platform"]
        tm = platform.task_manager
        await tm.update_task_status(task_id, "running - detect")
        platform.store.set_result(task_id, json.dumps(
            {"bytes": len(body), "tail": request.path}).encode())
        await tm.complete_task(task_id, "completed - bytes, tail")
        return web.json_response({"TaskId": task_id})

    async def echo(request: web.Request) -> web.Response:
        return web.json_response({"echo": (await request.read()).decode(),
                                  "query": request.query_string})

    app = web.Application()
    app.router.add_post("/v1/be/detect{tail:.*}", detect)
    app.router.add_post("/v1/be/echo", echo)
    return app, calls


async def drive_platform(side: str) -> dict:
    _, make_app, pa, _ = SIDES[side]
    box: dict = {}
    backend_app, calls = fake_backend(box)
    backend = TestServer(backend_app)
    await backend.start_server()
    base = f"http://127.0.0.1:{backend.port}"
    platform = pa.LocalPlatform(pa.PlatformConfig(retry_delay=0.01))
    box["platform"] = platform
    make_app(platform.store, app=platform.gateway.app)
    platform.publish_async_api("/v1/pub/detect", base + "/v1/be/detect")
    platform.publish_sync_api("/v1/pub/echo", base + "/v1/be/echo")
    records = []
    platform.store.add_listener(
        lambda t: records.append((t.status, t.backend_status)))
    await platform.start()
    try:
        async with TestClient(TestServer(platform.gateway.app)) as client:
            resp = await client.post("/v1/pub/detect/tile?x=1", data=b"abc",
                                     headers={"Content-Type":
                                              "application/octet-stream"})
            created = await answer(resp)
            task_id = (await resp.json())["TaskId"]
            final = await answer(await client.get(
                f"/v1/taskmanagement/task/{task_id}", params={"wait": "10"}))
            result = await answer(await client.get(
                "/v1/taskstore/result", params={"taskId": task_id}))
            unknown = (await client.get(
                "/v1/taskmanagement/task/nope")).status
            sync = await answer(await client.post("/v1/pub/echo?q=2",
                                                  data=b"hello"))
            health = await answer(await client.get("/healthz"))
    finally:
        await platform.stop()
        await backend.close()
    out = {"created": (created[0], dict(created[1], TaskId="*")),
           "final": (final[0], dict(final[1], TaskId="*")),
           "result": result, "unknown": unknown, "sync": sync,
           "health": health, "records": records, "calls": calls["n"]}
    # The backend's port differs from run to run.
    return json.loads(json.dumps(out).replace(base, "http://backend"))


class TestGatewayAndDispatcher:
    def test_backpressure_redelivery_same_records(self):
        jax_out = asyncio.run(drive_platform("jax"))
        port_out = asyncio.run(drive_platform("port"))
        assert port_out == jax_out
        assert jax_out["calls"] == 3
        assert jax_out["records"][0] == ["created", "created"]
        assert jax_out["records"].count(
            ["Awaiting service availability", "created"]) == 2
        assert jax_out["final"][1]["Status"] == "completed - bytes, tail"
        assert (jax_out["final"][1]["Endpoint"]
                == "http://backend/v1/be/detect/tile?x=1")
        assert jax_out["result"] == [200, {"bytes": 3,
                                           "tail": "/v1/be/detect/tile"}]
        assert jax_out["unknown"] == 404
        assert jax_out["sync"] == [200, {"echo": "hello", "query": "q=2"}]

    def test_dead_letter_after_the_delivery_budget(self):
        """A backend that always refuses: after ``max_delivery_count``
        deliveries the task reads JAX's dead-letter status on both sides."""
        async def run(side):
            _, make_app, pa, _ = SIDES[side]
            box: dict = {}
            backend_app, calls = fake_backend(box, refusals=10**6)
            backend = TestServer(backend_app)
            await backend.start_server()
            platform = pa.LocalPlatform(pa.PlatformConfig(
                retry_delay=0.01, max_delivery_count=3))
            box["platform"] = platform
            platform.publish_async_api(
                "/v1/pub/detect",
                f"http://127.0.0.1:{backend.port}/v1/be/detect")
            await platform.start()
            try:
                async with TestClient(TestServer(platform.gateway.app)) as c:
                    task_id = (await (await c.post(
                        "/v1/pub/detect", data=b"x")).json())["TaskId"]
                    final = await (await c.get(
                        f"/v1/taskmanagement/task/{task_id}",
                        params={"wait": "10"})).json()
            finally:
                await platform.stop()
                await backend.close()
            return final["Status"], final["BackendStatus"], calls["n"]

        assert asyncio.run(run("port")) == asyncio.run(run("jax")) == (
            "failed - delivery attempts exhausted", "failed", 3)


# -- the HTTP store clients against either store -----------------------------


async def client_sequence(tm, rs) -> list:
    def record(d):
        return d if d is None else dict(masked(d), TaskId="*")

    out = []
    created = await tm.add_task("http://w/v1/m/x-async", b"body")
    tid = created["TaskId"]
    out.append(record(created))
    out.append(record(await tm.add_task("ignored", b"", task_id=tid))
               == record(created))
    out.append(record(await tm.update_task_status(tid, "running - x")))
    out.append(await tm.update_task_status_if(tid, "created", "late"))
    out.append(await tm.is_terminal(tid))
    await rs.set_result(tid, b'{"a": 1}')
    out.append(await rs.get_result(tid))
    out.append(await rs.get_result("nope"))
    out.append(record(await tm.complete_task(tid, "completed - a")))
    out.append(await tm.is_terminal(tid))
    out.append(await tm.get_task_status("nope"))
    out.append(record(await tm.add_pipeline_task(tid, "http://w/v1/m/x-async")))
    out.append(record(await tm.update_task_status_if(
        tid, "created", "running - again")))
    with pytest.raises(KeyError):
        await tm.update_task_status("nope", "running")
    await rs.set_result("nope", b"x")  # dropped with a warning, as in JAX
    return out


class TestStoreClients:
    @pytest.mark.parametrize("client_side,store_side", [
        ("port", "jax"), ("jax", "port"), ("port", "port"), ("jax", "jax")])
    def test_clients_against_either_store(self, client_side, store_side):
        async def run():
            store_cls, make_app, _, _ = SIDES[store_side]
            tm_mod = SIDES[client_side][3]
            server = TestServer(make_app(store_cls()))
            await server.start_server()
            url = f"http://127.0.0.1:{server.port}"
            tm, rs = tm_mod.HttpTaskManager(url), tm_mod.HttpResultStore(url)
            try:
                return await client_sequence(tm, rs)
            finally:
                await tm.close()
                await rs.close()
                await server.close()

        got = asyncio.run(run())
        assert got[1] is True and got[3] is None
        assert got[4] is False and got[7]["Status"] == "completed - a"
        assert got[8] is True and got[9] is None
        assert got[5] == (b'{"a": 1}', "application/json")
        assert got[10]["Status"] == "created"
        reference = self.reference()
        assert got == reference

    _reference = None

    @classmethod
    def reference(cls):
        if cls._reference is None:
            async def run():
                server = TestServer(jax_make_app(JaxStore()))
                await server.start_server()
                url = f"http://127.0.0.1:{server.port}"
                tm, rs = jax_tm.HttpTaskManager(url), jax_tm.HttpResultStore(url)
                try:
                    return await client_sequence(tm, rs)
                finally:
                    await tm.close()
                    await rs.close()
                    await server.close()
            cls._reference = asyncio.run(run())
        return cls._reference

    @pytest.mark.parametrize("store_side", ["jax", "port"])
    def test_replica_list_skips_a_dead_first_url(self, store_side):
        dead = f"http://127.0.0.1:{free_port()}"

        async def run():
            store_cls, make_app, _, _ = SIDES[store_side]
            server = TestServer(make_app(store_cls()))
            await server.start_server()
            live = f"http://127.0.0.1:{server.port}"
            tm = port_tm.HttpTaskManager([dead, live])
            rs = port_tm.HttpResultStore(f"{dead},{live}".split(","))
            try:
                task = await tm.add_task("/v1/m/x", b"b")
                await rs.set_result(task["TaskId"], b"{}")
                record = await tm.get_task_status(task["TaskId"])
                return tm.base_url == live, record["Status"], \
                    await rs.get_result(task["TaskId"])
            finally:
                await tm.close()
                await rs.close()
                await server.close()

        assert asyncio.run(run()) == (True, "created",
                                      (b"{}", "application/json"))

    def test_refusals_are_typed(self):
        async def run():
            async def refuse(_request):
                return web.Response(status=503, headers={
                    "X-Shed-Reason": "journal-degraded", "Retry-After": "5"})

            app = web.Application()
            app.router.add_post("/v1/taskstore/update", refuse)
            server = TestServer(app)
            await server.start_server()
            tm = port_tm.HttpTaskManager(f"http://127.0.0.1:{server.port}")
            try:
                with pytest.raises(port_tm.StoreRefusalError) as info:
                    await tm.update_task_status("t", "running")
                return info.value.status, info.value.retry_after
            finally:
                await tm.close()
                await server.close()

        assert asyncio.run(run()) == (503, "5")


# -- the port's worker behind the port's control plane, in process ----------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


class TestSaturation:
    def test_saturated_worker_503s_and_every_task_completes(self):
        """An echo worker whose batcher holds 2 requests behind a 200 ms
        window, 12 async tasks at a route concurrency of 8: the worker
        refuses with 503 + Retry-After before adopting, the dispatcher
        redelivers, and every task completes with the right result."""
        from ai4e_tpu_torch.cli import build_worker

        async def run():
            platform = port_pa.LocalPlatform(port_pa.PlatformConfig(
                retry_delay=0.02))
            port_make_app(platform.store, app=platform.gateway.app)
            cp_port = free_port()
            cp_url = f"http://127.0.0.1:{cp_port}"
            spec = {"service_name": "echo", "prefix": "v1/echo",
                    "taskstore": cp_url,
                    "models": [{"family": "echo", "name": "echo", "size": 4,
                                "buckets": [1, 2], "sync_path": "/run",
                                "async_path": "/run-async"}]}
            worker, batcher, tm = build_worker(spec, device="cpu",
                                               max_wait_ms=200, max_pending=2)
            await batcher.start()
            wk = TestServer(worker.service.app)
            await wk.start_server()
            platform.publish_async_api(
                "/v1/pub/run", f"http://127.0.0.1:{wk.port}/v1/echo/run-async",
                concurrency=8)
            cp = TestServer(platform.gateway.app, port=cp_port)
            await cp.start_server()
            await platform.start()
            try:
                async with TestClient(cp) as client:
                    ids = []
                    for i in range(12):
                        resp = await client.post(
                            "/v1/pub/run", data=npy(np.full(4, i, np.float32)))
                        ids.append((await resp.json())["TaskId"])
                    finals = [await (await client.get(
                        f"/v1/taskmanagement/task/{t}",
                        params={"wait": "30"})).json() for t in ids]
                    results = [json.loads(await (await client.get(
                        "/v1/taskstore/result", params={"taskId": t})).read())
                        for t in ids]
                    metrics = await (await client.get("/metrics")).text()
            finally:
                await platform.stop()
                await worker.service.drain(timeout=5)
                await batcher.stop()
                await tm.close()
                await worker.store.close()
                await wk.close()
            return finals, results, metrics

        finals, results, metrics = asyncio.run(run())
        assert [f["Status"] for f in finals] == ["completed - echo"] * 12
        assert [r["echo"] for r in results] == [[float(i)] * 4
                                                for i in range(12)]
        backpressure = sum(
            float(line.rsplit(" ", 1)[1]) for line in metrics.splitlines()
            if line.startswith("ai4e_dispatch_total")
            and 'outcome="backpressure"' in line)
        assert backpressure >= 1


    @pytest.mark.parametrize("broker", [False, True])
    def test_saturated_after_adoption(self, broker):
        """A batcher that fills between admission and submit: with a broker
        behind the worker's store the task, created there with its body as
        a gateway creates it, goes back to the broker (status ``created``,
        republished with that body); a standalone worker, with nothing to
        redeliver the task, fails it."""
        from ai4e_tpu_torch.cli import build_worker
        from ai4e_tpu_torch.runtime.batcher import BatcherSaturated

        spec = {"service_name": "echo", "prefix": "v1/echo",
                "models": [{"family": "echo", "name": "echo", "size": 4,
                            "buckets": [1, 2], "sync_path": "/run",
                            "async_path": "/run-async"}]}
        worker, batcher, _tm = build_worker(spec, device="cpu")
        body = npy(np.ones(4, np.float32))
        published, headers = [], {}
        if broker:
            worker.store.set_publisher(published.append)
            headers["taskId"] = worker.store.upsert(PortTask(
                task_id="", endpoint="/v1/echo/run-async", body=body)).task_id

        async def saturated(*_args, **_kwargs):
            raise BatcherSaturated("full")

        batcher.submit = saturated

        async def run():
            await batcher.start()
            try:
                async with TestClient(TestServer(worker.service.app)) as c:
                    task_id = (await (await c.post(
                        "/v1/echo/run-async", data=body,
                        headers=headers)).json())["TaskId"]
                    for _ in range(500):
                        record = await (await c.get(
                            f"/v1/echo/task/{task_id}")).json()
                        if published or record["BackendStatus"] == "failed":
                            break
                        await asyncio.sleep(0.01)
            finally:
                await batcher.stop()
            return record

        record = asyncio.run(run())
        if broker:
            assert record["Status"] == record["BackendStatus"] == "created"
            assert [t.body for t in published] == [body]
        else:
            assert record["Status"] == "failed: full"
            assert record["BackendStatus"] == "failed"
            assert published == []


class TestControlPlaneSpec:
    def test_deployed_routes_give_jax_s_routes_and_queues(self):
        """deploy/specs/routes.json as written: the same published routes,
        modes and edge caps, the same dispatcher queues with their
        concurrency and retry delay, internal route included, and one
        autoscaler for each of the four ``autoscale`` routes with the same
        endpoint, policy fields, interval and starting replicas."""
        import dataclasses

        from ai4e_tpu.cli import build_control_plane as jax_build
        from ai4e_tpu.config import FrameworkConfig as JaxConfig
        from ai4e_tpu_torch.cli import build_control_plane as port_build
        from ai4e_tpu_torch.config import FrameworkConfig as PortConfig

        text = (ROOT / "deploy/specs/routes.json").read_text()
        env = {"AI4E_PLATFORM_RETRY_DELAY": "0.5",
               "AI4E_GATEWAY_MAX_BODY_BYTES": "1024"}

        def layout(platform):
            return (
                [(r.prefix, r.mode, r.backend_uri, r.max_body_bytes)
                 for r in platform.gateway.routes],
                platform.gateway.max_body_bytes,
                sorted((q, d.backend_uri, d.concurrency, d.retry_delay)
                       for q, d in platform.dispatchers.dispatchers.items()),
                sorted((a.endpoint_path, dataclasses.astuple(a.policy),
                        a.interval, a.target.replicas)
                       for a in platform.autoscalers))

        want = layout(jax_build(JaxConfig.from_env(env), json.loads(text)))
        got = layout(port_build(PortConfig.from_env(env), json.loads(text)))
        assert got == want
        assert "/v1/models/classify-species-batch-async" in [
            q for q, *_ in want[2]]
        assert len(want[3]) == sum(
            "autoscale" in a for a in json.loads(text)["apis"]) == 4


class TestIsolation:
    def test_control_plane_imports_and_assembles_without_torch_or_jax(self):
        code = (
            "import sys, importlib\n"
            "for name in ('torch', 'jax', 'jaxlib', 'flax', 'orbax', "
            "'ai4e_tpu'):\n"
            "    sys.modules[name] = None\n"
            "mods = ['config', 'utils.http', 'taskstore', 'taskstore.http',\n"
            "        'taskstore.reaper', 'taskstore.results',\n"
            "        'taskstore.native',\n"
            "        'service', 'service.task_manager', 'broker',\n"
            "        'broker.dispatcher', 'broker.native', 'gateway',\n"
            "        'resilience.retry',\n"
            "        'scaling', 'platform_assembly', 'cli']\n"
            "for m in mods:\n"
            "    importlib.import_module('ai4e_tpu_torch.' + m)\n"
            "from ai4e_tpu_torch.cli import build_control_plane\n"
            "from ai4e_tpu_torch.config import FrameworkConfig\n"
            "p = build_control_plane(FrameworkConfig.from_env({}), {'apis': [\n"
            "    {'prefix': '/v1/a', 'backend': 'http://w/v1/m/a'},\n"
            "    {'prefix': '/v1/s', 'backend': 'http://w/v1/m/s',\n"
            "     'mode': 'sync'}]})\n"
            "print(len(p.gateway.routes), len(mods))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["2", "17"]
