"""The port's typed API definitions (``ai4e_tpu_torch/gateway/
registration.py``) held against the JAX package's on the CPU: the same
public prefixes and backend URIs, ``routes_from_definitions`` equal to
JAX's, ``load_definitions`` reading one ``apis.json`` alike, an async
definition served end to end on the port's platform, the ``definitions``
key of routes.json in both packages' ``build_control_plane``, and the
port's control-plane CLI, as a child process, serving a routes.json whose
``definitions`` and weighted ``backends`` reach backends in this
process."""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
from aiohttp import ClientSession, web
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.gateway.registration as jax_reg
import ai4e_tpu_torch.gateway.registration as port_reg
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry

ROOT = Path(__file__).resolve().parents[1]

DEFINITIONS = [
    {"organization": "camera-trap", "api": "detection",
     "backend_host": "http://worker:8081"},
    {"organization": "org", "api": "seg", "backend_host": "http://w:1/",
     "backend_path": "/v1/landcover/classify-async", "concurrency": 4,
     "retry_delay": 0.5, "autoscale": {"max_replicas": 8},
     "operations": ["classify", "tile"]},
    {"organization": "o", "api": "b", "backend_host": "http://w:1",
     "mode": "sync", "version": "v2"},
]


def run(coro):
    return asyncio.run(coro)


@pytest.mark.parametrize("rec", DEFINITIONS, ids=["plain", "knobs", "sync"])
def test_definition_shapes_equal_jax_s(rec):
    want = jax_reg.ApiDefinition.from_dict(rec)
    got = port_reg.ApiDefinition.from_dict(rec)
    assert (got.public_prefix, got.backend_uri, got.operations) == (
        want.public_prefix, want.backend_uri, want.operations)


def test_reference_url_shape():
    d = port_reg.ApiDefinition(organization="camera-trap", api="detection",
                               backend_host="http://worker:8081")
    assert d.public_prefix == "/v1/camera-trap/detection"
    assert d.backend_uri == "http://worker:8081/v1/detection"


def test_routes_from_definitions_equal_jax_s():
    want = jax_reg.routes_from_definitions(
        [jax_reg.ApiDefinition.from_dict(r) for r in DEFINITIONS])
    got = port_reg.routes_from_definitions(
        [port_reg.ApiDefinition.from_dict(r) for r in DEFINITIONS])
    assert got == want
    assert got["apis"][1] == {
        "prefix": "/v1/org/seg", "mode": "async",
        "backend": "http://w:1/v1/landcover/classify-async",
        "concurrency": 4, "retry_delay": 0.5,
        "autoscale": {"max_replicas": 8}}


def test_load_definitions_equal_jax_s(tmp_path):
    path = tmp_path / "apis.json"
    path.write_text(json.dumps({"apis": DEFINITIONS}))
    got = port_reg.load_definitions(str(path))
    want = jax_reg.load_definitions(str(path))
    assert [vars(d) for d in got] == [vars(d) for d in want]
    assert got[1].operations == ("classify", "tile")


def test_async_definition_served_end_to_end():
    from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
    from ai4e_tpu_torch.service import APIService

    async def main():
        platform = LocalPlatform(PlatformConfig(retry_delay=0.05),
                                 metrics=PortRegistry())
        svc = APIService("det", prefix="v1/detection",
                         task_manager=platform.task_manager,
                         metrics=platform.metrics)

        @svc.api_async_func("/detect")
        def detect(taskId, body, content_type):
            asyncio.run(platform.task_manager.complete_task(
                taskId, "completed - registered"))

        svc_client = TestClient(TestServer(svc.app))
        await svc_client.start_server()
        port_reg.register_definitions(platform, [port_reg.ApiDefinition(
            organization="camera-trap", api="detection",
            backend_host=str(svc_client.make_url("")).rstrip("/"),
            backend_path="/v1/detection/detect")])
        gw = TestClient(TestServer(platform.gateway.app))
        await gw.start_server()
        await platform.start()
        try:
            resp = await gw.post("/v1/camera-trap/detection", data=b"x")
            tid = (await resp.json())["TaskId"]
            final = await (await gw.get(f"/v1/taskmanagement/task/{tid}",
                                        params={"wait": "10"})).json()
            return final["Status"]
        finally:
            await platform.stop()
            await gw.close()
            await svc_client.close()

    assert run(main()) == "completed - registered"


def test_definitions_key_in_both_control_planes():
    from ai4e_tpu.cli import build_control_plane as jax_build
    from ai4e_tpu.config import FrameworkConfig as JaxConfig
    from ai4e_tpu_torch.cli import build_control_plane as port_build
    from ai4e_tpu_torch.config import FrameworkConfig as PortConfig

    routes = {"definitions": DEFINITIONS[:1] + DEFINITIONS[2:],
              "apis": [{"prefix": "/v1/pub/x",
                        "backends": [{"uri": "http://a/v1/x", "weight": 3},
                                     {"uri": "http://b/v1/x", "weight": 1}]}]}
    want = jax_build(JaxConfig(), routes).gateway.routes
    got = port_build(PortConfig(), routes).gateway.routes
    assert ([(r.prefix, r.mode, r.backend_uri, r.cacheable) for r in got]
            == [(r.prefix, r.mode, r.backend_uri, r.cacheable)
                for r in want])
    assert [r.prefix for r in got] == ["/v1/camera-trap/detection",
                                       "/v2/o/b", "/v1/pub/x"]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_control_plane_cli_serves_definitions_and_backends(tmp_path):
    """``python -m ai4e_tpu_torch control-plane`` on a routes.json with a
    sync and an async definition and a weighted async route: the sync
    definition proxies to this process's backend, the async ones reach it
    through the dispatchers with their ``taskId``, and the startup line
    names the transport."""
    async def main():
        seen: list = []

        async def sync_run(request):
            return web.json_response({"echo": (await request.read()).decode()})

        async def async_run(request):
            seen.append((request.path, request.headers.get("taskId"),
                         await request.read()))
            return web.json_response({"ok": True})

        app = web.Application()
        app.router.add_post("/v1/echo", sync_run)
        app.router.add_post("/v1/w/run-async", async_run)
        app.router.add_post("/v1/w/run-async/{tail:.*}", async_run)
        backend = TestServer(app)
        await backend.start_server()
        host = str(backend.make_url("")).rstrip("/")
        cp_port = free_port()
        routes = {
            "definitions": [
                {"organization": "o", "api": "echo", "backend_host": host,
                 "mode": "sync"},
                {"organization": "o", "api": "run", "backend_host": host,
                 "backend_path": "/v1/w/run-async"}],
            "apis": [{"prefix": "/v1/pub/w",
                      "backends": [{"uri": host + "/v1/w/run-async",
                                    "weight": 1},
                                   {"uri": host + "/v1/w/run-async",
                                    "weight": 2}]}]}
        spec = tmp_path / "routes.json"
        spec.write_text(json.dumps(routes))
        log = tmp_path / "cp.log"
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("AI4E_")}
        env.update(PYTHONPATH=str(ROOT), AI4E_PLATFORM_RETRY_DELAY="0.05")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ai4e_tpu_torch", "control-plane",
                 "--routes", str(spec), "--port", str(cp_port)],
                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)
        base = f"http://127.0.0.1:{cp_port}"
        try:
            async with ClientSession() as http:
                deadline = time.monotonic() + 60
                while "control plane on" not in log.read_text():
                    assert proc.poll() is None, log.read_text()
                    assert time.monotonic() < deadline, log.read_text()
                    await asyncio.sleep(0.1)
                async with http.post(base + "/v1/o/echo",
                                     data=b"hi") as r:
                    sync = (r.status, await r.json())
                for path in ("/v1/o/run/tile", "/v1/pub/w"):
                    async with http.post(base + path, data=b"img") as r:
                        assert r.status == 200
                deadline = time.monotonic() + 20
                while len(seen) < 2:
                    assert time.monotonic() < deadline, seen
                    await asyncio.sleep(0.05)
            return sync, sorted((p, b, bool(t)) for p, t, b in seen)
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=30)
            await backend.close()

    sync, delivered = run(main())
    assert sync == (200, {"echo": "hi"})
    assert delivered == [("/v1/w/run-async", b"img", True),
                         ("/v1/w/run-async/tile", b"img", True)]
    line = next(x for x in (tmp_path / "cp.log").read_text().splitlines()
                if "control plane on" in x)
    assert "(3 routes, transport queue" in line
