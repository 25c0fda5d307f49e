"""The port's request reporter (``ai4e_tpu_torch/metrics/reporter.py``)
held against the JAX package's on the CPU: one script of deltas gives
equal values and ``/metrics`` samples on both packages' reporters, each
package's client feeds the other's reporter, the service shell reports
two replicas' in-flight requests (the sum, then 0), a dead reporter does
not break requests, and the port's ``reporter`` verb serves as a child
process. Every reporter counts into a registry of its own."""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest
from aiohttp import ClientSession
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.metrics.reporter as jax_rep
import ai4e_tpu_torch.metrics.reporter as port_rep
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry
from ai4e_tpu_torch.service import APIService

ROOT = Path(__file__).resolve().parents[1]
JAX = types.SimpleNamespace(rep=jax_rep, Registry=JaxRegistry)
PORT = types.SimpleNamespace(rep=port_rep, Registry=PortRegistry)

#: ``(cluster, path, increment, decrement)``: a decrement overtaking its
#: increment, a second path and cluster, a counter back at 0.
SCRIPT = [("h100", "/v1/lc", 1, 0), ("h100", "/v1/lc", 1, 0),
          ("h100", "/v1/lc", 0, 1), ("h100", "/v1/det", 0, 1),
          ("h100", "/v1/det", 1, 0), ("cpu", "/v1/lc", 3, 0),
          ("h100", "/v1/lc", 0, 1), ("cpu", "/v1/lc", 0, 1)]


def run(coro):
    return asyncio.run(coro)


async def serve(app) -> TestClient:
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def gauge_samples(text: str) -> list[str]:
    return sorted(x for x in text.splitlines()
                  if x.startswith("ai4e_current_requests{"))


async def scripted(ns):
    """The script through the reporter's HTTP surface: each answer, the
    values read back, the missing-path 400s and the gauge samples."""
    svc = ns.rep.RequestReporterService(metrics=ns.Registry())
    client = await serve(svc.app)
    try:
        answers = []
        for cluster, path, inc, dec in SCRIPT:
            r = await client.post("/v1/processing", json={
                "Cluster": cluster, "Path": path, "IncrementBy": inc,
                "DecrementBy": dec})
            answers.append((r.status, await r.json()))
        values = []
        for cluster, path in (("h100", "/v1/lc"), ("h100", "/v1/det"),
                              ("cpu", "/v1/lc"), ("cpu", "/v1/none")):
            r = await client.get("/v1/processing",
                                 params={"cluster": cluster, "path": path})
            values.append((await r.json())["CurrentRequests"])
        bad = [(await client.post("/v1/processing",
                                  json={"Cluster": "x"})).status,
               (await client.get("/v1/processing")).status,
               (await client.post("/v1/processing", data=b"{")).status]
        metrics = await (await client.get("/metrics")).text()
        return (answers, values, bad, gauge_samples(metrics),
                svc.counters.snapshot())
    finally:
        await client.close()


def test_one_script_gives_equal_values_and_samples():
    want = run(scripted(JAX))
    got = run(scripted(PORT))
    assert got == want
    answers, values, bad, samples, snapshot = got
    assert values == [0, 0, 2, 0]
    assert bad == [400, 400, 400]
    assert samples == [
        'ai4e_current_requests{cluster="cpu",path="/v1/lc"} 2',
        'ai4e_current_requests{cluster="h100",path="/v1/det"} 0',
        'ai4e_current_requests{cluster="h100",path="/v1/lc"} 0']
    assert snapshot == {("h100", "/v1/lc"): 0, ("h100", "/v1/det"): 0,
                        ("cpu", "/v1/lc"): 2}


def test_counters_clamp_reads_and_decay_stale_residue():
    for ns in (JAX, PORT):
        c = ns.rep.ProcessingCounters(ns.Registry(), stale_after=0.05)
        assert c.adjust("g", "/p", decrement=2) == 0
        assert c.adjust("g", "/p", increment=3) == 1
        time.sleep(0.1)
        assert c.value("g", "/p") == 0
        assert c.adjust("g", "/p", increment=1) == 1


@pytest.mark.parametrize("client_of,reporter_of", [("jax", "port"),
                                                   ("port", "jax")],
                         ids=["jax-client-port-reporter",
                              "port-client-jax-reporter"])
def test_each_package_s_client_feeds_the_other_s_reporter(client_of,
                                                          reporter_of):
    ns = {"jax": JAX, "port": PORT}

    async def main():
        svc = ns[reporter_of].rep.RequestReporterService(
            metrics=ns[reporter_of].Registry())
        http = await serve(svc.app)
        client = ns[client_of].rep.ProcessingReporterClient(
            str(http.make_url("/")), cluster="h100")
        try:
            for _ in range(3):
                client.report("/v1/lc", increment=1)
            client.report("/v1/lc", decrement=1)
            await client.drain()
            return (svc.counters.value("h100", "/v1/lc"),
                    await client.current("/v1/lc"),
                    await client.current("/v1/none"))
        finally:
            await client.close()
            await http.close()

    assert run(main()) == (2, 2, 0)


def test_service_reports_cross_replica_counts():
    """Two replicas of one API, each with a request held open, report to
    one reporter: it reads 2, then 0 once both answered."""
    async def main():
        reporter_svc = port_rep.RequestReporterService(
            metrics=PortRegistry())
        rep_http = await serve(reporter_svc.app)
        uri = str(rep_http.make_url("/"))
        release = threading.Event()
        replicas, clients = [], []
        for i in range(2):
            reporter = port_rep.ProcessingReporterClient(uri, cluster="h100")
            svc = APIService(f"echo{i}", prefix="v1/echo",
                             metrics=PortRegistry(), reporter=reporter)

            @svc.api_sync_func("/run")
            def handler(body, content_type):
                release.wait(timeout=5.0)
                return {"ok": True}

            replicas.append(reporter)
            clients.append(await serve(svc.app))
        try:
            posts = [asyncio.create_task(c.post("/v1/echo/run", data=b"x"))
                     for c in clients]
            deadline = time.monotonic() + 5
            while reporter_svc.counters.value("h100", "/v1/echo/run") < 2:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.02)
            peak = reporter_svc.counters.value("h100", "/v1/echo/run")
            release.set()
            statuses = [(await p).status for p in posts]
            for reporter in replicas:
                await reporter.drain()
            return peak, statuses, reporter_svc.counters.value(
                "h100", "/v1/echo/run")
        finally:
            release.set()
            for reporter in replicas:
                await reporter.close()
            for c in clients:
                await c.close()
            await rep_http.close()

    assert run(main()) == (2, [200, 200], 0)


def test_dead_reporter_does_not_break_requests():
    async def main():
        reporter = port_rep.ProcessingReporterClient("http://127.0.0.1:1",
                                                     cluster="h100")
        svc = APIService("echo", prefix="v1/echo", metrics=PortRegistry(),
                         reporter=reporter)

        @svc.api_sync_func("/run")
        def handler(body, content_type):
            return {"ok": True}

        client = await serve(svc.app)
        try:
            statuses = [(await client.post("/v1/echo/run",
                                           data=b"x")).status
                        for _ in range(3)]
            await reporter.drain()
            return statuses
        finally:
            await reporter.close()
            await client.close()

    assert run(main()) == [200, 200, 200]


def test_the_reporter_verb_serves(tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("AI4E_")}
    env.update(PYTHONPATH=str(ROOT), AI4E_SERVICE_HOST="127.0.0.1")
    log = tmp_path / "reporter.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ai4e_tpu_torch", "reporter", "--port",
             str(port)], cwd=ROOT, env=env, stdout=out,
            stderr=subprocess.STDOUT)

    async def main():
        base = f"http://127.0.0.1:{port}"
        async with ClientSession() as http:
            deadline = time.monotonic() + 60
            while "request reporter on" not in log.read_text():
                assert proc.poll() is None, log.read_text()
                assert time.monotonic() < deadline, log.read_text()
                await asyncio.sleep(0.1)
            async with http.post(base + "/v1/processing", json={
                    "Cluster": "h100", "Path": "/v1/lc",
                    "IncrementBy": 2}) as r:
                value = (await r.json())["CurrentRequests"]
            async with http.get(base + "/metrics") as r:
                samples = gauge_samples(await r.text())
        return value, samples

    try:
        value, samples = run(main())
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    assert value == 2
    assert samples == ['ai4e_current_requests{cluster="h100",path="/v1/lc"} 2']
    assert rc == 0, log.read_text()
