"""The port's load client (``ai4e_tpu_torch/utils/loadclient.py``) held
against the JAX package's.

``tests/test_loadclient.py`` runs whole on the port (``port_suite``), and
so does the pipeline coordinator's test that waited for the client (time
to first partial through the port's pipeline platform). Then both
packages' clients drive the same scripted stub: request ``k`` (its number
rides a header or the URL) meets the ``k``-th outcome of a script (a
completion, a late one, 5xx, 503 and 429 backpressure, a tenant-quota
429, a 504 shed, a bad body, tasks that fail, expire, vanish or pass
through ``running``, event streams with and without a partial), and every
later request is held until the window has closed. The windows then agree
in every count and in the error taxonomy; only times may differ.
"""

from __future__ import annotations

import asyncio
import itertools
import json

import pytest
from aiohttp import ClientSession, TCPConnector, web

import ai4e_tpu.utils.loadclient as jax_loadclient
import ai4e_tpu_torch.utils.loadclient as port_loadclient
from tests.test_torch_tenancy import port_module, port_suite

globals().update(port_suite("test_loadclient"))


class TestStreamingClients:
    """The load-client half of JAX's ``TestStreamingClients`` on the port's
    pipeline platform (the SDK half is in ``test_torch_pipeline.py``)."""

    test_loadclient_reports_time_to_first_partial = (
        port_module("test_pipeline_coordinator").TestStreamingClients
        .test_loadclient_reports_time_to_first_partial)


CLIENTS = {"jax": jax_loadclient, "port": port_loadclient}
GATE_S = 0.2      # every request waits this long: the window opens first
RAMP_S = 0.1
DURATION_S = 3.6
# A request's time includes the gate's wait, so the deadline sits well
# above it and a late answer well above the deadline.
DEADLINE_S = 0.8
LATE_S = 1.2
# Counts and taxonomy only: these move with the clock.
TIMED = {"value", "p50_latency_ms", "p95_latency_ms", "p99_latency_ms",
         "duration_s", "offered_rate", "achieved_rate", "goodput",
         "time_to_first_partial_ms_p50", "time_to_first_partial_ms_p95"}

SYNC_SCRIPT = ["ok", "ok", "late", "http500", "bp503", "ok", "bp429",
               "quota429", "shed504", "ok", "late", "http400", "ok", "bp503"]
ASYNC_SCRIPT = ["completed", "failed", "expired", "running>completed",
                "vanished", "late", "http500", "bp503", "quota429",
                "shed504", "bad_json", "no_task_id", "completed",
                "running>failed", "completed", "bp429"]
EVENTS_SCRIPT = ["sse:stage>completed", "sse:chunk>completed",
                 "sse:none>failed", "sse:404", "sse:stage>expired",
                 "completed", "sse:pending>completed", "http500"]
OPEN_SCRIPT = ["completed", "failed", "expired", "vanished", "http500",
               "bp503", "quota429", "shed504", "bad_json",
               "running>completed", "completed", "completed"]


class ScriptedStub:
    """An async task route, a sync route and an event stream whose answers
    follow ``script`` by request number; requests past its end hold until
    ``release_s`` and then complete."""

    def __init__(self, script: list[str], release_s: float):
        self.script = script
        self.release_s = release_s
        self.polls: dict[str, int] = {}
        self.go = asyncio.Event()
        self.release = asyncio.Event()
        self.app = web.Application()
        self.app.router.add_post("/sync", self.sync)
        self.app.router.add_post("/async", self.create)
        self.app.router.add_get("/task/{tid}", self.status)
        self.app.router.add_get("/task/{tid}/events", self.events)

    async def start(self) -> str:
        loop = asyncio.get_running_loop()
        loop.call_later(GATE_S, self.go.set)
        loop.call_later(self.release_s, self.release.set)
        self.runner = web.AppRunner(self.app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        return f"http://127.0.0.1:{self.runner.addresses[0][1]}"

    async def outcome(self, request) -> str:
        seq = int(request.headers.get("X-Seq")
                  or request.query.get("seq", "0"))
        await self.go.wait()
        if seq >= len(self.script):
            await self.release.wait()
            return "held"
        return self.script[seq]

    @staticmethod
    def refusal(kind: str):
        if kind == "bp503":
            return web.Response(status=503, text="busy",
                                headers={"Retry-After": "0.01"})
        if kind == "bp429":
            return web.Response(status=429, text="slow down")
        if kind == "quota429":
            return web.Response(status=429, text="quota", headers={
                "X-Shed-Reason": "tenant-quota at gateway",
                "Retry-After": "0.01"})
        if kind == "shed504":
            return web.Response(status=504, text="deadline")
        if kind.startswith("http"):
            return web.Response(status=int(kind[4:]), text="boom not json")
        return None

    async def sync(self, request):
        kind = await self.outcome(request)
        refused = self.refusal(kind)
        if refused is not None:
            return refused
        if kind == "late":
            await asyncio.sleep(LATE_S)
        return web.json_response({"ok": True})

    async def create(self, request):
        kind = await self.outcome(request)
        refused = self.refusal(kind)
        if refused is not None:
            return refused
        if kind == "bad_json":
            return web.Response(text="not json")
        if kind == "no_task_id":
            return web.json_response({"Task": "x"})
        seq = request.headers.get("X-Seq") or request.query.get("seq")
        return web.json_response({"TaskId": f"{seq}:{kind}"})

    async def status(self, request):
        tid = request.match_info["tid"]
        kind = tid.split(":", 1)[1].removeprefix("sse:").split(">")[-1]
        n = self.polls[tid] = self.polls.get(tid, 0) + 1
        if kind == "vanished":
            return web.Response(status=404, text="gone")
        if kind == "late":
            await asyncio.sleep(LATE_S)
            kind = "completed"
        if kind == "held":
            kind = "completed"
        if "running" in tid and n == 1:
            return web.json_response({"TaskId": tid, "Status": "running"})
        if kind == "404":
            kind = "completed"
        return web.json_response({"TaskId": tid, "Status": f"{kind} - x"})

    async def events(self, request):
        tid = request.match_info["tid"]
        kind = tid.split(":", 1)[1]
        if not kind.startswith("sse:") or kind == "sse:404":
            return web.Response(status=404, text="no stream")
        partial, terminal = kind[4:].split(">")
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream"})
        await resp.prepare(request)

        async def send(event: str, data: dict) -> None:
            await resp.write(f"event: {event}\ndata: {json.dumps(data)}\n\n"
                             .encode())

        await resp.write(b": keep-alive\n\n")
        if partial == "stage":
            await send("stage", {"stage": "a", "state": "completed"})
        elif partial == "chunk":
            await send("chunk", {"stage": "a", "seq": 0})
        elif partial == "pending":
            await send("stage", {"stage": "a", "state": "running"})
        await send("terminal", {"TaskId": tid, "Status": f"{terminal} - x"})
        await resp.write_eof()
        return resp


def untimed(window: dict) -> dict:
    out = {}
    for key, value in window.items():
        if key in TIMED or key.startswith("total_"):
            continue
        if isinstance(value, dict):
            value = {k: ({kk: vv for kk, vv in v.items() if kk not in TIMED}
                         if isinstance(v, dict) else v)
                     for k, v in value.items()}
        out[key] = value
    return out


async def closed_loop(client, script, *, mode, concurrency, events=False):
    stub = ScriptedStub(script, GATE_S + RAMP_S + DURATION_S + 0.2)
    base = await stub.start()
    seq = itertools.count()
    keys = itertools.cycle(["ka", "kb", "kc"])
    classes = itertools.cycle(["interactive", "background", ""])

    def headers_for() -> dict:
        hdrs = {"X-Seq": str(next(seq)),
                "Ocp-Apim-Subscription-Key": next(keys)}
        cls = next(classes)
        if cls:
            hdrs["X-Priority"] = cls
        return hdrs

    try:
        async with ClientSession(connector=TCPConnector(limit=0)) as session:
            return await client.run_closed_loop(
                session, post_url=f"{base}/{mode}", payload=b"x",
                headers={}, mode=mode, concurrency=concurrency,
                status_url_for=lambda tid: f"{base}/task/{tid}",
                events_url_for=((lambda tid: f"{base}/task/{tid}/events")
                                if events else None),
                duration=DURATION_S, ramp=RAMP_S, task_timeout=10.0,
                poll_wait=1.0, headers_for=headers_for,
                deadline_s=DEADLINE_S,
                tenant_names={"ka": "alpha", "kb": "beta"})
    finally:
        await stub.runner.cleanup()


@pytest.mark.parametrize("mode,script,concurrency,events", [
    ("sync", SYNC_SCRIPT, 1, False),
    ("sync", SYNC_SCRIPT, 3, False),
    ("async", ASYNC_SCRIPT, 3, False),
    ("async", EVENTS_SCRIPT, 2, True),
], ids=["sync-1", "sync-3", "async-3", "events-2"])
def test_closed_loop_counts_and_taxonomy_equal_jax(mode, script,
                                                   concurrency, events):
    got = {pkg: untimed(asyncio.run(closed_loop(
        client, script, mode=mode, concurrency=concurrency, events=events)))
        for pkg, client in CLIENTS.items()}
    assert got["port"] == got["jax"]
    # Every scripted request resolved inside the window, and only those.
    window = got["port"]
    assert window["offered"] == len(script)
    assert window["client_errors"]
    assert set(window["by_tenant"]) == {"alpha", "beta", ""}
    if events:
        assert window["first_partials"] == 3


async def open_loop(client, script):
    stub = ScriptedStub(script, GATE_S + RAMP_S + DURATION_S + 0.2)
    base = await stub.start()
    seq = itertools.count()
    accepted, terminal = [], []
    try:
        async with ClientSession(connector=TCPConnector(limit=0)) as session:
            window = await client.run_open_loop(
                session, post_url=f"{base}/async", payload=b"x", headers={},
                rate=40.0, status_url_for=lambda tid: f"{base}/task/{tid}",
                post_url_for=lambda: f"{base}/async?seq={next(seq)}",
                duration=DURATION_S, ramp=RAMP_S, max_inflight=512,
                task_timeout=10.0, poll_wait=1.0,
                on_accepted=accepted.append,
                on_terminal=lambda tid, status: terminal.append(
                    (tid, status)))
    finally:
        await stub.runner.cleanup()
    scripted = [t for t in accepted if not t.endswith(":held")]
    return (untimed(window), sorted(scripted),
            sorted(t for t in terminal if not t[0].endswith(":held")))


def test_open_loop_counts_and_taxonomy_equal_jax():
    got = {pkg: asyncio.run(open_loop(client, OPEN_SCRIPT))
           for pkg, client in CLIENTS.items()}
    # The window's offered count follows the clock; its outcomes do not.
    for pkg in got:
        got[pkg][0].pop("offered")
    assert got["port"] == got["jax"]
    window, accepted, _terminal = got["port"]
    assert window["mode"] == "open"
    assert (window["completed"], window["failed"], window["expired"]) == (
        4, 4, 2)
    assert len(accepted) == 7
