"""The port's task event hub and SSE surface (``pipeline/events.py``, the
gateway's ``/events`` route, ``serve_stream``'s chunks; ROADMAP A18.12)
held against the JAX package's.

``tests/test_streaming_sse.py`` runs on the port (``port_suite``; its soak
is marked slow there and stays so). Then the same scripts go through both
packages: the hub's replay, chunk bound, ``truncated`` marker and resume
points, and the SSE bytes of a task streamed over HTTP before and after
its completion, 404 for an unknown task and no route when pipelines are
off. Last, the LM's tokens on a CPU engine: each stream task's ``chunk``
events carry indices 0..N-1 equal to its stored tokens, a late client
gets the bounded replay behind ``truncated``, and a DAG's stage publishes
its chunks under the root TaskId, labelled with the stage.
"""

from __future__ import annotations

import asyncio
import json
import types

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.pipeline.events as jax_events
import ai4e_tpu.platform_assembly as jax_pa
import ai4e_tpu_torch.pipeline.events as port_events
import ai4e_tpu_torch.platform_assembly as port_pa
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu.taskstore import APITask as JaxTask
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry
from ai4e_tpu_torch.taskstore import APITask as PortTask
from tests.test_torch_tenancy import port_suite

globals().update(port_suite("test_streaming_sse"))

JAX = types.SimpleNamespace(ev=jax_events, pa=jax_pa, APITask=JaxTask,
                            Registry=JaxRegistry)
PORT = types.SimpleNamespace(ev=port_events, pa=port_pa, APITask=PortTask,
                             Registry=PortRegistry)
NS = {"jax": JAX, "port": PORT}


def run(coro):
    return asyncio.run(coro)


def both(fn):
    return {pkg: fn(ns) for pkg, ns in NS.items()}


# -- the hub -------------------------------------------------------------------


@pytest.mark.parametrize("chunk_replay", [2, 5, 128])
def test_hub_replay_truncation_and_resume_equal_jax(chunk_replay):
    """One task's status, stage and chunk events, a second task's, then the
    terminal one: the replay from every resume point, encoded as SSE."""
    def script(ns):
        ev = ns.ev
        hub = ev.TaskEventHub(replay=6, chunk_replay=chunk_replay,
                              max_tasks=3, metrics=ns.Registry())
        hub.track("t")
        hub.publish("t", ev.STATUS, {"Status": "running"})
        hub.publish("t", ev.STAGE, {"stage": "a", "state": "dispatched"})
        for i in range(9):
            hub.publish("t", ev.CHUNK, {"stage": "lm", "index": i,
                                        "data": {"token": 100 + i}})
            hub.publish("u", ev.CHUNK, {"stage": "lm", "index": i,
                                        "data": {"token": i}})
        hub.publish("t", ev.STAGE, {"stage": "a", "state": "completed",
                                    "resultAvailable": True})
        hub.publish("t", ev.TERMINAL, {"Status": "completed - x"})
        out = {after: b"".join(ev.sse_encode(e)
                               for e in hub.replay("t", after_seq=after))
               for after in (0, 1, 3, 8, 12, 40)}
        out["u"] = [e["event"] for e in hub.replay("u")]
        out["count"] = hub.subscriber_count
        for name in ("v", "w", "x"):  # LRU past max_tasks drops "t"
            hub.track(name)
        out["evicted"] = hub.replay("t")
        return out

    got = both(script)
    assert got["port"] == got["jax"]
    if chunk_replay < 9:
        assert b"event: truncated" in got["port"][0]


async def http_stream_script(ns, attach: str) -> list:
    """A task streamed over the gateway's SSE route, attached before its
    transitions or after its completion; the bytes of each stream, task
    timestamps taken out."""
    reg = ns.Registry()
    platform = ns.pa.LocalPlatform(ns.pa.PlatformConfig(
        pipeline=True, pipeline_stream_max_s=5.0), metrics=reg)
    client = TestClient(TestServer(platform.gateway.app))
    await client.start_server()
    await platform.start()
    store = platform.store
    out = []

    async def read(task_id, **params):
        async with client.get(f"/v1/taskmanagement/task/{task_id}/events",
                              params=params) as r:
            if r.status != 200:
                return r.status, await r.text()
            return r.status, await r.read()

    try:
        store.upsert(ns.APITask(task_id="t1", endpoint="/v1/x"))
        platform.task_events.track("t1")
        if attach == "before":
            reader = asyncio.ensure_future(read("t1", wait="5"))
            for _ in range(100):
                if platform.task_events.subscriber_count:
                    break
                await asyncio.sleep(0.01)
        store.update_status("t1", "running - x", "running")
        platform.task_events.publish("t1", "stage", {"stage": "s",
                                                      "state": "completed"})
        store.update_status("t1", "completed - x", "completed")
        if attach == "before":
            out.append(await reader)
        else:
            out.append(await read("t1"))
            out.append(await read("t1", lastEventId="2"))
        out.append(await read("nope"))
        out.append(platform.task_events.subscriber_count)
    finally:
        await client.close()
        await platform.stop()
    return [(item[0], _strip(item[1]) if isinstance(item[1], bytes)
             else item[1]) if isinstance(item, tuple) else item
            for item in out]


def _strip(body: bytes) -> bytes:
    """SSE bytes with each record's timestamp taken out."""
    lines = []
    for line in body.decode().splitlines():
        if line.startswith("data: "):
            data = json.loads(line[len("data: "):])
            if isinstance(data, dict):
                data.pop("Timestamp", None)
            line = "data: " + json.dumps(data, sort_keys=True)
        lines.append(line)
    return "\n".join(lines).encode()


@pytest.mark.parametrize("attach", ["before", "after"])
def test_sse_bytes_over_http_equal_jax(attach):
    got = both(lambda ns: run(http_stream_script(ns, attach)))
    assert got["port"] == got["jax"]
    first = got["port"][0][1].decode()
    assert first.index("event: status") < first.index("event: terminal")
    assert got["port"][-1] == 0  # no subscriber left behind


def test_events_route_absent_without_pipelines_alike():
    async def scenario(ns):
        platform = ns.pa.LocalPlatform(ns.pa.PlatformConfig(),
                                       metrics=ns.Registry())
        client = TestClient(TestServer(platform.gateway.app))
        await client.start_server()
        try:
            platform.store.upsert(ns.APITask(task_id="t1",
                                             endpoint="/v1/x"))
            async with client.get(
                    "/v1/taskmanagement/task/t1/events") as r:
                return (r.status, platform.task_events,
                        sorted(str(x.resource.canonical) for x in
                               platform.gateway.app.router.routes()
                               if x.resource is not None))
        finally:
            await client.close()

    got = both(lambda ns: run(scenario(ns)))
    assert got["port"][:2] == got["jax"][:2] == (404, None)
    assert not any(path.endswith("/events") for path in got["port"][2])


# -- the LM's chunks on a CPU engine ------------------------------------------


LM = dict(vocab_size=64, max_len=48, dim=32, depth=1, heads=2)


async def lm_platform(chunk_replay: int):
    """A pipeline platform with an LM worker in process: its stream route
    published, and a one-stage DAG whose stage is the LM, both through the
    platform's hub."""
    from ai4e_tpu_torch.pipeline import PipelineSpec, StageSpec
    from ai4e_tpu_torch.runtime.batcher import MicroBatcher
    from ai4e_tpu_torch.runtime.decode import DecodeEngine
    from ai4e_tpu_torch.runtime.kvcache import (PagedDecodeRuntime,
                                                build_lm_servable)
    from ai4e_tpu_torch.runtime.registry import ModelRuntime
    from ai4e_tpu_torch.runtime.worker import InferenceWorker

    torch.manual_seed(0)
    platform = port_pa.LocalPlatform(port_pa.PlatformConfig(
        pipeline=True, retry_delay=0.05,
        pipeline_chunk_replay=chunk_replay), metrics=PortRegistry())
    runtime = ModelRuntime(device="cpu")
    backend = PagedDecodeRuntime(build_lm_servable(name="lm", **LM),
                                 runtime, slots=4, prompt_buckets=(8,))
    engine = DecodeEngine(backend, metrics=PortRegistry())
    worker = InferenceWorker(
        "lmsvc", runtime, MicroBatcher(runtime, metrics=PortRegistry()),
        task_manager=platform.task_manager, prefix="v1/lm",
        metrics=PortRegistry(), store=platform.store)
    worker.serve_stream(engine, event_hub=platform.task_events)
    wk = TestClient(TestServer(worker.service.app))
    await wk.start_server()
    stream_uri = str(wk.make_url("/v1/lm/lm-stream-async"))
    platform.publish_async_api("/v1/pub/lm-stream-async", stream_uri)
    platform.register_pipeline(PipelineSpec("lmdag", "/v1/pipe/lm", [
        StageSpec("lm", stream_uri)]))
    gw = TestClient(TestServer(platform.gateway.app))
    await gw.start_server()
    await engine.start()
    await platform.start()

    async def close():
        await gw.close()
        await platform.stop()
        await engine.stop()
        await wk.close()

    return platform, gw, close


async def sse_events(gw, task_id: str, **params) -> list[dict]:
    events, current = [], {}
    async with gw.get(f"/v1/taskmanagement/task/{task_id}/events",
                      params={"wait": "30", **params}) as r:
        assert r.status == 200
        async for raw in r.content:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                current["event"] = line[len("event: "):]
            elif line.startswith("data: "):
                current["data"] = json.loads(line[len("data: "):])
            elif line == "" and current:
                events.append(current)
                if current["event"] == "terminal":
                    break
                current = {}
    return events


def test_lm_chunks_match_the_stored_tokens_and_ride_the_root_id():
    async def scenario():
        platform, gw, close = await lm_platform(chunk_replay=4)
        try:
            out = {"streams": []}
            for prompt in ([5, 9, 12], [1], [7, 7, 7, 7, 7]):
                body = json.dumps({"prompt": prompt,
                                   "max_new_tokens": 10}).encode()
                async with gw.post("/v1/pub/lm-stream-async",
                                   data=body) as r:
                    task_id = (await r.json())["TaskId"]
                live = await sse_events(gw, task_id)
                late = await sse_events(gw, task_id)
                stored = json.loads(platform.store.get_result(task_id)[0])
                out["streams"].append((live, late, stored))
            async with gw.post("/v1/pipe/lm", data=json.dumps(
                    {"prompt": [3, 4], "max_new_tokens": 6}).encode()) as r:
                root = (await r.json())["TaskId"]
            out["dag"] = (await sse_events(gw, root), json.loads(
                platform.store.get_result(root)[0]), root)
            out["subscribers"] = platform.task_events.subscriber_count
            return out
        finally:
            await close()

    out = run(scenario())
    for live, late, stored in out["streams"]:
        chunks = [e["data"] for e in live if e["event"] == "chunk"]
        # Attached at once: every chunk the hub still held, in order.
        assert [c["index"] for c in chunks] == list(
            range(10 - len(chunks), 10))
        assert [c["data"]["token"] for c in chunks] == \
            stored["tokens"][10 - len(chunks):]
        assert all(c["stage"] == "lm" for c in chunks)
        # After completion: `truncated` for the 6 chunks past the bound,
        # then the newest 4, then the terminal record.
        kinds = [e["event"] for e in late]
        assert kinds[0] == "status" and kinds[-1] == "terminal"
        assert "truncated" in kinds
        tail = [e["data"] for e in late if e["event"] == "chunk"]
        assert [c["index"] for c in tail] == [6, 7, 8, 9]
        assert [c["data"]["token"] for c in tail] == stored["tokens"][6:]
        assert stored["count"] == 10
    dag_events, dag_result, root = out["dag"]
    chunks = [e["data"] for e in dag_events if e["event"] == "chunk"]
    assert chunks and all(c["stage"] == "lm" for c in chunks)
    assert [c["data"]["token"] for c in chunks] == \
        dag_result["tokens"][-len(chunks):]
    stages = [e["data"]["state"] for e in dag_events
              if e["event"] == "stage"]
    assert stages[-1] == "completed"
    assert out["subscribers"] == 0
