"""The port's ``TaskReaper`` (``taskstore/reaper.py``) against the JAX
package's: the scenarios of JAX's ``tests/test_reaper.py``, each run on both
packages' stores and reapers on the same script and clock, which must take
the same actions; the rescue on the native store; a worker that dies after
adopting a task, rescued end to end; the store's redrive route against
JAX's ``make_app``; and the ``redrive`` verb against a running port
control plane."""

import asyncio
import json
import os
import subprocess
import sys
import time
import types
import urllib.request
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.platform_assembly as jax_pa
import ai4e_tpu.taskstore as jax_ts
import ai4e_tpu.taskstore.http as jax_http
import ai4e_tpu.taskstore.reaper as jax_reaper
import ai4e_tpu_torch.platform_assembly as port_pa
import ai4e_tpu_torch.taskstore as port_ts
import ai4e_tpu_torch.taskstore.http as port_http
import ai4e_tpu_torch.taskstore.reaper as port_reaper
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.service.app import APIService
from ai4e_tpu_torch.taskstore.native import NativeTaskStore

ROOT = Path(__file__).resolve().parent.parent

JAX = types.SimpleNamespace(
    Store=jax_ts.InMemoryTaskStore, Task=jax_ts.APITask,
    Status=jax_ts.TaskStatus, Reaper=jax_reaper.TaskReaper,
    Platform=jax_pa.LocalPlatform, Config=jax_pa.PlatformConfig,
    make_app=jax_http.make_app, metrics={})
PORT = types.SimpleNamespace(
    Store=port_ts.InMemoryTaskStore, Task=port_ts.APITask,
    Status=port_ts.TaskStatus, Reaper=port_reaper.TaskReaper,
    Platform=port_pa.LocalPlatform, Config=port_pa.PlatformConfig,
    make_app=port_http.make_app, metrics={"metrics": MetricsRegistry()})


def run(coro):
    return asyncio.run(coro)


def age(store, task_id: str, seconds: float = 1000.0) -> None:
    """Move a task's last transition ``seconds`` into the past: its record
    (the rescue's clock) and its status-set score (the eviction's)."""
    task = store._tasks[task_id]
    task.timestamp -= seconds
    store._sets[(task.endpoint_path, task.canonical_status)][task_id] = (
        task.timestamp)


# -- JAX's scenarios, on both packages ------------------------------------------


async def fresh_running_task_left_alone(ns):
    store = ns.Store()
    task = store.upsert(ns.Task(endpoint="/v1/x", body=b"B"))
    store.update_status(task.task_id, "running")
    reaper = ns.Reaper(store, running_timeout=60.0)
    return [await reaper.sweep(), store.get(task.task_id).status]


async def stuck_running_task_republished_with_original_body(ns):
    store = ns.Store()
    republished = []
    store.set_publisher(lambda t: republished.append(
        (t.task_id, t.body, t.content_type)))
    task = store.upsert(ns.Task(task_id="t", endpoint="/v1/x", body=b"ORIG",
                                content_type="image/jpeg"))
    store.update_status(task.task_id, "running")
    age(store, task.task_id)
    reaper = ns.Reaper(store, running_timeout=60.0)
    return [await reaper.sweep(), republished,
            store.get(task.task_id).canonical_status]


async def repeatedly_stuck_task_eventually_failed(ns):
    store = ns.Store()
    store.set_publisher(lambda t: None)
    task = store.upsert(ns.Task(endpoint="/v1/x", body=b"B"))
    reaper = ns.Reaper(store, running_timeout=60.0, max_requeues=2)
    seen = []
    for _ in range(3):
        store.update_status(task.task_id, "running")
        age(store, task.task_id)
        seen.append(await reaper.sweep())
        seen.append(store.get(task.task_id).status)
    return seen


async def completed_task_clears_rescue_budget(ns):
    store = ns.Store()
    store.set_publisher(lambda t: None)
    task = store.upsert(ns.Task(endpoint="/v1/x", body=b"B"))
    reaper = ns.Reaper(store, running_timeout=60.0)
    store.update_status(task.task_id, "running")
    age(store, task.task_id)
    seen = [await reaper.sweep(), dict(reaper._requeues).get(task.task_id)]
    # Back in created, waiting for redelivery: the budget stays.
    seen.append(await reaper.sweep())
    seen.append(reaper._requeues.get(task.task_id))
    store.update_status(task.task_id, "completed")
    seen.append(await reaper.sweep())
    seen.append(task.task_id in reaper._requeues)
    return seen


async def sweep_does_not_clobber_task_completed_mid_sweep(ns):
    store = ns.Store()
    store.set_publisher(lambda t: None)
    task = store.upsert(ns.Task(endpoint="/v1/x", body=b"B"))
    store.update_status(task.task_id, "running")
    age(store, task.task_id)
    reaper = ns.Reaper(store, running_timeout=60.0)
    store.update_status(task.task_id, "completed - raced")
    return [store.requeue_if(task.task_id, ns.Status.RUNNING),
            await reaper.sweep(), store.get(task.task_id).status]


async def fail_branch_refuses_completed_task(ns):
    store = ns.Store()
    task = store.upsert(ns.Task(endpoint="/v1/x", body=b"B"))
    store.update_status(task.task_id, "completed")
    return [store.update_status_if(task.task_id, ns.Status.RUNNING,
                                   "failed - nope"),
            store.get(task.task_id).canonical_status]


async def rescue_and_eviction_in_one_sweep(ns):
    """Both passes on one clock: old terminal tasks go, the stuck task is
    republished, a young one stays, and the counter says so."""
    store = ns.Store()
    store.set_publisher(lambda t: None)
    for tid, status in (("old-done", "completed"), ("old-failed", "failed"),
                        ("young-done", "completed"), ("stuck", "running"),
                        ("young", "running"), ("queued", "created")):
        store.upsert(ns.Task(task_id=tid, endpoint="/v1/x", body=b"B"))
        store.update_status(tid, status)
    for tid in ("old-done", "old-failed", "stuck", "queued"):
        age(store, tid)
    reaper = ns.Reaper(store, running_timeout=60.0, terminal_retention=100.0,
                       **ns.metrics)
    acted = await reaper.sweep()
    left = sorted((t.task_id, t.canonical_status)
                  for t in (store.get(tid) for ep in store.endpoints()
                            for s in ns.Status.ALL
                            for tid in store.set_members(ep, s)))
    return [acted, left]


async def disabled_rescue_only_evicts(ns):
    store = ns.Store()
    store.upsert(ns.Task(task_id="s", endpoint="/v1/x", body=b"B"))
    store.update_status("s", "running")
    age(store, "s")
    reaper = ns.Reaper(store, running_timeout=None, terminal_retention=None)
    return [await reaper.sweep(), store.get("s").status]


SCENARIOS = [fresh_running_task_left_alone,
             stuck_running_task_republished_with_original_body,
             repeatedly_stuck_task_eventually_failed,
             completed_task_clears_rescue_budget,
             sweep_does_not_clobber_task_completed_mid_sweep,
             fail_branch_refuses_completed_task,
             rescue_and_eviction_in_one_sweep,
             disabled_rescue_only_evicts]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_port_reaper_acts_as_jax_s(scenario):
    assert run(scenario(PORT)) == run(scenario(JAX))


def test_scenarios_show_the_expected_actions():
    """What the shared scenarios hold, spelled out once on the port."""
    assert run(fresh_running_task_left_alone(PORT)) == [0, "running"]
    assert run(stuck_running_task_republished_with_original_body(PORT)) == [
        1, [("t", b"ORIG", "image/jpeg")], "created"]
    assert run(repeatedly_stuck_task_eventually_failed(PORT)) == [
        1, "created", 1, "created", 1, "failed - no progress after 2 rescues"]
    assert run(completed_task_clears_rescue_budget(PORT)) == [
        1, 1, 0, 1, 0, False]
    assert run(sweep_does_not_clobber_task_completed_mid_sweep(PORT)) == [
        None, 0, "completed - raced"]
    acted, left = run(rescue_and_eviction_in_one_sweep(PORT))
    assert acted == 3
    assert left == [("queued", "created"), ("stuck", "created"),
                    ("young", "running"), ("young-done", "completed")]


def test_reaper_counts_its_actions_by_outcome():
    async def main():
        reg = MetricsRegistry()
        store = port_ts.InMemoryTaskStore()
        store.set_publisher(lambda t: None)
        for tid in ("a", "b", "c"):
            store.upsert(port_ts.APITask(task_id=tid, endpoint="/v1/x"))
        store.update_status("a", "completed")
        age(store, "a")
        reaper = port_reaper.TaskReaper(store, running_timeout=60.0,
                                        max_requeues=1,
                                        terminal_retention=100.0,
                                        metrics=reg)
        for _ in range(2):
            store.update_status("b", "running")
            age(store, "b")
            await reaper.sweep()
        counter = reg.counter("ai4e_reaper_actions_total")
        return {o: counter.value(outcome=o)
                for o in ("evicted", "requeued", "failed")}

    assert run(main()) == {"evicted": 1, "requeued": 1, "failed": 1}


# -- the assembly's retention and rescue knobs, on both packages ------------------


RETENTION = [
    pytest.param({}, id="auto"),
    pytest.param({"reaper_terminal_retention": 0}, id="zero"),
    pytest.param({"reaper_terminal_retention": -1}, id="negative"),
    pytest.param({"reaper_terminal_retention": 120.0}, id="explicit"),
    pytest.param({"reaper_running_timeout": 5.0, "reaper_max_requeues": 1,
                  "reaper_terminal_retention": -1}, id="rescue-only"),
    pytest.param({"native_store": True}, id="native-auto"),
    pytest.param({"native_store": True, "reaper_running_timeout": 5.0},
                 id="native-rescue"),
]


@pytest.mark.parametrize("fields", RETENTION)
def test_assembly_builds_jax_s_reaper(fields):
    def shape(platform):
        r = platform.reaper
        return None if r is None else (r.running_timeout, r.max_requeues,
                                       r.terminal_retention, r.interval)

    want = shape(JAX.Platform(JAX.Config(**fields)))
    got = shape(PORT.Platform(PORT.Config(**fields),
                              metrics=MetricsRegistry()))
    assert got == want


def test_native_store_explicit_retention_raises_as_jax_s():
    with pytest.raises(ValueError) as want:
        JAX.Platform(JAX.Config(native_store=True,
                                reaper_terminal_retention=60.0))
    with pytest.raises(ValueError) as got:
        PORT.Platform(PORT.Config(native_store=True,
                                  reaper_terminal_retention=60.0),
                      metrics=MetricsRegistry())
    assert str(got.value) == str(want.value)


def test_stuck_task_rescued_from_the_native_store():
    async def main():
        store = NativeTaskStore()
        republished = []
        store.set_publisher(lambda t: republished.append(
            (t.task_id, t.body)))
        task = store.upsert(port_ts.APITask(endpoint="/v1/x", body=b"ORIG"))
        store.update_status(task.task_id, "running")
        await asyncio.sleep(0.15)
        reaper = port_reaper.TaskReaper(store, running_timeout=0.1,
                                        metrics=MetricsRegistry())
        assert await reaper.sweep() == 1
        assert republished == [(task.task_id, b"ORIG")]
        assert store.get(task.task_id).canonical_status == "created"
        store.update_status(task.task_id, "completed")
        await asyncio.sleep(0.15)
        assert await reaper.sweep() == 0
        assert store.get(task.task_id).canonical_status == "completed"

    run(main())


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_worker_crash_after_adoption_recovers_on_healthy_replica(native):
    """The first delivery adopts the task (202 to the dispatcher: the
    message is completed), marks it running and dies; the reaper sees the
    stalled task and republishes it; the second delivery completes it under
    the same TaskId with the original body."""
    async def main():
        reg = MetricsRegistry()
        platform = port_pa.LocalPlatform(port_pa.PlatformConfig(
            retry_delay=0.05, reaper_running_timeout=0.3,
            reaper_interval=0.1, native_store=native, native_broker=native),
            metrics=reg)
        svc = APIService("flaky", prefix="v1/flaky",
                         task_manager=platform.task_manager, metrics=reg)
        calls = {"n": 0}

        @svc.api_async_func("/work")
        async def work(taskId, body, content_type):
            calls["n"] += 1
            if calls["n"] == 1:
                await platform.task_manager.update_task_status(
                    taskId, "running - replica-1")
                return  # crashed: never completes
            assert body == b"PAYLOAD", body
            await platform.task_manager.complete_task(
                taskId, "completed - replica-2 rescued")

        svc_client = TestClient(TestServer(svc.app))
        await svc_client.start_server()
        platform.publish_async_api(
            "/v1/public/work", str(svc_client.make_url("/v1/flaky/work")))
        gw = TestClient(TestServer(platform.gateway.app))
        await gw.start_server()
        await platform.start()
        try:
            resp = await gw.post("/v1/public/work", data=b"PAYLOAD")
            tid = (await resp.json())["TaskId"]
            r = await gw.get(f"/v1/taskmanagement/task/{tid}",
                             params={"wait": "20"})
            final = await r.json()
            for _ in range(200):
                if "completed" in final["Status"]:
                    break
                await asyncio.sleep(0.05)
                final = await (await gw.get(
                    f"/v1/taskmanagement/task/{tid}")).json()
            metrics = await (await gw.get("/metrics")).text()
        finally:
            await platform.stop()
            await gw.close()
            await svc_client.close()
        return final["Status"], calls["n"], metrics

    status, calls, metrics = run(main())
    assert status == "completed - replica-2 rescued"
    assert calls == 2
    assert 'ai4e_reaper_actions_total{outcome="requeued"}' in metrics


# -- the redrive route, against JAX's make_app --------------------------------------


REDRIVE = [
    pytest.param({"TaskId": "dead1"}, id="one"),
    pytest.param({"TaskId": "zz"}, id="unknown"),
    pytest.param({"TaskId": "done"}, id="not-failed"),
    pytest.param({}, id="sweep"),
    pytest.param({"Contains": ""}, id="contains-empty"),
    pytest.param({"Contains": "bad input"}, id="contains-text"),
    pytest.param(b"{not json", id="invalid-json"),
    pytest.param([1, 2], id="not-an-object"),
]

FAILED_DEAD = "failed - delivery attempts exhausted"


async def redrive_answer(ns, payload):
    store = ns.Store()
    published = []
    store.set_publisher(lambda t: published.append((t.task_id, t.body)))
    for tid, status in (("dead1", FAILED_DEAD), ("dead2", FAILED_DEAD),
                        ("bad", "failed - bad input: x"),
                        ("done", "completed - ok"), ("live", "running")):
        store.upsert(ns.Task(task_id=tid, endpoint="/v1/x",
                             body=tid.encode()))
        store.update_status(tid, status)
    client = TestClient(TestServer(ns.make_app(store)))
    await client.start_server()
    try:
        data = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        resp = await client.post("/v1/taskstore/redrive", data=data)
        body = await resp.json()
    finally:
        await client.close()
    if isinstance(body, dict):
        body.pop("Timestamp", None)
        if "task_ids" in body:
            body["task_ids"] = sorted(body["task_ids"])
    states = {tid: store.get(tid).status
              for tid in ("dead1", "dead2", "bad", "done", "live")}
    return resp.status, body, states, sorted(published)


@pytest.mark.parametrize("payload", REDRIVE)
def test_redrive_route_answers_as_jax_s(payload):
    want = run(redrive_answer(JAX, payload))
    got = run(redrive_answer(PORT, payload))
    assert got == want


def test_redrive_route_codes():
    codes = {}
    for param in REDRIVE:
        status, body, states, published = run(redrive_answer(
            PORT, param.values[0]))
        codes[param.id] = status
        if param.id == "sweep":
            assert body == {"redriven": 2, "task_ids": ["dead1", "dead2"]}
            assert published == [("dead1", b"dead1"), ("dead2", b"dead2")]
        if param.id == "contains-empty":
            assert body["redriven"] == 3
        if param.id == "not-failed":
            assert body == {"error": "task is not failed",
                            "Status": "completed - ok"}
    assert codes == {"one": 200, "unknown": 404, "not-failed": 409,
                     "sweep": 200, "contains-empty": 200,
                     "contains-text": 200, "invalid-json": 400,
                     "not-an-object": 400}


# -- the redrive verb against a running control plane ----------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def clean_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("AI4E_")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def control_plane(tmp_path_factory):
    routes = tmp_path_factory.mktemp("redrive") / "routes.json"
    routes.write_text(json.dumps({"apis": []}))
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ai4e_tpu_torch", "control-plane",
         "--routes", str(routes), "--port", str(port)],
        cwd=ROOT, env=clean_env(AI4E_GATEWAY_API_KEYS="k1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    url = f"http://127.0.0.1:{port}"
    try:
        for _ in range(300):
            try:
                urllib.request.urlopen(url + "/healthz", timeout=1).read()
                break
            except OSError:
                time.sleep(0.05)
        else:
            raise RuntimeError("control plane did not start")
        yield url
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def store_call(url: str, path: str, payload=None) -> dict:
    req = urllib.request.Request(
        url + path, data=None if payload is None
        else json.dumps(payload).encode(),
        headers={"Ocp-Apim-Subscription-Key": "k1",
                 "Content-Type": "application/json"},
        method="GET" if payload is None else "POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def redrive(url: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "ai4e_tpu_torch", "redrive", "--store", url,
         *args], cwd=ROOT, env=clean_env(), capture_output=True, text=True,
        timeout=60)


def test_redrive_verb_against_a_running_control_plane(control_plane):
    for tid, status in (("v-dead1", FAILED_DEAD), ("v-dead2", FAILED_DEAD),
                        ("v-bad", "failed - bad input: x"),
                        ("v-done", "completed - ok")):
        store_call(control_plane, "/v1/taskstore/upsert",
                   {"TaskId": tid, "Endpoint": "/v1/nowhere",
                    "Body": tid, "Status": "created"})
        store_call(control_plane, "/v1/taskstore/update",
                   {"TaskId": tid, "Status": status})
    out = redrive(control_plane)
    assert out.returncode == 1
    assert "subscription key" in out.stdout
    out = redrive(control_plane, "--api-key", "k1")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) in (
        {"redriven": 2, "task_ids": ["v-dead1", "v-dead2"]},
        {"redriven": 2, "task_ids": ["v-dead2", "v-dead1"]})
    out = redrive(control_plane, "--api-key", "k1", "--task-id", "v-done")
    assert out.returncode == 1
    assert "redrive refused (409)" in out.stderr
    assert json.loads(out.stdout)["Status"] == "completed - ok"
    out = redrive(control_plane, "--api-key", "k1", "--task-id", "v-zz")
    assert out.returncode == 1
    assert json.loads(out.stdout) == {"error": "unknown task"}
    out = redrive(control_plane, "--api-key", "k1", "--contains", "")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["task_ids"] == ["v-bad"]
    for tid in ("v-dead1", "v-dead2", "v-bad"):
        record = store_call(control_plane, f"/v1/taskstore/task?taskId={tid}")
        assert record["Status"] == "created"


def test_redrive_verb_without_a_control_plane_exits_with_a_message():
    out = redrive(f"http://127.0.0.1:{free_port()}")
    assert out.returncode == 1
    assert "cannot reach" in out.stderr
