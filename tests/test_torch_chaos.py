"""The port's chaos harness (``ai4e_tpu_torch/chaos/``) held against the
JAX package's.

Three parts. JAX's chaos scenarios (``tests/test_chaos.py``,
``test_shard_chaos.py``, ``test_orchestration_chaos.py``,
``test_tenancy_chaos.py``, ``test_pipeline_chaos.py``) run whole on the
port's ``LocalPlatform`` with the port's chaos (``port_suite``), under
their seeds and invariant assertions. The dark-fleet acceptance runs the
same source with what it leaves to chance seeded: task ids (the shard
each task lands on), the dispatchers' and the gateway's picks and backoff
jitter. Then the same seeds and scripts go through both packages:
injector decisions, the HTTP wrapper's fault shapes, invariant verdicts
and the violation dump. Last, the port's own worker under the scenario's
faults completes each task once (ROADMAP C11).
"""

from __future__ import annotations

import asyncio
import io
import random
import socket
import sys
import uuid

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.chaos as jax_chaos
import ai4e_tpu.taskstore as jax_taskstore
import ai4e_tpu_torch.chaos as port_chaos
import ai4e_tpu_torch.taskstore as port_taskstore
import ai4e_tpu_torch.taskstore.store as port_store
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
from tests.test_torch_tenancy import port_module, port_suite

for _name in ("test_chaos", "test_shard_chaos", "test_tenancy_chaos",
              "test_pipeline_chaos"):
    globals().update(port_suite(_name))
globals().update(port_suite("test_orchestration_chaos",
                            leave_out=("TestDarkFleetAcceptance",)))
_orchestration = sys.modules["_port_test_orchestration_chaos"]
TestChaosDump = port_module("test_request_observability").TestChaosDump

PACKAGES = {"jax": (jax_chaos, jax_taskstore),
            "port": (port_chaos, port_taskstore)}


def run(coro):
    return asyncio.run(coro)


# -- the dark fleet, seeded ------------------------------------------------------


class TestDarkFleetAcceptance:
    """JAX's ``TestDarkFleetAcceptance`` on the port. Its two timed runs
    compare goodput, and what JAX's leaves random moves that comparison
    from run to run; here each run starts from the same seeds."""

    def test_interactive_goodput_holds_while_background_reroutes(
            self, monkeypatch):
        def seeded_wrap(platform, injector):
            # Called once a run, after the routes and before traffic.
            rng = random.Random(injector.seed)
            random.seed(injector.seed)
            monkeypatch.setattr(
                port_store, "new_task_id",
                lambda: str(uuid.UUID(int=rng.getrandbits(128), version=4)))
            for d in platform.dispatchers.dispatchers.values():
                d._rng = random.Random(rng.getrandbits(64))
            platform.gateway._rng = random.Random(rng.getrandbits(64))
            port_chaos.wrap_platform_http(platform, injector)

        monkeypatch.setattr(_orchestration, "wrap_platform_http", seeded_wrap)
        _orchestration.TestDarkFleetAcceptance \
            .test_interactive_goodput_holds_while_background_reroutes(self)


# -- the injector ----------------------------------------------------------------


URLS = ("http://fleet:1/v1/be/x", "http://canary:2/v1/be/x",
        "http://fleet:3/v1/be/y")


def decision_script(chaos, seed: int) -> dict:
    """One seeded run of mixed HTTP and queue draws, with a bounded rule, a
    blackout and its lift part way: every decision, then the counts."""
    inj = chaos.FaultInjector(seed=seed)
    inj.add_rule(backend="canary:2", error_rate=0.5, error_status=503,
                 times=7)
    inj.add_rule(error_rate=0.2, error_status=500, drop_rate=0.05,
                 connect_error_rate=0.05, latency_rate=0.3, latency_s=0.01,
                 duplicate_rate=0.1)
    seq = []
    dark = None
    for i in range(400):
        if i == 100:
            dark = inj.blackout("fleet:3")
        if i == 200:
            inj.lift(dark)
        if i % 5 == 4:
            seq.append(("dup", inj.duplicate(f"/v1/be/{'xy'[i % 2]}")))
            continue
        d = inj.decide(URLS[i % len(URLS)])
        seq.append((d.fault, d.status, d.latency_s))
    return {"seq": seq, "counts": inj.counts()}


@pytest.mark.parametrize("seed", [0, 5, 20260803])
def test_injector_decisions_equal_jax(seed):
    got = {pkg: decision_script(chaos, seed)
           for pkg, (chaos, _ts) in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert set(got["port"]["counts"]) == {"error", "drop", "connect_error",
                                          "latency", "duplicate"}


def test_http_wrapper_fault_shapes_equal_jax():
    """Both packages' ``ChaosSession`` over one live backend under the same
    seeded rules: each request's outcome and whether the backend ran it."""
    async def main():
        import aiohttp

        hits = []

        async def handler(request):
            hits.append(1)
            return web.Response(text="real")

        app = web.Application()
        app.router.add_post("/x", handler)
        be = TestClient(TestServer(app))
        await be.start_server()
        url = str(be.make_url("/x"))
        out = {}
        try:
            for pkg, (chaos, _ts) in PACKAGES.items():
                hits.clear()
                inj = chaos.FaultInjector(seed=11)
                inj.add_rule(error_rate=0.3, error_status=502, drop_rate=0.2,
                             connect_error_rate=0.2)
                session = chaos.ChaosSession(be.session, inj)
                seen = []
                for _ in range(40):
                    try:
                        async with session.post(url) as resp:
                            seen.append((resp.status, await resp.read()))
                    except aiohttp.ClientConnectorError:
                        seen.append("refused")
                    except asyncio.TimeoutError:
                        seen.append("lost")
                    seen.append(len(hits))
                out[pkg] = (seen, inj.counts())
        finally:
            await be.close()
        return out

    got = run(main())
    assert got["port"] == got["jax"]


# -- the invariant checker ---------------------------------------------------------


def invariant_script(chaos, ts, seed: int) -> dict:
    """A seeded store history: creates, transitions (second completions
    among them), evictions and ids the store never saw, every verdict of
    the checker, TaskIds named by their order of creation."""
    rng = random.Random(seed)
    store = ts.InMemoryTaskStore()
    names: dict[str, str] = {}
    checker = chaos.InvariantChecker(
        shard_of=lambda tid: int(names.get(tid, "t0")[1:]) % 2)
    checker.attach(store)
    live: list[str] = []
    for i in range(60):
        r = rng.random()
        if r < 0.35 or not live:
            t = store.upsert(ts.APITask(endpoint="/v1/x"))
            names[t.task_id] = f"t{len(names)}"
            live.append(t.task_id)
            if rng.random() < 0.9:
                checker.note_accepted(t.task_id)
        elif r < 0.75:
            tid = rng.choice(live)
            status = rng.choice(["completed", "failed", "running",
                                 "expired"])
            store.update_status(tid, f"{status} - step {i}", status)
        elif r < 0.85:
            store.evict_terminal_older_than(0.0)
            live = [t for t in live if t in {x.task_id
                                             for x in store.snapshot()}]
        else:
            ghost = f"ghost-{i}"
            names[ghost] = f"g{i}"
            checker.note_accepted(ghost)

    def named(lines):
        out = []
        for line in lines:
            for tid, name in names.items():
                line = line.replace(tid, name)
            out.append(line)
        return sorted(out)

    some = [tid for tid, name in names.items() if int(name[1:]) % 3 == 0]
    verdicts = {"violations": named(checker.violations()),
                "subset": named(checker.violations(some)),
                "summary": checker.summary(),
                "by_shard": checker.by_shard()}
    for shard in (0, 1):
        try:
            checker.assert_shard_ok(shard)
            verdicts[f"shard{shard}"] = "ok"
        except AssertionError as exc:
            verdicts[f"shard{shard}"] = named(
                str(exc).split(":\n  ", 1)[1].split("\n  "))
    return verdicts


@pytest.mark.parametrize("seed", [1, 2, 3, 42])
def test_invariant_verdicts_equal_jax(seed, tmp_path, monkeypatch):
    monkeypatch.setenv("AI4E_CHAOS_DUMP_DIR", str(tmp_path))
    got = {pkg: invariant_script(chaos, ts, seed)
           for pkg, (chaos, ts) in PACKAGES.items()}
    assert got["port"] == got["jax"]
    text = "\n".join(got["port"]["violations"])
    assert "LOST" in text and "completed twice" in text


# -- the port's worker under the scenario's faults ---------------------------------


def npy(a) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("seed", [3, 20260803])
def test_port_worker_completes_each_task_once_under_lost_responses(seed):
    """The port's echo worker behind ``test_chaos.py``'s platform, lost
    responses on a third of the deliveries and a fifth of the publishes
    duplicated: each lost response retries while the worker's first run is
    in flight, a duplicated publish may arrive beside the first, and the
    worker must not run (and complete) the task again. Zero invariant
    violations, every answer its own request's."""
    from ai4e_tpu_torch.cli import build_worker
    from ai4e_tpu_torch.taskstore.http import make_app

    async def main():
        platform = LocalPlatform(PlatformConfig(
            resilience=True, retry_delay=0.01, lease_seconds=2.0,
            resilience_retry_base_s=0.001, resilience_failure_threshold=3,
            resilience_recovery_seconds=0.1, observability=True),
            metrics=MetricsRegistry())
        make_app(platform.store, app=platform.gateway.app,
                 lifecycle=platform)
        checker = port_chaos.InvariantChecker().attach(platform.store)
        cp_port = free_port()
        spec = {"service_name": "echo", "prefix": "v1/echo",
                "taskstore": f"http://127.0.0.1:{cp_port}",
                "models": [{"family": "echo", "name": "echo", "size": 4,
                            "buckets": [1, 2, 4], "sync_path": "/run",
                            "async_path": "/run-async"}]}
        worker, batcher, _tm = build_worker(spec, device="cpu",
                                            max_wait_ms=100)
        await batcher.start()
        wk = TestServer(worker.service.app)
        await wk.start_server()
        platform.publish_async_api(
            "/v1/pub/run", f"http://127.0.0.1:{wk.port}/v1/echo/run-async")
        injector = port_chaos.FaultInjector(seed=seed)
        # One rule for both surfaces: the first rule that matches decides,
        # and a catch-all first would shadow a queue rule after it.
        injector.add_rule(error_rate=0.2, error_status=500, drop_rate=0.3,
                          duplicate_rate=0.2)
        port_chaos.wrap_platform_http(platform, injector)
        port_chaos.wrap_publish_duplicates(platform, injector)
        cp = TestServer(platform.gateway.app, port=cp_port)
        await cp.start_server()
        await platform.start()
        ids = []
        try:
            async with TestClient(cp) as client:
                for i in range(24):
                    resp = await client.post(
                        "/v1/pub/run", data=npy(np.full(4, i, np.float32)))
                    ids.append((await resp.json())["TaskId"])
                    checker.note_accepted(ids[-1])
                for _ in range(600):
                    if len(checker.terminal) >= len(ids):
                        break
                    await asyncio.sleep(0.05)
                await asyncio.sleep(0.3)  # duplicates drain too
                checker.assert_ok()
                answers = [await (await client.get(
                    "/v1/taskstore/result", params={"taskId": t})).json()
                    for t in ids]
        finally:
            await platform.stop()
            await cp.close()
            await wk.close()
            await batcher.stop()
        return injector.counts(), set(checker.terminal.values()), answers

    counts, outcomes, answers = run(main())
    assert counts.get("drop", 0) > 0 and counts.get("duplicate", 0) > 0
    assert outcomes == {"completed"}
    assert answers == [{"echo": [float(i)] * 4} for i in range(24)]


# How many runs one shell makes of two deliveries of one task: both at once,
# the second while the first runs, the second under a failover's new store
# epoch while the first runs, the second after the first completed.
SHELL_RUNS = {"jax": {"concurrent": 2, "in_flight": 2, "new_epoch": 2,
                      "after": 1},
              "port": {"concurrent": 1, "in_flight": 1, "new_epoch": 2,
                       "after": 1}}


@pytest.mark.parametrize("arrival", list(SHELL_RUNS["port"]))
@pytest.mark.parametrize("pkg", list(SHELL_RUNS))
def test_shell_runs_of_a_second_delivery(pkg, arrival):
    """C11 in the service shell, against JAX's: a second delivery of a task
    the port's shell is adopting or running under the same store epoch is
    acknowledged without a run; one under a new epoch runs again, as in
    JAX. The store's reads take 50 ms, so two deliveries sent together both
    read before either runs."""
    if pkg == "jax":
        from ai4e_tpu.service import APIService, LocalTaskManager
        from ai4e_tpu.taskstore import APITask, InMemoryTaskStore
    else:
        from ai4e_tpu_torch.service import APIService, LocalTaskManager
        from ai4e_tpu_torch.taskstore import APITask, InMemoryTaskStore

    class SlowReads(LocalTaskManager):
        async def get_task_status(self, task_id):
            await asyncio.sleep(0.05)
            return await super().get_task_status(task_id)

    store = InMemoryTaskStore()
    tm = SlowReads(store)
    svc = APIService("svc", prefix="v1/test", task_manager=tm)
    runs: list[str] = []
    gate = asyncio.Event()

    @svc.api_async_func("/run")
    async def run_ep(taskId, body, content_type):
        runs.append(taskId)
        await gate.wait()
        await tm.complete_task(taskId, "completed - ok")

    async def main():
        task = store.upsert(APITask(endpoint="/v1/test/run", body=b""))
        completions = []
        store.add_listener(lambda t: completions.append(t.canonical_status)
                           if t.canonical_status == "completed" else None)
        client = TestClient(TestServer(svc.app))
        await client.start_server()

        async def deliver():
            resp = await client.post("/v1/test/run", data=b"{}",
                                     headers={"taskId": task.task_id})
            return resp.status

        async def until(pred):
            for _ in range(200):
                if pred():
                    return
                await asyncio.sleep(0.01)
            raise AssertionError("timed out")

        try:
            if arrival == "concurrent":
                statuses = await asyncio.gather(deliver(), deliver())
                await asyncio.sleep(0.1)
                gate.set()
            else:
                statuses = [await deliver()]
                await until(lambda: runs)
                if arrival == "new_epoch":
                    tm.store_epoch = 1
                if arrival == "after":
                    gate.set()
                    await until(lambda: completions)
                statuses.append(await deliver())
                gate.set()
            await until(lambda: not svc._background)
        finally:
            await client.close()
        return statuses, len(runs), store.get(task.task_id).status

    statuses, n_runs, status = run(main())
    assert statuses == [200, 200]
    assert n_runs == SHELL_RUNS[pkg][arrival]
    assert status == "completed - ok"
