"""The port's HA pair (``ai4e_tpu_torch/taskstore/replication.py``, the
journal routes of ``taskstore/http.py``, ``platform_assembly``'s standby,
promotion and demotion) held against the JAX package's on the CPU: a port
follower tails a JAX primary's ``/v1/taskstore/journal`` and a JAX
follower tails the port's; the same promote/demote/stale-epoch script over
HTTP gives equal roles, epochs, status codes and headers on both; a
journal-degraded store answers the same typed 503. Then the port alone:
a control plane restarted on its journal publishes its unfinished tasks
again with a cold result cache; a standby promotes after its primary
dies, and the old primary, restarted from its stale config, is fenced to
the new epoch and rejoins as a follower. Waits poll a condition under a
deadline; every store and platform gets a registry of its own."""

from __future__ import annotations

import asyncio
import json
import time
import types

import pytest
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.platform_assembly as jax_pa
import ai4e_tpu.taskstore.http as jax_http
import ai4e_tpu.taskstore.replication as jax_rep
import ai4e_tpu.taskstore.store as jax_store
import ai4e_tpu.taskstore.task as jax_task
import ai4e_tpu_torch.platform_assembly as port_pa
import ai4e_tpu_torch.taskstore.http as port_http
import ai4e_tpu_torch.taskstore.replication as port_rep
import ai4e_tpu_torch.taskstore.store as port_store
import ai4e_tpu_torch.taskstore.task as port_task
from ai4e_tpu.chaos.disk import DiskFaultInjector, attach_journal_faults
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry

JAX = types.SimpleNamespace(store=jax_store, task=jax_task, http=jax_http,
                            rep=jax_rep, pa=jax_pa, Registry=JaxRegistry)
PORT = types.SimpleNamespace(store=port_store, task=port_task,
                             http=port_http, rep=port_rep, pa=port_pa,
                             Registry=PortRegistry)
NS = {"jax": JAX, "port": PORT}


def run(coro):
    return asyncio.run(coro)


async def until(cond, what: str, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


def snapshot(store) -> dict:
    with store._lock:
        return {
            "tasks": {t: (r.to_dict(), r.body)
                      for t, r in store._tasks.items()},
            "results": dict(store._results),
            "sets": {f"{p}|{s}": sorted(m)
                     for (p, s), m in store._sets.items() if m},
            "orig": dict(store._orig_bodies),
        }


def mutate(ns, store, tag: str, n: int = 6) -> None:
    """``n`` tasks, half of them completed with a result."""
    for i in range(n):
        tid = f"{tag}{i}"
        store.upsert(ns.task.APITask(task_id=tid, endpoint="/v1/lc/classify",
                                     body=f"body-{tid}".encode()))
        if i % 2:
            store.update_status(tid, "completed - x", "completed")
            store.set_result(tid, json.dumps({"tid": tid}).encode())


# -- cross-package replication -----------------------------------------------


@pytest.mark.parametrize("primary,follower", [("jax", "port"),
                                              ("port", "jax")])
def test_follower_tails_the_other_packages_primary(primary, follower,
                                                   tmp_path):
    P, F = NS[primary], NS[follower]

    async def scenario():
        src = P.store.FollowerTaskStore(str(tmp_path / "primary.jsonl"),
                                        start_as_primary=True,
                                        metrics=P.Registry())
        server = TestServer(P.http.make_app(src))
        await server.start_server()
        dst = F.store.FollowerTaskStore(str(tmp_path / "follower.jsonl"),
                                        metrics=F.Registry())
        replicator = F.rep.JournalReplicator(
            dst, str(server.make_url("")), poll_wait=0.5,
            metrics=F.Registry())
        try:
            mutate(P, src, "a")
            replicator.start()

            def caught_up():
                return (replicator.synced.is_set()
                        and snapshot(dst) == snapshot(src))

            await until(caught_up, "the first sync")
            assert dst.replica_chain_head == src.chain_head
            mutate(P, src, "b")
            await until(caught_up, "the tail")
            gen = replicator.generation
            # A compaction rewrites the file: the follower resyncs from 0.
            src.compact()
            mutate(P, src, "c", 2)
            await until(lambda: replicator.generation != gen
                        and caught_up(), "the resync after compaction")
            assert dst.replica_chain_head == src.chain_head
            assert dst.role == "follower"
            with pytest.raises(F.store.NotPrimaryError):
                dst.upsert(F.task.APITask(task_id="w", endpoint="/v1/x"))
        finally:
            await replicator.aclose()
            await server.close()
            src.close()
            dst.close()
        # The follower's own journal replays to what it held.
        again = F.store.JournaledTaskStore(str(tmp_path / "follower.jsonl"),
                                           metrics=F.Registry())
        assert snapshot(again) == snapshot(src)
        again.close()

    run(scenario())


# -- the same role script over HTTP on both packages --------------------------


async def role_script(ns, path) -> list:
    store = ns.store.FollowerTaskStore(str(path), start_as_primary=True,
                                       metrics=ns.Registry())
    client = TestClient(TestServer(ns.http.make_app(store)))
    await client.start_server()
    out = []

    async def call(method, url, headers=None, **kw):
        async with client.request(method, url, headers=headers, **kw) as r:
            body = await r.json() if r.content_type == "application/json" \
                else await r.read()
            if isinstance(body, dict):
                body = {k: v for k, v in body.items()
                        if k not in ("chain_head", "replica_chain_head",
                                     "Timestamp")}
            out.append((method, url, r.status, r.headers.get("X-Store-Epoch"),
                        r.headers.get("X-Not-Primary"), body))

    task = {"TaskId": "t1", "Endpoint": "/v1/x", "Status": "created"}
    try:
        await call("GET", "/v1/taskstore/role")
        await call("POST", "/v1/taskstore/upsert", json=task)
        await call("POST", "/v1/taskstore/update",
                   json={"TaskId": "t1", "Status": "failed - x",
                         "BackendStatus": "failed"})
        await call("POST", "/v1/taskstore/demote", json={"epoch": 0})
        await call("POST", "/v1/taskstore/demote", json={})
        await call("POST", "/v1/taskstore/demote", json={"epoch": 2})
        await call("GET", "/v1/taskstore/role")
        await call("POST", "/v1/taskstore/upsert", json=task)
        await call("POST", "/v1/taskstore/redrive", json={})
        await call("POST", "/v1/taskstore/result?taskId=t1", data=b"{}")
        await call("GET", "/v1/taskstore/task?taskId=t1")
        await call("POST", "/v1/taskstore/promote")
        await call("GET", "/v1/taskstore/role")
        await call("POST", "/v1/taskstore/redrive", json={"TaskId": "t1"})
        # Passive fencing: an implausible epoch is ignored, a plausible
        # newer one demotes before the handler runs.
        await call("POST", "/v1/taskstore/update",
                   headers={"X-Store-Epoch": "99"},
                   json={"TaskId": "t1", "Status": "running",
                         "BackendStatus": "running"})
        await call("POST", "/v1/taskstore/update",
                   headers={"X-Store-Epoch": "5"},
                   json={"TaskId": "t1", "Status": "completed - y",
                         "BackendStatus": "completed"})
        await call("GET", "/v1/taskstore/role")
        await call("GET", "/v1/taskstore/journal?offset=0&wait=0&epoch=4")
        await call("GET", "/v1/taskstore/journal?offset=0&wait=0&epoch=9")
        await call("GET", "/v1/taskstore/role")
        await call("GET", "/v1/taskstore/journal?offset=x")
    finally:
        await client.close()
        store.close()
    journal = path.read_bytes()
    return out, journal


def test_role_script_equals_jax(tmp_path):
    got = {pkg: run(role_script(ns, tmp_path / f"{pkg}.jsonl"))
           for pkg, ns in NS.items()}
    port_calls, port_journal = got["port"]
    jax_calls, jax_journal = got["jax"]
    assert len(port_calls) == len(jax_calls)
    for p, j in zip(port_calls, jax_calls):
        if "/v1/taskstore/journal?offset=0" in p[1]:
            # The journals' bytes carry wall-clock timestamps.
            p, j = p[:5], j[:5]
        assert p == j
    statuses = [c[2] for c in port_calls]
    assert statuses == [200, 200, 200, 409, 400, 200, 200, 503, 503, 503,
                        200, 200, 200, 200, 200, 503, 200, 200, 200, 200,
                        400]
    roles = [c[5]["role"] for c in port_calls if c[1].endswith("/role")]
    epochs = [c[5]["epoch"] for c in port_calls if c[1].endswith("/role")]
    assert roles == ["primary", "follower", "primary", "follower",
                     "follower"]
    # Passive evidence moves only a primary: the follower stays at 5.
    assert epochs == [0, 2, 3, 5, 5]
    assert port_calls[7][4] == "1"  # X-Not-Primary on the follower's write
    # Both journals hold the same records, timestamps aside.
    strip = [json.loads(line.split(":", 3)[3]) for line in
             port_journal.decode().splitlines()]
    want = [json.loads(line.split(":", 3)[3]) for line in
            jax_journal.decode().splitlines()]
    for rec in strip + want:
        rec.pop("Timestamp", None)
    assert strip == want


@pytest.mark.parametrize("op", ["write", "fsync"])
def test_journal_degraded_answers_the_same_503(op, tmp_path):
    async def one(ns, path):
        store = ns.store.JournaledTaskStore(
            str(path), fsync="always", metrics=ns.Registry())
        injector = DiskFaultInjector(seed=1)
        injector.add_rule(op=op, errno=28)
        attach_journal_faults(store, injector)
        client = TestClient(TestServer(ns.http.make_app(store)))
        await client.start_server()
        out = []
        try:
            for _ in range(2):
                async with client.post(
                        "/v1/taskstore/upsert",
                        json={"TaskId": "a", "Endpoint": "/v1/x"}) as r:
                    out.append((r.status, r.headers.get("X-Shed-Reason"),
                                r.headers.get("X-Not-Primary"),
                                r.headers.get("Retry-After"),
                                (await r.json())["error"].split(":")[0]))
            async with client.get("/v1/taskstore/role") as r:
                out.append((await r.json())["degraded"])
            async with client.get("/v1/taskstore/task?taskId=a") as r:
                out.append(r.status)  # reads still serve
        finally:
            await client.close()
            store.close()
        return out

    got = {pkg: run(one(ns, tmp_path / f"{pkg}.jsonl"))
           for pkg, ns in NS.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0][:4] == (503, "journal-degraded", None, "5")
    assert got["port"][2] is True


# -- the platform's store choice -----------------------------------------------


@pytest.mark.parametrize("fields", [
    {"replicate_from": "http://p:1"},
    {"journal_path": "J", "native_store": True},
    {"journal_path": "J", "replicate_from": "http://p:1",
     "native_store": True},
], ids=["standby-without-journal", "native-journal", "native-standby"])
def test_store_choice_refuses_with_jax_s_text(fields, tmp_path):
    fields = {k: (str(tmp_path / "j.jsonl") if v == "J" else v)
              for k, v in fields.items()}
    texts = {}
    for pkg, ns in NS.items():
        with pytest.raises(ValueError) as exc:
            ns.pa.LocalPlatform(ns.pa.PlatformConfig(**fields),
                                metrics=ns.Registry())
        texts[pkg] = str(exc.value)
    assert texts["port"] == texts["jax"]


def test_journaled_platform_builds_a_born_primary(tmp_path):
    platform = port_pa.LocalPlatform(
        port_pa.PlatformConfig(journal_path=str(tmp_path / "j.jsonl"),
                               taskstore_fsync="always"),
        metrics=PortRegistry())
    assert isinstance(platform.store, port_store.FollowerTaskStore)
    assert platform.store.role == "primary"
    assert platform.store.journal_stats()["fsync_policy"] == "always"

    async def start_stop():
        await platform.start()
        # No HA peer: a forged epoch header must not demote it.
        assert platform.store.passive_fencing is False
        platform.store.note_epoch(1)
        assert platform.store.role == "primary"
        await platform.stop()
        platform.store.close()

    run(start_stop())


# -- the port alone: restart, failover, fencing --------------------------------


def test_restart_reseeds_unfinished_tasks_with_a_cold_cache(tmp_path):
    from ai4e_tpu_torch.rescache.keys import request_key

    journal = str(tmp_path / "cp.jsonl")
    key = request_key("/v1/lc/classify", b"tile", "application/octet-stream")

    async def first_life():
        platform = port_pa.LocalPlatform(
            port_pa.PlatformConfig(journal_path=journal, result_cache=True),
            metrics=PortRegistry())
        platform.broker.register_queue("/v1/lc/classify")
        await platform.start()
        store = platform.store
        for i in range(4):
            store.upsert(port_task.APITask(
                task_id=f"t{i}", endpoint="http://w/v1/lc/classify",
                body=b"tile", content_type="application/octet-stream",
                publish=True, cache_key=key if i == 0 else ""))
        platform.result_cache.register_inflight(key, "t0")
        store.update_status("t0", "running", "running")
        store.set_result("t0", b'{"n": 1}')
        store.update_status("t0", "completed - x", "completed")
        store.update_status("t1", "running", "running")
        assert platform.result_cache.get(key) is not None  # filled
        await platform.stop()
        platform.store.close()

    async def second_life():
        platform = port_pa.LocalPlatform(
            port_pa.PlatformConfig(journal_path=journal, result_cache=True),
            metrics=PortRegistry())
        platform.broker.register_queue("/v1/lc/classify")
        assert platform.store.replayed_task_ids == {"t0", "t1", "t2", "t3"}
        await platform.start()
        queued = []
        for _ in range(3):
            msg = await platform.broker.receive("/v1/lc/classify",
                                                timeout=1.0)
            queued.append((msg.task_id, msg.body))
        assert sorted(queued) == [("t1", b"tile"), ("t2", b"tile"),
                                  ("t3", b"tile")]
        assert platform.store.get_result("t0") == (b'{"n": 1}',
                                                   "application/json")
        # Cold, never stale: the request executes again.
        assert platform.result_cache.get(key) is None
        await platform.stop()
        platform.store.close()

    run(first_life())
    run(second_life())


class ControlPlane:
    """One port control plane (store surface with its lifecycle) served on
    a TestServer whose port survives a kill and a restart."""

    def __init__(self, config, port: int = 0):
        self.platform = port_pa.LocalPlatform(config, metrics=PortRegistry())
        self.platform.broker.register_queue("/v1/lc/classify")
        port_http.make_app(self.platform.store, app=self.platform.gateway.app,
                           lifecycle=self.platform)
        self.server = TestServer(self.platform.gateway.app, port=port)

    async def start(self):
        await self.server.start_server()
        await self.platform.start()
        return self

    @property
    def url(self) -> str:
        return str(self.server.make_url("")).rstrip("/")

    async def kill(self):
        """The process dies: its server and loops stop, its journal stays
        as it is on disk (every append was flushed)."""
        await self.server.close()
        await self.platform.stop()
        self.platform.store.close()


def test_failover_promotes_then_fences_the_restarted_old_primary(tmp_path):
    async def scenario():
        primary_cfg = dict(journal_path=str(tmp_path / "primary.jsonl"),
                           failover_interval=0.1)
        primary = await ControlPlane(port_pa.PlatformConfig(
            advertise_url="http://placeholder", **primary_cfg)).start()
        primary_port = primary.server.port
        primary.platform.config.advertise_url = primary.url
        standby = await ControlPlane(port_pa.PlatformConfig(
            journal_path=str(tmp_path / "standby.jsonl"),
            replicate_from=primary.url, failover_interval=0.1,
            failover_down_after=3)).start()
        standby.platform.config.advertise_url = standby.url
        try:
            store = primary.platform.store
            for i in range(6):
                store.upsert(port_task.APITask(
                    task_id=f"t{i}", endpoint="http://w/v1/lc/classify",
                    body=b"tile", publish=True))
            store.update_status("t0", "completed - x", "completed")
            store.set_result("t0", b'{"ok": 1}')
            replicator = standby.platform.replicator
            await until(lambda: replicator.synced.is_set()
                        and snapshot(standby.platform.store)
                        == snapshot(store), "the standby's sync")
            await primary.kill()
            watchdog = standby.platform.watchdog
            await until(watchdog.promoted.is_set, "the promotion")
            assert standby.platform.store.role == "primary"
            assert standby.platform.store.epoch == 1
            queued = []
            for _ in range(5):
                msg = await standby.platform.broker.receive(
                    "/v1/lc/classify", timeout=1.0)
                queued.append(msg.task_id)
            assert sorted(queued) == ["t1", "t2", "t3", "t4", "t5"]
            assert standby.platform.prober is not None
            # The old primary restarts from its stale config on its port.
            old = await ControlPlane(port_pa.PlatformConfig(
                advertise_url=f"http://127.0.0.1:{primary_port}",
                **primary_cfg), port=primary_port).start()
            assert old.platform.store.role == "primary"
            await until(lambda: old.platform.store.role == "follower"
                        and old.platform.replicator is not None,
                        "the fence and the rejoin")
            assert old.platform.store.epoch == 1
            # The new primary takes writes; the old one follows them.
            standby.platform.store.upsert(port_task.APITask(
                task_id="after", endpoint="http://w/v1/lc/classify",
                body=b"x"))
            await until(lambda: old.platform.replicator.synced.is_set()
                        and snapshot(old.platform.store)
                        == snapshot(standby.platform.store),
                        "the old primary catching up")
            import aiohttp
            async with aiohttp.ClientSession() as http:
                async with http.post(
                        old.url + "/v1/taskstore/upsert",
                        json={"TaskId": "x", "Endpoint": "/v1/x"}) as r:
                    assert r.status == 503
                    assert r.headers["X-Not-Primary"] == "1"
                    assert r.headers["X-Store-Epoch"] == "1"
                async with http.get(old.url + "/v1/taskstore/role") as r:
                    role = await r.json()
                async with http.get(standby.url
                                    + "/v1/taskstore/role") as r:
                    new_role = await r.json()
            assert role["role"] == "follower" and role["replicating"]
            assert role["replica_chain_head"] == new_role["chain_head"]
            assert new_role == dict(new_role, role="primary", epoch=1,
                                    replicating=False)
            await old.kill()
        finally:
            await standby.kill()

    run(scenario())


def test_a_standby_that_never_synced_does_not_promote(tmp_path):
    async def scenario():
        standby = await ControlPlane(port_pa.PlatformConfig(
            journal_path=str(tmp_path / "s.jsonl"),
            replicate_from="http://127.0.0.1:9", failover_interval=0.05,
            failover_down_after=1)).start()
        try:
            await asyncio.sleep(0.5)
            assert not standby.platform.watchdog.promoted.is_set()
            assert standby.platform.store.role == "follower"
            assert not standby.platform._transport_running
        finally:
            await standby.kill()

    run(scenario())


def test_standby_gateway_answers_not_primary(tmp_path):
    async def scenario():
        standby = port_pa.LocalPlatform(port_pa.PlatformConfig(
            journal_path=str(tmp_path / "s.jsonl"),
            replicate_from="http://127.0.0.1:9"), metrics=PortRegistry())
        standby.publish_async_api("/v1/lc/classify-async",
                                  "http://w/v1/lc/classify")
        port_http.make_app(standby.store, app=standby.gateway.app,
                           lifecycle=standby)
        client = TestClient(TestServer(standby.gateway.app))
        await client.start_server()
        await standby.start()
        try:
            async with client.post("/v1/lc/classify-async",
                                   data=b"x") as r:
                assert r.status == 503
                assert r.headers["X-Not-Primary"] == "1"
                assert r.headers["Retry-After"] == "2"
            async with client.post("/v1/taskstore/promote") as r:
                assert r.status == 200
                assert (await r.json())["epoch"] == 1
            assert standby.replicator is None and standby.watchdog is None
            async with client.post("/v1/lc/classify-async",
                                   data=b"x") as r:
                assert r.status == 200
        finally:
            await client.close()
            await standby.stop()
            standby.store.close()

    run(scenario())


def test_a_standalone_worker_closes_its_own_store_on_stop(tmp_path):
    """The base store's ``close`` is synchronous (the journaled one closes
    its journal): the worker's shutdown awaits only the clients' closes."""
    from ai4e_tpu_torch.cli import build_worker, serve

    worker, batcher, _ = build_worker(
        {"models": [{"family": "echo", "name": "echo"}]}, device="cpu")

    async def scenario():
        stop = asyncio.Event()
        server = asyncio.create_task(serve(worker, batcher, "127.0.0.1", 0,
                                           stop, drain_timeout=1.0))
        await asyncio.sleep(0.2)
        stop.set()
        await asyncio.wait_for(server, 30)

    run(scenario())
    assert worker.store._closed


def test_depth_logger_reports_role_and_epoch_like_jax(tmp_path):
    """``ai4e_store_role`` and ``ai4e_store_epoch`` over a follower, then
    the promoted primary, in both packages."""
    from ai4e_tpu.observability.depth_logger import DepthLogger as JaxDL
    from ai4e_tpu_torch.observability.depth_logger import DepthLogger

    got = {}
    for pkg, ns, cls in (("jax", JAX, JaxDL), ("port", PORT, DepthLogger)):
        store = ns.store.FollowerTaskStore(str(tmp_path / f"{pkg}.jsonl"),
                                           metrics=ns.Registry())
        registry = ns.Registry()
        logger = cls(store, metrics=registry)
        lines = []
        for step in ("follower", "promoted"):
            if step == "promoted":
                store.promote()
            logger.sample_queue_depth()
            lines.append(sorted(
                line for line in registry.render_prometheus().splitlines()
                if line.startswith(("ai4e_store_role", "ai4e_store_epoch"))))
        store.close()
        got[pkg] = lines
    assert got["port"] == got["jax"]
    assert got["port"][1] == ["ai4e_store_epoch 1.0", "ai4e_store_role 1.0"]


# -- C10: a stale primary's re-seed against a result on the new primary --------


class PackageControlPlane:
    """One control plane of either package: the store surface on the
    gateway's app, land cover's async route to ``backend``, served on a
    TestServer whose port survives a kill and a restart."""

    def __init__(self, ns, config, backend: str, port: int = 0):
        self.platform = ns.pa.LocalPlatform(config, metrics=ns.Registry())
        self.platform.publish_async_api("/v1/lc/classify-async", backend)
        ns.http.make_app(self.platform.store, app=self.platform.gateway.app,
                         lifecycle=self.platform)
        self.server = TestServer(self.platform.gateway.app, port=port)

    async def start(self):
        await self.server.start_server()
        await self.platform.start()
        return self

    @property
    def url(self) -> str:
        return str(self.server.make_url("")).rstrip("/")

    async def kill(self):
        await self.server.close()
        await self.platform.stop()
        self.platform.store.close()


async def stale_reseed_replay(pkg: str, tmp_path, order: str) -> dict:
    """The candidate of C10, replayed on one package: a task runs on the
    worker when its primary is killed; the promoted standby re-seeds it and
    the worker runs it again (a new store epoch); the old primary restarts
    from its stale config and re-seeds it too, once it completed on the new
    primary (``order="completed"``) or while it still runs there
    (``order="running"``), which JAX's worker runs a third time and the
    port's acknowledges without a run (C11: the same epoch's run is in
    flight). Every result read comes from the new primary."""
    import aiohttp

    if pkg == "jax":
        from ai4e_tpu.service.app import APIService
        from ai4e_tpu.service.task_manager import (HttpResultStore,
                                                   HttpTaskManager)
    else:
        from ai4e_tpu_torch.service.app import APIService
        from ai4e_tpu_torch.service.task_manager import (HttpResultStore,
                                                         HttpTaskManager)
    ns = NS[pkg]
    # JAX's shell runs a delivery of a task it is running; the port's only
    # under a new store epoch (C11).
    reruns = pkg == "jax"
    gate = asyncio.Event()
    runs: list[str] = []
    holder: dict = {}

    svc = APIService("lc", metrics=ns.Registry())
    deliveries: list[str] = []
    answered: list[str] = []

    @aiohttp.web.middleware
    async def count(request, handler):
        deliveries.append(request.path)
        response = await handler(request)
        answered.append(request.path)
        return response

    svc.app.middlewares.append(count)

    @svc.api_async_func("/v1/lc/classify")
    async def classify(taskId, body, content_type):
        runs.append(taskId)
        tm = holder["tm"]
        await tm.update_task_status(taskId, "running - lc")
        await gate.wait()
        await holder["results"].set_result(
            taskId, json.dumps({"run": len(runs)}).encode())
        await tm.complete_task(taskId, "completed - lc")

    worker = TestServer(svc.app)
    await worker.start_server()
    backend = str(worker.make_url("/v1/lc/classify"))
    cfg = dict(journal_path=str(tmp_path / f"{pkg}_primary.jsonl"),
               failover_interval=0.1, retry_delay=0.05)
    primary = await PackageControlPlane(ns, ns.pa.PlatformConfig(
        advertise_url="http://placeholder", **cfg), backend).start()
    primary_port = primary.server.port
    primary.platform.config.advertise_url = primary.url
    standby = await PackageControlPlane(ns, ns.pa.PlatformConfig(
        journal_path=str(tmp_path / f"{pkg}_standby.jsonl"),
        replicate_from=primary.url, failover_interval=0.1,
        failover_down_after=3, retry_delay=0.05), backend).start()
    standby.platform.config.advertise_url = standby.url
    replicas = [primary.url, standby.url]
    holder["tm"] = HttpTaskManager(replicas)
    holder["results"] = HttpResultStore(replicas)
    svc.task_manager = holder["tm"]
    old = None
    out: dict = {}
    try:
        async with aiohttp.ClientSession() as http:
            async with http.post(primary.url + "/v1/lc/classify-async",
                                 data=b"tile") as r:
                task_id = (await r.json())["TaskId"]
            await until(lambda: len(runs) == 1, "the first delivery")
            await until(lambda: standby.platform.replicator.synced.is_set()
                        and snapshot(standby.platform.store)
                        == snapshot(primary.platform.store),
                        "the standby's sync")
            await primary.kill()
            await until(standby.platform.watchdog.promoted.is_set,
                        "the promotion")
            await until(lambda: len(answered) == 2 and len(runs) == 2,
                        "the new primary's re-seed")
            if order == "completed":
                gate.set()
                await until(lambda: standby.platform.store.get_result(
                    task_id) is not None and standby.platform.store.get(
                    task_id).canonical_status == "completed",
                    "the completion on the new primary")
            # The new primary's fencing probe waits until the stale
            # primary's delivery has run its course, which a probe interval
            # would otherwise race.
            prober = standby.platform.prober
            await prober.stop()
            old = await PackageControlPlane(ns, ns.pa.PlatformConfig(
                advertise_url=f"http://127.0.0.1:{primary_port}", **cfg),
                backend, port=primary_port).start()
            await until(lambda: len(deliveries) == 3, "the stale re-seed")
            if order == "running":
                # The stale primary's delivery reaches the worker while the
                # task still runs on the new primary: JAX's runs it a third
                # time.
                await until(lambda: len(answered) == 3
                            and len(runs) == (3 if reruns else 2),
                            "the third delivery")
                gate.set()
            await until(lambda: standby.platform.store.get(
                task_id).canonical_status == "completed"
                and not svc._background, "every run's end")
            prober._stopped.clear()
            prober.start()
            await until(lambda: old.platform.store.role == "follower"
                        and old.platform.replicator is not None,
                        "the fence")
            await until(lambda: old.platform.replicator.synced.is_set()
                        and snapshot(old.platform.store)
                        == snapshot(standby.platform.store),
                        "the old primary catching up")
            async with http.get(standby.url + "/v1/taskstore/result",
                                params={"taskId": task_id}) as r:
                out["result_status"] = r.status
            async with http.get(standby.url + "/v1/taskstore/task",
                                params={"taskId": task_id}) as r:
                out["status"] = (await r.json())["Status"]
            out["runs"] = len(runs)
        out["deliveries"] = len(deliveries)
    finally:
        gate.set()
        await holder["tm"].close()
        await holder["results"].close()
        if old is not None:
            await old.kill()
        await standby.kill()
        await worker.close()
    return out


@pytest.mark.parametrize("order", ["completed", "running"])
def test_c10_stale_reseed_against_the_new_primary_s_result(order, tmp_path):
    """C10's candidate on both packages. A task the stale primary re-seeds
    after it completed on the new primary keeps its result: the worker's
    adoption re-check skips it. One it re-seeds while the task still runs
    there runs a third time in JAX's worker (not in the port's, C11), and
    its result is lost in both packages: the worker's result client wrote
    nothing since the kill, so it still sticks to the old primary's URL,
    where the restarted, not yet fenced store takes the write, while the
    task manager's client, which rotated, puts the completion on the new
    primary. JAX's design; the port keeps it."""
    got = {pkg: run(stale_reseed_replay(pkg, tmp_path, order))
           for pkg in ("jax", "port")}
    # Every observation equal but the runs: the port's worker runs the
    # task once a store epoch.
    assert got["port"] == dict(got["jax"], runs=2)
    assert got["port"]["status"] == "completed - lc"
    if order == "completed":
        assert got["jax"] == dict(got["jax"], result_status=200, runs=2)
    else:
        assert got["jax"] == dict(got["jax"], result_status=204, runs=3)
