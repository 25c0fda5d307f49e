"""The port gateway's long poll (``GET /v1/taskmanagement/task/{id}?wait=``)
on the change feed (``ai4e_tpu_torch/taskstore/feed.py``) held against the
JAX package's gateway on the CPU: each case runs through both gateways on
their own stores and gives the same status codes, the same records and the
same wake (an early wake well inside the wait, or the timeout). The cases
are JAX's ``tests/test_longpoll.py``: a wake with the terminal record, a
timeout with the current status, a 400 on a bad ``wait``, a zero wait as a
plain GET, a 404 for a task evicted mid-wait, a long poll answered by a
second gateway on the same store, and the same on a sharded store, whose
owning shard's feed wakes the poll. Wait times are wall-clock bounds with
a wide margin (an early wake under 5 s of a 10 s wait)."""

from __future__ import annotations

import asyncio
import time
import types

import pytest
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.gateway as jax_gateway
import ai4e_tpu.taskstore as jax_taskstore
import ai4e_tpu.taskstore.sharding as jax_sharding
import ai4e_tpu_torch.gateway as port_gateway
import ai4e_tpu_torch.taskstore as port_taskstore
import ai4e_tpu_torch.taskstore.sharding as port_sharding
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry

NS = {
    "jax": types.SimpleNamespace(gateway=jax_gateway, ts=jax_taskstore,
                                 sharding=jax_sharding,
                                 Registry=JaxRegistry),
    "port": types.SimpleNamespace(gateway=port_gateway, ts=port_taskstore,
                                  sharding=port_sharding,
                                  Registry=PortRegistry),
}
EARLY_S = 5.0   # an early wake answers well inside the 10 s wait


def run(coro):
    return asyncio.run(coro)


async def serve(app) -> TestClient:
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def both(scenario) -> dict:
    seen = {name: run(scenario(ns)) for name, ns in NS.items()}
    assert seen["port"] == seen["jax"]
    return seen["port"]


def make_store(ns, sharded: bool):
    if sharded:
        return ns.sharding.ShardedTaskStore(4)
    return ns.ts.InMemoryTaskStore()


async def poll(client, task_id: str, **params):
    t0 = time.perf_counter()
    resp = await client.get(f"/v1/taskmanagement/task/{task_id}",
                            params=params)
    waited = time.perf_counter() - t0
    body = await resp.json() if resp.status == 200 else await resp.text()
    if isinstance(body, dict):
        # Each package stamps its own clock.
        assert body.pop("Timestamp") > 0
    return resp.status, body, waited


def watchers(gateway, store, task_id: str) -> int:
    feed_for = getattr(store, "feed_for", None)
    feed = feed_for(task_id) if feed_for else gateway._fallback_feed
    return feed.watcher_count if feed is not None else 0


def test_store_listeners_see_every_transition_and_survive_a_fault():
    def scenario(ns):
        async def main():
            store = ns.ts.InMemoryTaskStore()
            seen = []
            store.add_listener(lambda t: seen.append(t.status))

            def bad(_):
                raise RuntimeError("observer bug")

            store.add_listener(bad)
            task = store.upsert(ns.ts.APITask(task_id="l1",
                                              endpoint="http://x/v1/a",
                                              body=b"b"))
            store.update_status(task.task_id, "running", "running")
            store.update_status(task.task_id, "completed", "completed")
            return seen, store.get("l1").status
        return main()

    assert both(scenario) == (
        ["created", "running", "completed"], "completed")


@pytest.mark.parametrize("sharded", [False, True], ids=["store", "sharded"])
def test_a_wait_wakes_early_with_the_terminal_record(sharded):
    def scenario(ns):
        async def main():
            store = make_store(ns, sharded)
            gw = ns.gateway.Gateway(store, metrics=ns.Registry())
            client = await serve(gw.app)
            try:
                store.upsert(ns.ts.APITask(task_id="w1",
                                           endpoint="http://h/v1/api",
                                           body=b"x", publish=False))

                async def complete_soon():
                    await asyncio.sleep(0.15)
                    store.update_status("w1", "completed - done",
                                        "completed")

                done = asyncio.ensure_future(complete_soon())
                status, body, waited = await poll(client, "w1", wait="10")
                await done
                ledger = await poll(client, "w1", ledger="1")
                return (status, body, 0.1 <= waited < EARLY_S,
                        watchers(gw, store, "w1"), ledger[:2],
                        gw._fallback_feed is None)
            finally:
                await client.close()
        return main()

    status, body, early, left, ledger, own_feed = both(scenario)
    assert status == 200 and body["Status"] == "completed - done" and early
    assert left == 0 and ledger[0] == 200 and ledger[1]["Ledger"] == []
    # A sharded store's own feed woke the poll.
    assert own_feed == sharded


@pytest.mark.parametrize("sharded", [False, True], ids=["store", "sharded"])
def test_a_wait_times_out_with_the_current_status(sharded):
    def scenario(ns):
        async def main():
            store = make_store(ns, sharded)
            gw = ns.gateway.Gateway(store, metrics=ns.Registry())
            client = await serve(gw.app)
            try:
                store.upsert(ns.ts.APITask(task_id="t1",
                                           endpoint="http://x/v1/never",
                                           body=b"x", publish=False))
                status, body, waited = await poll(client, "t1", wait="0.2")
                return (status, body["Status"], 0.15 <= waited < 2.0,
                        watchers(gw, store, "t1"))
            finally:
                await client.close()
        return main()

    assert both(scenario) == (200, "created", True, 0)


@pytest.mark.parametrize("wait,want", [("soon", 400), ("0", 200),
                                       ("-1", 200), ("nan", 200)])
def test_bad_and_zero_waits_answer_like_jax(wait, want):
    def scenario(ns):
        async def main():
            store = ns.ts.InMemoryTaskStore()
            gw = ns.gateway.Gateway(store, metrics=ns.Registry())
            client = await serve(gw.app)
            try:
                store.upsert(ns.ts.APITask(task_id="z1",
                                           endpoint="http://x/v1/a",
                                           body=b"x", publish=False))
                status, body, waited = await poll(client, "z1", wait=wait)
                plain = await poll(client, "z1")
                return (status, body if status != 200 else body["Status"],
                        waited < 1.0, plain[:2],
                        watchers(gw, store, "z1"))
            finally:
                await client.close()
        return main()

    status, _, quick, plain, left = both(scenario)
    assert status == want and quick and left == 0
    assert plain[0] == 200 and plain[1]["Status"] == "created"


def test_a_task_evicted_mid_wait_is_404():
    def scenario(ns):
        async def main():
            store = ns.ts.InMemoryTaskStore()
            gw = ns.gateway.Gateway(store, metrics=ns.Registry())
            client = await serve(gw.app)
            try:
                store.upsert(ns.ts.APITask(task_id="e1",
                                           endpoint="http://h/v1/api",
                                           body=b"x"))

                async def evict_soon():
                    await asyncio.sleep(0.1)
                    # No terminal transition publishes: the poll rides out
                    # its wait, and the re-read answers 404.
                    with store._lock:
                        store._apply_evict("e1")

                done = asyncio.ensure_future(evict_soon())
                status, body, _ = await poll(client, "e1", wait="0.4")
                await done
                unknown = await poll(client, "nope", wait="0.1")
                return status, body, unknown[:2]
            finally:
                await client.close()
        return main()

    status, body, unknown = both(scenario)
    assert status == 404 and body == "Task not found."
    assert unknown == (404, "Task not found.")


@pytest.mark.parametrize("sharded", [False, True], ids=["store", "sharded"])
def test_a_second_gateway_on_the_store_wakes_with_the_record(sharded):
    def scenario(ns):
        async def main():
            store = make_store(ns, sharded)
            gw_a = ns.gateway.Gateway(store, metrics=ns.Registry())
            gw_b = ns.gateway.Gateway(store, metrics=ns.Registry())
            gw_a.add_async_route("/v1/pub/api", "http://h/v1/api")
            client_a = await serve(gw_a.app)
            client_b = await serve(gw_b.app)
            try:
                resp = await client_a.post("/v1/pub/api", data=b"x")
                task_id = (await resp.json())["TaskId"]

                async def complete_soon():
                    await asyncio.sleep(0.15)
                    store.update_status(task_id, "completed", "completed")

                done = asyncio.ensure_future(complete_soon())
                status, body, waited = await poll(client_b, task_id,
                                                  wait="10")
                await done
                return (status, body["Status"], body["TaskId"] == task_id,
                        waited < EARLY_S)
            finally:
                await client_a.close()
                await client_b.close()
        return main()

    assert both(scenario) == (200, "completed", True, True)
