"""The port's native cores (``taskstore/native.py``, ``broker/native.py``,
built from ``ai4e_tpu_torch/native/*_core.cpp``) against the JAX package's
and against the port's Python store and broker, on one op script each:
transitions, conditional updates, ``requeue_if``, results, the status
sets, leases, abandon and dead letters. A hypothesis sequence drives the
four stores at once. Then the assembly: its refusals carry JAX's texts,
AUTO retention is off on the native store, and an async request runs end
to end on the native cores."""

import asyncio
import threading
import time

import pytest
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as st

from ai4e_tpu.broker.native import NativeBroker as JaxNativeBroker
from ai4e_tpu.platform_assembly import LocalPlatform as JaxPlatform
from ai4e_tpu.platform_assembly import PlatformConfig as JaxPlatformConfig
from ai4e_tpu.taskstore import APITask as JaxTask
from ai4e_tpu.taskstore import InMemoryTaskStore as JaxStore
from ai4e_tpu.taskstore import TaskNotFound as JaxNotFound
from ai4e_tpu.taskstore.native import NativeTaskStore as JaxNativeStore
from ai4e_tpu_torch.broker.native import NativeBroker
from ai4e_tpu_torch.broker.queue import InMemoryBroker
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
from ai4e_tpu_torch.service.app import APIService
from ai4e_tpu_torch.taskstore import APITask, InMemoryTaskStore, TaskNotFound
from ai4e_tpu_torch.taskstore.native import NativeTaskStore
from ai4e_tpu_torch.utils.native_build import BUILD_DIR


def run(coro):
    return asyncio.run(coro)


class Kit:
    """One package's store or broker with its task type."""

    def __init__(self, name, make, task_cls, not_found):
        self.name = name
        self.make = make
        self.task = task_cls
        self.not_found = not_found


STORES = [
    Kit("jax-python", JaxStore, JaxTask, JaxNotFound),
    Kit("jax-native", JaxNativeStore, JaxTask, JaxNotFound),
    Kit("port-python", InMemoryTaskStore, APITask, TaskNotFound),
    Kit("port-native", NativeTaskStore, APITask, TaskNotFound),
]


def view(task) -> tuple | None:
    """A record without its clock."""
    if task is None:
        return None
    return (task.task_id, task.status, task.backend_status, task.endpoint,
            task.body, task.content_type, task.publish, task.cache_key)


def store_script(kit: Kit) -> list:
    """Every verb of the store on one scripted history; returns what each
    step observed."""
    store = kit.make()
    published = []
    store.set_publisher(lambda t: published.append(
        (t.task_id, t.endpoint, t.body, t.content_type)))
    seen = []
    T = kit.task
    seen.append(view(store.upsert(T(task_id="a", endpoint="http://h/v1/x?q=1",
                                    body=b"IMG", content_type="image/jpeg",
                                    publish=True))))
    seen.append(view(store.upsert(T(task_id="b", endpoint="/v1/x",
                                    body=b"B", cache_key="k-b"))))
    seen.append(view(store.upsert(T(task_id="c", endpoint="/v1/y",
                                    body=b"C"))))
    blank = store.upsert(T(endpoint="/v1/y", body=b"D"))
    seen.append((len(blank.task_id), blank.status))
    seen.append(view(store.update_status("a", "running - model")))
    seen.append(view(store.update_status_if("a", "created", "failed - x")))
    seen.append(view(store.update_status_if("a", "running", "running - 2")))
    # A rescue: the stale view refuses, the live one republishes the
    # original body and type.
    seen.append(view(store.requeue_if("a", "completed")))
    seen.append(view(store.requeue_if("a", "running")))
    # A handoff with a fresh body becomes the replay body.
    seen.append(view(store.upsert(T(task_id="a", endpoint="/v1/z",
                                    body=b"CROPS", content_type="x/npy",
                                    publish=True))))
    seen.append(view(store.upsert(T(task_id="a", endpoint="/v1/z",
                                    publish=True))))
    seen.append(view(store.update_status("b", "completed - 3 found",
                                         "completed")))
    seen.append(view(store.update_status("c", "failed - delivery attempts "
                                         "exhausted", "failed")))
    seen.append(view(store.requeue_if("c", "failed")))
    seen.append(view(store.get("b")))
    for verb in (lambda: store.get("nope"),
                 lambda: store.update_status("nope", "running")):
        with pytest.raises(kit.not_found):
            verb()
    with pytest.raises(ValueError, match="stage separator"):
        store.upsert(T(task_id="x:y", endpoint="/v1/x"))
    store.set_result("b", b'{"n":1}')
    store.set_result("b", b"stage", "application/x-npy", stage="det")
    seen.append(store.get_result("b"))
    seen.append(store.get_result("b", stage="det"))
    seen.append(store.get_result("nope"))
    with pytest.raises(kit.not_found):
        store.set_result("nope", b"x")
    seen.append(store.endpoints())
    for path in store.endpoints():
        for status in ("created", "running", "completed", "failed"):
            members = ["<minted>" if m == blank.task_id else m
                       for m in store.set_members(path, status)]
            seen.append((path, status, store.set_len(path, status),
                         sorted(members)))
    seen.append(store.depths())

    def boom(task):
        raise RuntimeError("broker down")

    store.set_publisher(boom)
    seen.append(view(store.upsert(T(task_id="e", endpoint="/v1/x",
                                    body=b"E", publish=True))))
    seen.append(view(store.get("e")))
    return [seen, published]


def test_store_script_matches_across_packages_and_cores():
    want = store_script(STORES[0])
    for kit in STORES[1:]:
        assert store_script(kit) == want, kit.name


@pytest.mark.parametrize("kit", [STORES[1], STORES[3]],
                         ids=["jax-native", "port-native"])
def test_native_unfinished_tasks_restore_bodies(kit):
    store = kit.make()
    t1 = store.upsert(kit.task(endpoint="/v1/x", body=b"A"))
    t2 = store.upsert(kit.task(endpoint="/v1/x", body=b"B"))
    store.update_status(t1.task_id, "running")
    store.update_status(t2.task_id, "completed")
    unfinished = store.unfinished_tasks()
    assert [(u.task_id, u.body) for u in unfinished] == [(t1.task_id, b"A")]


def test_native_store_parallel_transitions_keep_sets_consistent():
    store = NativeTaskStore()
    tasks = [store.upsert(APITask(endpoint="/v1/x", body=b"x"))
             for _ in range(40)]

    def churn(task):
        store.update_status(task.task_id, "running")
        store.update_status(task.task_id, "completed")

    threads = [threading.Thread(target=churn, args=(t,)) for t in tasks]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert [store.set_len("/v1/x", s) for s in
            ("created", "running", "completed")] == [0, 0, 40]


def test_native_store_listeners_hear_every_transition():
    store = NativeTaskStore()
    heard = []
    store.add_listener(lambda t: heard.append((t.task_id, t.status)))
    store.upsert(APITask(task_id="a", endpoint="/v1/x", body=b"x"))
    store.update_status("a", "running")
    store.update_status_if("a", "running", "completed")
    assert heard == [("a", "created"), ("a", "running"), ("a", "completed")]


# -- a random history through the four stores --------------------------------

IDS = ["t0", "t1", "t2"]
STATUSES = ["created", "running - m", "completed - ok",
            "failed - delivery attempts exhausted", "failed - bad input"]
CANON = ["created", "running", "completed", "failed"]

OPS = st.one_of(
    st.tuples(st.just("upsert"), st.sampled_from(IDS),
              st.sampled_from(["/v1/a", "/v1/b"]), st.binary(max_size=6),
              st.booleans()),
    st.tuples(st.just("update"), st.sampled_from(IDS),
              st.sampled_from(STATUSES)),
    st.tuples(st.just("update_if"), st.sampled_from(IDS),
              st.sampled_from(CANON), st.sampled_from(STATUSES)),
    st.tuples(st.just("requeue_if"), st.sampled_from(IDS),
              st.sampled_from(CANON)),
    st.tuples(st.just("result"), st.sampled_from(IDS), st.binary(max_size=6),
              st.sampled_from([None, "s"])),
)


def apply_ops(kit: Kit, ops) -> list:
    store = kit.make()
    published = []
    store.set_publisher(lambda t: published.append((t.task_id, t.body)))
    out = []
    for op in ops:
        try:
            if op[0] == "upsert":
                _, tid, ep, body, publish = op
                r = view(store.upsert(kit.task(task_id=tid, endpoint=ep,
                                               body=body, publish=publish)))
            elif op[0] == "update":
                r = view(store.update_status(op[1], op[2]))
            elif op[0] == "update_if":
                r = view(store.update_status_if(op[1], op[2], op[3]))
            elif op[0] == "requeue_if":
                r = view(store.requeue_if(op[1], op[2]))
            else:
                store.set_result(op[1], op[2], stage=op[3])
                r = store.get_result(op[1], stage=op[3])
        except kit.not_found:
            r = "not found"
        out.append(r)
    sets = {(ep, s): sorted(store.set_members(ep, s))
            for ep in store.endpoints() for s in CANON}
    return [out, published, sets, store.depths()]


@settings(max_examples=60, deadline=None)
@given(st.lists(OPS, max_size=25))
def test_random_histories_agree(ops):
    want = apply_ops(STORES[0], ops)
    for kit in STORES[1:]:
        assert apply_ops(kit, ops) == want, kit.name


# -- the broker ----------------------------------------------------------------


BROKERS = [
    ("jax-native", lambda **kw: JaxNativeBroker(**kw), JaxTask),
    ("port-native", lambda **kw: NativeBroker(**kw), APITask),
    ("port-python", lambda **kw: InMemoryBroker(metrics=MetricsRegistry(),
                                                **kw), APITask),
]


def msg_view(msg):
    if msg is None:
        return None
    return (msg.task_id, msg.endpoint, msg.body, msg.content_type,
            msg.delivery_count)


def depth(broker) -> int:
    """Ready messages on ``/v1/api`` (the Python broker has no
    ``depths``)."""
    if hasattr(broker, "depths"):
        return broker.depths()["/v1/api"]
    return len(broker.queue("/v1/api"))


async def broker_script(make, task_cls) -> list:
    broker = make(max_delivery_count=2, lease_seconds=0.2)
    broker.bind_loop(asyncio.get_running_loop())
    dead = []
    broker.set_dead_letter_handler(lambda m: dead.append(m.task_id))
    broker.register_queue("/v1/api")
    seen = []
    try:
        for i in range(3):
            broker.publish(task_cls(task_id=f"t{i}", endpoint="/v1/api",
                                    body=bytes([0, 255, i]),
                                    content_type="application/x-npy"))
        seen.append(depth(broker))
        m0 = await broker.receive("/v1/api", timeout=2)
        seen.append(msg_view(m0))
        broker.complete(m0)
        m1 = await broker.receive("/v1/api", timeout=2)
        seen.append(msg_view(m1))
        seen.append(broker.abandon(m1))       # redelivered, count 1 of 2
        m2 = await broker.receive("/v1/api", timeout=2)
        seen.append(msg_view(m2))             # t2 first: FIFO
        m1b = await broker.receive("/v1/api", timeout=2)
        seen.append(msg_view(m1b))            # t1 again, second delivery
        seen.append(broker.abandon(m1b))      # budget spent: dead-lettered
        broker.complete(m2)
        # A lease that expires redelivers without an abandon.
        broker.publish(task_cls(task_id="t3", endpoint="/v1/api", body=b"L"))
        m3 = await broker.receive("/v1/api", timeout=2)
        seen.append(msg_view(m3))
        await asyncio.sleep(0.3)
        m3b = await broker.receive("/v1/api", timeout=2)
        seen.append(msg_view(m3b))
        broker.complete(m3b)
        seen.append(msg_view(await broker.receive("/v1/api", timeout=0.05)))
        seen.append(depth(broker))
        await asyncio.sleep(0.05)  # the dead-letter handler runs on the loop
        seen.append(dead)
    finally:
        if hasattr(broker, "close"):
            broker.close()
    return seen


def test_broker_script_matches_across_packages_and_cores():
    want = run(broker_script(*BROKERS[0][1:]))
    assert want[-1] == ["t1"]
    for name, make, task_cls in BROKERS[1:]:
        assert run(broker_script(make, task_cls)) == want, name


def test_native_broker_receive_parks_off_the_loop():
    """A blocking receive waits in the broker's threads: the loop keeps
    running, and a publish from another thread wakes the receiver."""
    async def main():
        broker = NativeBroker()
        broker.register_queue("/v1/api")
        try:
            waiter = asyncio.ensure_future(broker.receive("/v1/api",
                                                          timeout=5))
            ticks = 0
            for _ in range(5):
                await asyncio.sleep(0.01)
                ticks += 1
            threading.Thread(target=broker.publish, args=(APITask(
                task_id="t", endpoint="/v1/api", body=b"x"),)).start()
            msg = await asyncio.wait_for(waiter, 5)
            assert (ticks, msg.task_id, msg.body) == (5, "t", b"x")
            broker.complete(msg)
        finally:
            broker.close()

    run(main())


@pytest.mark.parametrize("package", ["jax", "port"])
def test_idle_receivers_do_not_starve_a_busy_queue(package):
    """Sixteen delivery loops parked on empty queues, as routes.json's
    starting loops are, and one more on a queue that gets a message: the
    port's pool gives it a thread at once; JAX's pool of 8 makes it wait
    for an idle receive to time out."""
    async def main():
        broker = (JaxNativeBroker() if package == "jax" else NativeBroker())
        task_cls = JaxTask if package == "jax" else APITask
        for q in ("/v1/idle", "/v1/busy"):
            broker.register_queue(q)
        try:
            idle = [asyncio.ensure_future(broker.receive("/v1/idle",
                                                         timeout=3))
                    for _ in range(16)]
            await asyncio.sleep(0.2)
            broker.publish(task_cls(task_id="t", endpoint="/v1/busy"))
            t0 = time.monotonic()
            msg = await broker.receive("/v1/busy", timeout=10)
            waited = time.monotonic() - t0
            broker.complete(msg)
            await asyncio.gather(*idle)
        finally:
            broker.close()
        return waited

    waited = run(main())
    if package == "port":
        assert waited < 1.0
    else:
        assert waited >= 2.0


def test_closed_native_broker_refuses_publish():
    broker = NativeBroker()
    broker.close()
    with pytest.raises(RuntimeError, match="closed"):
        broker.publish(APITask(task_id="t", endpoint="/v1/api"))


def test_native_build_lands_in_the_build_dir_and_a_failed_build_raises(
        monkeypatch):
    from ai4e_tpu_torch.broker import native as broker_native
    from ai4e_tpu_torch.taskstore import native as store_native

    for module, stem in ((store_native, "libtaskstore_core-"),
                         (broker_native, "libbroker_core-")):
        path = module.build_library()
        assert path.startswith(str(BUILD_DIR)) and stem in path
    # No fallback: a compiler that fails raises at construction.
    monkeypatch.setattr(store_native, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(Exception):
        NativeTaskStore()


# -- the assembly ----------------------------------------------------------------

REFUSALS = [
    pytest.param({"native_store": True, "result_dir": "R"}, id="result-dir"),
    pytest.param({"native_store": True, "reaper_terminal_retention": 60.0},
                 id="retention"),
    pytest.param({"native_store": True, "admission": True},
                 id="admission-store"),
    pytest.param({"native_broker": True, "admission": True},
                 id="admission-broker"),
    pytest.param({"native_store": True, "observability": True},
                 id="observability"),
]


@pytest.mark.parametrize("fields", REFUSALS)
def test_assembly_refusals_carry_jax_s_texts(fields, tmp_path):
    fields = {k: (str(tmp_path / v) if k == "result_dir" else v)
              for k, v in fields.items()}
    with pytest.raises(ValueError) as want:
        JaxPlatform(JaxPlatformConfig(**fields))
    with pytest.raises(ValueError) as got:
        LocalPlatform(PlatformConfig(**fields), metrics=MetricsRegistry())
    assert str(got.value) == str(want.value)


def test_native_store_turns_auto_retention_off_and_keeps_the_rescue():
    p = LocalPlatform(PlatformConfig(native_store=True),
                      metrics=MetricsRegistry())
    assert p.reaper is None
    assert JaxPlatform(JaxPlatformConfig(native_store=True)).reaper is None
    p = LocalPlatform(PlatformConfig(native_store=True,
                                     reaper_running_timeout=5.0,
                                     reaper_terminal_retention=-1),
                      metrics=MetricsRegistry())
    assert isinstance(p.store, NativeTaskStore)
    assert (p.reaper.running_timeout, p.reaper.terminal_retention) == (5.0,
                                                                       None)


@pytest.mark.parametrize("native_store,native_broker", [
    (True, True), (True, False), (False, True)],
    ids=["both", "store", "broker"])
def test_async_request_end_to_end_on_the_native_cores(native_store,
                                                      native_broker):
    async def main():
        reg = MetricsRegistry()
        platform = LocalPlatform(PlatformConfig(
            retry_delay=0.05, native_store=native_store,
            native_broker=native_broker), metrics=reg)
        assert isinstance(platform.store, NativeTaskStore) == native_store
        assert isinstance(platform.broker, NativeBroker) == native_broker
        svc = APIService("echo", prefix="v1/echo",
                         task_manager=platform.task_manager, metrics=reg)

        @svc.api_async_func("/work")
        async def work(taskId, body, content_type):
            await platform.task_manager.update_task_status(taskId,
                                                           "running - echo")
            platform.store.set_result(taskId, body[::-1], content_type)
            await platform.task_manager.complete_task(taskId,
                                                      "completed - echoed")

        svc_client = TestClient(TestServer(svc.app))
        await svc_client.start_server()
        platform.publish_async_api("/v1/pub/work",
                                   str(svc_client.make_url("/v1/echo/work")))
        gw = TestClient(TestServer(platform.gateway.app))
        await gw.start_server()
        await platform.start()
        try:
            tids = []
            for i in range(8):
                resp = await gw.post("/v1/pub/work", data=bytes([i, 1, 2]))
                assert resp.status == 200
                tids.append((await resp.json())["TaskId"])
            for i, tid in enumerate(tids):
                r = await gw.get(f"/v1/taskmanagement/task/{tid}",
                                 params={"wait": "10"})
                assert (await r.json())["Status"] == "completed - echoed"
                assert platform.store.get_result(tid)[0] == bytes([2, 1, i])
            r = await gw.get(f"/v1/taskmanagement/task/{tids[0]}",
                             params={"ledger": "1"})
            assert (await r.json())["Ledger"] == []
        finally:
            await platform.stop()
            await gw.close()
            await svc_client.close()

    run(main())
