"""The port's multi-tenancy (``ai4e_tpu_torch/tenancy/``, ROADMAP A18.10)
held against the JAX package's.

Two halves. ``tests/test_tenancy.py`` runs whole on the port: its source
with every ``ai4e_tpu`` import pointed at ``ai4e_tpu_torch``
(``port_suite``, which the port's pipeline and SSE test files use too).
Then the same scripts go through both packages and their outputs are
compared: spec errors word for word, the label map, quota decisions and
Retry-After on one fake clock, the deficit-round-robin dequeue message by
message (tenants, weights, priorities, redeliveries, a live reweight,
shard sub-queues), the gateway's 429s, the charge, the per-tenant series,
the tenant over the store's wire and journal, and ``tenancy=False``
leaving every surface as it was."""

from __future__ import annotations

import asyncio
import json
import pathlib
import random
import re
import sys
import types

import pytest
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.broker.queue as jax_queue
import ai4e_tpu.platform_assembly as jax_pa
import ai4e_tpu.taskstore as jax_taskstore
import ai4e_tpu.taskstore.http as jax_http
import ai4e_tpu.taskstore.store as jax_store
import ai4e_tpu.tenancy as jax_tenancy
import ai4e_tpu_torch.broker.queue as port_queue
import ai4e_tpu_torch.platform_assembly as port_pa
import ai4e_tpu_torch.taskstore as port_taskstore
import ai4e_tpu_torch.taskstore.http as port_http
import ai4e_tpu_torch.taskstore.store as port_store
import ai4e_tpu_torch.tenancy as port_tenancy
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry

TESTS = pathlib.Path(__file__).parent

JAX = types.SimpleNamespace(queue=jax_queue, pa=jax_pa, ts=jax_taskstore,
                            http=jax_http, store=jax_store, ten=jax_tenancy,
                            Registry=JaxRegistry)
PORT = types.SimpleNamespace(queue=port_queue, pa=port_pa,
                             ts=port_taskstore, http=port_http,
                             store=port_store, ten=port_tenancy,
                             Registry=PortRegistry)
NS = {"jax": JAX, "port": PORT}


def port_module(name: str) -> types.ModuleType:
    """``tests/{name}.py`` with every ``ai4e_tpu`` import pointed at the
    port, executed as a module of its own."""
    path = TESTS / f"{name}.py"
    src = re.sub(r"\bai4e_tpu\b(?!_torch)", "ai4e_tpu_torch",
                 path.read_text())
    mod = types.ModuleType(f"_port_{name}")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def port_suite(name: str, leave_out: tuple[str, ...] = ()) -> dict:
    """The tests, test classes and fixtures of ``tests/{name}.py`` on the
    port, by name, for a test module's globals; ``leave_out`` names the
    ones that need a module the port does not have yet."""
    mod = port_module(name)
    return {key: value for key, value in vars(mod).items()
            if key not in leave_out
            and (key.startswith(("test_", "Test"))
                 or type(value).__name__ == "FixtureFunctionDefinition"
                 or hasattr(value, "_pytestfixturefunction"))}


globals().update(port_suite("test_tenancy"))


def run(coro):
    return asyncio.run(coro)


def both(fn):
    """``fn(ns)`` on each package."""
    return {pkg: fn(ns) for pkg, ns in NS.items()}


def metric_lines(registry, prefix: str) -> list[str]:
    return sorted(line for line in registry.render_prometheus().splitlines()
                  if line.startswith(prefix))


# -- the registry ----------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "justaname", "a=", "=k", "a=k1,a=k2", "a=k,b=k", "a=k:heavy", "a=k:0",
    "a=k:-1", "a=k:1:fast", "a=k:1:2:lots", "a=k||:2", ",,", "",
    "alpha=key-a1|key-a2:4:50:100,beta=key-b:2",
    "a=k1|k2::3,b=k3:::7, c = k4 : 2 ",
])
def test_parse_tenants_and_its_errors_word_for_word(spec):
    def parse(ns):
        try:
            return [(t.tenant_id, t.weight, t.rps, t.burst, t.keys)
                    for t in ns.ten.parse_tenants(spec, default_weight=1.5,
                                                  default_rps=7.0)]
        except ValueError as exc:
            return f"{type(exc).__name__}: {exc}"

    got = both(parse)
    assert got["port"] == got["jax"]


def test_resolution_and_the_frozen_label_map_equal_jax():
    spec = "a=ka,b=kb|kb2:3,c=kc:1:5,default=kd:2"
    ids = ["a", "b", "c", "default", "never", "", "late"]
    keys = ["ka", "kb2", "kc", "kd", "nope", None, "kl"]

    def view(ns):
        out = {}
        for n in (0, 1, 2, 3, 8):
            reg = ns.ten.TenantRegistry(ns.ten.parse_tenants(spec),
                                        default_weight=0.5, label_top_n=n)
            reg.update(ns.ten.Tenant("late", keys=("kl",)))
            out[n] = ([reg.tenant_label(i) for i in ids],
                      [(reg.resolve(k).tenant_id, reg.resolve(k).weight)
                       for k in keys],
                      [reg.weight(i) for i in ids])
        return out

    got = both(view)
    assert got["port"] == got["jax"]
    assert got["port"][2][0][:3] == ["a", "b", "other"]


# -- quotas ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quota_decisions_and_retry_after_on_one_clock(seed):
    """One random script of clock steps and admissions, with a live
    policy update halfway, through both packages' buckets."""
    spec = "a=ka:1:2,b=kb:1:0.5:3,c=kc:1:0,d=kd:1:10:1"

    def script(ns):
        rng = random.Random(seed)
        clock = {"t": 1000.0}
        reg = ns.ten.TenantRegistry(ns.ten.parse_tenants(spec),
                                    default_rps=1.0)
        quota = ns.ten.TenantQuota(reg, now=lambda: clock["t"])
        out = []
        for step in range(400):
            clock["t"] += rng.choice((0.0, 0.0, 0.01, 0.1, 0.4, 1.3, 90.0))
            tenant = rng.choice(("a", "b", "c", "d", "default", "ghost"))
            if step == 200:
                reg.update(ns.ten.Tenant("a", rps=5.0, burst=1.0,
                                         keys=("ka",)))
            out.append((tenant, quota.admit(tenant),
                        round(quota.tokens(tenant), 12)))
        return out

    got = both(script)
    assert got["port"] == got["jax"]
    assert any(not allowed for _, (allowed, _), _ in got["port"])


# -- the deficit-round-robin lanes ---------------------------------------------


async def fair_script(ns, seed: int, shards: int) -> list:
    """Messages of several tenants, weights and priorities published into
    a fair broker (one queue, or a queue's shard sub-queues); received in
    turns, some abandoned for redelivery; a live reweight halfway. The
    sequence of (queue, task, tenant, delivery) as each receive saw it."""
    rng = random.Random(seed)
    reg = ns.ten.TenantRegistry(ns.ten.parse_tenants(
        "noisy=kn:1,alpha=ka:4,beta=kb:1:5:5"), default_weight=0.5)
    lanes = ns.ten.TenantLanes(reg, min_quantum=0.05)
    router = ((lambda task_id: int(task_id[1:]) % shards)
              if shards > 1 else None)
    broker = ns.queue.InMemoryBroker(metrics=ns.Registry(),
                                     shard_router=router, fair=lanes)
    broker.register_queue("/v1/q")
    broker.bind_loop(asyncio.get_running_loop())
    names = ([ns.queue.shard_queue_name("/v1/q", i) for i in range(shards)]
             if shards > 1 else ["/v1/q"])
    n = 0

    def publish(count: int) -> None:
        nonlocal n
        for _ in range(count):
            tenant = rng.choices(("noisy", "alpha", "beta", ""),
                                 weights=(6, 2, 2, 1))[0]
            broker.publish(ns.ts.APITask(
                task_id=f"t{n}", endpoint="/v1/q", tenant=tenant,
                priority=rng.choice((0, 1, 2)), publish=True))
            n += 1

    publish(60)
    await asyncio.sleep(0)
    seen = []
    for turn in range(120):
        if turn == 40:
            reg.set_weight("noisy", 3.0)
        if turn in (20, 70):
            publish(25)
            await asyncio.sleep(0)
        name = names[turn % len(names)]
        msg = await broker.receive(name, timeout=0.001)
        if msg is None:
            seen.append((name, None))
            continue
        seen.append((name, msg.task_id, msg.tenant, msg.delivery_count,
                     msg.priority))
        if rng.random() < 0.25:
            broker.abandon(msg)
        else:
            broker.complete(msg)
    seen.append({name: broker.queue(name).lane_depths() for name in names})
    return seen


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("seed", [0, 7, 21])
def test_drr_dequeue_sequence_equals_jax_message_by_message(seed, shards):
    got = both(lambda ns: run(fair_script(ns, seed, shards)))
    assert got["port"] == got["jax"]
    tenants = [s[2] for s in got["port"] if isinstance(s, tuple)
               and len(s) > 2]
    assert {"noisy", "alpha", "beta", ""} <= set(tenants)


def test_fifo_queue_without_a_policy_is_today_s_queue():
    """Without ``fair=`` the queue keeps one FIFO: the same script gives
    the publish order back, and no lane or deficit state exists."""
    async def script(ns):
        q = ns.queue.EndpointQueue("/v1/q", metrics=ns.Registry())
        for i in range(6):
            q.put(ns.queue.Message(task_id=f"t{i}", endpoint="/v1/q", seq=i,
                                   tenant="ab"[i % 2]))
        out = []
        for _ in range(6):
            msg = await q.receive(timeout=0.01)
            out.append(msg.task_id)
            if msg.seq == 1 and msg.delivery_count == 1:
                q.abandon(msg)
        return out, q.lane_depths(), q.deficits(), q.fair

    got = both(lambda ns: run(script(ns)))
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["t0", "t1", "t2", "t3", "t4", "t5"]


# -- accounting and the charge ----------------------------------------------------


def test_per_tenant_series_equal_jax():
    """Terminal transitions of tenants' tasks through the store's feed,
    quota sheds and charges: the ``ai4e_tenant_*`` exposition lines."""
    def script(ns):
        reg = ns.Registry()
        tenancy = ns.ten.Tenancy.from_spec("a=ka,b=kb,c=kc", metrics=reg,
                                           label_top_n=2)
        store = ns.ts.InMemoryTaskStore()
        tenancy.attach_store(store)
        outcomes = [("completed - ok", "completed", 0.0),
                    ("completed - late", "completed", 1.0),
                    ("failed - x", "failed", 0.0),
                    ("expired - deadline exceeded at worker", "expired",
                     0.0)]
        for i in range(24):
            tenant = ("a", "b", "c", "", "ghost")[i % 5]
            prose, canonical, late = outcomes[i % 4]
            store.upsert(ns.ts.APITask(
                task_id=f"t{i}", endpoint="/v1/q", tenant=tenant,
                deadline_at=late))
            store.update_status(f"t{i}", prose, canonical)
            tenancy.charge(tenant, (0.5, 1.0, 3.0)[i % 3])
        for tenant in ("a", "c", "c", ""):
            tenancy.note_quota_shed(tenant)
            tenancy.note_admitted(tenant)
        # The burn windows decay on the wall clock: compared to a bound.
        return ([line for line in metric_lines(reg, "ai4e_tenant_")
                 if not line.startswith("ai4e_tenant_slo_burn")],
                {label: tenancy.accounting.burn_rate(label)
                 for label in ("a", "b", "other")})

    got = both(script)
    assert got["port"][0] == got["jax"][0]
    for label, burn in got["jax"][1].items():
        assert got["port"][1][label] == pytest.approx(burn, rel=1e-3)
    assert any(line.startswith('ai4e_tenant_cost_total{tenant="other"}')
               for line in got["port"][0])


def test_dispatcher_charges_the_backend_it_ran_on_like_jax():
    """Two backends under orchestration, the cheap one refusing
    connections: each delivery fails over and charges its message's
    tenant the cost of the backend that took it, not of the pick."""
    from aiohttp import web

    async def scenario(ns):
        async def ok(request):
            return web.json_response({"ok": True})

        app = web.Application()
        app.router.add_post("/v1/q", ok)
        dead, live = TestServer(web.Application()), TestServer(app)
        for s in (dead, live):
            await s.start_server()
        urls = [str(s.make_url("/v1/q")) for s in (dead, live)]
        await dead.close()
        reg = ns.Registry()
        platform = ns.pa.LocalPlatform(ns.pa.PlatformConfig(
            tenancy=True, tenancy_tenants="a=ka,b=kb", admission=True,
            resilience=True, orchestration=True, retry_delay=0.05,
            orchestration_costs=f"{urls[0][:-len('v1/q')]}=1,"
                                f"{urls[1][:-len('v1/q')]}=4"),
            metrics=reg)
        platform.publish_async_api("/v1/pub/q", [(urls[0], 1.0),
                                                 (urls[1], 1.0)])
        await platform.start()
        try:
            for i in range(12):
                platform.store.upsert(ns.ts.APITask(
                    task_id=f"t{i}", endpoint=urls[0], body=b"{}",
                    tenant="ab"[i % 2], publish=True))
            for _ in range(500):
                if all(platform.store.get(f"t{i}").canonical_status
                       != "created" for i in range(12)):
                    break
                await asyncio.sleep(0.02)
            delivered = {
                line.split('backend="', 1)[1].split('"')[0]:
                float(line.rsplit(" ", 1)[1])
                for line in reg.render_prometheus().splitlines()
                if line.startswith("ai4e_dispatch_total")
                and 'outcome="delivered"' in line}
            cost = metric_lines(reg, "ai4e_tenant_cost_total")
        finally:
            await platform.stop()
            await live.close()
        return delivered, cost, urls[1].split("/")[2]

    for pkg, ns in NS.items():
        delivered, cost, live = run(scenario(ns))
        assert delivered == {live: 12.0}, pkg
        assert cost == ['ai4e_tenant_cost_total{tenant="a"} 24.0',
                        'ai4e_tenant_cost_total{tenant="b"} 24.0'], pkg


# -- the gateway's edge ----------------------------------------------------------


async def edge_script(ns, admission: bool) -> list:
    """Keyed requests at one tenant's bucket, polls of the created tasks,
    an unknown key and a keyless caller: every answer's status, the
    headers a client reads, and the created tasks' tenants."""
    reg = ns.Registry()
    platform = ns.pa.LocalPlatform(ns.pa.PlatformConfig(
        tenancy=True, admission=admission,
        tenancy_tenants="alpha=ka:4,beta=kb:1:1:2"), metrics=reg)
    platform.publish_async_api("/v1/pub/q", "http://127.0.0.1:9/v1/q")
    client = TestClient(TestServer(platform.gateway.app))
    await client.start_server()
    out = []
    try:
        for key in ("kb", "kb", "kb", "kb", "ka", "nope", None):
            headers = {"Ocp-Apim-Subscription-Key": key} if key else {}
            async with client.post("/v1/pub/q", data=b"{}",
                                   headers=headers) as r:
                body = await r.json()
                out.append((key, r.status, r.headers.get("Retry-After"),
                            r.headers.get("X-Shed-Reason"),
                            body.get("error")))
                if r.status == 200:
                    record = platform.store.get(body["TaskId"]).to_dict()
                    out.append(record.get("Tenant"))
                    async with client.get(
                            f"/v1/taskmanagement/task/{body['TaskId']}",
                            headers={"Ocp-Apim-Subscription-Key": "kb"}
                    ) as poll:
                        out.append(("poll", poll.status))
        out.append(metric_lines(reg, "ai4e_tenant_admissions_total"))
        out.append([line for line in metric_lines(
            reg, "ai4e_gateway_requests_total") if "tenant" in line])
    finally:
        await client.close()
    return out


@pytest.mark.parametrize("admission", [False, True])
def test_edge_429s_headers_and_task_tenants_equal_jax(admission):
    got = both(lambda ns: run(edge_script(ns, admission)))
    assert got["port"] == got["jax"]
    refusals = [x for x in got["port"] if isinstance(x, tuple)
                and len(x) == 5 and x[1] == 429]
    assert len(refusals) == 2
    assert all(int(r[2]) >= 1 and r[3] == "tenant-quota at gateway"
               for r in refusals)


@pytest.mark.parametrize("fields", [
    {"tenancy": True, "transport": "push"},
    {"tenancy": True, "native_store": True},
    {"tenancy": True, "native_broker": True},
    {"tenancy": True, "tenancy_tenants": "a=k,a=k2"},
], ids=["push", "native-store", "native-broker", "bad-spec"])
def test_assembly_refusals_word_for_word(fields):
    def build(ns):
        try:
            ns.pa.LocalPlatform(ns.pa.PlatformConfig(**fields),
                                metrics=ns.Registry())
        except ValueError as exc:
            return str(exc)
        return None

    got = both(build)
    assert got["port"] == got["jax"] and got["port"]


def test_tenancy_off_leaves_every_surface_as_it_was():
    """``tenancy=False``: nothing resolved or stamped, no lane, no tenant
    series, and the same records and exposition names as JAX's."""
    async def scenario(ns):
        reg = ns.Registry()
        platform = ns.pa.LocalPlatform(ns.pa.PlatformConfig(), metrics=reg)
        platform.publish_async_api("/v1/pub/q", "http://127.0.0.1:9/v1/q")
        client = TestClient(TestServer(platform.gateway.app))
        await client.start_server()
        try:
            async with client.post("/v1/pub/q", data=b"{}",
                                   headers={"Ocp-Apim-Subscription-Key":
                                            "k"}) as r:
                task_id = (await r.json())["TaskId"]
            record = platform.store.get(task_id).to_dict()
        finally:
            await client.close()
        return (platform.tenancy, platform.gateway._tenancy,
                platform.broker.queue("/v1/q").fair,
                sorted(record), record.get("Tenant"),
                [line for line in reg.render_prometheus().splitlines()
                 if "tenant" in line])

    got = both(lambda ns: run(scenario(ns)))
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (None, None, None)


# -- the tenant over the store's wire and journal ---------------------------------


def test_tenant_rides_the_http_wire_and_the_journal_byte_equal(tmp_path):
    """Records with tenants (and an interactive priority, which both
    packages read back as 1) through the store's HTTP surface into a
    journaled store: the answers and the journal's records equal JAX's,
    and a replay restores the tenants."""
    async def scenario(ns, path):
        store = ns.store.JournaledTaskStore(str(path), metrics=ns.Registry())
        client = TestClient(TestServer(ns.http.make_app(store)))
        await client.start_server()
        out = []
        try:
            for i, (tenant, priority) in enumerate(
                    (("alpha", 0), ("", 1), ("beta", 2), ("alpha", 1))):
                async with client.post("/v1/taskstore/upsert", json={
                        "TaskId": f"t{i}", "Endpoint": "/v1/q",
                        "Tenant": tenant, "Priority": priority}) as r:
                    body = await r.json()
                    body.pop("Timestamp", None)
                    out.append((r.status, body))
            async with client.post("/v1/taskstore/update", json={
                    "TaskId": "t0", "Status": "completed - x",
                    "BackendStatus": "completed"}) as r:
                body = await r.json()
                body.pop("Timestamp", None)
                out.append((r.status, body))
        finally:
            await client.close()
            store.close()
        replayed = ns.store.JournaledTaskStore(str(path),
                                               metrics=ns.Registry())
        out.append({t: (r.tenant, r.priority)
                    for t, r in sorted(replayed._tasks.items())})
        replayed.close()
        records = [json.loads(line.split(":", 3)[3])
                   for line in path.read_text().splitlines()]
        for rec in records:
            rec.pop("Timestamp", None)
        return out, records

    got = {pkg: run(scenario(ns, tmp_path / f"{pkg}.jsonl"))
           for pkg, ns in NS.items()}
    assert got["port"] == got["jax"]
    out, records = got["port"]
    assert out[-1] == {"t0": ("alpha", 1), "t1": ("", 1), "t2": ("beta", 2),
                       "t3": ("alpha", 1)}
    assert any(rec.get("Tenant") == "beta" for rec in records)
