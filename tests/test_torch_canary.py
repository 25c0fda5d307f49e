"""The port's weighted canary backends (``ai4e_tpu_torch/utils/backends.py``
and their use in the dispatcher, the gateway and the push webhook) and its
rollout generations (``rollout/canary.py``, the worker's per-generation
series) held against the JAX package's on the CPU: the accepted forms and
the errors of ``normalize_backends`` text for text, the same picks from
one seed, no RNG call for one backend, the async, sync and webhook splits
of ``tests/test_canary_routing.py``, the dispatch counter's ``backend``
label, weighted routes never answered from the result cache, the label's
fold into ``other`` after eight generations, and the worker's two rollout
series on the same requests. Each platform and worker counts into a
registry of its own, and the label's seen-generation lists are swapped
for fresh ones for the test that fills them."""

from __future__ import annotations

import asyncio
import random
import time
import types
from collections import Counter
from urllib.parse import urlparse

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.platform_assembly as jax_pa
import ai4e_tpu.rollout.canary as jax_canary
import ai4e_tpu.utils.backends as jax_backends
import ai4e_tpu_torch.platform_assembly as port_pa
import ai4e_tpu_torch.rollout.canary as port_canary
import ai4e_tpu_torch.utils.backends as port_backends
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry

JAX = types.SimpleNamespace(pa=jax_pa, backends=jax_backends,
                            Registry=JaxRegistry)
PORT = types.SimpleNamespace(pa=port_pa, backends=port_backends,
                             Registry=PortRegistry)


def run(coro):
    return asyncio.run(coro)


def on_both(scenario, *args):
    """``scenario(ns, *args)`` on the JAX package and on the port; the
    port's observations, which must equal JAX's."""
    want = run(scenario(JAX, *args))
    got = run(scenario(PORT, *args))
    assert got == want
    return got


async def serve(app) -> TestClient:
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


async def until(cond, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        await asyncio.sleep(0.02)


# -- normalize_backends and pick_backend -----------------------------------

FORMS = [
    "http://a/v1/x",
    [{"uri": "http://a/v1/x", "weight": 9}, "http://b/v1/x",
     ("http://c/v1/x", 0)],
    [("http://a/v1/x", 3.0), ("http://b/v1/x", 1.0)],
    ({"uri": "http://a/v1/x"} for _ in range(2)),
]


@pytest.mark.parametrize("form", range(len(FORMS)),
                         ids=["str", "mixed", "normalized", "generator"])
def test_normalize_forms_equal_jax_s(form):
    def build():
        value = FORMS[form]
        return ({"uri": "http://a/v1/x"} for _ in range(2)) \
            if form == 3 else value
    assert port_backends.normalize_backends(build()) == \
        jax_backends.normalize_backends(build())


@pytest.mark.parametrize("bad", [
    [], [("http://a/v1/x", 0), ("http://b/v1/x", 0)],
    [("http://a/v1/x", -1)], ["http://a/v1/x", "http://b/v1/OTHER"]],
    ids=["empty", "all-zero", "negative", "mixed-paths"])
def test_normalize_errors_equal_jax_s(bad):
    with pytest.raises(ValueError) as want:
        jax_backends.normalize_backends(bad)
    with pytest.raises(ValueError) as got:
        port_backends.normalize_backends(bad)
    assert str(got.value) == str(want.value)


def test_a_normalized_set_comes_back_as_a_copy():
    given = [("http://a/v1/x", 3.0), ("http://b/v1/x", 1.0)]
    out = port_backends.normalize_backends(given)
    assert out == given and out is not given


@pytest.mark.parametrize("seed", [0, 7])
def test_picks_from_one_seed_equal_jax_s(seed):
    sets = [[("http://a/v1/x", 9.0), ("http://b/v1/x", 1.0)],
            [("http://a/v1/x", 1.0), ("http://b/v1/x", 1.0),
             ("http://c/v1/x", 0.0), ("http://d/v1/x", 2.5)]]
    for backends in sets:
        rj, rp = random.Random(seed), random.Random(seed)
        want = [jax_backends.pick_backend(backends, rj) for _ in range(500)]
        got = [port_backends.pick_backend(backends, rp) for _ in range(500)]
        assert got == want
        assert "http://c/v1/x" not in got


def test_one_backend_makes_no_rng_call():
    rng = random.Random(3)
    state = rng.getstate()
    assert [port_backends.pick_backend([("http://a/v1/x", 1.0)], rng)
            for _ in range(10)] == ["http://a/v1/x"] * 10
    assert rng.getstate() == state


def test_pick_distribution_and_a_drained_entry():
    backends = port_backends.normalize_backends(
        [("http://a/v1/x", 9), ("http://b/v1/x", 1)])
    rng = random.Random(0)
    counts = Counter(port_backends.pick_backend(backends, rng)
                     for _ in range(2000))
    assert 1650 <= counts["http://a/v1/x"] <= 1950
    drained = port_backends.normalize_backends(
        [("http://live/v1/x", 1), ("http://drained/v1/x", 0)])
    rng = random.Random(1)
    assert {port_backends.pick_backend(drained, rng)
            for _ in range(200)} == {"http://live/v1/x"}


# -- the splits through the platform ---------------------------------------


async def counting_service(name, hits, task_manager) -> TestClient:
    """An async backend recording which instance served each task."""
    app = web.Application()

    async def handle(request):
        tid = request.headers.get("taskId", "")
        hits[name].append(tid)
        await task_manager.complete_task(tid, f"completed - by {name}")
        return web.json_response({"ok": name})

    app.router.add_post("/v1/split/run-async", handle)
    return await serve(app)


async def async_split(ns):
    """Weights (1, 0) send every task to A; swapping the dispatcher's set
    to (0, 1) sends every task to B, through gateway, store, queue and
    dispatcher; the dispatch counter splits by backend."""
    platform = ns.pa.LocalPlatform(ns.pa.PlatformConfig(retry_delay=0.05),
                                   metrics=ns.Registry())
    hits = {"A": [], "B": []}
    a = await counting_service("A", hits, platform.task_manager)
    b = await counting_service("B", hits, platform.task_manager)
    a_uri = str(a.make_url("/v1/split/run-async"))
    b_uri = str(b.make_url("/v1/split/run-async"))
    platform.publish_async_api(
        "/v1/public/split",
        [{"uri": a_uri, "weight": 1}, {"uri": b_uri, "weight": 0}])
    gw = await serve(platform.gateway.app)
    await platform.start()
    counter = platform.metrics.counter("ai4e_dispatch_total", "")
    try:
        for _ in range(6):
            await gw.post("/v1/public/split", data=b"x")
        await until(lambda: len(hits["A"]) + len(hits["B"]) >= 6)
        first = (len(hits["A"]), len(hits["B"]))
        (dispatcher,) = platform.dispatchers.dispatchers.values()
        dispatcher.backends = ns.backends.normalize_backends(
            [{"uri": a_uri, "weight": 0}, {"uri": b_uri, "weight": 1}])
        for _ in range(6):
            await gw.post("/v1/public/split", data=b"x")
        await until(lambda: len(hits["B"]) >= 6)

        def delivered(uri):
            return counter.value(outcome="delivered",
                                 queue="/v1/split/run-async",
                                 backend=urlparse(uri).netloc)
        await until(lambda: delivered(a_uri) + delivered(b_uri) >= 12)
        return (first, (len(hits["A"]), len(hits["B"])),
                (delivered(a_uri), delivered(b_uri)),
                platform.gateway.routes[0].cacheable,
                platform.gateway.routes[0].backend_uri == a_uri)
    finally:
        await platform.stop()
        await gw.close()
        await a.close()
        await b.close()


def test_async_deliveries_split_flip_and_count_by_backend():
    assert on_both(async_split) == ((6, 0), (6, 6), (6.0, 6.0), False, True)


async def sync_split(ns):
    platform = ns.pa.LocalPlatform(ns.pa.PlatformConfig(),
                                   metrics=ns.Registry())
    seen = Counter()

    def backend_app(name):
        app = web.Application()

        async def handle(_request):
            seen[name] += 1
            return web.json_response({"served_by": name})

        app.router.add_post("/v1/split/run", handle)
        return app

    a = await serve(backend_app("A"))
    b = await serve(backend_app("B"))
    platform.publish_sync_api(
        "/v1/public/run",
        [{"uri": str(a.make_url("/v1/split/run")), "weight": 1},
         {"uri": str(b.make_url("/v1/split/run")), "weight": 1}])
    gw = await serve(platform.gateway.app)
    try:
        statuses = [(await gw.post("/v1/public/run", data=b"x")).status
                    for _ in range(40)]
        # 50/50 over 40 requests: P[one side takes all] = 2^-39.
        return (set(statuses), seen["A"] > 0 and seen["B"] > 0,
                seen["A"] + seen["B"])
    finally:
        await gw.close()
        await a.close()
        await b.close()


def test_sync_requests_split_across_backends():
    assert on_both(sync_split) == ({200}, True, 40)


def test_webhook_targets_split_by_weight():
    from ai4e_tpu_torch.broker.push import WebhookDispatcher
    from ai4e_tpu_torch.service import LocalTaskManager
    from ai4e_tpu_torch.taskstore import InMemoryTaskStore

    webhook = WebhookDispatcher(LocalTaskManager(InMemoryTaskStore()),
                                metrics=PortRegistry())
    webhook.add_route(
        "/v1/split/run-async",
        [{"uri": "http://fleet:1/v1/split/run-async", "weight": 1},
         {"uri": "http://canary:1/v1/split/run-async", "weight": 1}])
    targets = Counter(
        webhook._target_for("http://edge/v1/split/run-async/tile?x=1")
        for _ in range(60))
    assert set(targets) == {"http://fleet:1/v1/split/run-async/tile?x=1",
                            "http://canary:1/v1/split/run-async/tile?x=1"}
    assert sum(targets.values()) == 60


# -- weighted routes and the result cache ----------------------------------


async def cache_on_weighted_routes(ns):
    """With the result cache on, identical requests repeat on a weighted
    and a one-backend route, async and sync: the weighted routes execute
    every time and answer no ``X-Cache``; the one-backend routes hit."""
    platform = ns.pa.LocalPlatform(ns.pa.PlatformConfig(
        retry_delay=0.05, result_cache=True), metrics=ns.Registry())
    runs = Counter()
    app = web.Application()
    tm = platform.task_manager

    def async_handler(tag):
        async def handle(request):
            tid = request.headers["taskId"]
            runs[tag] += 1
            platform.store.set_result(tid, b'{"ok": 1}')
            await tm.complete_task(tid, "completed")
            return web.json_response({"ok": 1})
        return handle

    def sync_handler(tag):
        async def handle(_request):
            runs[tag] += 1
            return web.json_response({"ok": tag})
        return handle

    for path, handler in (("/v1/w/run-async", async_handler("async-w")),
                          ("/v1/o/run-async", async_handler("async-one")),
                          ("/v1/w/run", sync_handler("sync-w")),
                          ("/v1/o/run", sync_handler("sync-one"))):
        app.router.add_post(path, handler)
    a = await serve(app)
    b = await serve(app)

    def pair(path):
        return [{"uri": str(a.make_url(path)), "weight": 1},
                {"uri": str(b.make_url(path)), "weight": 1}]

    platform.publish_async_api("/v1/pub/w", pair("/v1/w/run-async"))
    platform.publish_async_api("/v1/pub/o",
                               str(a.make_url("/v1/o/run-async")))
    platform.publish_sync_api("/v1/pub/ws", pair("/v1/w/run"))
    platform.publish_sync_api("/v1/pub/os", str(a.make_url("/v1/o/run")))
    gw = await serve(platform.gateway.app)
    await platform.start()
    headers: dict = {}
    try:
        for prefix in ("/v1/pub/w", "/v1/pub/o"):
            for _ in range(3):
                resp = await gw.post(prefix, data=b"same")
                rec = await resp.json()
                headers.setdefault(prefix, []).append(
                    resp.headers.get("X-Cache"))
                await until(lambda: platform.store.get(
                    rec["TaskId"]).canonical_status == "completed")
        for prefix in ("/v1/pub/ws", "/v1/pub/os"):
            for _ in range(3):
                resp = await gw.post(prefix, data=b"same")
                headers.setdefault(prefix, []).append(
                    resp.headers.get("X-Cache"))
        return headers, dict(runs), [r.cacheable
                                     for r in platform.gateway.routes]
    finally:
        await platform.stop()
        await gw.close()
        await a.close()
        await b.close()


def test_weighted_routes_are_never_served_from_the_cache():
    headers, runs, cacheable = on_both(cache_on_weighted_routes)
    assert headers == {"/v1/pub/w": [None] * 3,
                       "/v1/pub/o": ["miss", "hit", "hit"],
                       "/v1/pub/ws": [None] * 3,
                       "/v1/pub/os": ["miss", "hit", "hit"]}
    assert runs == {"async-w": 3, "async-one": 1, "sync-w": 3,
                    "sync-one": 1}
    assert cacheable == [False, True, False, True]


# -- rollout generations ---------------------------------------------------


def test_generation_label_folds_into_other_like_jax_s(monkeypatch):
    monkeypatch.setattr(jax_canary, "_seen_generations", [])
    monkeypatch.setattr(port_canary, "_seen_generations", [])
    values = [1, 2, "3", 2, 4, 5, 6, 7, 8, 9, 10, 1, 9, "other", 3]
    want = [jax_canary.generation_label(v) for v in values]
    got = [port_canary.generation_label(v) for v in values]
    assert got == want
    assert port_canary.GENERATION_LABEL_CAP == \
        jax_canary.GENERATION_LABEL_CAP == 8
    assert got[9:11] == ["other", "other"] and got[11] == "1"


def rollout_series(metrics) -> dict:
    """``{(family, labels): value}`` of the two rollout families, the
    histogram by its observation count."""
    out = {}
    for _, name, labels, value in (
            metrics.counter("ai4e_rollout_outcomes_total").collect()
            + metrics.histogram("ai4e_rollout_request_seconds").collect()):
        out[(name, tuple(sorted(labels.items())))] = (
            value["count"] if isinstance(value, dict) else value)
    return out


def echo_workers(tmp_path):
    """The JAX package's and the port's echo workers, each on a store and
    a registry of its own."""
    import ai4e_tpu.runtime.batcher as jb
    import ai4e_tpu.runtime.families as jf
    import ai4e_tpu.runtime.registry as jr
    import ai4e_tpu.runtime.worker as jw
    import ai4e_tpu.service as js
    import ai4e_tpu.taskstore as jt
    import ai4e_tpu_torch.runtime.batcher as pb
    import ai4e_tpu_torch.runtime.families as pf
    import ai4e_tpu_torch.runtime.registry as pr
    import ai4e_tpu_torch.runtime.worker as pw
    import ai4e_tpu_torch.service as ps
    import ai4e_tpu_torch.taskstore as pt

    out = {}
    for tag, (b, f, r, w, s, t, reg, kw) in {
            "jax": (jb, jf, jr, jw, js, jt, JaxRegistry, {}),
            "port": (pb, pf, pr, pw, ps, pt, PortRegistry,
                     {"device": "cpu"})}.items():
        runtime = r.ModelRuntime(**kw)
        servable = runtime.register(f.build_servable(
            "echo", name="echo", size=8, buckets=(1, 4)))
        metrics = reg()
        batcher = b.MicroBatcher(runtime, max_wait_ms=1.0, metrics=metrics)
        store = t.InMemoryTaskStore()
        worker = w.InferenceWorker("w", runtime, batcher,
                                   task_manager=s.LocalTaskManager(store),
                                   prefix="v1/echo", metrics=metrics,
                                   store=store,
                                   checkpoint_root=str(tmp_path))
        worker.serve_model(servable, sync_path="/run",
                           async_path="/run-async")
        out[tag] = (worker, batcher, servable, store)
    return out


async def drive_generations(worker, batcher, servable, store, reload_npz):
    """2 sync + 1 async requests at generation 1, then a move to
    generation 3 (the port's through its reload verb with ``generation``,
    JAX's by the attribute its reload sets) and 1 sync + 2 async."""
    payload = np.arange(8, dtype=np.float32)
    import io
    buf = io.BytesIO()
    np.save(buf, payload)
    body = buf.getvalue()
    headers = {"Content-Type": "application/x-npy"}
    await batcher.start()
    client = await serve(worker.service.app)
    try:
        async def burst(n_sync, n_async):
            for _ in range(n_sync):
                r = await client.post("/v1/echo/run", data=body,
                                      headers=headers)
                assert r.status == 200, await r.text()
            for _ in range(n_async):
                r = await client.post("/v1/echo/run-async", data=body,
                                      headers=headers)
                tid = (await r.json())["TaskId"]
                await until(lambda: store.get(tid).canonical_status
                            == "completed")

        await burst(2, 1)
        if reload_npz:
            r = await client.post("/v1/echo/models/echo/reload", json={
                "checkpoint": reload_npz, "generation": 3})
            assert r.status == 200, await r.text()
            assert (await r.json())["generation"] == 3
        else:
            servable.generation = 3
        await burst(1, 2)
        return rollout_series(worker.service.metrics)
    finally:
        await client.close()
        await batcher.stop()


def test_rollout_series_by_generation_equal_jax_s(tmp_path, monkeypatch):
    from ai4e_tpu_torch.convert import save_npz

    monkeypatch.setattr(jax_canary, "_seen_generations", [])
    monkeypatch.setattr(port_canary, "_seen_generations", [])
    npz = str(tmp_path / "echo_g3.npz")
    save_npz({"scale": np.array(2.0, np.float32)}, npz)
    workers = echo_workers(tmp_path)
    want = run(drive_generations(*workers["jax"], None))
    got = run(drive_generations(*workers["port"], npz))
    assert got == want
    assert got == {
        ("ai4e_rollout_outcomes_total",
         (("generation", "1"), ("outcome", "ok"))): 3.0,
        ("ai4e_rollout_outcomes_total",
         (("generation", "3"), ("outcome", "ok"))): 3.0,
        ("ai4e_rollout_request_seconds", (("generation", "1"),)): 3,
        ("ai4e_rollout_request_seconds", (("generation", "3"),)): 3}
