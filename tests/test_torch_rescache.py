"""The inference result cache in the port (ROADMAP A18.6):
``ai4e_tpu_torch/rescache`` (keys, ``ResultCache``, the store listener)
and its wiring across the port's gateway, dispatcher, task store and
worker, mirroring the classes of ``tests/test_rescache.py`` that apply to
the port: request key, eviction, the single-flight registry, async-path
caching, the dispatcher serving from the cache, invalidation on hot
reload, stale-fill refusal, edge-only counting, sync single-flight
cleanup, the sync bypass, sync coalesce invalidation, the dispatcher with
no result store, hit-record durability and the config plumbing. The
port's worker keeps no cache of its own (JAX's ``cache_sync_path``): it
takes the caching gateway's for its reload's invalidation, so the bypass
is held at the gateway's sync proxy.

Where the packages meet the port is held to JAX: ``request_key``,
``canonical_payload``, ``normalize_media_type``, ``family_of`` and
``cache_bypass_requested`` are byte-equal to JAX's on hypothesis-generated
JSON spellings, binary payloads, media types and ``extra`` tails, and one
op sequence gives the same answers, stats and eviction reasons in both
``ResultCache``s. Land cover at a small width (JAX's weights carried over
by ``convert.save_npz``) behind the port's control plane: a hit's bytes
are the executed answer's, and a reload to other weights empties the
family and serves the new weights' answer.

Classes of ``tests/test_rescache.py`` that need stores the port does not
have yet wait for their items: ``TestNativeStoreCacheProvenance`` and
``TestNonDurableResultsStayInline`` (the native store and the result
offload, ROADMAP A18.13), ``TestStandbyOutcomeCounting``,
``TestLegacyTaskIdReplay`` and ``TestPassiveEpochBound`` (the journaled,
replicated store and its HA standby, A18.1), ``TestNormalizeBackendsCopy``
(weighted backends, A18.8) and ``TestClientRetryExhaustion`` (the Python
client SDK's replica rotation, A18.14). The journal half of
``TestHitRecordDurability`` waits for A18.1; the memory-only flag it
checks is here. ``TestReloadEndpointHardening`` and
``TestWorkerCliHardeningWired`` are in ``tests/test_torch_reload.py`` and
``tests/test_torch_gateway_auth.py``."""

import asyncio
import io
import json
import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as st

from ai4e_tpu import rescache as jax_rescache
from ai4e_tpu.metrics import MetricsRegistry as JaxMetrics
from ai4e_tpu.runtime.families import build_unet as jax_build_unet
from ai4e_tpu_torch import convert
from ai4e_tpu_torch import rescache
from ai4e_tpu_torch.broker.dispatcher import Dispatcher
from ai4e_tpu_torch.broker.queue import InMemoryBroker, Message
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
from ai4e_tpu_torch.rescache import (ResultCache, attach_store,
                                     canonical_payload, family_of,
                                     request_key)
from ai4e_tpu_torch.runtime.batcher import MicroBatcher
from ai4e_tpu_torch.runtime.families import build_servable
from ai4e_tpu_torch.runtime.registry import ModelRuntime
from ai4e_tpu_torch.runtime.worker import InferenceWorker
from ai4e_tpu_torch.taskstore import APITask, InMemoryTaskStore, TaskStatus
from ai4e_tpu_torch.taskstore.task import endpoint_path


def run(coro):
    return asyncio.run(coro)


async def serve(app):
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


async def poll_until(client, task_id, predicate, tries=400, delay=0.02,
                     headers=None):
    body = None
    for _ in range(tries):
        resp = await client.get(f"/v1/taskmanagement/task/{task_id}",
                                headers=headers)
        body = await resp.json()
        if predicate(body):
            return body
        await asyncio.sleep(delay)
    return body


def npy_bytes(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def executed_examples(reg: MetricsRegistry) -> float:
    """Rows the runtime executed: the batch-size histogram's sum."""
    return sum(float(data["sum"]) for _, _, _, data
               in reg.histogram("ai4e_batch_size", "").collect())


def completed(body) -> bool:
    return "completed" in body["Status"]


# -- canonical request hashing ---------------------------------------------------


class TestRequestKey:
    def test_json_equivalent_payloads_share_a_key(self):
        a = request_key("/v1/x", b'{"a": 1, "b": [2, 3]}', "application/json")
        b = request_key("/v1/x", b'{"b":[2,3],"a":1}',
                        "application/json; charset=utf-8")
        assert a == b

    def test_semantically_different_json_differs(self):
        a = request_key("/v1/x", b'{"a": 1}', "application/json")
        b = request_key("/v1/x", b'{"a": 2}', "application/json")
        assert a != b

    def test_binary_payloads_hash_raw(self):
        payload = npy_bytes(np.arange(4, dtype=np.float32))
        a = request_key("/v1/x", payload, "application/octet-stream")
        b = request_key("/v1/x", payload, "application/octet-stream")
        c = request_key("/v1/x", payload + b"\0", "application/octet-stream")
        assert a == b and a != c

    def test_every_dimension_is_significant(self):
        base = request_key("/v1/x", b"p", "application/octet-stream")
        assert request_key("/v1/y", b"p", "application/octet-stream") != base
        assert request_key("/v1/x", b"p", "image/jpeg") != base
        assert request_key("/v1/x", b"p", "application/octet-stream",
                           checkpoint="2") != base
        assert request_key("/v1/x", b"p", "application/octet-stream",
                           extra="op?conf=0.9") != base

    def test_family_recoverable_from_key(self):
        key = request_key("/v1/detect", b"p")
        assert family_of(key) == "/v1/detect"

    def test_invalid_json_falls_back_to_raw_bytes(self):
        broken = b'{"a": '
        assert canonical_payload(broken, "application/json") == broken


# -- byte equality with the JAX package's keys -----------------------------------

JSON_VALUES = st.recursive(
    st.none() | st.booleans() | st.integers(-2**53, 2**53)
    | st.floats(allow_nan=False, allow_infinity=False)
    | st.text(max_size=12),
    lambda children: st.lists(children, max_size=4)
    | st.dictionaries(st.text(max_size=6), children, max_size=4),
    max_leaves=12)
JSON_SPELLINGS = st.sampled_from([
    {}, {"separators": (",", ":")}, {"indent": 2}, {"sort_keys": True},
    {"ensure_ascii": False}, {"indent": "\t", "sort_keys": True}])
MEDIA_TYPES = st.sampled_from([
    "", "application/json", "application/json; charset=utf-8",
    "APPLICATION/JSON", " application/ld+json ", "text/json",
    "application/octet-stream", "image/jpeg", "application/x-npy",
    "multipart/form-data; boundary=x"])
TAILS = st.text(string.ascii_letters + string.digits + "/?=&.-_%",
                max_size=24)
FAMILIES = st.sampled_from(["/v1/models/classify-async",
                            "/v1/models/classify", "landcover", "moe",
                            "/v1/x/op", ""])


def same_key_functions(family, body, media, checkpoint, extra) -> None:
    assert (rescache.canonical_payload(body, media)
            == jax_rescache.canonical_payload(body, media))
    assert (rescache.normalize_media_type(media)
            == jax_rescache.normalize_media_type(media))
    key = rescache.request_key(family, body, media, checkpoint=checkpoint,
                               extra=extra)
    assert key == jax_rescache.request_key(family, body, media,
                                           checkpoint=checkpoint, extra=extra)
    assert rescache.family_of(key) == jax_rescache.family_of(key) == family


class TestKeyParityWithJax:
    @settings(max_examples=150, deadline=None)
    @given(value=JSON_VALUES, spelling=JSON_SPELLINGS, media=MEDIA_TYPES,
           family=FAMILIES, extra=TAILS,
           checkpoint=st.sampled_from(["", "1", "2", "17"]))
    def test_json_spellings(self, value, spelling, media, family, extra,
                            checkpoint):
        body = json.dumps(value, **spelling).encode("utf-8")
        same_key_functions(family, body, media, checkpoint, extra)
        # Every spelling of one document shares a key on a JSON wire.
        if media.strip().lower().split(";")[0].endswith("json"):
            compact = json.dumps(value).encode()
            assert (request_key(family, body, media)
                    == request_key(family, compact, media))

    @settings(max_examples=150, deadline=None)
    @given(body=st.binary(max_size=512), media=MEDIA_TYPES, family=FAMILIES,
           extra=TAILS)
    def test_binary_payloads(self, body, media, family, extra):
        same_key_functions(family, body, media, "", extra)

    @pytest.mark.parametrize("shape,dtype", [
        ((32, 32, 3), np.uint8), ((256, 256, 3), np.uint8),
        ((1024,), np.uint16), ((8,), np.float32)])
    def test_served_bodies(self, shape, dtype):
        rng = np.random.default_rng(0)
        body = npy_bytes(rng.integers(0, 255, shape).astype(dtype))
        same_key_functions("/v1/models/classify-async", body,
                           "application/octet-stream", "", "")

    @pytest.mark.parametrize("headers", [
        {}, {"X-Cache-Bypass": "1"}, {"X-Cache-Bypass": "true"},
        {"X-Cache-Bypass": " Off "}, {"X-Cache-Bypass": "0"},
        {"X-Cache-Bypass": "no"}, {"Cache-Control": "no-cache"},
        {"Cache-Control": "max-age=0, no-store"},
        {"Cache-Control": "max-age=60"}])
    def test_bypass_header(self, headers):
        assert (rescache.cache_bypass_requested(headers)
                == jax_rescache.cache_bypass_requested(headers))

    def test_header_names_are_jax_s(self):
        assert rescache.BYPASS_HEADER == jax_rescache.BYPASS_HEADER
        assert (rescache.CACHE_STATUS_HEADER
                == jax_rescache.CACHE_STATUS_HEADER)


# -- eviction and the single-flight registry -------------------------------------


class TestEviction:
    def test_lru_entry_budget(self):
        cache = ResultCache(max_entries=2, max_bytes=1 << 20,
                            metrics=MetricsRegistry())
        cache.put("f|a", b"1")
        cache.put("f|b", b"2")
        assert cache.get("f|a") is not None
        cache.put("f|c", b"3")
        assert cache.peek("f|a") and cache.peek("f|c")
        assert not cache.peek("f|b")

    def test_byte_budget(self):
        cache = ResultCache(max_entries=100, max_bytes=10,
                            max_entry_bytes=10, metrics=MetricsRegistry())
        cache.put("f|a", b"12345")
        cache.put("f|b", b"12345")
        cache.put("f|c", b"12345")
        assert not cache.peek("f|a")
        assert cache.peek("f|b") and cache.peek("f|c")
        assert cache.stats()["bytes"] == 10

    def test_oversized_entry_refused(self):
        cache = ResultCache(max_bytes=100, max_entry_bytes=4,
                            metrics=MetricsRegistry())
        assert cache.put("f|big", b"12345") is False
        assert not cache.peek("f|big")

    def test_ttl_expiry(self):
        now = [0.0]
        reg = MetricsRegistry()
        cache = ResultCache(ttl_s=10.0, metrics=reg, clock=lambda: now[0])
        cache.put("f|a", b"1")
        now[0] = 9.9
        assert cache.get("f|a") is not None
        now[0] = 10.0
        assert cache.get("f|a") is None
        assert cache.stats()["entries"] == 0
        assert reg.gauge("ai4e_rescache_entries", "").value() == 0
        assert reg.gauge("ai4e_rescache_bytes", "").value() == 0

    def test_bypass_header_falsy_values_do_not_bypass(self):
        from ai4e_tpu_torch.rescache.keys import cache_bypass_requested
        assert cache_bypass_requested({"X-Cache-Bypass": "1"})
        assert cache_bypass_requested({"X-Cache-Bypass": "true"})
        assert cache_bypass_requested({"Cache-Control": "no-cache"})
        for raw in ("0", "false", "no", "off", ""):
            assert not cache_bypass_requested({"X-Cache-Bypass": raw})
        assert not cache_bypass_requested({})

    def test_invalidate_family_is_scoped(self):
        cache = ResultCache(metrics=MetricsRegistry())
        cache.put("fam1|a", b"1")
        cache.put("fam1|b", b"2")
        cache.put("fam2|c", b"3")
        assert cache.invalidate_family("fam1") == 2
        assert not cache.peek("fam1|a") and not cache.peek("fam1|b")
        assert cache.peek("fam2|c")

    def test_invalidate_family_clears_inflight(self):
        cache = ResultCache(metrics=MetricsRegistry())
        cache.register_inflight("fam1|a", "t1")
        cache.register_inflight("fam2|b", "t2")
        cache.invalidate_family("fam1")
        assert cache.leader_for("fam1|a") is None
        assert cache.leader_for("fam2|b") == "t2"

    def test_invalidating_a_path_spares_its_siblings(self):
        """The worker invalidates ``/v1/models/classify`` and
        ``/v1/models/classify-async``: a tailed sub-path goes with its
        route, a sibling whose name merely starts the same stays."""
        cache = ResultCache(metrics=MetricsRegistry())
        for fam in ("/v1/models/classify", "/v1/models/classify/op",
                    "/v1/models/classify-species-async", "/v1/models/route"):
            cache.put(fam + "|k", b"x")
        assert cache.invalidate_family("/v1/models/classify") == 2
        assert cache.peek("/v1/models/classify-species-async|k")
        assert cache.peek("/v1/models/route|k")


class TestSingleFlightRegistry:
    def test_register_leader_release(self):
        cache = ResultCache(metrics=MetricsRegistry())
        assert cache.register_inflight("f|k", "t1") is True
        assert cache.register_inflight("f|k", "t2") is False
        assert cache.leader_for("f|k") == "t1"
        cache.release_inflight("f|k", "t2")
        assert cache.leader_for("f|k") == "t1"
        cache.release_inflight("f|k", "t1")
        assert cache.leader_for("f|k") is None


#: One script of cache operations: (op, args). ``tick`` advances the clock.
OPS = [
    ("put", ("a|1", b"x" * 10)), ("put", ("a|2", b"y" * 20)),
    ("get", ("a|1",)), ("put", ("b|1", b"z" * 30)), ("get", ("a|2",)),
    ("put", ("b|2", b"w" * 90)), ("put", ("b|3", b"v" * 300)),
    ("put", ("a|1", b"x" * 11)), ("register_inflight", ("a|9", "t1")),
    ("register_inflight", ("a|9", "t2")), ("leader_for", ("a|9",)),
    ("tick", (4.0,)), ("put", ("c|1", b"u" * 5)), ("generation", ("a|1",)),
    ("invalidate_family", ("a",)), ("generation", ("a|1",)),
    ("leader_for", ("a|9",)), ("put", ("a|3", b"s"), {"if_generation": 0}),
    ("put", ("a|3", b"s"), {"if_generation": 1}),
    ("register_inflight", ("c|7", "t3")),
    ("fill_inflight", ("c|7", "t4", b"r")),
    ("fill_inflight", ("c|7", "t3", b"r")), ("get", ("c|7",)),
    ("tick", (7.0,)), ("get", ("b|1",)), ("get", ("c|1",)), ("sweep", ()),
    ("get", ("missing|0",)), ("get", ("c|7",), {"count": False}),
    ("put", ("d|1", b"q" * 40)), ("put", ("d|2", b"q" * 41)),
    ("put", ("d|3", b"q" * 42)), ("put", ("d|4", b"q" * 43)),
    ("peek", ("d|1",)), ("release_inflight", ("zz|1", "t9")),
    ("invalidate_family", ("d",)), ("count_hit", ()), ("count_miss", ()),
    ("count_coalesced", ()), ("count_bypass", ()),
]


def run_ops(cache, clock) -> list:
    out = []
    for op in OPS:
        name, args = op[0], op[1]
        kwargs = op[2] if len(op) > 2 else {}
        if name == "tick":
            clock[0] += args[0]
            continue
        out.append(getattr(cache, name)(*args, **kwargs))
    return out


class TestCacheParityWithJax:
    def test_one_op_sequence_same_answers_stats_and_evictions(self):
        clocks = [0.0], [0.0]
        port_reg, jax_reg = MetricsRegistry(), JaxMetrics()
        port = ResultCache(max_entries=4, max_bytes=160, ttl_s=10.0,
                           max_entry_bytes=100,
                           metrics=port_reg, clock=lambda: clocks[0][0])
        jax_cache = jax_rescache.ResultCache(
            max_entries=4, max_bytes=160, ttl_s=10.0, max_entry_bytes=100,
            metrics=jax_reg,
            clock=lambda: clocks[1][0])
        got, want = run_ops(port, clocks[0]), run_ops(jax_cache, clocks[1])
        assert got == want
        assert port.stats() == jax_cache.stats()
        reasons = ("lru", "bytes", "ttl", "invalidated", "replaced",
                   "oversize")
        evictions = {r: port_reg.counter("ai4e_rescache_evictions_total",
                                         "").value(reason=r)
                     for r in reasons}
        assert evictions == {
            r: jax_reg.counter("ai4e_rescache_evictions_total",
                               "").value(reason=r) for r in reasons}
        # The script reaches every reason.
        assert all(evictions[r] > 0 for r in reasons), evictions
        for name in ("ai4e_rescache_entries", "ai4e_rescache_bytes"):
            assert (port_reg.gauge(name, "").value()
                    == jax_reg.gauge(name, "").value())

    def test_metric_names_render_as_jax_s(self):
        reg = MetricsRegistry()
        cache = ResultCache(metrics=reg)
        cache.put("f|a", b"1")
        cache.get("f|a")
        cache.get("f|b")
        cache.invalidate_family("f")
        text = reg.render_prometheus()
        for line in ('ai4e_rescache_requests_total{outcome="hit"} 1',
                     'ai4e_rescache_requests_total{outcome="miss"} 1',
                     'ai4e_rescache_evictions_total{reason="invalidated"} 1',
                     "ai4e_rescache_entries 0", "ai4e_rescache_bytes 0"):
            assert line in text, line


# -- the gateway's async path end to end -----------------------------------------


async def echo_platform(reg: MetricsRegistry, **worker_kw):
    """The port's platform with the cache on, and a worker serving the echo
    model on an async route in the same process."""
    platform = LocalPlatform(PlatformConfig(retry_delay=0.05,
                                            result_cache=True), metrics=reg)
    servable = build_servable("echo", name="echo", size=8, buckets=(4,))
    runtime = ModelRuntime(device="cpu")
    runtime.register(servable)
    batcher = MicroBatcher(runtime, max_wait_ms=1.0, metrics=reg)
    worker = InferenceWorker("w", runtime, batcher,
                             task_manager=platform.task_manager,
                             prefix="v1/echo", store=platform.store,
                             result_cache=platform.result_cache,
                             **worker_kw)
    worker.serve_model(servable, sync_path="/run", async_path="/run-async")
    await batcher.start()
    svc = await serve(worker.service.app)
    platform.publish_async_api("/v1/public/run",
                               str(svc.make_url("/v1/echo/run-async")))
    platform.publish_sync_api("/v1/public/run-sync",
                              str(svc.make_url("/v1/echo/run")))
    gw = await serve(platform.gateway.app)
    await platform.start()
    payload = npy_bytes(np.arange(8, dtype=np.float32))
    return platform, gw, svc, batcher, payload


async def close(platform, gw, svc, batcher) -> None:
    await platform.stop()
    await batcher.stop()
    await gw.close()
    await svc.close()


class TestAsyncPathCaching:
    def test_coalescing_one_execution_for_n_identical_requests(self):
        async def main():
            reg = MetricsRegistry()
            platform, gw, svc, batcher, payload = await echo_platform(reg)
            try:
                posts = await asyncio.gather(*(
                    gw.post("/v1/public/run", data=payload)
                    for _ in range(5)))
                records, xcache = [], []
                for resp in posts:
                    assert resp.status == 200
                    xcache.append(resp.headers.get("X-Cache"))
                    records.append(await resp.json())
                assert xcache.count("miss") == 1, xcache
                assert set(xcache) <= {"miss", "coalesced", "hit"}
                leader_id = records[xcache.index("miss")]["TaskId"]
                for rec, x in zip(records, xcache):
                    if x == "coalesced":
                        assert rec["TaskId"] == leader_id
                expect = {"echo": [float(v) for v in range(8)]}
                for rec in records:
                    final = await poll_until(gw, rec["TaskId"], completed)
                    assert completed(final), final
                    body, _ = platform.store.get_result(rec["TaskId"])
                    assert json.loads(body) == expect
                assert executed_examples(reg) == 1.0
                resp = await gw.post("/v1/public/run", data=payload)
                assert resp.headers.get("X-Cache") == "hit"
                rec = await resp.json()
                assert rec["Status"] == "completed - served from cache"
                assert rec["TaskId"] != leader_id
                hit_body, _ = platform.store.get_result(rec["TaskId"])
                leader_body, _ = platform.store.get_result(leader_id)
                assert hit_body == leader_body  # byte for byte
                assert executed_examples(reg) == 1.0
                stats = platform.result_cache.stats()
                assert (stats["hits"], stats["misses"]) == (
                    1 + xcache.count("hit"), 1)
                assert stats["coalesced"] == xcache.count("coalesced")
            finally:
                await close(platform, gw, svc, batcher)

        run(main())

    def test_bypass_header_opts_out_and_executes(self):
        async def main():
            reg = MetricsRegistry()
            platform, gw, svc, batcher, payload = await echo_platform(reg)
            try:
                first = await gw.post("/v1/public/run", data=payload)
                assert first.headers.get("X-Cache") == "miss"
                await poll_until(gw, (await first.json())["TaskId"],
                                 completed)
                assert executed_examples(reg) == 1.0
                resp = await gw.post("/v1/public/run", data=payload,
                                     headers={"X-Cache-Bypass": "1"})
                assert resp.headers.get("X-Cache") == "bypass"
                rec = await resp.json()
                assert rec["Status"] == "created"
                await poll_until(gw, rec["TaskId"], completed)
                assert executed_examples(reg) == 2.0
                assert "CacheKey" not in rec
                assert platform.result_cache.stats()["bypass"] == 1
            finally:
                await close(platform, gw, svc, batcher)

        run(main())

    def test_different_payloads_do_not_share_results(self):
        async def main():
            reg = MetricsRegistry()
            platform, gw, svc, batcher, payload = await echo_platform(reg)
            try:
                other = npy_bytes(np.arange(8, dtype=np.float32) + 1.0)
                r1 = await gw.post("/v1/public/run", data=payload)
                r2 = await gw.post("/v1/public/run", data=other)
                assert r2.headers.get("X-Cache") == "miss"
                t1 = (await r1.json())["TaskId"]
                t2 = (await r2.json())["TaskId"]
                assert t1 != t2
                await poll_until(gw, t1, completed)
                await poll_until(gw, t2, completed)
                b1, _ = platform.store.get_result(t1)
                b2, _ = platform.store.get_result(t2)
                assert json.loads(b1) != json.loads(b2)
                assert executed_examples(reg) == 2.0
            finally:
                await close(platform, gw, svc, batcher)

        run(main())

    def test_key_is_the_task_s_and_its_queue_s(self):
        """The key the gateway stamps is ``request_key`` of the backend's
        endpoint path: the queue name, the worker's served path and the
        family a reload invalidates."""
        async def main():
            reg = MetricsRegistry()
            platform, gw, svc, batcher, payload = await echo_platform(reg)
            try:
                resp = await gw.post(
                    "/v1/public/run", data=payload,
                    headers={"Content-Type": "application/octet-stream"})
                tid = (await resp.json())["TaskId"]
                key = platform.store.get(tid).cache_key
                assert key == jax_rescache.request_key(
                    "/v1/echo/run-async", payload,
                    "application/octet-stream")
                assert family_of(key) == "/v1/echo/run-async"
                await poll_until(gw, tid, completed)
            finally:
                await close(platform, gw, svc, batcher)

        run(main())

    def test_sync_proxy_hit_miss_and_coalesced(self):
        async def main():
            reg = MetricsRegistry()
            platform, gw, svc, batcher, payload = await echo_platform(reg)
            try:
                answers = await asyncio.gather(*(
                    gw.post("/v1/public/run-sync", data=payload)
                    for _ in range(4)))
                xcache = [r.headers.get("X-Cache") for r in answers]
                bodies = [await r.read() for r in answers]
                assert xcache.count("miss") == 1, xcache
                assert set(xcache) <= {"miss", "coalesced", "hit"}
                assert len(set(bodies)) == 1
                assert executed_examples(reg) == 1.0
                again = await gw.post("/v1/public/run-sync", data=payload)
                assert again.headers.get("X-Cache") == "hit"
                assert await again.read() == bodies[0]
                assert platform.gateway._sync_inflight == {}
                # A GET passes through untouched.
                r = await gw.get("/v1/public/run-sync")
                assert "X-Cache" not in r.headers
            finally:
                await close(platform, gw, svc, batcher)

        run(main())


class TestDispatcherServeFromCache:
    def test_redelivery_completes_from_cache_without_backend(self):
        async def main():
            reg = MetricsRegistry()
            platform = LocalPlatform(PlatformConfig(
                retry_delay=0.05, result_cache=True), metrics=reg)
            platform.publish_async_api("/v1/public/dead",
                                       "http://127.0.0.1:1/v1/dead/x")
            gw = await serve(platform.gateway.app)
            await platform.start()
            try:
                resp = await gw.post("/v1/public/dead", data=b"PAYLOAD")
                assert resp.headers.get("X-Cache") == "miss"
                tid = (await resp.json())["TaskId"]
                key = platform.store.get(tid).cache_key
                assert key
                platform.result_cache.put(key, b'{"ok": 1}')
                final = await poll_until(gw, tid, completed)
                assert final["Status"] == "completed - served from cache"
                body, _ = platform.store.get_result(tid)
                assert json.loads(body) == {"ok": 1}
                assert platform.result_cache.leader_for(key) is None
                assert reg.counter("ai4e_dispatch_total", "").value(
                    outcome="cache_hit", queue="/v1/dead/x", backend="") == 1
            finally:
                await platform.stop()
                await gw.close()

        run(main())

    def test_message_carries_the_task_s_cache_key(self):
        broker = InMemoryBroker()
        broker.register_queue("/v1/x")
        broker.publish(APITask(endpoint="/v1/x", body=b"b",
                               cache_key="/v1/x|abc"))
        msg = broker.queue("/v1/x")._ready[0]
        assert msg.cache_key == "/v1/x|abc"


class TestDispatcherNoResultStore:
    def test_cache_hit_without_result_store_dispatches(self):
        async def main():
            cache = ResultCache(metrics=MetricsRegistry())
            key = request_key("/v1/x", b"B")
            cache.put(key, b'{"ok": 1}')
            d = Dispatcher(InMemoryBroker(), "q", "http://127.0.0.1:1/v1/x",
                           task_manager=None, result_cache=cache,
                           result_store=None)
            msg = Message(task_id="t-1", endpoint="/v1/x", cache_key=key)
            assert await d._complete_from_cache(msg) is False

        run(main())

    def test_cache_hit_without_task_manager_completes(self):
        async def main():
            class Sink:
                def __init__(self):
                    self.results = {}

                def set_result(self, task_id, payload,
                               content_type="application/json"):
                    self.results[task_id] = payload

            cache = ResultCache(metrics=MetricsRegistry())
            key = request_key("/v1/x", b"B")
            cache.put(key, b'{"ok": 1}')
            sink = Sink()
            d = Dispatcher(InMemoryBroker(), "q", "http://127.0.0.1:1/v1/x",
                           task_manager=None, result_cache=cache,
                           result_store=sink)
            msg = Message(task_id="t-1", endpoint="/v1/x", cache_key=key)
            assert await d._complete_from_cache(msg) is True
            assert sink.results["t-1"] == b'{"ok": 1}'

        run(main())


# -- invalidation on reload and stale fills ---------------------------------------


def echo_worker(reg, cache, tmp_path):
    servable = build_servable("echo", name="echo", size=8, buckets=(4,))
    runtime = ModelRuntime(device="cpu")
    runtime.register(servable)
    batcher = MicroBatcher(runtime, max_wait_ms=1.0, metrics=reg)
    worker = InferenceWorker("w", runtime, batcher, prefix="v1/echo",
                             metrics=reg, result_cache=cache,
                             checkpoint_root=str(tmp_path))
    worker.serve_model(servable, sync_path="/run")
    return worker, batcher


class TestInvalidationOnHotReload:
    def test_reload_invalidates_and_serves_new_weights(self, tmp_path):
        ckpt = str(tmp_path / "echo_v2.npz")
        convert.save_npz({"scale": np.array(3.0, np.float32)}, ckpt)

        async def main():
            reg = MetricsRegistry()
            platform, gw, svc, batcher, payload = await echo_platform(
                reg, checkpoint_root=str(tmp_path))
            try:
                first = await gw.post("/v1/public/run-sync", data=payload)
                assert first.headers.get("X-Cache") == "miss"
                before = (await first.json())["echo"]
                assert before[:3] == [0.0, 1.0, 2.0]
                executed_once = executed_examples(reg)
                again = await gw.post("/v1/public/run-sync", data=payload)
                assert again.headers.get("X-Cache") == "hit"
                assert (await again.json())["echo"] == before
                assert executed_examples(reg) == executed_once
                cache = platform.result_cache
                assert cache.stats()["entries"] == 1
                resp = await svc.post("/v1/echo/models/echo/reload",
                                      json={"checkpoint": ckpt})
                assert resp.status == 200, await resp.json()
                assert cache.stats()["entries"] == 0
                after = await gw.post("/v1/public/run-sync", data=payload)
                assert after.headers.get("X-Cache") == "miss"
                assert (await after.json())["echo"][:3] == [0.0, 3.0, 6.0]
            finally:
                await close(platform, gw, svc, batcher)

        run(main())

    def test_reload_invalidates_every_served_path(self, tmp_path):
        """A reload drops the gateway's and dispatcher's namespace too: the
        endpoint paths of ``serve_model`` and ``serve_batch`` alike."""
        ckpt = str(tmp_path / "echo_v2.npz")
        convert.save_npz({"scale": np.array(2.0, np.float32)}, ckpt)

        async def main():
            reg = MetricsRegistry()
            cache = ResultCache(metrics=reg)
            worker, batcher = echo_worker(reg, cache, tmp_path)
            worker.serve_batch(worker.runtime.models["echo"])
            served = dict(worker._served["echo"])
            assert served == {"sync": "/v1/echo/run",
                              "async": "/v1/echo/echo-async",
                              "batch_sync": "/v1/echo/echo-batch",
                              "batch_async": "/v1/echo/echo-batch-async"}
            for path in served.values():
                cache.put(request_key(path, b"p"), b"old")
            cache.put(request_key("/v1/other/run", b"p"), b"keep")
            await batcher.start()
            client = await serve(worker.service.app)
            try:
                resp = await client.post("/v1/echo/models/echo/reload",
                                         json={"checkpoint": ckpt})
                assert resp.status == 200
                assert cache.stats()["entries"] == 1
                assert cache.peek(request_key("/v1/other/run", b"p"))
            finally:
                await batcher.stop()
                await client.close()

        run(main())


class TestStaleFillRefusal:
    def _store_and_cache(self):
        store = InMemoryTaskStore()
        cache = ResultCache(metrics=MetricsRegistry())
        attach_store(store, cache)
        return store, cache

    def _complete(self, store, task):
        store.set_result(task.task_id, b'{"r": 1}')
        store.upsert(task.with_status("completed", TaskStatus.COMPLETED))

    def test_registered_leader_fill_lands(self):
        store, cache = self._store_and_cache()
        task = store.upsert(APITask(endpoint="/v1/x", body=b"p",
                                    cache_key="fam|k"))
        cache.register_inflight("fam|k", task.task_id)
        self._complete(store, task)
        assert cache.peek("fam|k")
        assert cache.leader_for("fam|k") is None

    def test_invalidation_mid_flight_refuses_the_fill(self):
        store, cache = self._store_and_cache()
        task = store.upsert(APITask(endpoint="/v1/x", body=b"p",
                                    cache_key="fam|k"))
        cache.register_inflight("fam|k", task.task_id)
        cache.invalidate_family("fam")
        self._complete(store, task)
        assert not cache.peek("fam|k")
        assert cache.leader_for("fam|k") is None

    def test_unregistered_completion_leaves_cache_cold(self):
        store, cache = self._store_and_cache()
        task = store.upsert(APITask(endpoint="/v1/x", body=b"p",
                                    cache_key="fam|k"))
        self._complete(store, task)
        assert not cache.peek("fam|k")

    def test_put_if_generation_refuses_stale_sync_fill(self):
        cache = ResultCache(metrics=MetricsRegistry())
        gen = cache.generation("fam|k")
        cache.invalidate_family("fam")
        assert cache.put("fam|k", b"old", if_generation=gen) is False
        assert not cache.peek("fam|k")
        assert cache.put("fam|k", b"new",
                         if_generation=cache.generation("fam|k")) is True
        assert cache.peek("fam|k")

    def test_fill_inflight_only_for_the_owner(self):
        cache = ResultCache(metrics=MetricsRegistry())
        cache.register_inflight("f|k", "t1")
        assert cache.fill_inflight("f|k", "t2", b"r") is False
        assert not cache.peek("f|k")
        assert cache.leader_for("f|k") == "t1"
        assert cache.fill_inflight("f|k", "t1", b"r") is True
        assert cache.peek("f|k") and cache.leader_for("f|k") is None

    def test_release_inflight_reports_ownership(self):
        cache = ResultCache(metrics=MetricsRegistry())
        cache.register_inflight("f|k", "t1")
        assert cache.release_inflight("f|k", "t2") is False
        assert cache.release_inflight("f|k", "t1") is True

    def test_failed_leader_releases(self):
        store, cache = self._store_and_cache()
        task = store.upsert(APITask(endpoint="/v1/x", body=b"p",
                                    cache_key="fam|k"))
        cache.register_inflight("fam|k", task.task_id)
        store.update_status(task.task_id, "failed - backend 500",
                            backend_status="failed")
        assert not cache.peek("fam|k")
        assert cache.leader_for("fam|k") is None

    def test_post_reload_leader_survives_the_stale_completion(self):
        """A leader of the old weights completes after a reload and a new
        leader took its key: the stale fill lands nowhere and the new
        leader keeps its registration, then fills."""
        store, cache = self._store_and_cache()
        old = store.upsert(APITask(endpoint="/v1/x", body=b"p",
                                   cache_key="/v1/x|k"))
        cache.register_inflight("/v1/x|k", old.task_id)
        cache.invalidate_family("/v1/x")
        new = store.upsert(APITask(endpoint="/v1/x", body=b"p",
                                   cache_key="/v1/x|k"))
        assert cache.register_inflight("/v1/x|k", new.task_id)
        self._complete(store, old)
        assert not cache.peek("/v1/x|k")
        assert cache.leader_for("/v1/x|k") == new.task_id
        store.set_result(new.task_id, b'{"r": 2}')
        store.upsert(new.with_status("completed", TaskStatus.COMPLETED))
        assert cache.get("/v1/x|k") == (b'{"r": 2}', "application/json")


class TestEdgeOnlyCounting:
    def test_uncounted_lookup_leaves_hit_ratio_alone(self):
        cache = ResultCache(metrics=MetricsRegistry())
        cache.put("f|k", b"x")
        assert cache.get("f|k", count=False) is not None
        assert cache.get("f|missing", count=False) is None
        stats = cache.stats()
        assert stats["hits"] == 0 and stats["misses"] == 0
        cache.get("f|k")
        assert cache.stats()["hits"] == 1

    def test_dispatcher_hit_counts_no_edge_outcome(self):
        async def main():
            cache = ResultCache(metrics=MetricsRegistry())
            key = request_key("/v1/x", b"B")
            cache.put(key, b"{}")
            store = InMemoryTaskStore()
            task = store.upsert(APITask(endpoint="/v1/x", body=b"B",
                                        cache_key=key))
            from ai4e_tpu_torch.service import LocalTaskManager
            d = Dispatcher(InMemoryBroker(), "q", "http://127.0.0.1:1/v1/x",
                           task_manager=LocalTaskManager(store),
                           result_cache=cache, result_store=store)
            msg = Message(task_id=task.task_id, endpoint="/v1/x",
                          cache_key=key)
            assert await d._complete_from_cache(msg) is True
            assert store.get(task.task_id).status == (
                "completed - served from cache")
            assert cache.stats()["hits"] == 0
            # A redelivery of the finished task is a duplicate.
            assert await d._complete_from_cache(msg) is True
            assert d._dispatched.value(outcome="duplicate", queue="q",
                                       backend="") == 1

        run(main())


class TestSyncSingleFlightCleanup:
    def test_leader_failure_before_proxy_releases_waiters(self):
        async def main():
            reg = MetricsRegistry()
            platform = LocalPlatform(PlatformConfig(result_cache=True),
                                     metrics=reg)
            platform.publish_sync_api("/v1/public/sync",
                                      "http://127.0.0.1:1/v1/x")

            async def boom():
                raise RuntimeError("session factory down")

            platform.gateway._get_session = boom
            gw = await serve(platform.gateway.app)
            try:
                r1, r2 = await asyncio.wait_for(asyncio.gather(
                    gw.post("/v1/public/sync", data=b"B"),
                    gw.post("/v1/public/sync", data=b"B")), timeout=10.0)
                assert r1.status == 500 and r2.status == 500
                assert platform.gateway._sync_inflight == {}
                r3 = await asyncio.wait_for(
                    gw.post("/v1/public/sync", data=b"B"), timeout=10.0)
                assert r3.status == 500
                assert platform.gateway._sync_inflight == {}
            finally:
                await gw.close()

        run(main())


class TestSyncBypass:
    def test_bypass_header_executes_past_the_gateway_cache(self):
        async def main():
            reg = MetricsRegistry()
            platform, gw, svc, batcher, payload = await echo_platform(reg)
            try:
                first = await gw.post("/v1/public/run-sync", data=payload)
                body = await first.read()
                assert executed_examples(reg) == 1.0
                cache = platform.result_cache
                assert cache.stats()["entries"] == 1
                for hdr in ({"X-Cache-Bypass": "1"},
                            {"Cache-Control": "no-cache"}):
                    again = await gw.post("/v1/public/run-sync",
                                          data=payload, headers=hdr)
                    assert again.headers.get("X-Cache") == "bypass"
                    assert await again.read() == body
                assert executed_examples(reg) == 3.0
                assert cache.stats()["entries"] == 1
                hit = await gw.post("/v1/public/run-sync", data=payload)
                assert hit.headers.get("X-Cache") == "hit"
                assert await hit.read() == body
                assert executed_examples(reg) == 3.0
            finally:
                await close(platform, gw, svc, batcher)

        run(main())

    def test_worker_answers_nothing_from_its_cache(self, tmp_path):
        """A worker given the cache only invalidates it: its own sync path
        neither reads nor fills it."""
        async def main():
            reg = MetricsRegistry()
            cache = ResultCache(metrics=reg)
            worker, batcher = echo_worker(reg, cache, tmp_path)
            await batcher.start()
            client = await serve(worker.service.app)
            try:
                payload = npy_bytes(np.arange(8, dtype=np.float32))
                for _ in range(2):
                    await client.post("/v1/echo/run", data=payload)
                assert executed_examples(reg) == 2.0
                assert cache.stats()["entries"] == 0
            finally:
                await batcher.stop()
                await client.close()

        run(main())


class TestSyncCoalesceInvalidation:
    def test_waiter_does_not_adopt_pre_reload_leader(self):
        async def main():
            reg = MetricsRegistry()
            hits = 0
            got_request = asyncio.Event()
            release = asyncio.Event()

            async def backend(request):
                nonlocal hits
                hits += 1
                mine = hits
                got_request.set()
                if mine == 1:
                    await release.wait()
                return web.Response(text=str(mine))

            app = web.Application()
            app.router.add_post("/v1/x", backend)
            be = await serve(app)
            platform = LocalPlatform(PlatformConfig(result_cache=True),
                                     metrics=reg)
            backend_uri = str(be.make_url("/v1/x"))
            platform.publish_sync_api("/v1/public/sync", backend_uri)
            gw = await serve(platform.gateway.app)
            try:
                leader = asyncio.create_task(
                    gw.post("/v1/public/sync", data=b"B"))
                await asyncio.wait_for(got_request.wait(), timeout=10.0)
                platform.result_cache.invalidate_family(
                    endpoint_path(backend_uri))
                waiter = asyncio.create_task(
                    gw.post("/v1/public/sync", data=b"B"))
                await asyncio.sleep(0.05)
                release.set()
                r1 = await asyncio.wait_for(leader, timeout=10.0)
                r2 = await asyncio.wait_for(waiter, timeout=10.0)
                assert await r1.text() == "1"
                assert r2.headers.get("X-Cache") != "coalesced"
                assert await r2.text() == "2"
                assert hits == 2
                assert platform.result_cache.stats()["entries"] == 0
            finally:
                await gw.close()
                await be.close()

        run(main())


# -- hit-record durability and the config ---------------------------------------


class TestHitRecordDurability:
    def test_gateway_hit_record_is_non_durable(self):
        async def main():
            reg = MetricsRegistry()
            platform, gw, svc, batcher, payload = await echo_platform(reg)
            try:
                first = await gw.post("/v1/public/run", data=payload)
                miss_id = (await first.json())["TaskId"]
                await poll_until(gw, miss_id, completed)
                hit = await gw.post("/v1/public/run", data=payload)
                assert hit.headers.get("X-Cache") == "hit"
                hit_id = (await hit.json())["TaskId"]
                assert platform.store.get(miss_id).durable is True
                assert platform.store.get(hit_id).durable is False
                # Never on the wire.
                assert "durable" not in json.dumps(
                    platform.store.get(hit_id).to_dict()).lower()
            finally:
                await close(platform, gw, svc, batcher)

        run(main())

    def test_external_upsert_cannot_promote_a_hit_record(self):
        store = InMemoryTaskStore()
        hit = store.upsert(APITask(endpoint="/v1/x",
                                   status="completed - served from cache",
                                   backend_status="completed",
                                   durable=False))
        replacement = store.upsert(APITask(task_id=hit.task_id,
                                           endpoint="/v1/x",
                                           status="completed - rewritten",
                                           backend_status="completed"))
        assert replacement.durable is False
        assert store.update_status(hit.task_id, "completed - x").durable \
            is False


class TestConfigPlumbing:
    def test_platform_env_section_carries_cache_knobs(self):
        from ai4e_tpu_torch.config import FrameworkConfig, PlatformSection

        cfg = PlatformSection.from_env(env={
            "AI4E_PLATFORM_RESULT_CACHE": "true",
            "AI4E_PLATFORM_CACHE_MAX_ENTRIES": "7",
            "AI4E_PLATFORM_CACHE_MAX_BYTES": "1024",
            "AI4E_PLATFORM_CACHE_TTL_SECONDS": "60",
        }).to_platform_config()
        assert cfg.result_cache is True
        assert cfg.cache_max_entries == 7
        assert cfg.cache_max_bytes == 1024
        assert cfg.cache_ttl_seconds == 60.0
        off = PlatformSection.from_env(env={}).to_platform_config()
        assert off.result_cache is False
        platform = LocalPlatform(FrameworkConfig.from_env({
            "AI4E_PLATFORM_RESULT_CACHE": "1",
            "AI4E_PLATFORM_CACHE_MAX_ENTRIES": "7"}).to_platform_config(),
            metrics=MetricsRegistry())
        assert platform.result_cache.max_entries == 7
        assert platform.gateway._result_cache is platform.result_cache
        for d in (platform.dispatchers,):
            assert d.result_cache is platform.result_cache
            assert d.result_store is platform.store
        assert LocalPlatform(PlatformConfig(),
                             metrics=MetricsRegistry()).result_cache is None


# -- land cover at a small width ------------------------------------------------

TILE = 32
WIDTHS = (8, 16)
N_TILES = 3
ADMIN = {"Ocp-Apim-Subscription-Key": "adm"}


@pytest.fixture(scope="module")
def landcover_checkpoints(tmp_path_factory):
    """JAX's land-cover weights and a perturbed copy, each saved flat for
    the port by ``convert.save_npz``."""
    servable = jax_build_unet(tile=TILE, widths=WIDTHS, num_classes=4,
                              buckets=(1, 4))
    params = jax.tree.map(np.asarray, servable.params)
    rng = np.random.default_rng(7)
    other = jax.tree.map(
        lambda a: (a * rng.uniform(0.25, 1.75, a.shape)).astype(a.dtype),
        params)
    root = tmp_path_factory.mktemp("landcover")
    paths = []
    for name, tree in (("seed0", params), ("other", other)):
        path = str(root / f"{name}.npz")
        convert.save_npz(tree, path)
        paths.append(path)
    return servable, str(root), paths


def jax_histogram(servable, image: np.ndarray) -> np.ndarray:
    out = servable.apply_fn(servable.params, jnp.asarray(image[None]))
    result = servable.postprocess({k: np.asarray(v)[0]
                                   for k, v in out.items()})
    return histogram(json.loads(json.dumps(result)))


def histogram(result: dict) -> np.ndarray:
    counts = np.zeros(4, np.int64)
    for cls, n in result["class_histogram"].items():
        counts[int(cls)] = n
    return counts


class TestLandCoverSmall:
    def test_hits_are_the_executed_bytes_and_reload_serves_new_weights(
            self, landcover_checkpoints):
        from ai4e_tpu_torch.cli import restore_checkpoint

        jax_servable, root, (seed0, other) = landcover_checkpoints
        images = np.random.default_rng(0).integers(
            0, 256, (N_TILES, TILE, TILE, 3), np.uint8)
        bodies = [npy_bytes(img) for img in images]

        async def main():
            reg = MetricsRegistry()
            platform = LocalPlatform(PlatformConfig(
                retry_delay=0.05, result_cache=True), metrics=reg)
            runtime = ModelRuntime(device="cpu")
            servable = build_servable("unet", name="landcover", tile=TILE,
                                      widths=WIDTHS, num_classes=4,
                                      buckets=(1, 4, 8))
            restore_checkpoint(servable, seed0)
            runtime.register(servable)
            runtime.warmup()
            batcher = MicroBatcher(runtime, max_wait_ms=50.0, metrics=reg)
            worker = InferenceWorker(
                "w", runtime, batcher, task_manager=platform.task_manager,
                prefix="v1/models", metrics=reg, store=platform.store,
                result_cache=platform.result_cache,
                checkpoint_root=root, admin_api_keys={"adm"})
            worker.serve_model(servable, sync_path="/classify",
                               async_path="/classify-async")
            await batcher.start()
            svc = await serve(worker.service.app)
            platform.publish_async_api(
                "/v1/landcover/classify-async",
                str(svc.make_url("/v1/models/classify-async")),
                concurrency=2 * N_TILES)
            platform.publish_sync_api(
                "/v1/landcover/classify",
                str(svc.make_url("/v1/models/classify")))
            gw = await serve(platform.gateway.app)
            await platform.start()

            async def wave(headers=None, copies=1) -> tuple[list, list]:
                # The whole wave at once, so the dispatcher delivers it
                # together and the batcher cuts it into one bucket (4 for
                # the tiles once, 8 for them twice): two executions of a
                # tile land in different buckets and batch rows, and must
                # agree byte for byte (ROADMAP C8).
                resps = await asyncio.gather(*(
                    gw.post("/v1/landcover/classify-async", data=b,
                            headers={"Content-Type":
                                     "application/octet-stream",
                                     **(headers or {})})
                    for b in bodies * copies))
                outcomes = [resp.headers.get("X-Cache") for resp in resps]
                tids = [(await resp.json())["TaskId"] for resp in resps]
                for final in await asyncio.gather(*(
                        poll_until(gw, tid, completed) for tid in tids)):
                    assert completed(final), final
                return outcomes, [platform.store.get_result(tid)[0]
                                  for tid in tids]

            try:
                outcomes, executed = await wave()
                assert outcomes == ["miss"] * N_TILES
                rows = executed_examples(reg)
                assert rows == N_TILES
                for body, img in zip(executed, images):
                    got = histogram(json.loads(body))
                    assert got.sum() == TILE * TILE
                    # JAX's answer on the same weights, within 1% of the
                    # pixels per class (bfloat16 rounds elsewhere).
                    assert np.abs(got - jax_histogram(jax_servable, img)
                                  ).max() <= 0.01 * TILE * TILE
                outcomes, hits = await wave()
                assert outcomes == ["hit"] * N_TILES
                assert hits == executed  # byte for byte
                assert executed_examples(reg) == rows
                sync = [await (await gw.post(
                    "/v1/landcover/classify", data=b,
                    headers={"Content-Type": "application/octet-stream"}))
                    .read() for b in bodies * 2]
                assert sync[N_TILES:] == sync[:N_TILES]
                assert executed_examples(reg) == rows + N_TILES
                assert platform.result_cache.stats()["entries"] == 2 * N_TILES

                r = await svc.post("/v1/models/models/landcover/reload",
                                   json={"checkpoint": other})
                assert r.status == 401
                r = await svc.post("/v1/models/models/landcover/reload",
                                   json={"checkpoint": other}, headers=ADMIN)
                assert r.status == 200, await r.text()
                # Both routes' families emptied with the swap.
                assert platform.result_cache.stats()["entries"] == 0
                outcomes, after = await wave()
                assert outcomes == ["miss"] * N_TILES
                _, bypassed = await wave({"X-Cache-Bypass": "1"}, copies=2)
                assert after == bypassed[:N_TILES] == bypassed[N_TILES:]
                assert after != executed
                assert executed_examples(reg) == rows + 4 * N_TILES
            finally:
                await platform.stop()
                await batcher.stop()
                await gw.close()
                await svc.close()

        run(main())
