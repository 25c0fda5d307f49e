"""Subscription keys, rate limits and quotas in the port (ROADMAP A18.4):
``ai4e_tpu_torch/gateway/ratelimit.py``, the gateway's key middleware, the
store clients' key and the worker's admin gate, mirroring the classes of
``tests/test_gateway_auth.py`` (``TestGatewayAuth``,
``TestProxyCredentialStripping``, ``TestEdgePayloadCap``) and
``tests/test_ratelimit.py`` (``TestTokenBucket``, ``TestGatewayThrottle``,
``TestQuota``) on the port's gateway.

Where the two packages meet the port is held to JAX: one fake-clock
sequence gives the same ``(allowed, retry_after)`` answers from both
limiters and both quota trackers, the parsers accept and refuse the same
specs with the same messages, and each package's keyed store client is
accepted by the other's keyed control plane (a wrong key gets 401 from
both). The worker's reload, drain and resume answer 401 without a key and
200 with one; the CLI fails closed on a set-but-empty key list and hands
the worker the first non-empty store key."""

import asyncio
import io
import os

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu.gateway import ratelimit as jax_rl
from ai4e_tpu_torch.config import ConfigError, FrameworkConfig
from ai4e_tpu_torch.gateway import ratelimit as rl
from ai4e_tpu_torch.gateway.ratelimit import (Quota, QuotaTracker, RateLimit,
                                              RateLimiter, parse_quota,
                                              parse_quotas, parse_rate_limits)
from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
from ai4e_tpu_torch.taskstore.http import make_app


def run(coro):
    return asyncio.run(coro)


async def serve(app):
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def keyed_platform(keys=("good-key",), **config) -> LocalPlatform:
    platform = LocalPlatform(PlatformConfig(retry_delay=0.05, **config))
    if keys:
        platform.gateway.set_api_keys(set(keys))
    return platform


# -- tests/test_gateway_auth.py's classes --------------------------------------


class TestGatewayAuth:
    def test_key_required_on_published_apis_and_polling(self):
        async def main():
            platform = keyed_platform()
            platform.publish_async_api("/v1/api/run",
                                       "http://127.0.0.1:1/v1/api/run")
            gw = await serve(platform.gateway.app)
            try:
                r = await gw.post("/v1/api/run", data=b"x")
                assert r.status == 401
                r = await gw.post("/v1/api/run", data=b"x",
                                  headers={"X-Api-Key": "bad"})
                assert r.status == 401
                assert (await r.json())["error"] == (
                    "missing or invalid subscription key")
                r = await gw.post(
                    "/v1/api/run", data=b"x",
                    headers={"Ocp-Apim-Subscription-Key": "good-key"})
                assert r.status == 200
                tid = (await r.json())["TaskId"]
                r = await gw.get(f"/v1/taskmanagement/task/{tid}")
                assert r.status == 401
                r = await gw.get(f"/v1/taskmanagement/task/{tid}",
                                 headers={"X-Api-Key": "good-key"})
                assert r.status == 200
                assert (await gw.get("/healthz")).status == 200
                metrics = await (await gw.get("/metrics")).text()
                # One constant label for every refusal, whatever the path.
                assert ('ai4e_gateway_requests_total{outcome="401",'
                        'route="unauthorized"} 3') in metrics
            finally:
                await gw.close()

        run(main())

    def test_taskstore_surface_keyed_and_workers_attach_key(self):
        from ai4e_tpu_torch.service.task_manager import (HttpResultStore,
                                                         HttpTaskManager)

        async def main():
            platform = keyed_platform(keys=("k",))
            make_app(platform.store, app=platform.gateway.app)
            gw = await serve(platform.gateway.app)
            try:
                r = await gw.post("/v1/taskstore/upsert",
                                  json={"Endpoint": "/v1/x", "Body": "b"})
                assert r.status == 401
                base = str(gw.make_url("")).rstrip("/")
                tm = HttpTaskManager(base, api_key="k")
                task = await tm.add_task("/v1/x", b"payload")
                assert task["Status"] == "created"
                got = await tm.get_task_status(task["TaskId"])
                assert got["TaskId"] == task["TaskId"]
                results = HttpResultStore(base, api_key="k")
                await results.set_result(task["TaskId"], b'{"r": 1}')
                assert await results.get_result(task["TaskId"]) == (
                    b'{"r": 1}', "application/json")
                await tm.close()
                await results.close()
            finally:
                await gw.close()

        run(main())

    def test_no_keys_configured_means_open(self):
        async def main():
            platform = keyed_platform(keys=())
            platform.publish_async_api("/v1/open/run",
                                       "http://127.0.0.1:1/v1/open/run")
            gw = await serve(platform.gateway.app)
            try:
                r = await gw.post("/v1/open/run",
                                  data=npy(np.zeros(2, np.float32)))
                assert r.status == 200
            finally:
                await gw.close()

        run(main())


class TestProxyCredentialStripping:
    def test_sync_backend_never_sees_the_subscription_key(self):
        async def main():
            seen = {}

            async def backend(request):
                seen.update(request.headers)
                return web.json_response({"ok": True})

            app = web.Application()
            app.router.add_post("/v1/b/run", backend)
            be = await serve(app)
            platform = keyed_platform(keys=("secret-key",))
            platform.publish_sync_api(
                "/v1/b/run", str(be.make_url("")).rstrip("/") + "/v1/b/run")
            gw = await serve(platform.gateway.app)
            try:
                for header in ("Ocp-Apim-Subscription-Key", "X-Api-Key"):
                    seen.clear()
                    r = await gw.post("/v1/b/run", data=b"x",
                                      headers={header: "secret-key",
                                               "X-Custom": "kept"})
                    assert r.status == 200
                    assert "Ocp-Apim-Subscription-Key" not in seen
                    assert "X-Api-Key" not in seen
                    assert seen.get("X-Custom") == "kept"
            finally:
                await gw.close()
                await be.close()

        run(main())


class TestEdgePayloadCap:
    def test_oversized_async_post_is_413_before_task_creation(self):
        async def main():
            platform = keyed_platform(keys=())
            platform.gateway.max_body_bytes = 1024
            platform.publish_async_api("/v1/api/run", "http://backend/run")
            gw = await serve(platform.gateway.app)
            try:
                resp = await gw.post("/v1/api/run", data=b"x" * 2048)
                assert resp.status == 413
                assert platform.store.set_len("/run", "created") == 0
                under = await gw.post("/v1/api/run", data=b"x" * 512)
                assert under.status == 200
                assert "TaskId" in await under.json()
                assert platform.store.set_len("/run", "created") == 1
            finally:
                await gw.close()

        run(main())

    def test_chunked_body_aborts_at_the_cap_not_after_buffering(self):
        async def main():
            platform = keyed_platform(keys=())
            platform.gateway.max_body_bytes = 1024
            platform.publish_async_api("/v1/api/run", "http://backend/run")
            gw = await serve(platform.gateway.app)
            try:
                async def chunks():
                    for _ in range(64):
                        yield b"x" * 1024
                resp = await gw.post("/v1/api/run", data=chunks())
                assert resp.status == 413
                assert platform.store.set_len("/run", "created") == 0
            finally:
                await gw.close()

        run(main())

    def test_sync_proxy_refuses_oversized_and_route_override_wins(self):
        async def main():
            seen = []

            async def backend(request):
                seen.append(len(await request.read()))
                return web.json_response({"ok": True})

            be_app = web.Application()
            be_app.router.add_post("/run", backend)
            be = await serve(be_app)
            platform = keyed_platform(keys=())
            platform.gateway.max_body_bytes = 1024
            platform.gateway.add_sync_route(
                "/v1/sync/run", f"http://127.0.0.1:{be.port}/run",
                max_body_bytes=4096)
            gw = await serve(platform.gateway.app)
            try:
                ok = await gw.post("/v1/sync/run", data=b"x" * 2048)
                assert ok.status == 200, ok.status
                too_big = await gw.post("/v1/sync/run", data=b"x" * 8192)
                assert too_big.status == 413
                assert seen == [2048]
            finally:
                await gw.close()
                await be.close()

        run(main())


# -- tests/test_ratelimit.py's classes ------------------------------------------


class TestTokenBucket:
    def test_burst_then_throttle_then_refill(self):
        clock = FakeClock()
        limiter = RateLimiter(RateLimit(rps=10, burst=3), clock=clock)
        assert [limiter.allow("k")[0] for _ in range(3)] == [True] * 3
        allowed, retry = limiter.allow("k")
        assert not allowed and retry > 0
        clock.t += 0.1
        assert limiter.allow("k")[0]
        assert not limiter.allow("k")[0]

    def test_retry_after_predicts_next_token(self):
        clock = FakeClock()
        limiter = RateLimiter(RateLimit(rps=2, burst=1), clock=clock)
        assert limiter.allow("k")[0]
        _, retry = limiter.allow("k")
        clock.t += retry
        assert limiter.allow("k")[0]

    def test_keys_have_independent_buckets(self):
        clock = FakeClock()
        limiter = RateLimiter(RateLimit(rps=1, burst=1), clock=clock)
        assert limiter.allow("a")[0]
        assert not limiter.allow("a")[0]
        assert limiter.allow("b")[0]

    def test_per_key_override(self):
        clock = FakeClock()
        limiter = RateLimiter(RateLimit(rps=1, burst=1),
                              per_key={"vip": RateLimit(rps=100, burst=5)},
                              clock=clock)
        assert [limiter.allow("vip")[0] for _ in range(5)] == [True] * 5
        assert limiter.allow("free")[0]
        assert not limiter.allow("free")[0]

    def test_idle_buckets_pruned(self):
        clock = FakeClock()
        limiter = RateLimiter(RateLimit(rps=10, burst=2), clock=clock)
        for i in range(100):
            limiter.allow(f"key-{i}")
        clock.t += 120.0
        limiter.allow("fresh")
        assert len(limiter._buckets) == 1

    def test_parse_rate_limits(self):
        limits = parse_rate_limits("partner=50:100, free=2")
        assert limits["partner"].rps == 50 and limits["partner"].burst == 100
        assert limits["free"].rps == 2 and limits["free"].burst == 4.0

    def test_parse_rejects_malformed(self):
        with pytest.raises(ValueError):
            parse_rate_limits("no-rate")
        with pytest.raises(ValueError):
            RateLimit(rps=0)


class TestGatewayThrottle:
    def test_429_with_retry_after_and_taskstore_exempt(self):
        async def main():
            platform = keyed_platform()
            platform.gateway.set_rate_limiter(
                RateLimiter(RateLimit(rps=0.5, burst=2)))
            platform.publish_async_api("/v1/api/run",
                                       "http://127.0.0.1:1/v1/api/run")
            make_app(platform.store, app=platform.gateway.app)
            gw = await serve(platform.gateway.app)
            hdr = {"X-Api-Key": "good-key"}
            try:
                r1 = await gw.post("/v1/api/run", data=b"x", headers=hdr)
                r2 = await gw.post("/v1/api/run", data=b"x", headers=hdr)
                assert (r1.status, r2.status) == (200, 200)
                r3 = await gw.post("/v1/api/run", data=b"x", headers=hdr)
                assert r3.status == 429
                assert r3.headers["Retry-After"] == "2"
                assert (await r3.json())["error"] == "rate limit exceeded"
                r = await gw.post("/v1/api/run", data=b"x",
                                  headers={"X-Api-Key": "bad"})
                assert r.status == 401
                tid = (await r1.json())["TaskId"]
                for _ in range(10):
                    r = await gw.get(f"/v1/taskstore/task?taskId={tid}",
                                     headers=hdr)
                    assert r.status == 200
                assert (await gw.get("/healthz")).status == 200
                # Task polls are the public surface: throttled too.
                r = await gw.get(f"/v1/taskmanagement/task/{tid}",
                                 headers=hdr)
                assert r.status == 429
            finally:
                await gw.close()

        run(main())

    def test_unkeyed_gateway_buckets_by_remote_addr(self):
        async def main():
            platform = keyed_platform(keys=())
            platform.gateway.set_rate_limiter(
                RateLimiter(RateLimit(rps=0.5, burst=1)))
            platform.publish_async_api("/v1/api/run",
                                       "http://127.0.0.1:1/v1/api/run")
            gw = await serve(platform.gateway.app)
            try:
                assert (await gw.post("/v1/api/run", data=b"x")).status == 200
                r = await gw.post("/v1/api/run", data=b"x",
                                  headers={"X-Api-Key": "made-up-2"})
                assert r.status == 429
                assert r.headers["Retry-After"].isdigit()
                assert int(r.headers["Retry-After"]) >= 1
            finally:
                await gw.close()

        run(main())


class TestQuota:
    def test_window_exhausts_then_resets(self):
        clock = FakeClock()
        q = QuotaTracker(Quota(requests=3, window_seconds=60), clock=clock)
        assert all(q.allow("k")[0] for _ in range(3))
        allowed, retry = q.allow("k")
        assert not allowed and 0 < retry <= 60
        clock.t += retry
        assert q.allow("k")[0]

    def test_per_key_override_and_independence(self):
        clock = FakeClock()
        q = QuotaTracker(Quota(requests=1, window_seconds=60),
                         per_key={"big": Quota(requests=5,
                                               window_seconds=60)},
                         clock=clock)
        assert q.allow("small")[0] and not q.allow("small")[0]
        assert all(q.allow("big")[0] for _ in range(5))
        assert not q.allow("big")[0]

    def test_parsers(self):
        assert parse_quota("100").requests == 100
        assert parse_quota("100").window_seconds == 3600.0
        assert parse_quota("5/86400").window_seconds == 86400.0
        out = parse_quotas("partner=100000/86400, free=10")
        assert out["partner"].requests == 100000
        assert out["free"].window_seconds == 3600.0
        with pytest.raises(ValueError):
            parse_quotas("nokey")
        with pytest.raises(ValueError):
            parse_quota("0")

    def test_none_default_is_unlimited_and_untracked(self):
        clock = FakeClock()
        q = QuotaTracker(None, per_key={"metered": Quota(requests=1)},
                         clock=clock)
        for _ in range(50):
            assert q.allow("some-client-ip")[0]
        assert "some-client-ip" not in q._windows
        assert q.allow("metered")[0] and not q.allow("metered")[0]

    def test_quota_refusal_consumes_no_rate_token(self):
        async def main():
            platform = keyed_platform()
            platform.gateway.set_rate_limiter(
                RateLimiter(RateLimit(rps=0.001, burst=2)))
            platform.gateway.set_quota_tracker(
                QuotaTracker(Quota(requests=1, window_seconds=3600)))
            platform.publish_async_api("/v1/api/run",
                                       "http://127.0.0.1:1/v1/api/run")
            gw = await serve(platform.gateway.app)
            hdr = {"X-Api-Key": "good-key"}
            try:
                assert (await gw.post("/v1/api/run", data=b"x",
                                      headers=hdr)).status == 200
                for _ in range(5):
                    r = await gw.post("/v1/api/run", data=b"x", headers=hdr)
                    assert r.status == 403
                    # The window's reset, in whole seconds.
                    assert 3590 <= int(r.headers["Retry-After"]) <= 3600
                assert platform.gateway._rate_limiter._buckets[
                    "good-key"][0] >= 0.99
            finally:
                await gw.close()

        run(main())

    def test_gateway_403_after_quota_and_rate_refusals_dont_consume(self):
        async def main():
            platform = keyed_platform()
            platform.gateway.set_rate_limiter(
                RateLimiter(RateLimit(rps=0.001, burst=1)))
            platform.gateway.set_quota_tracker(
                QuotaTracker(Quota(requests=2, window_seconds=3600)))
            platform.publish_async_api("/v1/api/run",
                                       "http://127.0.0.1:1/v1/api/run")
            gw = await serve(platform.gateway.app)
            hdr = {"X-Api-Key": "good-key"}
            try:
                r1 = await gw.post("/v1/api/run", data=b"x", headers=hdr)
                assert r1.status == 200
                for _ in range(3):
                    r = await gw.post("/v1/api/run", data=b"x", headers=hdr)
                    assert r.status == 429
                platform.gateway._rate_limiter._buckets["good-key"][0] = 1.0
                assert (await gw.post("/v1/api/run", data=b"x",
                                      headers=hdr)).status == 200
                platform.gateway._rate_limiter._buckets["good-key"][0] = 1.0
                r = await gw.post("/v1/api/run", data=b"x", headers=hdr)
                assert r.status == 403
                assert float(r.headers["Retry-After"]) > 0
                assert "quota" in (await r.json())["error"]
            finally:
                await gw.close()

        run(main())


# -- parity with the JAX package -----------------------------------------------

#: One fake-clock script: ``(seconds to advance, key)`` per call.
SCRIPT = [(0.0, "a"), (0.0, "a"), (0.0, "a"), (0.05, "a"), (0.0, "b"),
          (0.3, "a"), (0.0, "vip"), (0.0, "vip"), (0.01, "vip"), (1.7, "a"),
          (0.0, "a"), (0.0, "a"), (61.0, "c"), (0.0, "a"), (0.2, "b"),
          (3600.0, "a"), (0.0, "a"), (0.0, "vip")]


def run_script(limiter_or_tracker, clock, method: str = "allow") -> list:
    out = []
    for dt, key in SCRIPT:
        clock.t += dt
        out.append(getattr(limiter_or_tracker, method)(key))
    return out


class TestParityWithJax:
    @pytest.mark.parametrize("default,per_key", [
        ((10.0, 3.0), {}),
        ((2.0, 0.0), {"vip": (100.0, 5.0)}),
        ((0.5, 1.0), {"a": (4.0, 0.0), "b": (0.25, 2.0)}),
    ], ids=["burst3", "vip", "per-key"])
    def test_rate_limiter_sequence(self, default, per_key):
        clocks = FakeClock(), FakeClock()
        jax_limiter = jax_rl.RateLimiter(
            jax_rl.RateLimit(*default),
            per_key={k: jax_rl.RateLimit(*v) for k, v in per_key.items()},
            clock=clocks[0])
        port_limiter = RateLimiter(
            RateLimit(*default),
            per_key={k: RateLimit(*v) for k, v in per_key.items()},
            clock=clocks[1])
        want = run_script(jax_limiter, clocks[0])
        got = run_script(port_limiter, clocks[1])
        assert got == want
        assert any(not allowed for allowed, _ in got)
        assert port_limiter._buckets == jax_limiter._buckets

    @pytest.mark.parametrize("method", ["allow", "would_allow"])
    @pytest.mark.parametrize("default,per_key", [
        ((3, 60.0), {}),
        (None, {"a": (2, 10.0), "vip": (5, 3600.0)}),
        ((1, 1.0), {"b": (4, 100.0)}),
    ], ids=["window60", "none-default", "short-window"])
    def test_quota_tracker_sequence(self, default, per_key, method):
        clocks = FakeClock(), FakeClock()
        trackers = [
            mod.QuotaTracker(
                mod.Quota(*default) if default else None,
                per_key={k: mod.Quota(*v) for k, v in per_key.items()},
                clock=clock)
            for mod, clock in ((jax_rl, clocks[0]), (rl, clocks[1]))]
        want = run_script(trackers[0], clocks[0], method)
        got = run_script(trackers[1], clocks[1], method)
        assert got == want
        assert trackers[1]._windows == trackers[0]._windows

    @pytest.mark.parametrize("parser,spec", [
        ("parse_rate_limits", "partner=50:100, free=2"),
        ("parse_rate_limits", ""),
        ("parse_rate_limits", "k-rate=20:10"),
        ("parse_rate_limits", "no-rate"),
        ("parse_rate_limits", "=5"),
        ("parse_rate_limits", "k=0"),
        ("parse_rate_limits", "k=fast"),
        ("parse_rate_limits", "k=1:x"),
        ("parse_quotas", "partner=100000/86400, free=10"),
        ("parse_quotas", "k-quota=16/3600"),
        ("parse_quotas", "nokey"),
        ("parse_quotas", "k="),
        ("parse_quotas", "k=0"),
        ("parse_quotas", "k=5/-1"),
        ("parse_quota", "100"),
        ("parse_quota", "5/86400"),
        ("parse_quota", ""),
        ("parse_quota", "lots"),
        ("parse_quota", "0"),
        ("parse_quota", "3/0"),
    ])
    def test_parsers_accept_and_refuse_alike(self, parser, spec):
        def outcome(mod):
            try:
                value = getattr(mod, parser)(spec)
            except ValueError as exc:
                return "error", str(exc)
            if isinstance(value, dict):
                return "ok", {k: vars(v) for k, v in value.items()}
            return "ok", vars(value)

        assert outcome(rl) == outcome(jax_rl)


#: One request script against both gateways: (method, path, key).
GATEWAY_SCRIPT = (
    [("POST", "/v1/api/run", None), ("POST", "/v1/api/run", "nope"),
     ("GET", "/v1/taskmanagement/task/x", None), ("GET", "/healthz", None),
     ("GET", "/metrics", "nope")]
    + [("POST", "/v1/api/run", "k-rate")] * 4
    + [("POST", "/v1/api/run", "k-quota")] * 5
    + [("GET", "/v1/taskmanagement/task/x", "k-quota"),
       ("GET", "/v1/taskstore/task?taskId=x", "k-quota"),
       ("POST", "/v1/api/sync", "k-open"), ("POST", "/v1/api/sync", None),
       ("GET", "/v1/taskstore/task?taskId=x", None)]
    + [("POST", "/v1/api/run", "k-open")] * 3)


class TestGatewayParityWithJax:
    def test_statuses_retry_after_and_errors_are_jax_s(self):
        """The same keys, limiter, quotas and request script give the same
        status, ``Retry-After`` and error body from JAX's gateway and the
        port's."""
        from ai4e_tpu.platform_assembly import LocalPlatform as JaxPlatform
        from ai4e_tpu.platform_assembly import \
            PlatformConfig as JaxPlatformConfig
        from ai4e_tpu.taskstore.http import make_app as jax_make_app

        def configure(platform, mod, make):
            platform.gateway.set_api_keys({"k-open", "k-rate", "k-quota"})
            platform.gateway.set_rate_limiter(mod.RateLimiter(
                mod.RateLimit(rps=1e9),
                per_key={"k-rate": mod.RateLimit(rps=0.01, burst=2)}))
            platform.gateway.set_quota_tracker(mod.QuotaTracker(
                None, per_key={"k-quota": mod.Quota(3, 3600.0)}))
            platform.publish_async_api("/v1/api/run",
                                       "http://127.0.0.1:1/v1/api/run")
            platform.publish_sync_api("/v1/api/sync",
                                      "http://127.0.0.1:1/v1/api/sync")
            make(platform.store, app=platform.gateway.app)
            return platform

        async def answers(app) -> list:
            gw = await serve(app)
            out = []
            try:
                for method, path, key in GATEWAY_SCRIPT:
                    headers = {"X-Api-Key": key} if key else {}
                    r = await gw.request(method, path, data=b"x",
                                         headers=headers)
                    body = await r.read()
                    error = None
                    if r.status in (401, 403, 429):
                        error = (await r.json())["error"]
                    out.append((method, path, key, r.status,
                                r.headers.get("Retry-After"), error,
                                len(body) > 0))
            finally:
                await gw.close()
            return out

        async def main():
            jax_platform = configure(
                JaxPlatform(JaxPlatformConfig(retry_delay=0.05)), jax_rl,
                jax_make_app)
            port_platform = configure(keyed_platform(keys=()), rl, make_app)
            want = await answers(jax_platform.gateway.app)
            got = await answers(port_platform.gateway.app)
            assert got == want
            # Every answer of the middleware, and the routes behind it.
            assert {row[3] for row in got} == {200, 204, 401, 403, 429, 502}
            assert {row[4] for row in got if row[3] in (403, 429)} == {
                "3600", "100"}

        run(main())


# -- each package's keyed store client against the other's control plane -------


class TestInteroperability:
    def test_jax_client_against_the_port_s_keyed_control_plane(self):
        from ai4e_tpu.service.task_manager import \
            HttpTaskManager as JaxTaskManager

        async def main():
            platform = keyed_platform(keys=("k1", "k2"))
            make_app(platform.store, app=platform.gateway.app)
            gw = await serve(platform.gateway.app)
            base = str(gw.make_url("")).rstrip("/")
            try:
                tm = JaxTaskManager(base, api_key="k2")
                task = await tm.add_task("/v1/x", b"payload")
                assert platform.store.get(task["TaskId"]).body == b"payload"
                await tm.update_task_status(task["TaskId"], "running - x")
                got = await tm.get_task_status(task["TaskId"])
                assert got["Status"] == "running - x"
                await tm.close()
                wrong = JaxTaskManager(base, api_key="nope")
                with pytest.raises(Exception) as exc:
                    await wrong.add_task("/v1/x", b"payload")
                assert "401" in str(exc.value)
                await wrong.close()
            finally:
                await gw.close()

        run(main())

    def test_port_client_against_jax_s_keyed_control_plane(self):
        from ai4e_tpu.platform_assembly import LocalPlatform as JaxPlatform
        from ai4e_tpu.platform_assembly import \
            PlatformConfig as JaxPlatformConfig
        from ai4e_tpu.taskstore.http import make_app as jax_make_app
        from ai4e_tpu_torch.service.task_manager import (HttpResultStore,
                                                         HttpTaskManager)

        async def main():
            platform = JaxPlatform(JaxPlatformConfig(retry_delay=0.05))
            platform.gateway.set_api_keys({"k1"})
            jax_make_app(platform.store, app=platform.gateway.app)
            gw = await serve(platform.gateway.app)
            base = str(gw.make_url("")).rstrip("/")
            try:
                tm = HttpTaskManager(base, api_key="k1")
                results = HttpResultStore(base, api_key="k1")
                task = await tm.add_task("/v1/x", b"payload")
                await results.set_result(task["TaskId"], b'{"r": 2}')
                await tm.complete_task(task["TaskId"], "completed - r")
                record = platform.store.get(task["TaskId"])
                assert record.canonical_status == "completed"
                assert platform.store.get_result(task["TaskId"])[0] == \
                    b'{"r": 2}'
                await tm.close()
                await results.close()
                wrong = HttpTaskManager(base, api_key="nope")
                with pytest.raises(Exception) as exc:
                    await wrong.add_task("/v1/x", b"payload")
                assert "401" in str(exc.value)
                await wrong.close()
                # And keyless: 401 as well.
                r = await gw.post("/v1/taskstore/upsert",
                                  json={"Endpoint": "/v1/x", "Body": "b"})
                assert r.status == 401
            finally:
                await gw.close()

        run(main())


# -- the worker's admin verbs ---------------------------------------------------


def echo_worker(tmp_path, admin_api_keys=None):
    from ai4e_tpu_torch.metrics import MetricsRegistry
    from ai4e_tpu_torch.runtime.batcher import MicroBatcher
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime
    from ai4e_tpu_torch.runtime.worker import InferenceWorker
    from ai4e_tpu_torch.service import LocalTaskManager
    from ai4e_tpu_torch.taskstore import InMemoryTaskStore

    runtime = ModelRuntime(device="cpu")
    servable = runtime.register(build_servable("echo", name="echo", size=8,
                                               buckets=(1, 4)))
    metrics = MetricsRegistry()
    batcher = MicroBatcher(runtime, max_wait_ms=1.0, metrics=metrics)
    store = InMemoryTaskStore()
    worker = InferenceWorker("w", runtime, batcher,
                             task_manager=LocalTaskManager(store),
                             prefix="v1/echo", metrics=metrics, store=store,
                             checkpoint_root=str(tmp_path),
                             admin_api_keys=admin_api_keys)
    worker.serve_model(servable, sync_path="/run", async_path="/run-async")
    return worker, batcher


class TestWorkerAdminGate:
    @pytest.mark.parametrize("header", ["Ocp-Apim-Subscription-Key",
                                        "X-Api-Key"])
    def test_reload_drain_resume_need_a_key(self, tmp_path, header):
        from ai4e_tpu_torch.convert import save_npz

        npz = str(tmp_path / "echo_v2.npz")
        save_npz({"scale": np.array(2.0, np.float32)}, npz)

        async def main():
            worker, batcher = echo_worker(tmp_path, {"sek", "other"})
            await batcher.start()
            client = await serve(worker.service.app)
            key = {header: "sek"}
            payload = npy(np.arange(8, dtype=np.float32))
            try:
                verbs = [("/v1/echo/models/echo/reload",
                          {"checkpoint": npz}),
                         ("/v1/echo/worker/drain", None),
                         ("/v1/echo/worker/resume", None)]
                for path, body in verbs:
                    for bad in ({}, {header: "wrong"}):
                        r = await client.post(path, json=body, headers=bad)
                        assert r.status == 401, path
                        assert (await r.json())["error"] == (
                            "missing or invalid subscription key")
                assert worker.drain_state.state == "active"
                assert worker.runtime.models["echo"].params_version == 1
                # The open surface: listing, drain status, inference.
                assert (await client.get("/v1/echo/models")).status == 200
                assert (await client.get(
                    "/v1/echo/worker/drain")).status == 200
                r = await client.post("/v1/echo/run", data=payload)
                assert (await r.json())["echo"][:3] == [0.0, 1.0, 2.0]
                r = await client.post("/v1/echo/run-async", data=payload)
                assert r.status == 200
                for path, body in verbs:
                    r = await client.post(path, json=body, headers=key)
                    assert r.status == 200, (path, await r.text())
                assert worker.runtime.models["echo"].params_version == 2
                assert worker.drain_state.state == "active"
                r = await client.post("/v1/echo/run", data=payload)
                assert (await r.json())["echo"][:3] == [0.0, 2.0, 4.0]
            finally:
                await client.close()
                await batcher.stop()

        run(main())

    def test_no_keys_means_open_verbs(self, tmp_path):
        async def main():
            worker, batcher = echo_worker(tmp_path)
            await batcher.start()
            client = await serve(worker.service.app)
            try:
                for path in ("/v1/echo/worker/drain",
                             "/v1/echo/worker/resume"):
                    assert (await client.post(path)).status == 200
            finally:
                await client.close()
                await batcher.stop()

        run(main())


# -- the CLI ---------------------------------------------------------------------


class TestCli:
    ROUTES = {"apis": [{"prefix": "/v1/pub/run", "backend":
                        "http://127.0.0.1:1/v1/be/run", "mode": "async"}]}

    @pytest.mark.parametrize("keys", [" ", " , ,", ","])
    def test_set_but_empty_keys_fail_closed(self, keys):
        from ai4e_tpu_torch.cli import build_control_plane

        config = FrameworkConfig.from_env({"AI4E_GATEWAY_API_KEYS": keys})
        with pytest.raises(ConfigError, match="contains no keys"):
            build_control_plane(config, self.ROUTES)

    @pytest.mark.parametrize("keys", [" ", " , ,", ","])
    def test_worker_refuses_set_but_empty_keys(self, keys, tmp_path):
        """The same list gates the worker's admin verbs: set but empty, the
        worker does not start with its verbs open."""
        from ai4e_tpu_torch.cli import build_worker

        config = FrameworkConfig.from_env({
            "AI4E_GATEWAY_API_KEYS": keys,
            "AI4E_RUNTIME_CHECKPOINT_DIR": str(tmp_path)})
        with pytest.raises(ConfigError, match="contains no keys"):
            build_worker({"models": [{"family": "echo", "name": "echo",
                                      "size": 8, "buckets": [4],
                                      "sync_path": "/run"}]},
                         device="cpu", config=config)

    def test_control_plane_wires_keys_limits_and_quotas(self):
        from ai4e_tpu_torch.cli import build_control_plane

        config = FrameworkConfig.from_env({
            "AI4E_GATEWAY_API_KEYS": "k-open, k-rate,k-quota",
            "AI4E_GATEWAY_RATE_LIMITS": "k-rate=20:10",
            "AI4E_GATEWAY_QUOTAS": "k-quota=16/3600"})
        gw = build_control_plane(config, self.ROUTES).gateway
        assert gw._api_keys == {"k-open", "k-rate", "k-quota"}
        # Per-key limits alone: the others get an effectively unlimited
        # default, and no default quota.
        assert gw._rate_limiter.default.rps == 1e9
        assert vars(gw._rate_limiter.per_key["k-rate"]) == {
            "rps": 20.0, "burst": 10.0}
        assert gw._quota_tracker.default is None
        assert gw._quota_tracker.per_key["k-quota"].requests == 16
        config = FrameworkConfig.from_env({
            "AI4E_GATEWAY_RATE_LIMIT_RPS": "5",
            "AI4E_GATEWAY_RATE_LIMIT_BURST": "7",
            "AI4E_GATEWAY_QUOTA": "100/60"})
        gw = build_control_plane(config, self.ROUTES).gateway
        assert gw._api_keys is None
        assert vars(gw._rate_limiter.default) == {"rps": 5.0, "burst": 7.0}
        assert vars(gw._quota_tracker.default) == {"requests": 100,
                                                   "window_seconds": 60.0}
        plain = build_control_plane(FrameworkConfig(), self.ROUTES).gateway
        assert (plain._api_keys, plain._rate_limiter,
                plain._quota_tracker) == (None, None, None)

    @pytest.mark.parametrize("raw,want", [
        (None, None), ("k1", "k1"), (",k2,k3", "k2"), (" , k4 ", "k4"),
        (",", None)])
    def test_worker_takes_the_first_non_empty_store_key(self, raw, want):
        from ai4e_tpu_torch.cli import _stores

        env = {} if raw is None else {"AI4E_SERVICE_TASKSTORE_API_KEY": raw}
        tm, results = _stores({"taskstore": "http://127.0.0.1:1"},
                              FrameworkConfig.from_env(env))
        for client in (tm, results):
            assert client._holder._headers == (
                {"Ocp-Apim-Subscription-Key": want} if want else None)

    def test_build_worker_wires_the_admin_keys(self, tmp_path):
        from ai4e_tpu_torch.cli import build_worker

        cfg = FrameworkConfig.from_env({
            "AI4E_RUNTIME_CHECKPOINT_DIR": str(tmp_path),
            "AI4E_GATEWAY_API_KEYS": "sk-1, sk-2"})
        worker, _, _ = build_worker({"models": []}, device="cpu", config=cfg)
        assert worker._checkpoint_root == os.path.realpath(str(tmp_path))
        assert worker._admin_keys == {"sk-1", "sk-2"}
        open_worker, _, _ = build_worker({"models": []}, device="cpu")
        assert open_worker._admin_keys is None
