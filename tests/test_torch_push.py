"""The port's push (webhook) transport (``ai4e_tpu_torch/broker/push.py``
and the push branch of ``platform_assembly``) held against the JAX
package's on the CPU. Each scenario of ``tests/test_push_transport.py``
runs on both packages' platforms and must give equal observations: the
handshake and a bad echo, the whole lifecycle, backpressure retried by the
topic, exhausted delivery failing the task, an unroutable subject, a
pipeline stage handed on, raw bytes in binary mode, a non-Latin-1
subject, the structured envelope, the window bound on in-flight
deliveries, buffering before start, the config plumbing and an unknown
transport. Beyond them: the events' wire forms are byte-equal, each
package's topic delivers to the other's webhook over HTTP, and a push
platform demoted and promoted again delivers through a new topic. Every
platform, topic and webhook counts into a registry of its own."""

from __future__ import annotations

import asyncio
import threading
import time
import types

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.broker.push as jax_push
import ai4e_tpu.config as jax_config
import ai4e_tpu.platform_assembly as jax_pa
import ai4e_tpu.service as jax_service
import ai4e_tpu.taskstore as jax_taskstore
import ai4e_tpu_torch.broker.push as port_push
import ai4e_tpu_torch.config as port_config
import ai4e_tpu_torch.platform_assembly as port_pa
import ai4e_tpu_torch.service as port_service
import ai4e_tpu_torch.taskstore as port_taskstore
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry

JAX = types.SimpleNamespace(push=jax_push, pa=jax_pa, config=jax_config,
                            service=jax_service, ts=jax_taskstore,
                            Registry=JaxRegistry)
PORT = types.SimpleNamespace(push=port_push, pa=port_pa, config=port_config,
                             service=port_service, ts=port_taskstore,
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


async def poll_until(client, task_id, predicate, timeout=10.0) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        body = await (await client.get(
            f"/v1/taskmanagement/task/{task_id}")).json()
        if predicate(body) or time.monotonic() > deadline:
            return body
        await asyncio.sleep(0.02)


def platform_of(ns, **config):
    return ns.pa.LocalPlatform(ns.pa.PlatformConfig(**config),
                               metrics=ns.Registry())


def service_of(ns, platform, name: str, prefix: str):
    """A service shell on the platform's task manager and registry."""
    return ns.service.APIService(name, prefix=prefix,
                                 task_manager=platform.task_manager,
                                 metrics=platform.metrics)


def push_counts(metrics, name: str) -> dict:
    """``{outcome: count}`` of one counter family, summed over its other
    labels."""
    out: dict = {}
    for _, _, labels, value in metrics.counter(name, "").collect():
        out[labels["outcome"]] = out.get(labels["outcome"], 0) + value
    return out


# -- the handshake -------------------------------------------------------


async def handshake_echo(ns):
    webhook = ns.push.WebhookDispatcher(
        ns.service.LocalTaskManager(ns.ts.InMemoryTaskStore()),
        metrics=ns.Registry())
    client = await serve(webhook.app)
    try:
        resp = await client.post("/api/events", json=[{
            "EventType": ns.push.VALIDATION_EVENT, "ValidationCode": "c0de"}])
        return resp.status, await resp.json()
    finally:
        await client.close()


def test_webhook_echoes_validation_code():
    assert on_both(handshake_echo) == (200, {"validationResponse": "c0de"})


async def bad_echo(ns):
    async def bad_handler(_request):
        return web.json_response({"validationResponse": "WRONG"})

    app = web.Application()
    app.router.add_post("/api/events", bad_handler)
    client = await serve(app)
    topic = ns.push.PushTopic(metrics=ns.Registry())
    try:
        with pytest.raises(ns.push.SubscriptionError) as err:
            await topic.subscribe("bad", str(client.make_url("/api/events")))
        return str(err.value).split(" echoed ")[1], topic._subscriptions
    finally:
        await topic.aclose()
        await client.close()


def test_subscribe_rejects_bad_echo():
    assert on_both(bad_echo) == ("a bad validation code", [])


async def failed_handshake_at_start(ns):
    """A webhook that answers the handshake with 500: ``start()`` raises
    ``SubscriptionError``, never falling back to the queue."""
    platform = platform_of(ns, transport="push")

    async def refuse(_request):
        return web.Response(status=500)

    app = web.Application()
    app.router.add_post("/api/events", refuse)
    bad = await serve(app)
    subscribe = platform.topic.subscribe

    async def to_refuse(name, _url):
        await subscribe(name, str(bad.make_url("/api/events")))

    platform.topic.subscribe = to_refuse
    try:
        with pytest.raises(ns.push.SubscriptionError) as err:
            await platform.start()
        return (str(err.value).endswith("returned 500"), platform.broker,
                platform.topic._subscriptions)
    finally:
        await platform.stop()
        await bad.close()


def test_a_failed_handshake_raises_at_start():
    assert on_both(failed_handshake_at_start) == (True, None, [])


# -- the platform end to end ---------------------------------------------


async def full_lifecycle(ns):
    platform = platform_of(ns, transport="push", retry_delay=0.05)
    svc = service_of(ns, platform, "detector", "v1/detector")

    @svc.api_async_func("/detect")
    def detect(taskId, body, content_type):
        asyncio.run(platform.task_manager.complete_task(
            taskId, f"completed - {len(body)} bytes scored"))

    svc_client = await serve(svc.app)
    platform.publish_async_api("/v1/camera-trap/detect",
                               str(svc_client.make_url("/v1/detector/detect")))
    gw = await serve(platform.gateway.app)
    await platform.start()
    try:
        resp = await gw.post("/v1/camera-trap/detect", data=b"JPEGDATA")
        created = await resp.json()
        final = await poll_until(gw, created["TaskId"],
                                 lambda b: "completed" in b["Status"])
        await platform.topic.drain(timeout=5.0)
        return (resp.status, created["Status"], final["Status"],
                push_counts(platform.metrics, "ai4e_push_deliveries_total"),
                push_counts(platform.metrics, "ai4e_webhook_forwards_total"))
    finally:
        await platform.stop()
        await gw.close()
        await svc_client.close()


def test_full_async_lifecycle_over_push():
    assert on_both(full_lifecycle) == (
        200, "created", "completed - 8 bytes scored", {"delivered": 1},
        {"delivered": 1})


async def backpressure(ns):
    """A cap-1 backend: the webhook passes 503 back as 429 and the topic's
    backoff retries each delivery until it lands."""
    platform = platform_of(ns, transport="push", retry_delay=0.05,
                           push_max_attempts=50)
    svc = service_of(ns, platform, "slow", "v1/slow")
    gate = threading.Semaphore(1)

    @svc.api_async_func("/work", maximum_concurrent_requests=1)
    def work(taskId, body, content_type):
        with gate:
            time.sleep(0.05)
        asyncio.run(platform.task_manager.complete_task(taskId, "completed"))

    svc_client = await serve(svc.app)
    platform.publish_async_api("/v1/public/work",
                               str(svc_client.make_url("/v1/slow/work")))
    gw = await serve(platform.gateway.app)
    await platform.start()
    try:
        ids = [(await (await gw.post("/v1/public/work",
                                     data=b"x")).json())["TaskId"]
               for _ in range(4)]
        finals = [(await poll_until(gw, t, lambda b: "completed"
                                    in b["Status"]))["Status"] for t in ids]
        await platform.topic.drain(timeout=5.0)
        deliveries = push_counts(platform.metrics,
                                 "ai4e_push_deliveries_total")
        forwards = push_counts(platform.metrics,
                               "ai4e_webhook_forwards_total")
        return (finals, deliveries["delivered"], deliveries.get("retry", 0) > 0,
                forwards.get("backpressure") == deliveries.get("retry"),
                "dead_letter" in deliveries)
    finally:
        await platform.stop()
        await gw.close()
        await svc_client.close()


def test_backpressure_retries_via_topic():
    assert on_both(backpressure) == (["completed"] * 4, 4, True, True, False)


async def exhausted(ns):
    """An unreachable backend: after ``push_max_attempts`` the event
    dead-letters and the platform fails the task."""
    platform = platform_of(ns, transport="push", retry_delay=0.02,
                           push_max_attempts=2)
    platform.publish_async_api("/v1/public/never",
                               "http://127.0.0.1:1/v1/never")
    gw = await serve(platform.gateway.app)
    await platform.start()
    try:
        tid = (await (await gw.post("/v1/public/never",
                                    data=b"x")).json())["TaskId"]
        final = await poll_until(gw, tid, lambda b: "failed" in b["Status"])
        return (final["Status"],
                push_counts(platform.metrics, "ai4e_push_deliveries_total"),
                push_counts(platform.metrics, "ai4e_webhook_forwards_total"))
    finally:
        await platform.stop()
        await gw.close()


def test_exhausted_delivery_fails_task():
    status, deliveries, forwards = on_both(exhausted)
    assert "failed" in status
    assert deliveries == {"retry": 1, "dead_letter": 1}
    assert forwards == {"unreachable": 2}


async def unroutable(ns):
    platform = platform_of(ns, transport="push")
    # On the gateway only: the webhook has no backend for it.
    platform.gateway.add_async_route("/v1/public/ghost",
                                     "http://127.0.0.1:1/v1/ghost/run")
    gw = await serve(platform.gateway.app)
    await platform.start()
    try:
        tid = (await (await gw.post("/v1/public/ghost",
                                    data=b"x")).json())["TaskId"]
        final = await poll_until(gw, tid, lambda b: "failed" in b["Status"])
        return (final["Status"],
                push_counts(platform.metrics, "ai4e_webhook_forwards_total"))
    finally:
        await platform.stop()
        await gw.close()


def test_unroutable_subject_fails_task():
    status, forwards = on_both(unroutable)
    assert status == ("failed - no backend route for "
                      "http://127.0.0.1:1/v1/ghost/run")
    assert forwards == {"unroutable": 1}


async def pipeline(ns):
    """A stage republishes under the same TaskId; the webhook routes the
    next stage to its backend and the store replays the original body."""
    platform = platform_of(ns, transport="push", retry_delay=0.05)
    seen = {}
    det = service_of(ns, platform, "det", "v1/det")
    cls = service_of(ns, platform, "cls", "v1/cls")

    @det.api_async_func("/detect")
    def detect(taskId, body, content_type):
        asyncio.run(platform.task_manager.add_pipeline_task(taskId,
                                                            cls_backend))

    @cls.api_async_func("/classify")
    def classify(taskId, body, content_type):
        seen["stage2_body"] = body
        asyncio.run(platform.task_manager.complete_task(
            taskId, "completed - classified"))

    det_client = await serve(det.app)
    cls_client = await serve(cls.app)
    cls_backend = str(cls_client.make_url("/v1/cls/classify"))
    platform.publish_async_api("/v1/pipeline/detect",
                               str(det_client.make_url("/v1/det/detect")))
    platform.webhook.add_route("/v1/cls/classify", cls_backend)
    gw = await serve(platform.gateway.app)
    await platform.start()
    try:
        tid = (await (await gw.post("/v1/pipeline/detect",
                                    data=b"ORIGINAL-IMG")).json())["TaskId"]
        final = await poll_until(gw, tid,
                                 lambda b: "completed" in b["Status"])
        return final["Status"], seen.get("stage2_body")
    finally:
        await platform.stop()
        await gw.close()
        await det_client.close()
        await cls_client.close()


def test_pipeline_over_push():
    assert on_both(pipeline) == ("completed - classified", b"ORIGINAL-IMG")


async def prestart(ns):
    """A task accepted before ``start()`` waits in the topic's backlog and
    is delivered once the subscription validates."""
    platform = platform_of(ns, transport="push", retry_delay=0.05)
    svc = service_of(ns, platform, "svc", "v1/svc")

    @svc.api_async_func("/work")
    def work(taskId, body, content_type):
        asyncio.run(platform.task_manager.complete_task(
            taskId, "completed - buffered"))

    svc_client = await serve(svc.app)
    platform.publish_async_api("/v1/public/work",
                               str(svc_client.make_url("/v1/svc/work")))
    gw = await serve(platform.gateway.app)
    try:
        created = await (await gw.post("/v1/public/work", data=b"x")).json()
        backlog = len(platform.topic._backlog)
        await platform.start()
        final = await poll_until(gw, created["TaskId"],
                                 lambda b: "completed" in b["Status"])
        return created["Status"], backlog, final["Status"]
    finally:
        await platform.stop()
        await gw.close()
        await svc_client.close()


def test_task_accepted_before_start_is_delivered():
    assert on_both(prestart) == ("created", 1, "completed - buffered")


# -- binary content mode and the window ----------------------------------


async def recording_backend(received: dict) -> TestClient:
    async def backend(request):
        received["body"] = await request.read()
        received["task_id"] = request.headers.get("taskId")
        received["content_type"] = request.headers.get("Content-Type")
        received["query"] = request.query_string
        received["b3"] = "X-B3-TraceId" in request.headers
        return web.Response(status=200)

    app = web.Application()
    app.router.add_post("/v1/m/score", backend)
    return await serve(app)


async def raw_delivery(ns, endpoint: str, body: bytes, ctype: str | None,
                       webhook_ns=None):
    """One task published on ``ns``'s topic to ``webhook_ns``'s webhook
    (default: ``ns``'s) in front of a recording backend; what the backend
    received, and the dead letters."""
    webhook_ns = webhook_ns or ns
    received: dict = {}
    be = await recording_backend(received)
    store = webhook_ns.ts.InMemoryTaskStore()
    webhook = webhook_ns.push.WebhookDispatcher(
        webhook_ns.service.LocalTaskManager(store),
        metrics=webhook_ns.Registry())
    webhook.add_route("/v1/m/score", str(be.make_url("/v1/m/score")))
    wh = await serve(webhook.app)
    topic = ns.push.PushTopic(retry_delay=0.02, ttl_seconds=2.0,
                              metrics=ns.Registry())
    topic.bind_loop(asyncio.get_running_loop())
    dead = []
    topic.set_dead_letter_handler(lambda ev: dead.append(ev.id))
    try:
        await topic.subscribe("wh", str(wh.make_url("/api/events")))
        task = store.upsert(webhook_ns.ts.APITask(
            endpoint=endpoint, body=body,
            **({"content_type": ctype} if ctype else {})))
        topic.publish(task)
        await topic.drain(timeout=5.0)
        received["task_id"] = received.get("task_id") == task.task_id
        return received, dead
    finally:
        await topic.aclose()
        await wh.close()
        await be.close()


RAW = bytes(range(256)) * 2


def test_task_events_ship_raw_bytes():
    received, dead = on_both(raw_delivery, "http://edge/v1/m/score", RAW,
                             "application/octet-stream")
    assert received == {"body": RAW, "task_id": True,
                        "content_type": "application/octet-stream",
                        "query": "", "b3": True}
    assert dead == []


def test_non_latin1_subject_delivers():
    received, dead = on_both(
        raw_delivery, "http://edge/v1/m/score?región=añejo&pct=5%25",
        b"payload", None)
    assert received["body"] == b"payload"
    # aiohttp hands the backend the decoded query string.
    assert received["query"] == "región=añejo&pct=5%"
    assert dead == []


@pytest.mark.parametrize("topic_of,webhook_of", [("jax", "port"),
                                                 ("port", "jax")],
                         ids=["jax-topic-to-port-webhook",
                              "port-topic-to-jax-webhook"])
def test_each_package_s_topic_delivers_to_the_other_s_webhook(topic_of,
                                                              webhook_of):
    ns = {"jax": JAX, "port": PORT}
    for endpoint, body in (("http://edge/v1/m/score", RAW),
                           ("http://edge/v1/m/score?región=añejo", b"p")):
        got = run(raw_delivery(ns[topic_of], endpoint, body,
                               "application/octet-stream",
                               webhook_ns=ns[webhook_of]))
        want = run(raw_delivery(ns[webhook_of], endpoint, body,
                                "application/octet-stream"))
        assert got == want
        assert got[0]["body"] == body and got[1] == []


async def structured(ns):
    received: dict = {}
    be = await recording_backend(received)
    webhook = ns.push.WebhookDispatcher(
        ns.service.LocalTaskManager(ns.ts.InMemoryTaskStore()),
        metrics=ns.Registry())
    webhook.add_route("/v1/m/score", str(be.make_url("/v1/m/score")))
    wh = await serve(webhook.app)
    try:
        resp = await wh.post("/api/events", json=[{
            "Id": "tid-1", "Subject": "http://edge/v1/m/score",
            "EventType": "ai4e.task.created", "Data": "hello"}])
        return resp.status, received["body"], received["task_id"]
    finally:
        await wh.close()
        await be.close()


def test_structured_envelope_still_accepted():
    assert on_both(structured) == (200, b"hello", "tid-1")


async def window(ns):
    """``window=2`` with a gate holding deliveries open: at most two are
    ever in the subscriber at once."""
    in_flight = {"now": 0, "max": 0}
    gate = asyncio.Event()

    async def handshake_or_slow(request):
        if request.headers.get("X-AI4E-Event-Type"):
            await request.read()
            in_flight["now"] += 1
            in_flight["max"] = max(in_flight["max"], in_flight["now"])
            await gate.wait()
            in_flight["now"] -= 1
            return web.Response(status=200)
        body = await request.json()
        return web.json_response(
            {"validationResponse": body[0]["ValidationCode"]})

    app = web.Application()
    app.router.add_post("/api/events", handshake_or_slow)
    sub = await serve(app)
    topic = ns.push.PushTopic(retry_delay=0.02, window=2,
                              metrics=ns.Registry())
    topic.bind_loop(asyncio.get_running_loop())
    try:
        await topic.subscribe("wh", str(sub.make_url("/api/events")))
        store = ns.ts.InMemoryTaskStore()
        for i in range(6):
            topic.publish(store.upsert(ns.ts.APITask(
                endpoint=f"http://edge/v1/m/{i}", body=b"x")))
        await asyncio.sleep(0.3)
        held = (in_flight["max"], topic.pending)
        gate.set()
        await topic.drain(timeout=5.0)
        return held, in_flight["max"], topic.pending
    finally:
        await topic.aclose()
        await sub.close()


def test_delivery_window_bounds_in_flight():
    assert on_both(window) == ((2, 6), 2, 0)


# -- the wire forms --------------------------------------------------------

EVENTS = [
    dict(id="t-1", subject="http://edge/v1/m/score", data=RAW,
         content_type="application/octet-stream", event_time=1700000000.25),
    dict(id="t-2", subject="/v1/m/score/tile?región=añejo&pct=5%25",
         data=b'{"a": 1}', event_time=1700000001.0),
    dict(id="t-3", subject="", data=b"", content_type="",
         event_type="ai4e.subscription.validation", event_time=0.5),
]


@pytest.mark.parametrize("fields", EVENTS, ids=["raw", "quoted", "empty"])
def test_wire_forms_are_byte_equal_to_jax_s(fields):
    want = jax_push.PushEvent(**fields)
    got = port_push.PushEvent(**fields)
    assert got.to_wire() == want.to_wire()
    assert got.to_headers() == want.to_headers()
    assert got.headers_for_attempt(3) == want.headers_for_attempt(3)
    headers = want.headers_for_attempt(2)
    assert vars(port_push.PushEvent.from_headers(headers, want.data)) == vars(
        jax_push.PushEvent.from_headers(headers, want.data))
    round_trip = port_push.PushEvent.from_headers(got.headers_for_attempt(2),
                                                  got.data)
    assert (round_trip.subject, round_trip.data, round_trip.attempts) == (
        fields["subject"], fields["data"], 2)
    assert vars(port_push.PushEvent.from_wire(want.to_wire())) == vars(
        jax_push.PushEvent.from_wire(want.to_wire()))


# -- demotion and promotion ----------------------------------------------


async def demote_then_promote(ns, tmp):
    """A journaled push platform delivers, is demoted (its topic and
    webhook closed), promoted again and delivers through a new topic."""
    platform = platform_of(ns, transport="push", retry_delay=0.05,
                           journal_path=str(tmp / f"{ns is PORT}.jsonl"))
    svc = service_of(ns, platform, "svc", "v1/svc")

    @svc.api_async_func("/work")
    def work(taskId, body, content_type):
        asyncio.run(platform.task_manager.complete_task(
            taskId, f"completed - {body.decode()}"))

    svc_client = await serve(svc.app)
    platform.publish_async_api("/v1/public/work",
                               str(svc_client.make_url("/v1/svc/work")))
    gw = await serve(platform.gateway.app)
    await platform.start()
    try:
        first_topic = platform.topic
        tid = (await (await gw.post("/v1/public/work",
                                    data=b"one")).json())["TaskId"]
        one = (await poll_until(gw, tid, lambda b: "completed"
                                in b["Status"]))["Status"]
        await platform.demote_now(1)
        demoted = (platform.store.role, platform.topic, platform.webhook,
                   platform._webhook_runner, first_topic._closed)
        await platform.promote_now()
        fresh = (platform.topic is not None
                 and platform.topic is not first_topic)
        tid = (await (await gw.post("/v1/public/work",
                                    data=b"two")).json())["TaskId"]
        two = (await poll_until(gw, tid, lambda b: "completed"
                                in b["Status"]))["Status"]
        return (one, demoted, platform.store.role, platform.store.epoch,
                fresh, two)
    finally:
        await platform.stop()
        platform.store.close()
        await gw.close()
        await svc_client.close()


def test_a_demoted_then_promoted_platform_delivers_with_a_fresh_topic(
        tmp_path):
    assert on_both(demote_then_promote, tmp_path) == (
        "completed - one", ("follower", None, None, None, True), "primary",
        2, True, "completed - two")


# -- config ----------------------------------------------------------------


def test_transport_type_from_env():
    env = {"AI4E_PLATFORM_TRANSPORT": "push",
           "AI4E_PLATFORM_PUSH_MAX_ATTEMPTS": "7"}
    pc = port_config.FrameworkConfig.from_env(env).to_platform_config()
    want = jax_config.FrameworkConfig.from_env(env).to_platform_config()
    assert (pc.transport, pc.push_max_attempts) == ("push", 7)
    assert (pc.transport, pc.push_max_attempts, pc.push_ttl_seconds,
            pc.push_window) == (want.transport, want.push_max_attempts,
                                want.push_ttl_seconds, want.push_window)


def test_unknown_transport_rejected():
    with pytest.raises(ValueError) as want:
        jax_pa.LocalPlatform(jax_pa.PlatformConfig(
            transport="carrier-pigeon"), metrics=JaxRegistry())
    with pytest.raises(ValueError, match="unknown transport") as got:
        port_pa.LocalPlatform(port_pa.PlatformConfig(
            transport="carrier-pigeon"), metrics=PortRegistry())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knob", [{"concurrency": 2}, {"retry_delay": 1.0},
                                  {"autoscale": "policy"}],
                         ids=["concurrency", "retry_delay", "autoscale"])
def test_push_refuses_queue_knobs_with_jax_s_text(knob):
    texts = []
    for ns in (JAX, PORT):
        platform = platform_of(ns, transport="push")
        with pytest.raises(ValueError) as err:
            platform.publish_async_api("/v1/p/x", "http://w/v1/x", **knob)
        texts.append(str(err.value))
    assert texts[0] == texts[1]
