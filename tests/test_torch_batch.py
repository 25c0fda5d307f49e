"""The port's batch API (``InferenceWorker.serve_batch``) and its batcher's
priority classes against the JAX package's.

The cases of ``tests/test_batch_api.py`` run on both workers, each behind
its own package's control plane in this process, with the same servables
(a float32 "square" model whose postprocess raises on an overflowing row,
the species ResNet on uint8 pixels, a token SeqFormer) and the same
stacks; the answers, statuses and stored results must agree. The priority
classes are held against JAX's ``MicroBatcher`` directly: the same pending
requests (classes, ages) give the same batch cut under strict priority and
under aging, and the same submits are refused at the background cap."""

import asyncio
import io
import json
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.runtime.batcher as jax_batcher_mod
from ai4e_tpu.metrics import MetricsRegistry as JaxMetrics
from ai4e_tpu.parallel import MeshSpec, make_mesh
from ai4e_tpu.platform_assembly import LocalPlatform as JaxPlatform
from ai4e_tpu.platform_assembly import PlatformConfig as JaxPlatformConfig
from ai4e_tpu.runtime import InferenceWorker as JaxWorker
from ai4e_tpu.runtime import MicroBatcher as JaxBatcher
from ai4e_tpu.runtime import ModelRuntime as JaxRuntime
from ai4e_tpu.runtime import ServableModel as JaxServable
from ai4e_tpu.runtime import build_servable as jax_build
from ai4e_tpu.taskstore import TaskStatus
import ai4e_tpu_torch.runtime.batcher as port_batcher_mod
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
from ai4e_tpu_torch.runtime.batcher import BatcherSaturated, MicroBatcher
from ai4e_tpu_torch.runtime.families import build_servable
from ai4e_tpu_torch.runtime.registry import ModelRuntime, ServableModel
from ai4e_tpu_torch.runtime.worker import InferenceWorker

torch.set_num_threads(2)

SIZE = 8
RESNET = dict(name="cls", image_size=16, stage_sizes=(1,), width=8,
              num_classes=4, buckets=(4,))
TOKENS = dict(name="lctok", seq_len=SIZE, dim=16, depth=1, heads=2,
              num_classes=4, attention="full", vocab_size=10, buckets=(4,))
CONF_ATOL = 1e-2


def run(coro):
    return asyncio.run(coro)


def npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def square_postprocess(out):
    total = float(np.asarray(out).sum())
    if total > 1e6:
        raise ValueError("example overflow")  # the failure-isolation pill
    return {"sum_sq": total}


def square_preprocess(body, _content_type):
    return np.load(io.BytesIO(body))


def jax_square():
    return JaxServable(
        name="square", apply_fn=lambda params, batch: jnp.asarray(batch) ** 2,
        params={}, input_shape=(SIZE,), preprocess=square_preprocess,
        postprocess=square_postprocess, batch_buckets=(4, 16))


def port_square():
    return ServableModel(
        name="square", apply_fn=lambda module, batch: batch ** 2,
        module=torch.nn.Module(), input_shape=(SIZE,),
        preprocess=square_preprocess, postprocess=square_postprocess,
        batch_buckets=(4, 16))


def jax_runtime():
    return JaxRuntime(mesh=make_mesh(MeshSpec(dp=1),
                                     devices=jax.devices()[:1]))


#: Each package's pieces, for running one scenario on both.
JAX = SimpleNamespace(
    name="jax", Platform=JaxPlatform, PlatformConfig=JaxPlatformConfig,
    Worker=JaxWorker, Batcher=JaxBatcher, Metrics=JaxMetrics,
    runtime=jax_runtime, square=jax_square,
    build=lambda family, **kw: jax_build(family, **kw))
PORT = SimpleNamespace(
    name="port", Platform=LocalPlatform, PlatformConfig=PlatformConfig,
    Worker=InferenceWorker, Batcher=MicroBatcher, Metrics=MetricsRegistry,
    runtime=lambda: ModelRuntime(device="cpu"), square=port_square,
    build=lambda family, **kw: build_servable(family, **kw))


def port_on_jax_weights(family, jax_servable, **kw):
    """The port's servable of ``family`` on the JAX servable's weights."""
    servable = build_servable(family, **kw)
    servable.module.load_state_dict(servable.state_dict_from_flax(
        jax.tree.map(np.asarray, jax_servable.params)))
    return servable


async def start(pkg, servable, prefix, **batch_kwargs):
    """A worker serving ``servable``'s batch API behind ``pkg``'s control
    plane; returns ``(platform, worker, batcher, client)``."""
    platform = pkg.Platform(pkg.PlatformConfig(retry_delay=0.05))
    runtime = pkg.runtime()
    runtime.register(servable)
    runtime.warmup()
    batcher = pkg.Batcher(runtime, max_wait_ms=1, max_pending=32,
                          metrics=pkg.Metrics())
    worker = pkg.Worker(f"{servable.name}-svc", runtime, batcher,
                        task_manager=platform.task_manager, prefix=prefix,
                        store=platform.store, metrics=pkg.Metrics())
    worker.serve_batch(servable, **batch_kwargs)
    await batcher.start()
    client = TestClient(TestServer(worker.service.app))
    await client.start_server()
    return platform, worker, batcher, client


async def stop(platform, batcher, *clients):
    await platform.stop()
    await batcher.stop()
    for c in clients:
        await c.close()


async def post_stack(pkg, servable, path, stacks, **batch_kwargs):
    """Each stack in turn to the sync batch endpoint: ``[(status, body)]``
    (JSON or text)."""
    platform, _, batcher, client = await start(pkg, servable, "v1/w",
                                               **batch_kwargs)
    out = []
    try:
        for stack in stacks:
            resp = await client.post(f"/v1/w/{path}", data=npy_bytes(stack))
            body = (await resp.json() if resp.status == 200
                    else await resp.text())
            out.append((resp.status, body))
    finally:
        await stop(platform, batcher, client)
    return out


async def async_stack(pkg, servable, body: bytes):
    """One body through a public async route to the async batch endpoint:
    ``(final status, stored result or None, statuses seen)``."""
    platform, _, batcher, client = await start(
        pkg, servable, "v1/w", max_items=64, progress_every=0.0)
    seen = []
    update = platform.store.update_status

    def spy(task_id, status, *args, **kwargs):
        seen.append(status)
        return update(task_id, status, *args, **kwargs)

    platform.store.update_status = spy
    platform.publish_async_api(
        "/v1/public/batch",
        str(client.make_url(f"/v1/w/{servable.name}-batch-async")))
    gw = TestClient(TestServer(platform.gateway.app))
    await gw.start_server()
    await platform.start()
    try:
        resp = await gw.post("/v1/public/batch", data=body)
        tid = (await resp.json())["TaskId"]
        r = await gw.get(f"/v1/taskmanagement/task/{tid}",
                         params={"wait": "30"})
        final = (await r.json())["Status"]
        stored = platform.store.get_result(tid)
        return final, (json.loads(stored[0]) if stored else None), seen
    finally:
        await stop(platform, batcher, gw, client)


@pytest.fixture(params=[JAX, PORT], ids=["jax", "port"])
def pkg(request):
    return request.param


class TestBatchSync:
    def test_stack_scored_in_one_request(self):
        stack = np.arange(3 * SIZE, dtype=np.float32).reshape(3, SIZE)
        (jax_status, want), = run(post_stack(JAX, jax_square(),
                                             "square-batch", [stack]))
        (status, got), = run(post_stack(PORT, port_square(), "square-batch",
                                        [stack]))
        assert status == jax_status == 200
        assert got == want
        assert got["count"] == 3 and got["failed"] == 0
        for i, item in enumerate(got["items"]):
            assert item["index"] == i
            assert item["result"]["sum_sq"] == float((stack[i] ** 2).sum())

    @pytest.mark.parametrize("stack", [
        np.zeros((3, SIZE + 1), np.float32), np.zeros((0, SIZE), np.float32),
        np.zeros((65, SIZE), np.float32)], ids=["shape", "empty", "max_items"])
    def test_bad_stack_rejected(self, stack):
        (jax_status, want), = run(post_stack(JAX, jax_square(),
                                             "square-batch", [stack],
                                             max_items=64))
        (status, got), = run(post_stack(PORT, port_square(), "square-batch",
                                        [stack], max_items=64))
        assert status == jax_status and status in (400, 500)
        assert got == want


class TestBatchAsync:
    def test_failure_isolation_progress_and_terminal_status(self):
        stack = np.ones((10, SIZE), np.float32)
        stack[4] = 1e4  # poison: postprocess raises for this image
        want = run(async_stack(JAX, jax_square(), npy_bytes(stack)))
        got = run(async_stack(PORT, port_square(), npy_bytes(stack)))
        assert got[0] == want[0] == "completed - 10 images, 1 errors"
        assert TaskStatus.canonical(got[0]) == "completed"
        assert got[1] == want[1]
        assert got[1]["count"] == 10 and got[1]["failed"] == 1
        assert "error" in got[1]["items"][4]
        progress = [s for s in got[2] if " batch " in s]
        assert progress[0] == "running - square batch 0/10"
        assert progress[-1] == "running - square batch 10/10"
        assert progress == [s for s in want[2] if " batch " in s]

    def test_bad_payload_fails_task(self):
        want = run(async_stack(JAX, jax_square(), b"not-an-npy"))
        got = run(async_stack(PORT, port_square(), b"not-an-npy"))
        assert got[0].startswith("failed - bad input")
        assert got[0] == want[0]
        assert got[1] is None


class TestPipelinedExecution:
    def test_many_concurrent_submits_all_resolve_correctly(self, pkg):
        async def main():
            platform, _, batcher, client = await start(pkg, pkg.square(),
                                                       "v1/w")
            try:
                gate = asyncio.Semaphore(24)  # under max_pending=32

                async def one(i):
                    x = np.full((SIZE,), float(i % 7), np.float32)
                    async with gate:
                        out = await batcher.submit("square", x)
                    assert out["sum_sq"] == float((x ** 2).sum()), (i, out)

                await asyncio.gather(*(one(i) for i in range(120)))
            finally:
                await stop(platform, batcher, client)

        run(main())

    def test_stack_items_submit_at_background_priority(self):
        async def main():
            platform, _, batcher, client = await start(PORT, port_square(),
                                                       "v1/w")
            priorities = []
            submit = batcher.submit

            async def spy(name, example, priority=0):
                priorities.append(priority)
                return await submit(name, example, priority=priority)

            batcher.submit = spy
            try:
                resp = await client.post(
                    "/v1/w/square-batch",
                    data=npy_bytes(np.ones((5, SIZE), np.float32)))
                assert resp.status == 200
            finally:
                await stop(platform, batcher, client)
            return priorities

        assert run(main()) == [1] * 5


class TestModelListing:
    def test_models_endpoint_lists_the_batch_routes(self, pkg):
        async def main():
            platform, _, batcher, client = await start(pkg, pkg.square(),
                                                       "v1/w")
            try:
                resp = await client.get("/v1/w/models")
                return (await resp.json())["models"]
            finally:
                await stop(platform, batcher, client)

        (model,) = run(main())
        assert model["endpoints"] == {
            "batch_sync": "/v1/w/square-batch",
            "batch_async": "/v1/w/square-batch-async"}


class TestUint8StackDecode:
    def test_float_stack_to_uint8_servable_is_scaled_not_truncated(self):
        jax_servable = jax_build("resnet", **RESNET)
        port = port_on_jax_weights("resnet", jax_servable, **RESNET)
        assert port.input_dtype == np.uint8
        stack = np.random.default_rng(1).uniform(
            0.2, 1.0, (3, 16, 16, 3)).astype(np.float32)
        (jax_status, want), = run(post_stack(JAX, jax_servable, "cls-batch",
                                             [stack]))
        (status, got), = run(post_stack(PORT, port, "cls-batch", [stack]))
        assert status == jax_status == 200
        assert got["count"] == want["count"] == 3
        assert got["failed"] == want["failed"] == 0
        for g, w in zip(got["items"], want["items"]):
            assert set(g["result"]) == set(w["result"]) == {
                "class_id", "label", "confidence"}
            assert abs(g["result"]["confidence"]
                       - w["result"]["confidence"]) < CONF_ATOL
        # A truncating cast would have zeroed the images: every item the
        # same answer, the zero image's.
        (_, zero), = run(post_stack(PORT, port, "cls-batch",
                                    [np.zeros((1, 16, 16, 3), np.uint8)]))
        assert any(g["result"] != zero["items"][0]["result"]
                   for g in got["items"])


class TestTokenStacks:
    def test_token_stack_scores_and_bad_ids_fail_loudly(self):
        jax_servable = jax_build("seqformer", **TOKENS)
        port = port_on_jax_weights("seqformer", jax_servable, **TOKENS)
        stack = np.random.default_rng(0).integers(0, 10, size=(3, SIZE),
                                                  dtype=np.uint16)
        bad = stack.copy()
        bad[1, 0] = 10  # == vocab_size: the embedding would clamp it
        wrap = stack.astype(np.int64)
        wrap[0, 0] = 2**32 + 3  # wraps into range under an int32 cast
        stacks = [stack, bad, wrap, stack.astype(np.float32)]
        want = run(post_stack(JAX, jax_servable, "lctok-batch", stacks,
                              max_items=16))
        got = run(post_stack(PORT, port, "lctok-batch", stacks,
                             max_items=16))
        assert [s for s, _ in got] == [s for s, _ in want]
        assert got[0][0] == 200
        assert got[0][1]["count"] == 3 and got[0][1]["failed"] == 0
        for item in got[0][1]["items"]:
            assert 0 <= item["result"]["class_id"] < 4
        for (status, text), (_, jax_text), word in zip(
                got[1:], want[1:], ("token ids", "token ids", "integer")):
            assert status in (400, 500)
            assert word in text and text == jax_text


# -- priority classes ---------------------------------------------------------


class FakeRuntime:
    """A runtime that returns its batch: enough for the batchers' cut and
    admission logic."""

    def __init__(self, buckets=(1, 4, 8)):
        self.models = {"m": SimpleNamespace(
            name="m", input_shape=(1,), input_dtype=np.float32,
            batch_buckets=tuple(buckets), max_bucket=buckets[-1])}

    def run_batch_report(self, name, batch):
        return batch, frozenset()

    def run_batch_phases(self, name, batch):
        return batch, frozenset(), {}


#: (priority, seconds waited) of each pending request, oldest first.
QUEUES = {
    "background-older": [(1, 3.0)] * 6 + [(0, 0.5)] * 5,
    "interleaved": [(1, 1.0), (0, 0.9), (1, 0.8), (0, 0.7), (1, 0.6),
                    (0, 0.5), (1, 0.4), (0, 0.3), (1, 0.2), (0, 0.1)],
    "aged-background": [(1, 9.0), (1, 5.0), (1, 1.0)] + [(0, 0.2)] * 8,
    "two-classes": [(2, 4.0), (1, 2.5), (2, 1.0)] + [(0, 0.1)] * 7,
    "fits-whole": [(1, 2.0), (0, 1.0), (1, 0.5)],
}


def cut(batcher_mod, batcher_cls, queue, aging, monkeypatch):
    """The first batch ``batcher_cls`` cuts from ``queue`` (each request
    tagged by its position), with the clock frozen."""
    now = 1000.0
    monkeypatch.setattr(time, "perf_counter", lambda: now)

    async def main():
        loop = asyncio.get_running_loop()
        metrics = (JaxMetrics() if batcher_cls is JaxBatcher
                   else MetricsRegistry())
        batcher = batcher_cls(FakeRuntime(), max_wait_ms=1, max_pending=64,
                              priority_aging_s=aging, metrics=metrics)
        batcher._pending["m"] = [
            batcher_mod._Pending(np.array([float(i)], np.float32),
                                 loop.create_future(), enqueued=now - waited,
                                 priority=prio)
            for i, (prio, waited) in enumerate(queue)]
        batch, bucket = batcher._take_batch("m")
        rest = batcher._pending["m"]
        return ([int(p.example[0]) for p in batch], bucket,
                [int(p.example[0]) for p in rest])

    return run(main())


class TestPriorityClasses:
    @pytest.mark.parametrize("aging", [0.0, 2.0], ids=["strict", "aging"])
    @pytest.mark.parametrize("queue", sorted(QUEUES))
    def test_same_cut_as_jax(self, queue, aging, monkeypatch):
        want = cut(jax_batcher_mod, JaxBatcher, QUEUES[queue], aging,
                   monkeypatch)
        got = cut(port_batcher_mod, MicroBatcher, QUEUES[queue], aging,
                  monkeypatch)
        assert got == want

    def test_strict_priority_takes_interactive_first(self, monkeypatch):
        batch, bucket, rest = cut(port_batcher_mod, MicroBatcher,
                                  QUEUES["background-older"], 0.0,
                                  monkeypatch)
        assert bucket == 8
        assert batch == [6, 7, 8, 9, 10, 0, 1, 2]
        assert rest == [3, 4, 5]

    def test_aging_lets_old_background_through(self, monkeypatch):
        batch, _, _ = cut(port_batcher_mod, MicroBatcher,
                          QUEUES["aged-background"], 2.0, monkeypatch)
        assert batch[:2] == [0, 1]  # waited 9 s and 5 s: aged past 0

    @pytest.mark.parametrize("reserve", [0.25, 0.5, 0.0])
    def test_background_cap_as_jax(self, reserve):
        """The same submits (6 background, then 3 interactive, then one
        more background) meet the same refusals at ``max_pending`` 8."""

        async def outcomes(batcher_cls, metrics):
            batcher = batcher_cls(FakeRuntime(), max_wait_ms=1, max_pending=8,
                                  interactive_reserve=reserve,
                                  metrics=metrics)
            pending, out = [], []
            for prio in [1] * 6 + [0] * 3 + [1]:
                task = asyncio.ensure_future(batcher.submit(
                    "m", np.zeros(1, np.float32), priority=prio))
                await asyncio.sleep(0)
                if task.done():
                    exc = task.exception()
                    out.append((prio, type(exc).__name__))
                else:
                    pending.append(task)
                    out.append((prio, "queued"))
            for task in pending:
                task.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
            return out

        want = run(outcomes(JaxBatcher, JaxMetrics()))
        got = run(outcomes(MicroBatcher, MetricsRegistry()))
        assert got == want
        cap = max(1, int(8 * (1 - reserve)))
        assert got[:6] == [(1, "queued")] * min(cap, 6) + \
            [(1, BatcherSaturated.__name__)] * (6 - min(cap, 6))
