"""The port's continuous-batching decode path (``runtime/decode.py``,
``runtime/kvcache.py``, ``InferenceWorker.serve_stream``), JAX-free but for
the interleaving explorer of the JAX package:

- the engine cases of ``tests/test_decode.py`` (slot pool, scheduling:
  joins, backpressure, deadline sweep, cancellation, hot-reload re-prefill,
  the late joiner against the whole-batch baseline) run against the port's
  engine with the same fake backend;
- ``serve_stream`` over aiohttp: completion with chunks, bad input, 503
  when saturated or draining, saturation after admission handed back to
  the broker, a drain under load, the LM reload verb;
- the CLI wiring with ``AI4E_RUNTIME_DECODE_ENABLE`` off and on;
- slot conservation under ``explore_interleavings`` (the fixed engine
  passes every schedule; the split-sweep revert is caught);
- ``cuda``-marked tests of the CUDA graphs, which skip without a card.
"""

import asyncio
import json
import logging
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu.analysis.race import explore_interleavings, yield_point
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.admission.deadline import DeadlineExceeded
from ai4e_tpu_torch.cli import build_worker
from ai4e_tpu_torch.config import FrameworkConfig
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.runtime.batcher import MicroBatcher
from ai4e_tpu_torch.runtime.decode import (DecodeEngine, DecodeSaturated,
                                           SlotError, SlotPool)
from ai4e_tpu_torch.runtime.kvcache import (PagedDecodeRuntime,
                                            build_lm_servable)
from ai4e_tpu_torch.runtime.registry import ModelRuntime
from ai4e_tpu_torch.runtime.worker import InferenceWorker
from ai4e_tpu_torch.service.task_manager import LocalTaskManager
from ai4e_tpu_torch.taskstore import APITask, InMemoryTaskStore

torch.set_num_threads(2)

PREFIX = "/v1/lm"
LM = dict(vocab_size=64, max_len=48, dim=32, depth=1, heads=2, eos_id=63)


class FakeBackend:
    """Deterministic decode backend: token ids count up from the last
    prompt token; ``step_s`` simulates device time."""

    def __init__(self, slots=2, max_len=64, eos_id=None, step_s=0.0,
                 name="lm"):
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.name = name
        self.step_s = step_s
        self.params_version = 1
        self.resets = 0
        self.prefills = []
        self.steps = 0

    def reset_cache(self):
        self.resets += 1

    def prefill_into(self, slot, tokens):
        if self.step_s:
            time.sleep(self.step_s)
        self.prefills.append((slot, tuple(tokens)))
        return int(tokens[-1]) + 1

    def step(self, tokens, positions, active):
        if self.step_s:
            time.sleep(self.step_s)
        self.steps += 1
        return [int(t) + 1 for t in tokens]


def run(coro):
    return asyncio.run(coro)


async def wait_until(cond, timeout=10.0):
    deadline = time.perf_counter() + timeout
    while not cond():
        assert time.perf_counter() < deadline, "condition not reached"
        await asyncio.sleep(0.001)


class TestSlotPool:
    def test_acquire_release_conservation(self):
        pool = SlotPool(3)
        a, b = pool.acquire(), pool.acquire()
        assert {a, b} == {0, 1}
        pool.release(a)
        assert pool.free_count == 2 and pool.busy_count == 1
        pool.check_conservation()

    def test_exhaustion_returns_none(self):
        pool = SlotPool(1)
        assert pool.acquire() == 0
        assert pool.acquire() is None

    def test_double_release_raises(self):
        pool = SlotPool(2)
        s = pool.acquire()
        pool.release(s)
        with pytest.raises(SlotError):
            pool.release(s)

    def test_foreign_release_raises(self):
        pool = SlotPool(2)
        with pytest.raises(SlotError):
            pool.release(1)


class TestEngineScheduling:
    def test_generates_and_streams_tokens(self):
        async def main():
            backend = FakeBackend(slots=2)
            engine = DecodeEngine(backend, metrics=MetricsRegistry())
            await engine.start()
            chunks = []
            out = await engine.submit([5, 6], 4,
                                      on_token=lambda i, t: chunks.append(
                                          (i, t)))
            await engine.stop()
            return out, chunks, backend

        out, chunks, backend = run(main())
        assert out == [7, 8, 9, 10]
        assert chunks == [(0, 7), (1, 8), (2, 9), (3, 10)]
        assert backend.prefills[0] == (0, (5, 6))

    def test_eos_finishes_early_and_frees_slot(self):
        async def main():
            engine = DecodeEngine(FakeBackend(slots=1, eos_id=9),
                                  metrics=MetricsRegistry())
            await engine.start()
            out = await engine.submit([6], 64)
            await engine.stop()
            return out, engine

        out, engine = run(main())
        assert out == [7, 8, 9]  # stops AT the eos token
        assert engine.pool.free_count == 1

    def test_backpressure_raises_decode_saturated(self):
        async def main():
            engine = DecodeEngine(FakeBackend(slots=1), max_pending=1,
                                  metrics=MetricsRegistry())
            # Not started: submissions stay queued.
            first = asyncio.ensure_future(engine.submit([1], 2))
            await asyncio.sleep(0)
            with pytest.raises(DecodeSaturated):
                await engine.submit([1], 2)
            first.cancel()

        run(main())

    def test_prompt_must_fit_kv_cache(self):
        async def main():
            engine = DecodeEngine(FakeBackend(slots=1, max_len=4),
                                  metrics=MetricsRegistry())
            with pytest.raises(ValueError):
                await engine.submit([1, 2, 3, 4], 2)

        run(main())

    def test_context_full_finishes_sequence(self):
        async def main():
            engine = DecodeEngine(FakeBackend(slots=1, max_len=5),
                                  metrics=MetricsRegistry())
            await engine.start()
            # Prompt of 3 under a length of 5: the prefill's token (at
            # position 3), then 2 steps fill the cache.
            out = await engine.submit([1, 2, 3], 64)
            await engine.stop()
            return out

        assert len(run(main())) == 3

    def test_late_joiner_streams_before_running_sequence_finishes(self):
        """A request arriving mid-decode of a long sequence gets its first
        token while that sequence still decodes; the whole-batch baseline
        (``continuous=False``) makes it wait for the drain."""

        async def continuous():
            backend = FakeBackend(slots=2, step_s=0.002)
            engine = DecodeEngine(backend, metrics=MetricsRegistry())
            await engine.start()
            stamps = {}
            long_task = asyncio.ensure_future(engine.submit([1], 60))
            await wait_until(lambda: backend.prefills and backend.steps >= 5)
            t_join = time.perf_counter()
            joiner = await engine.submit(
                [40], 3, on_token=lambda i, t: stamps.setdefault(
                    "first", time.perf_counter()))
            await long_task
            t_long_done = time.perf_counter()
            await engine.stop()
            return stamps["first"] - t_join, t_long_done - t_join, joiner

        ttft, remaining, joiner = run(continuous())
        assert len(joiner) == 3
        assert ttft < remaining

        async def whole_batch():
            backend = FakeBackend(slots=2, step_s=0.002)
            engine = DecodeEngine(backend, continuous=False,
                                  metrics=MetricsRegistry())
            await engine.start()
            stamps, long_done = {}, {}
            long_task = asyncio.ensure_future(engine.submit([1], 30))
            long_task.add_done_callback(
                lambda _: long_done.setdefault("t", time.perf_counter()))
            await wait_until(lambda: backend.steps >= 5)
            await engine.submit([40], 3, on_token=lambda i, t: stamps
                                .setdefault("first", time.perf_counter()))
            await long_task
            await engine.stop()
            return stamps["first"], long_done["t"]

        t_first, t_long_done = run(whole_batch())
        assert t_first >= t_long_done

    def test_deadline_sweep_frees_slot_mid_decode(self):
        async def main():
            backend = FakeBackend(slots=1, step_s=0.005)
            reg = MetricsRegistry()
            engine = DecodeEngine(backend, metrics=reg)
            await engine.start()
            with pytest.raises(DeadlineExceeded):
                await engine.submit([1], 10_000,
                                    deadline_at=time.time() + 0.05)
            assert engine.pool.free_count == 1
            expired = reg.counter("ai4e_admission_expired_total")
            assert expired.value(hop="decode", priority="interactive") == 1
            await engine.stop()
            engine.pool.check_conservation()

        run(main())

    def test_cancelled_waiter_frees_slot(self):
        async def main():
            engine = DecodeEngine(FakeBackend(slots=1),
                                  metrics=MetricsRegistry())
            await engine.start()
            fut = asyncio.ensure_future(engine.submit([1], 10_000))
            await wait_until(lambda: engine.active_count)
            fut.cancel()
            await wait_until(lambda: not engine.active_count)
            assert engine.pool.free_count == 1
            await engine.stop()
            engine.pool.check_conservation()

        run(main())

    def test_hot_reload_invalidates_and_reprefills(self):
        async def main():
            backend = FakeBackend(slots=1, step_s=0.002)
            reg = MetricsRegistry()
            engine = DecodeEngine(backend, metrics=reg)
            await engine.start()
            fut = asyncio.ensure_future(engine.submit([1], 30))
            await wait_until(lambda: backend.steps >= 3)
            backend.params_version += 1  # a hot reload lands
            out = await fut
            await engine.stop()
            return backend, reg, out

        backend, reg, out = run(main())
        assert len(out) == 30
        assert backend.resets >= 1
        reprefill = [p for p in backend.prefills if len(p[1]) > 1]
        assert reprefill and reprefill[0][1][0] == 1
        assert reg.counter("ai4e_decode_reprefills_total").value(
            model="lm") >= 1

    def test_metrics_registered_only_with_engine(self):
        reg = MetricsRegistry()
        assert not any(n.startswith("ai4e_decode_") for n in reg._metrics)
        DecodeEngine(FakeBackend(), metrics=reg)
        assert {n for n in reg._metrics if n.startswith("ai4e_decode_")} == {
            "ai4e_decode_ttft_seconds", "ai4e_decode_intertoken_seconds",
            "ai4e_decode_step_seconds", "ai4e_decode_slot_occupancy",
            "ai4e_decode_pending", "ai4e_decode_tokens_total",
            "ai4e_decode_sequences_total", "ai4e_decode_reprefills_total"}

    def test_default_worker_has_no_decode_metrics(self):
        reg = MetricsRegistry()
        MicroBatcher(ModelRuntime(device="cpu"), metrics=reg)
        assert "ai4e_decode_" not in reg.render_prometheus()

    def test_chunk_stamp_carries_ttft(self):
        """One ``chunk`` ledger stamp a request, at the first token."""
        from ai4e_tpu_torch.observability.ledger import CHUNK, HopLedger

        async def main():
            engine = DecodeEngine(FakeBackend(slots=1),
                                  metrics=MetricsRegistry())
            await engine.start()
            ledger = HopLedger()
            await engine.submit([1], 5, ledger=ledger)
            await engine.stop()
            return ledger.drain()

        events = run(main())
        assert [e["e"] for e in events] == [CHUNK]
        assert events[0]["h"] == "decode" and events[0]["ms"] >= 0


# -- serve_stream ------------------------------------------------------------


class Hub:
    """The duck type ``serve_stream`` publishes to."""

    def __init__(self):
        self.tracked, self.events = [], []

    def track(self, task_id):
        self.tracked.append(task_id)

    def publish(self, task_id, event, data):
        self.events.append((task_id, event, data))


def stream_worker(engine, hub=None, publisher=None):
    store = InMemoryTaskStore()
    if publisher is not None:
        store.set_publisher(publisher)
    runtime = ModelRuntime(device="cpu")
    batcher = MicroBatcher(runtime, metrics=MetricsRegistry())
    worker = InferenceWorker("lmsvc", runtime, batcher,
                             task_manager=LocalTaskManager(store),
                             prefix="v1/lm", metrics=MetricsRegistry(),
                             store=store)
    worker.serve_stream(engine, event_hub=hub)
    return worker, store


async def post_stream(client, body) -> tuple[int, dict | str, dict]:
    resp = await client.post(f"{PREFIX}/lm-stream-async",
                             data=body if isinstance(body, bytes)
                             else json.dumps(body).encode())
    text = await resp.text()
    try:
        text = json.loads(text)
    except json.JSONDecodeError:
        pass
    return resp.status, text, dict(resp.headers)


async def final_status(client, task_id: str) -> str:
    for _ in range(2000):
        resp = await client.get(f"{PREFIX}/task/{task_id}")
        status = (await resp.json())["Status"]
        if not status.startswith(("created", "running")):
            return status
        await asyncio.sleep(0.005)
    raise AssertionError(f"task {task_id} never finished: {status}")


async def serving(worker, engine, fn):
    await engine.start()
    client = TestClient(TestServer(worker.service.app))
    await client.start_server()
    try:
        return await fn(client)
    finally:
        await client.close()
        await engine.stop()


class TestServeStream:
    def test_completes_with_chunks_and_result(self):
        hub = Hub()
        engine = DecodeEngine(FakeBackend(slots=2), metrics=MetricsRegistry())
        worker, store = stream_worker(engine, hub=hub)

        async def main(client):
            code, body, _ = await post_stream(
                client, {"prompt": [5], "max_new_tokens": 3})
            assert code == 200, body
            return body["TaskId"], await final_status(client, body["TaskId"])

        task_id, status = run(serving(worker, engine, main))
        assert status == "completed - 3 tokens"
        payload, ctype = store.get_result(task_id)
        assert json.loads(payload) == {"tokens": [6, 7, 8], "count": 3}
        assert ctype == "application/json"
        assert hub.tracked == [task_id]
        assert [(t, e, d["index"], d["data"]["token"], d["stage"])
                for t, e, d in hub.events] == [
            (task_id, "chunk", i, 6 + i, "lm") for i in range(3)]
        assert worker._served["lm"] == {"stream_async":
                                        "/v1/lm/lm-stream-async"}

    def test_tokens_key_feeds_a_stage_result(self):
        engine = DecodeEngine(FakeBackend(slots=1), metrics=MetricsRegistry())
        worker, store = stream_worker(engine)

        async def main(client):
            _, body, _ = await post_stream(client, {"tokens": [9, 10],
                                                    "max_new_tokens": 2})
            return body["TaskId"], await final_status(client, body["TaskId"])

        task_id, status = run(serving(worker, engine, main))
        assert status == "completed - 2 tokens"
        assert json.loads(store.get_result(task_id)[0])["tokens"] == [11, 12]

    @pytest.mark.parametrize("body,why", [
        (b"not json", "Expecting value"),
        ({"prompt": "nope"}, "non-empty list of token ids"),
        ({"prompt": []}, "non-empty list of token ids"),
        ({"prompt": [1, 64]}, r"token ids must be in [0, 64)"),
        ({"prompt": [1] * 48}, "leaves no room"),
        ({"prompt": [1], "max_new_tokens": 0}, "positive int"),
        ([1, 2], "JSON object"),
    ], ids=["json", "type", "empty", "vocab", "length", "max_new", "list"])
    def test_bad_input_fails_the_task_not_the_engine(self, body, why):
        backend = FakeBackend(slots=1, max_len=48)
        backend.servable = SimpleNamespace(vocab_size=64)
        engine = DecodeEngine(backend, metrics=MetricsRegistry())
        worker, _ = stream_worker(engine)

        async def main(client):
            _, created, _ = await post_stream(client, body)
            bad = await final_status(client, created["TaskId"])
            _, created, _ = await post_stream(client, {"prompt": [1],
                                                       "max_new_tokens": 1})
            return bad, await final_status(client, created["TaskId"])

        bad, good = run(serving(worker, engine, main))
        assert bad.startswith("failed - bad input: ")
        assert why in bad
        assert good == "completed - 1 tokens"

    def test_saturated_or_draining_answers_503(self):
        engine = DecodeEngine(FakeBackend(slots=1), max_pending=0,
                              metrics=MetricsRegistry())
        worker, store = stream_worker(engine)

        async def main(client):
            saturated = await post_stream(client, {"prompt": [1]})
            engine.max_pending = 4
            worker.drain_state.begin()
            draining = await post_stream(client, {"prompt": [1]})
            return saturated, draining

        (code, text, headers), (dcode, _, dheaders) = run(
            serving(worker, engine, main))
        assert code == 503 and headers["Retry-After"] == "1"
        assert "saturated" in text
        assert dcode == 503 and dheaders["X-Draining"] == "1"
        assert dheaders["X-Shed-Reason"] == "draining at worker"
        assert store.depths() == {}  # refused before any task exists

    @pytest.mark.parametrize("broker", [True, False],
                             ids=["broker", "standalone"])
    def test_saturated_after_admission(self, broker):
        """Saturated between admission and submit: behind a broker the task
        is handed back (its original body replayed on redelivery); a
        standalone worker fails it."""
        published = []
        engine = DecodeEngine(FakeBackend(slots=1), max_pending=0,
                              metrics=MetricsRegistry())
        worker, store = stream_worker(
            engine, publisher=published.append if broker else None)
        store.upsert(APITask(task_id="t-1", endpoint="/lm-stream-async",
                             body=b"", publish=False))
        handler = worker.service.endpoints["/lm-stream-async"].func

        async def main():
            try:
                await handler(taskId="t-1",
                              body=json.dumps({"prompt": [1]}).encode(),
                              content_type="application/json")
            except DecodeSaturated:
                return "raised"
            return "returned"

        outcome = run(main())
        if broker:
            assert outcome == "returned"
            assert [t.task_id for t in published] == ["t-1"]
            assert published[0].endpoint == "/lm-stream-async"
        else:
            assert outcome == "raised"  # the shell fails the task
            assert published == []

    def test_drain_finishes_actives_refuses_new_and_resumes(self):
        backend = FakeBackend(slots=2, step_s=0.002)
        engine = DecodeEngine(backend, metrics=MetricsRegistry())
        worker, _ = stream_worker(engine)

        async def main(client):
            ids = []
            for prompt in ([1], [100]):
                _, body, _ = await post_stream(
                    client, {"prompt": prompt, "max_new_tokens": 40})
                ids.append(body["TaskId"])
            await wait_until(lambda: engine.active_count == 2)
            drain = await (await client.post(f"{PREFIX}/worker/drain",
                                             json={"timeout_ms": 10000}))\
                .json()
            refused = await post_stream(client, {"prompt": [1]})
            state = await (await client.get(f"{PREFIX}/worker/drain")).json()
            finals = [await final_status(client, i) for i in ids]
            await client.post(f"{PREFIX}/worker/resume")
            _, body, _ = await post_stream(client, {"prompt": [7],
                                                    "max_new_tokens": 2})
            return (drain, refused, state, finals,
                    await final_status(client, body["TaskId"]))

        drain, refused, state, finals, after = run(
            serving(worker, engine, main))
        assert drain["state"] == "drained" and drain["clean"]
        assert drain["forced"] == 0
        assert refused[0] == 503 and refused[2]["X-Draining"] == "1"
        assert state["decode_active"] == 0 and state["state"] == "drained"
        assert finals == ["completed - 40 tokens"] * 2
        assert after == "completed - 2 tokens"


class SlowRuntime(PagedDecodeRuntime):
    """The CPU runtime with a 10 ms step, so a reload lands mid-decode."""

    def step(self, tokens, positions, active):
        time.sleep(0.01)
        return super().step(tokens, positions, active)


class TestLMReload:
    def test_reload_verb_reaches_the_decode_backend(self, tmp_path):
        """``POST {prefix}/models/{lm}/reload`` finds the LM on its engine:
        200 with the version bumped and the active sequence re-prefilled
        from its history, 404 for an unknown name, 409 for a tree of
        another shape."""
        lm = build_lm_servable(name="lm", **LM)
        backend = SlowRuntime(lm, ModelRuntime(device="cpu"), slots=2,
                              prompt_buckets=(8,))
        reg = MetricsRegistry()
        engine = DecodeEngine(backend, metrics=reg)
        worker, _ = stream_worker(engine)
        other = build_lm_servable(
            name="lm", generator=torch.Generator().manual_seed(1), **LM)
        good = tmp_path / "lm.npz"
        convert.save_npz(convert.seqformer_lm_flax_from_state_dict(
            other.module.state_dict()), str(good))
        wrong = tmp_path / "wrong.npz"
        convert.save_npz(convert.seqformer_lm_flax_from_state_dict(
            build_lm_servable(name="lm", **{**LM, "dim": 16})
            .module.state_dict()), str(wrong))

        async def main(client):
            _, body, _ = await post_stream(client, {"prompt": [3, 4],
                                                    "max_new_tokens": 40})
            await wait_until(lambda: engine.active_count == 1
                             and reg.counter("ai4e_decode_tokens_total")
                             .value(model="lm") >= 3)
            ok = await client.post(f"{PREFIX}/models/lm/reload",
                                   json={"checkpoint": str(good)})
            ok = (ok.status, await ok.json())
            missing = await client.post(f"{PREFIX}/models/nope/reload",
                                        json={"checkpoint": str(good)})
            mismatch = await client.post(f"{PREFIX}/models/lm/reload",
                                         json={"checkpoint": str(wrong)})
            return (ok, missing.status, mismatch.status,
                    await final_status(client, body["TaskId"]))

        ok, missing, mismatch, final = run(serving(worker, engine, main))
        assert ok[0] == 200, ok
        assert ok[1]["params_version"] == 2 and backend.params_version == 2
        assert ok[1]["checkpoint"] == str(good)
        assert lm.checkpoint_path == str(good)
        assert missing == 404 and mismatch == 409
        assert final.startswith("completed - ")
        assert reg.counter("ai4e_decode_reprefills_total").value(
            model="lm") == 1
        assert torch.equal(lm.module.embed.weight, other.module.embed.weight)


# -- CLI wiring --------------------------------------------------------------


MODELS = {"service_name": "w", "prefix": "v1/lm",
          "models": [
              {"family": "echo", "name": "echo", "size": 4, "buckets": [2]},
              {"family": "seqformer-lm", "name": "lm", "vocab_size": 32,
               "max_len": 32, "dim": 16, "depth": 1, "heads": 2,
               "eos_id": 2}]}


class TestCliDecodeWiring:
    def test_decode_enable_builds_engine_and_stream_endpoint(self):
        config = FrameworkConfig.from_env({
            "AI4E_RUNTIME_DECODE_ENABLE": "1", "AI4E_RUNTIME_KV_SLOTS": "2",
            "AI4E_RUNTIME_DECODE_PROMPT_BUCKETS": "4",
            "AI4E_RUNTIME_DECODE_MAX_PENDING": "5"})
        worker, _, _ = build_worker(json.loads(json.dumps(MODELS)),
                                    device="cpu", config=config)
        engine, = worker.decode_engines
        assert engine.backend.slots == 2 and engine.max_pending == 5
        # The spec's max_len wins over AI4E_RUNTIME_KV_MAX_LEN; the prompt
        # ladder is the knob's, with the covering top added.
        assert engine.backend.max_len == 32
        assert engine.backend.prompt_buckets == (4, 32)
        assert engine.backend.eos_id == 2
        assert engine.backend.device == torch.device("cpu")
        assert "lm" not in worker.runtime.models
        assert "/lm-stream-async" in worker.service.endpoints
        assert engine.metrics is worker.service.metrics

    def test_decode_off_skips_lm_specs(self, caplog):
        with caplog.at_level(logging.WARNING, "ai4e_tpu_torch.cli"):
            worker, _, _ = build_worker(json.loads(json.dumps(MODELS)),
                                        device="cpu",
                                        config=FrameworkConfig())
        assert worker.decode_engines == []
        assert "/lm-stream-async" not in worker.service.endpoints
        assert "lm" not in worker.runtime.models
        assert "AI4E_RUNTIME_DECODE_ENABLE is off — not serving them" in \
            caplog.text
        assert "ai4e_decode_" not in worker.service.metrics.render_prometheus()


# -- slot conservation under the interleaving explorer ----------------------


SEED = 20260803
SCHEDULES = 60


class _FakeDecodeBackend:
    """Async decode backend: every device call is a real suspension, so the
    explorer owns every window the executor hop opens when serving."""

    def __init__(self, slots=2, max_len=64):
        self.slots, self.max_len = slots, max_len
        self.eos_id, self.name = None, "lm"
        self.params_version = 1

    async def reset_cache(self):
        await yield_point()

    async def prefill_into(self, slot, tokens):
        await yield_point()
        return int(tokens[-1]) + 1

    async def step(self, tokens, positions, active):
        await yield_point()
        return [int(t) + 1 for t in tokens]


class _SplitSweepEngine(DecodeEngine):
    """The expiry sweep with its guard and its release in two segments: a
    cancel landing between them retires the sequence first, and the
    resumed sweep releases a slot it no longer holds."""

    async def _tick(self):
        await self._check_reload()
        await self._sweep_split()
        await self._admit()
        await self._step()

    async def _sweep_split(self):
        now = time.time()
        doomed = [(seq, seq.slot) for seq in self._active.values()
                  if not seq.done and seq.deadline_at
                  and seq.deadline_at <= now]
        for seq, slot in doomed:
            await yield_point()
            self._active.pop(slot, None)
            self.pool.release(slot)
            seq.slot = None
            seq.done = True
            if not seq.future.done():
                seq.future.set_exception(
                    DeadlineExceeded("decode", seq.deadline_at))


def _slot_conservation_scenario(engine_cls, ticks=120):
    """Join vs decode step vs expiry sweep vs cancel vs hot reload over a
    2-slot pool."""

    def make():
        backend = _FakeDecodeBackend(slots=2, max_len=8)
        engine = engine_cls(backend, max_pending=8, metrics=MetricsRegistry())
        results = {}

        async def driver():
            for _ in range(ticks):
                if results.get("stop"):
                    break
                await yield_point()
                await engine._tick()
            for seq in list(engine._active.values()) + list(engine._queue):
                engine._retire(seq, "cancelled", error=RuntimeError("drained"))

        async def submit(tag, prompt, max_new):
            try:
                results[tag] = await engine.submit(prompt, max_new)
            except BaseException as exc:  # noqa: BLE001 — the outcome is the result under exploration
                results[tag] = exc

        async def joiner():
            await yield_point()
            await submit("b", [10], 2)

        async def expiring_then_cancel():
            for _ in range(40):
                if engine._active:
                    break
                await yield_point()
            else:
                return
            seq = next(iter(engine._active.values()))
            seq.deadline_at = 1.0  # long past: the next sweep dooms it
            await yield_point()
            engine.cancel(seq.future)

        async def reloader():
            await yield_point()
            backend.params_version += 1

        async def finisher():
            for _ in range(200):
                if "a" in results and "b" in results:
                    break
                await yield_point()
            results["stop"] = True

        coros = [driver(), submit("a", [1], 6), joiner(),
                 expiring_then_cancel(), reloader(), finisher()]

        def check():
            engine.pool.check_conservation()
            assert engine.pool.free_count == engine.pool.slots
            assert not engine._active and not engine._queue
            assert "a" in results and "b" in results, results

        return coros, check

    return make


class TestDecodeSlotConservation:
    def test_engine_conserves_slots(self):
        report = explore_interleavings(
            _slot_conservation_scenario(DecodeEngine),
            schedules=SCHEDULES, seed=SEED)
        assert report.ok, report.describe()

    def test_split_sweep_revert_caught(self):
        report = explore_interleavings(
            _slot_conservation_scenario(_SplitSweepEngine),
            schedules=SCHEDULES, seed=SEED)
        assert not report.ok
        assert any("Slot" in type(r.error).__name__
                   or "released" in str(r.error) for r in report.failures)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def card_runtime(slots=3, buckets=(4, 16)):
    lm = build_lm_servable(name="lm", **{**LM, "depth": 2})
    rt = PagedDecodeRuntime(lm, ModelRuntime(device="cuda"), slots=slots,
                            prompt_buckets=buckets)
    rt.warm()
    return rt


@pytest.mark.cuda
def test_graph_replays_equal_eager(cuda):
    """Every prefill bucket's replay and the step's equal an eager call of
    the module on the same inputs, tokens and caches bit for bit."""
    rt = card_runtime()
    assert set(rt.graphs) == {("prefill", 4), ("prefill", 16),
                              ("prefill", 48), ("step",)}
    gen = np.random.default_rng(0)
    for bucket in rt.prompt_buckets:
        n = min(bucket, rt.max_len - 1)
        tokens = gen.integers(0, 64, n).tolist()
        slot = bucket % rt.slots
        got = rt.prefill_into(slot, tokens)
        padded = torch.zeros((1, bucket), dtype=torch.int64, device=cuda)
        padded[0, :n] = torch.tensor(tokens, device=cuda)
        with torch.inference_mode():
            want, k, _ = rt.module.prefill(
                padded, torch.tensor([n], device=cuda))
        assert got == int(want[0])
        assert torch.equal(rt.k_cache[:, slot, :, :bucket], k[:, 0])
    tokens = gen.integers(0, 64, rt.slots).tolist()
    positions = [5, 0, 47]
    k, v = rt.k_cache.clone(), rt.v_cache.clone()
    torch.cuda.synchronize()  # the clones before the step's writes
    got = rt.step(tokens, positions, [True, False, True])
    with torch.inference_mode():
        want, _, _ = rt.module.decode_step(
            torch.tensor(tokens, device=cuda), k, v,
            torch.tensor(positions, device=cuda))
    assert got == want.tolist()
    assert torch.equal(rt.k_cache, k) and torch.equal(rt.v_cache, v)


@pytest.mark.cuda
def test_reset_and_reload_in_place_on_the_card(cuda):
    rt = card_runtime()
    ptr = rt.k_cache.data_ptr()
    rt.prefill_into(0, [1, 2, 3])
    rt.reset_cache()
    assert rt.k_cache.data_ptr() == ptr and not rt.k_cache.any()
    before = rt.prefill_into(0, [1, 2, 3])
    other = build_lm_servable(name="lm", generator=torch.Generator()
                              .manual_seed(3), **{**LM, "depth": 2})
    rt.reload_params(convert.seqformer_lm_flax_from_state_dict(
        other.module.state_dict()))
    with torch.inference_mode():
        want = other.module.to(cuda).prefill(
            torch.tensor([[1, 2, 3, 0]], device=cuda),
            torch.tensor([3], device=cuda))[0]
    assert rt.prefill_into(0, [1, 2, 3]) == int(want[0])
    assert rt.params_version == 2
    del before


@pytest.mark.cuda
def test_engine_end_to_end_on_the_card(cuda):
    rt = card_runtime(slots=2)

    async def main():
        engine = DecodeEngine(rt, metrics=MetricsRegistry())
        await engine.start()
        out = await asyncio.gather(*(engine.submit([i + 1, 2], 6)
                                     for i in range(5)))
        await engine.stop()
        engine.pool.check_conservation()
        return out

    out = run(main())
    assert all(1 <= len(t) <= 6 for t in out)
    assert rt.graphs[("step",)].replays > 0
