"""The port's observability modules (``ai4e_tpu_torch/observability/``,
the store's ledger and its HTTP surface, the registry's exemplars, the
gateway's ledger view and flight dump, the config's exporters, the
``trace`` verb) held against the JAX package's on the same inputs: equal
events, decisions, rendered text and JSON, byte for byte unless a test
says otherwise. Times are passed in or frozen, so nothing here depends on
the clock."""

import asyncio
import json
import logging
import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu import cli as jax_cli
from ai4e_tpu import config as jax_config
from ai4e_tpu import metrics as jax_metrics
from ai4e_tpu import platform_assembly as jax_pa
from ai4e_tpu.observability import depth_logger as jax_depth
from ai4e_tpu.observability import flight as jax_flight
from ai4e_tpu.observability import hub as jax_hub
from ai4e_tpu.observability import ledger as jax_ledger
from ai4e_tpu.observability import otlp as jax_otlp
from ai4e_tpu.observability import slo as jax_slo
from ai4e_tpu.observability import timeline as jax_timeline
from ai4e_tpu.observability import tracing as jax_tracing
from ai4e_tpu.observability import traceview as jax_traceview
from ai4e_tpu.observability import vitals as jax_vitals
from ai4e_tpu.taskstore import APITask as JaxTask
from ai4e_tpu.taskstore import InMemoryTaskStore as JaxStore
from ai4e_tpu.taskstore.http import make_app as jax_make_app
from ai4e_tpu_torch import cli as port_cli
from ai4e_tpu_torch import config as port_config
from ai4e_tpu_torch import metrics as port_metrics
from ai4e_tpu_torch import platform_assembly as port_pa
from ai4e_tpu_torch.observability import depth_logger as port_depth
from ai4e_tpu_torch.observability import flight as port_flight
from ai4e_tpu_torch.observability import hub as port_hub
from ai4e_tpu_torch.observability import ledger as port_ledger
from ai4e_tpu_torch.observability import otlp as port_otlp
from ai4e_tpu_torch.observability import slo as port_slo
from ai4e_tpu_torch.observability import timeline as port_timeline
from ai4e_tpu_torch.observability import tracing as port_tracing
from ai4e_tpu_torch.observability import traceview as port_traceview
from ai4e_tpu_torch.observability import vitals as port_vitals
from ai4e_tpu_torch.taskstore import APITask as PortTask
from ai4e_tpu_torch.taskstore import InMemoryTaskStore as PortStore
from ai4e_tpu_torch.taskstore.http import make_app as port_make_app

ROOT = Path(__file__).resolve().parent.parent
SIDES = {
    "jax": dict(ledger=jax_ledger, tracing=jax_tracing, otlp=jax_otlp,
                slo=jax_slo, flight=jax_flight, hub=jax_hub,
                traceview=jax_traceview, timeline=jax_timeline,
                depth=jax_depth, vitals=jax_vitals, metrics=jax_metrics,
                store=JaxStore, task=JaxTask, make_app=jax_make_app,
                pa=jax_pa, config=jax_config, cli=jax_cli),
    "port": dict(ledger=port_ledger, tracing=port_tracing, otlp=port_otlp,
                 slo=port_slo, flight=port_flight, hub=port_hub,
                 traceview=port_traceview, timeline=port_timeline,
                 depth=port_depth, vitals=port_vitals, metrics=port_metrics,
                 store=PortStore, task=PortTask, make_app=port_make_app,
                 pa=port_pa, config=port_config, cli=port_cli),
}


def both(fn):
    """``fn(side modules)`` on each side; asserts the results are equal and
    returns the port's."""
    want, got = fn(SIDES["jax"]), fn(SIDES["port"])
    assert got == want
    return got


# -- the ledger ----------------------------------------------------------------

#: Events as hops stamp them: (event, hop, t, reason, ms).
STAMPS = [("admitted", "gateway", 100.0, "/v1/a", None),
          ("published", "gateway", 100.0004, None, None),
          ("popped", "dispatcher", 100.0021, "delivery 1", None),
          ("backpressure", "dispatcher", 100.0105, "127.0.0.1:9", None),
          ("popped", "dispatcher", 100.31, "delivery 2", None),
          ("delivered", "dispatcher", 100.3161, "127.0.0.1:9", None),
          ("batched", "batcher", 100.3212, "size 3 bucket 16", None),
          ("h2d", "device", 100.3215, None, 0.4123456),
          ("execute", "device", 100.3219, None, 2.5),
          ("d2h", "device", 100.3244, None, 0.0999),
          ("completed", "store", 100.33, "completed", None)]


class TestLedger:
    def test_vocabulary_and_cap(self):
        names = [n for n in dir(jax_ledger) if n.isupper()]
        assert {n: getattr(port_ledger, n) for n in names} == \
            {n: getattr(jax_ledger, n) for n in names}

    def test_ledger_event(self):
        both(lambda m: [m["ledger"].ledger_event(e, h, t=t, reason=r, ms=ms)
                        for e, h, t, r, ms in STAMPS])

    def test_hop_ledger_stamps_drains_and_caps(self):
        def run(m):
            buf = m["ledger"].HopLedger()
            for i in range(m["ledger"].MAX_EVENTS + 5):
                e, h, t, r, ms = STAMPS[i % len(STAMPS)]
                buf.stamp(e, h, t=t + i, reason=r, ms=ms)
            events = buf.events()
            drained = buf.drain()
            return events, drained, buf.drain(), len(events)

        out = both(run)
        assert out[3] == port_ledger.MAX_EVENTS and out[2] == []

    def test_validate_events(self):
        raw = [{"e": "h2d", "h": "device", "t": 1, "ms": "2.5"},
               {"e": "x", "h": "y", "t": 2.0, "r": 7, "ms": "bad"},
               {"e": 1, "h": "y", "t": 2.0}, {"e": "x", "t": 1.0},
               {"e": "x", "h": "y", "t": "soon"}, "garbage", None,
               {"e": "x", "h": "y", "t": True, "extra": 1}]
        assert len(both(lambda m: m["ledger"].validate_events(raw))) == 3
        both(lambda m: m["ledger"].validate_events(None))

    @pytest.mark.parametrize("status", [None, "completed - histogram"])
    def test_render_ledger(self, status):
        def run(m):
            events = [m["ledger"].ledger_event(e, h, t=t, reason=r, ms=ms)
                      for e, h, t, r, ms in reversed(STAMPS)]
            return (m["ledger"].render_ledger("t-1", events, status=status),
                    m["ledger"].render_ledger("t-2", [], status=status))

        text, empty = both(run)
        assert "(+299.5ms)" in text and "no ledger events" in empty

    def test_store_cap_and_single_truncation_marker(self, monkeypatch):
        monkeypatch.setattr(time, "time", lambda: 42.0)

        def run(m):
            store = m["store"]()
            tid = store.upsert(m["task"](endpoint="/v1/a", body=b"x")).task_id
            kept = [store.append_ledger(tid, [m["ledger"].ledger_event(
                "retry", "worker", t=float(i))] * 50) for i in range(4)]
            try:
                store.append_ledger("nope", [])
                missing = None
            except KeyError as exc:
                missing = type(exc).__name__
            return kept, store.get_ledger(tid), store.get_ledger("nope"), \
                missing

        kept, timeline, unknown, missing = both(run)
        assert kept == [50, 50, 28, 0] and unknown == []
        assert [e["e"] for e in timeline].count("truncated") == 1
        assert len(timeline) == port_ledger.MAX_EVENTS + 1
        assert missing == "TaskNotFound"

    def test_eviction_drops_the_timeline(self):
        def run(m):
            store = m["store"]()
            tid = store.upsert(m["task"](endpoint="/v1/a", body=b"x")).task_id
            store.append_ledger(tid, [m["ledger"].ledger_event(
                "popped", "dispatcher", t=1.0)])
            store.update_status(tid, "completed - x",
                                backend_status="completed")
            before = len(store.get_ledger(tid))
            return before, store.evict_terminal_older_than(0.0), \
                store.get_ledger(tid)

        assert both(run) == (1, 1, [])

    def test_http_surface(self, monkeypatch):
        """POST and GET /v1/taskstore/ledger: the same statuses and
        bodies, sanitised events, 404 for an unknown task, 400 without a
        TaskId."""
        monkeypatch.setattr(time, "time", lambda: 7.0)

        async def run(m):
            store = m["store"]()
            store.upsert(m["task"](task_id="t1", endpoint="/v1/a",
                                   body=b"x"))
            out = []
            async with TestClient(TestServer(m["make_app"](store))) as c:
                for method, kw in [
                        ("post", {"json": {"TaskId": "t1", "Events": [
                            {"e": "h2d", "h": "device", "t": 1.0, "ms": 3},
                            "garbage"]}}),
                        ("post", {"json": {"TaskId": "nope", "Events": []}}),
                        ("post", {"json": {"Events": []}}),
                        ("post", {"data": b"{nope"}),
                        ("get", {"params": {"taskId": "t1"}}),
                        ("get", {"params": {"taskId": "nope"}}),
                        ("get", {})]:
                    resp = await getattr(c, method)("/v1/taskstore/ledger",
                                                    **kw)
                    out.append((resp.status, await resp.json()))
            return out

        got = both(lambda m: asyncio.run(run(m)))
        assert got[0] == (200, {"ok": True, "appended": 1})
        assert got[4][1]["Events"] == [{"e": "h2d", "h": "device",
                                        "t": 1.0, "ms": 3.0}]

    def test_task_managers_append(self):
        """The in-process and HTTP task managers land the same events; the
        HTTP one counts a refusal as zero kept."""
        async def run(m, tm_mod):
            store = m["store"]()
            store.upsert(m["task"](task_id="t1", endpoint="/v1/a", body=b""))
            events = [m["ledger"].ledger_event("batched", "batcher", t=1.0,
                                               reason="size 1 bucket 1")]
            local = await tm_mod.LocalTaskManager(store).append_ledger(
                "t1", events)
            async with TestClient(TestServer(m["make_app"](store))) as c:
                http = tm_mod.HttpTaskManager(str(c.make_url("")))
                kept = await http.append_ledger("t1", events)
                refused = await http.append_ledger("nope", events)
                await http.close()
            return local, kept, refused, store.get_ledger("t1")

        from ai4e_tpu.service import task_manager as jax_tm
        from ai4e_tpu_torch.service import task_manager as port_tm
        want = asyncio.run(run(SIDES["jax"], jax_tm))
        got = asyncio.run(run(SIDES["port"], port_tm))
        assert got == want and got[:3] == (1, 1, 0)


# -- tracing -------------------------------------------------------------------


def trace_ids(n: int) -> list[str]:
    rng = random.Random(0)
    return [f"{rng.getrandbits(128):032x}" for _ in range(n)]


class TestTracing:
    @pytest.mark.parametrize("rate", [0.05, 0.5, 0.9])
    def test_sample_decision(self, rate):
        kept = both(lambda m: [m["tracing"]._sample(t, rate)
                               for t in trace_ids(1000)])
        assert 0 < sum(kept) < 1000
        both(lambda m: [m["tracing"]._sample(t, r) for t in trace_ids(10)
                        for r in (0.0, 1.0, -1.0, 2.0)])

    @pytest.mark.parametrize("headers", [
        {}, {"x-b3-traceid": "abc"},
        {"x-b3-traceid": "abc", "x-b3-spanid": "def", "x-b3-sampled": "0"},
        {"x-b3-traceid": "abc", "x-b3-spanid": "def", "x-b3-sampled": "1"},
        {"x-b3-spanid": "def"}])
    def test_parent_from(self, headers):
        both(lambda m: m["tracing"].Tracer.parent_from(headers))

    def test_header_names(self):
        both(lambda m: [m["tracing"].TRACE_HEADER, m["tracing"].SPAN_HEADER,
                        m["tracing"].PARENT_HEADER,
                        m["tracing"].SAMPLED_HEADER])

    def test_injection_and_span_tree(self, monkeypatch):
        """Inbound headers parent a span; the headers injected inside it
        carry its ids; the sampled bit survives; rate 0 kills export
        even under an inbound sampled:1."""
        def run(m):
            ids = iter(f"{i:016x}" for i in range(1, 1000))
            monkeypatch.setattr(m["tracing"], "_new_span_id",
                                lambda: next(ids))
            sink = m["tracing"].InMemoryExporter()
            reg = m["metrics"].MetricsRegistry()
            tracer = m["tracing"].Tracer("svc", exporter=sink,
                                         sample_rate=1.0, metrics=reg)
            inbound = {"x-b3-traceid": "t" * 32, "x-b3-spanid": "p" * 16,
                       "x-b3-sampled": "1"}
            with tracer.span("outer", task_id="task", headers=inbound,
                             a=1) as outer:
                injected = tracer.headers()
                with tracer.span("inner") as inner:
                    inner_headers = tracer.headers()
            off = m["tracing"].Tracer("svc", exporter=sink, sample_rate=0.0,
                                      metrics=reg)
            with off.span("dropped", headers=inbound):
                pass
            spans = [s.to_dict() for s in sink.spans]
            for s in spans:
                s.pop("start"), s.pop("duration")
            return (spans, injected, inner_headers, outer.parent_id,
                    inner.parent_id, tracer.headers())

        spans, injected, inner_headers, outer_parent, inner_parent, after = \
            both(run)
        assert [s["name"] for s in spans] == ["inner", "outer"]
        assert outer_parent == "p" * 16 and injected["x-b3-traceid"] == \
            "t" * 32 and after == {}

    def test_span_error_and_span_metrics(self):
        def run(m):
            sink = m["tracing"].InMemoryExporter()
            reg = m["metrics"].MetricsRegistry()
            tracer = m["tracing"].Tracer("gateway", exporter=sink,
                                         metrics=reg)
            with pytest.raises(ValueError):
                with tracer.span("create_task"):
                    raise ValueError("boom")
            hist = reg.histogram("ai4e_span_seconds", "")
            (_, _, labels, data), = hist.collect()
            return (sink.spans[0].status, sink.spans[0].error, labels,
                    data["count"])

        assert both(run) == ("error", "ValueError: boom",
                             {"name": "create_task", "service": "gateway"},
                             1)

    def test_jsonl_exporter_lines(self, tmp_path):
        def run(m):
            path = tmp_path / f"{m['tracing'].__name__}.jsonl"
            exporter = m["tracing"].JsonlExporter(str(path))
            for span in spans_of(m["tracing"]):
                exporter.export(span)
            exporter.close()
            return path.read_text()

        assert both(run).count("\n") == 4

    def test_log_and_fanout_exporters(self, caplog):
        def run(m):
            caplog.clear()
            sink = m["tracing"].InMemoryExporter()

            class Broken:
                def export(self, span):
                    raise RuntimeError("down")

                def close(self):
                    raise RuntimeError("down")

            fan = m["tracing"].FanoutExporter([Broken(), sink])
            with caplog.at_level(logging.INFO):
                for span in spans_of(m["tracing"]):
                    fan.export(span)
                    m["tracing"].LogExporter().export(span)
                fan.close()
            return ([s.to_dict() for s in sink.spans],
                    [r.getMessage() for r in caplog.records
                     if r.getMessage().startswith("span ")
                     and "failed" not in r.getMessage()])

        spans, lines = both(run)
        assert len(spans) == 4 and len(lines) == 4

    def test_configure_tracer_is_followed_live(self):
        def run(m):
            sink = m["tracing"].InMemoryExporter()
            tracer = m["tracing"].Tracer("late",
                                         metrics=m["metrics"].MetricsRegistry())
            m["tracing"].configure_tracer(exporter=sink, sample_rate=1.0)
            try:
                with tracer.span("a"):
                    pass
                m["tracing"].configure_tracer(sample_rate=0.0)
                with tracer.span("b"):
                    pass
            finally:
                m["tracing"].configure_tracer(exporter=None, sample_rate=None)
            return [s.name for s in sink.spans]

        assert both(run) == ["a"]

    def test_device_trace_is_a_profiler_range(self):
        import torch

        with torch.profiler.profile() as prof:
            with port_tracing.device_trace("request-7"):
                torch.ones(4).sum()
        assert any(e.name == "request-7" for e in prof.events())


def spans_of(tracing) -> list:
    """Four spans of two traces, fixed ids and times."""
    out = []
    for i, (name, service, parent, task, status) in enumerate([
            ("create_task", "gateway", None, "t1", "ok"),
            ("dispatch", "dispatcher", "0000000000000001", "t1", "ok"),
            ("/classify-async", "w", "0000000000000002", "t1", "error"),
            ("/classify", "w", None, None, "ok")]):
        span = tracing.Span(
            name=name, service=service,
            trace_id=("a" * 32 if i < 3 else "b" * 32),
            span_id=f"{i + 1:016x}", parent_id=parent, task_id=task,
            start=1000.0 + i * 0.001, duration=0.002 * (4 - i),
            status=status, error=("RuntimeError: x" if status == "error"
                                  else None),
            attrs=({"route": "/v1/a"} if i == 0 else {}))
        out.append(span)
    return out


class TestOtlp:
    def test_request_bodies_over_http(self):
        """The same spans reach a local collector as the same OTLP JSON
        bodies, through the exporter's batch thread."""
        async def collect(m) -> list:
            bodies = []
            got = threading.Event()

            async def traces(request):
                bodies.append(json.loads(await request.read()))
                got.set()
                return web.json_response({})

            app = web.Application()
            app.router.add_post("/v1/traces", traces)
            server = TestServer(app)
            await server.start_server()
            try:
                exporter = m["otlp"].OtlpHttpExporter(
                    str(server.make_url("/v1/traces")), flush_interval=0.05,
                    max_batch=2)
                for span in spans_of(m["tracing"]):
                    exporter.export(span)
                await asyncio.to_thread(exporter.close, 10.0)
                return bodies, exporter.exported, exporter.dropped
            finally:
                await server.close()

        bodies, exported, dropped = both(lambda m: asyncio.run(collect(m)))
        assert exported == 4 and dropped == 0 and len(bodies) == 2

    def test_ids_and_overflow(self):
        both(lambda m: [m["otlp"]._hex_id(v, w) for v, w in [
            ("abc", 16), ("a" * 16, 32), ("not-hex", 16), ("", 32),
            ("f" * 40, 32)]])

        def overflow(m):
            exporter = m["otlp"].OtlpHttpExporter(
                "http://127.0.0.1:9/v1/traces", flush_interval=3600,
                max_batch=100, max_queue=3)
            spans = spans_of(m["tracing"])
            for span in spans:
                exporter.export(span)
            kept = [s.name for s in exporter._queue]
            exporter._closed = True  # no flush to the dead address
            with exporter._cond:
                exporter._queue.clear()
                exporter._cond.notify()
            exporter._thread.join(5)
            return exporter.dropped, kept

        assert both(overflow) == (1, ["dispatch", "/classify-async",
                                      "/classify"])


# -- SLOs ----------------------------------------------------------------------


class TestSlo:
    @pytest.mark.parametrize("spec", [
        None, "", "/v1/a=250:99", "/v1/a=goodput:99.9, /v1/b=1000:95",
        "/v1/a=250:99,/v1/a=goodput:90"])
    def test_parse_objectives(self, spec):
        both(lambda m: [(o.route, o.kind, o.target, o.latency_s, o.budget)
                        for o in m["slo"].parse_objectives(spec)])

    @pytest.mark.parametrize("spec", [
        "v1/a=250:99", "/v1/a=250", "/v1/a=250:x", "/v1/a=250:100",
        "/v1/a=fast:99", "/v1/a=0:99", "/v1/a=250:99,/v1/a=300:90"])
    def test_parse_errors(self, spec):
        def run(m):
            with pytest.raises(ValueError) as exc:
                m["slo"].parse_objectives(spec)
            return str(exc.value)

        both(run)

    def test_burn_rates(self):
        """The same histogram and counter series, ticked on the same clock,
        give the same burn rates, gauges and breach counts."""
        rng = np.random.default_rng(0)
        latencies = rng.exponential(0.2, 600)
        outcomes = rng.choice(["ok", "ok", "ok", "late", "failed", "shed",
                               "client_error"], 600)

        def run(m):
            reg = m["metrics"].MetricsRegistry()
            clock = {"t": 0.0}
            engine = m["slo"].SloEngine(
                m["slo"].parse_objectives("/v1/a=250:90,/v1/a=goodput:80"),
                metrics=reg, fast_window_s=10.0, slow_window_s=40.0,
                tick_s=1.0, clock=lambda: clock["t"])
            hist = reg.histogram("ai4e_request_e2e_seconds", "")
            counter = reg.counter("ai4e_request_outcomes_total", "")
            ticks = []
            for step in range(60):
                for i in range(step * 10, step * 10 + 10):
                    hist.observe(float(latencies[i]), route="/v1/a")
                    counter.inc(route="/v1/a", outcome=str(outcomes[i]))
                clock["t"] = float(step)
                ticks.append(engine.tick())
            return ticks, reg.render_prometheus()

        ticks, text = both(run)
        assert ticks[-1][("/v1/a", "latency")]["fast"] > 0
        assert "ai4e_slo_breaches_total" in text


# -- the flight recorder -------------------------------------------------------

REQUESTS = [
    ("t1", "/v1/a", "completed - x", 12.0, [{"e": "popped"}], None),
    ("t2", "/v1/a", "failed - boom", 3000.0, [], None),
    ("t3", "/v1/a", "completed - x", 1500.0, [], None),
    ("t4", "/v1/a", "completed - x", 5.0, [{"e": "backpressure"}], None),
    ("t5", "/v1/a", "completed - x", 5.0, [{"e": "retry"}], None),
    (None, "/v1/b", None, None, None, "shed"),
    (None, "/v1/b", None, None, None, "expired"),
    (None, "/v1/b", "shed - HTTP 429", 2.0, None, None),
    ("t6", "/v1/a", "expired - x", 5.0, [], None),
    ("t7", "/v1/a", "finished", 5.0, [{"e": "dead_letter"}], None),
] + [(f"b{i}", "/v1/a", "completed - x", 5.0, [], None) for i in range(30)]


class TestFlight:
    @pytest.mark.parametrize("capacity,sample", [(512, 0.05), (8, 0.25),
                                                 (64, 0.0), (64, 1.0)])
    def test_entries_and_reasons(self, capacity, sample, monkeypatch):
        monkeypatch.setattr(time, "time", lambda: 5.0)

        def run(m):
            reg = m["metrics"].MetricsRegistry()
            fr = m["flight"].FlightRecorder(capacity=capacity, sample=sample,
                                            slow_ms=1000.0, metrics=reg)
            kept = [fr.record(tid, route, status=status, duration_ms=ms,
                              events=events, refusal=refusal, priority=1)
                    for tid, route, status, ms, events, refusal in REQUESTS]
            return (kept, fr.dump(), fr.entries(reason="failed"),
                    fr.entries(task_id="t4"), reg.render_prometheus())

        kept, dump, *_ = both(run)
        assert dump["by_reason"]

    def test_capacity_must_be_positive(self):
        def run(m):
            with pytest.raises(ValueError) as exc:
                m["flight"].FlightRecorder(capacity=0)
            return str(exc.value)

        both(run)


# -- the hub -------------------------------------------------------------------


class TestHub:
    def test_store_feed(self, monkeypatch):
        """Creation, a pipeline handoff, completions on time and late, a
        failure, a stamp on an evicted task, sync calls and refusals: the
        same ledgers, counters, e2e histogram and flight entries."""
        clock = {"t": 100.0}
        monkeypatch.setattr(time, "time", lambda: clock["t"])

        def run(m):
            clock["t"] = 100.0
            reg = m["metrics"].MetricsRegistry()
            store = m["store"]()
            hub = m["hub"].RequestObservability(
                store, metrics=reg, flight=m["flight"].FlightRecorder(
                    sample=1.0, metrics=reg))
            hub.map_route("/v1/be/run", "/v1/pub/run")
            tids = []
            for i, path in enumerate(["http://w/v1/be/run",
                                      "http://w/v1/be/run/tail?x=1",
                                      "http://w/v1/other"]):
                task = store.upsert(m["task"](
                    task_id=f"t{i}", endpoint=path, body=b"x",
                    deadline_at=(100.5 if i == 1 else 0.0)))
                tids.append(task.task_id)
            hub.stamp("t0", m["ledger"].ledger_event("popped", "dispatcher",
                                                     t=100.1))
            store.upsert(m["task"](task_id="t0", endpoint="http://w/v1/cls",
                                   body=b"", status="created",
                                   backend_status="created"))
            clock["t"] = 101.0
            store.update_status("t0", "completed - a",
                                backend_status="completed")
            store.update_status("t1", "completed - b",
                                backend_status="completed")
            store.update_status("t2", "failed - c", backend_status="failed")
            hub.stamp("missing", m["ledger"].ledger_event("x", "y", t=1.0))
            hub.stamp("t0")
            hub.observe_sync("/v1/pub/sync", 0.02, 200)
            hub.observe_sync("/v1/pub/sync", 0.02, 429)
            hub.observe_sync("/v1/pub/sync", 0.02, 404)
            hub.observe_sync("/v1/pub/sync", 2.0, 502)
            hub.record_refusal("/v1/pub/run", "expired", priority=2)
            hub.record_refusal("/v1/pub/run", "overload")
            text = reg.render_prometheus()
            return ({t: store.get_ledger(t) for t in tids},
                    hub.flight.dump(), text)

        ledgers, dump, text = both(run)
        assert [e["e"] for e in ledgers["t0"]] == ["popped", "stage",
                                                  "completed"]
        assert ledgers["t0"][1]["r"] == "/v1/be/run -> /v1/cls"
        assert '# exemplar ai4e_request_e2e_seconds_bucket' in text
        assert 'outcome="late",route="/v1/pub/run"' in text

    def test_gateway_assembly_and_flight_route(self, monkeypatch):
        """LocalPlatform with observability: the gateway maps async routes
        onto their published prefix, ``?ledger=1`` adds the timeline (the
        default answer unchanged), ``/v1/debug/flight`` answers; without
        it the route is 404 on both sides."""
        async def run(m, on: bool):
            platform = m["pa"].LocalPlatform(m["pa"].PlatformConfig(
                observability=on))
            platform.publish_async_api("/v1/pub/run",
                                       "http://127.0.0.1:9/v1/be/run")
            async with TestClient(TestServer(platform.gateway.app)) as c:
                flight = await c.get("/v1/debug/flight")
                task = platform.store.upsert(m["task"](
                    task_id="t1", endpoint="http://127.0.0.1:9/v1/be/run",
                    body=b"x"))
                platform.store.append_ledger(task.task_id, [
                    m["ledger"].ledger_event("popped", "dispatcher",
                                             t=1.0)])
                plain = await (await c.get(
                    "/v1/taskmanagement/task/t1")).json()
                with_ledger = await (await c.get(
                    "/v1/taskmanagement/task/t1",
                    params={"ledger": "1"})).json()
                off = await (await c.get("/v1/taskmanagement/task/t1",
                                         params={"ledger": "0"})).json()
                body = (await flight.json() if flight.status == 200
                        else None)
            for d in (plain, with_ledger, off):
                d.pop("Timestamp")
            return (flight.status, body and sorted(body), plain, with_ledger,
                    off, getattr(platform.observability, "_route_map", None))

        for on in (False, True):
            got = both(lambda m: asyncio.run(run(m, on)))
            assert got[0] == (200 if on else 404)
            assert "Ledger" not in got[2] and got[3]["Ledger"][0]["e"] == \
                "popped"

    def test_slo_needs_observability(self):
        def run(m):
            with pytest.raises(ValueError) as exc:
                m["pa"].LocalPlatform(m["pa"].PlatformConfig(
                    slo_objectives="/v1/a=250:99"))
            return str(exc.value).split(" — ")[0]

        both(run)


# -- depth gauges and vitals -----------------------------------------------------


class TestDepthAndVitals:
    def test_depth_logger_samples(self):
        def run(m):
            reg = m["metrics"].MetricsRegistry()
            store = m["store"]()
            for i, status in enumerate(["created", "created", "running",
                                        "completed", "failed"]):
                store.upsert(m["task"](task_id=f"t{i}", endpoint="/v1/a",
                                       status=status, backend_status=status))
            logger = m["depth"].DepthLogger(store, metrics=reg)
            return (logger.sample_queue_depth(),
                    logger.sample_process_depths(), reg.render_prometheus())

        both(run)

    def test_depth_logger_timers(self):
        async def run(m):
            reg = m["metrics"].MetricsRegistry()
            store = m["store"]()
            store.upsert(m["task"](task_id="t", endpoint="/v1/a"))
            logger = m["depth"].DepthLogger(store, metrics=reg,
                                            queue_interval=0.01,
                                            process_interval=0.01)
            await logger.start()
            await asyncio.sleep(0.05)
            await logger.stop()
            return reg.gauge("ai4e_task_depth", "").value(
                endpoint="/v1/a", status="created")

        assert both(lambda m: asyncio.run(run(m))) == 1.0

    def test_proc_readers_on_a_fake_proc(self, tmp_path):
        """The /proc parsers on the same files: RSS, CPU seconds (a comm
        with spaces and parentheses), fds, the host's cpu line."""
        proc = tmp_path / "proc"
        (proc / "self" / "fd").mkdir(parents=True)
        for fd in range(5):
            (proc / "self" / "fd" / str(fd)).touch()
        (proc / "self" / "status").write_text("Name:\tx\nVmRSS:\t  2048 kB\n")
        (proc / "self" / "stat").write_text(
            "1 (a (b) c) S " + " ".join(str(i) for i in range(1, 50)))
        (proc / "stat").write_text("cpu  10 0 5 100 1 0 0 7\ncpu0 1 2 3\n")
        got = both(lambda m: (
            m["vitals"].read_rss_bytes(proc_root=str(proc)),
            m["vitals"].read_cpu_seconds(proc_root=str(proc)),
            m["vitals"].read_fd_count(proc_root=str(proc)),
            m["vitals"].read_host_cpu_ticks(str(proc)),
            m["vitals"].read_rss_bytes(proc_root=str(tmp_path / "none"))))
        assert got[0] == 2048 * 1024 and got[2] == 5 and got[4] == -1.0

    def test_sampler_series(self):
        """One loop-driven sampler per side: the same ``ai4e_process_*``
        families, and a sample with the same keys."""
        async def run(m):
            reg = m["metrics"].MetricsRegistry()
            sampler = m["vitals"].VitalsSampler(reg, interval_s=0.02)
            await sampler.start()
            await asyncio.sleep(0.1)
            await sampler.stop()
            recent = sampler.recent()
            return sorted(reg._metrics), sorted(recent[-1])

        families, keys = both(lambda m: asyncio.run(run(m)))
        assert "ai4e_process_loop_lag_seconds" in families
        assert "lag_s" in keys


# -- traceview and the timeline --------------------------------------------------


class TestTraceviewAndTimeline:
    def test_traceview(self, tmp_path):
        path = tmp_path / "spans.jsonl"
        lines = [json.dumps(s.to_dict()) for s in spans_of(port_tracing)]
        path.write_text("\n".join(lines[:2] + ["{garbage", "", "[1]"]
                                  + lines[2:]) + "\n{\"trace_id\": \"x\"")

        def run(m):
            tv = m["traceview"]
            spans = tv.load_spans(str(path))
            return (spans, tv.render_trace(spans),
                    tv.render_trace(tv.select_traces(spans, task_id="t1")),
                    tv.select_traces(spans, trace_id="b" * 32),
                    tv.render_list(spans), tv.render_list(spans, limit=1))

        spans, tree, *_ = both(run)
        assert len(spans) == 4 and "ERROR" in tree

    def test_chrome_trace(self):
        ledgers = {
            "t1": [{"e": e, "h": h, "t": t, **({"r": r} if r else {}),
                    **({"ms": ms} if ms is not None else {})}
                   for e, h, t, r, ms in STAMPS],
            "t2": [{"e": "admitted", "h": "gateway", "t": 100.001},
                   {"e": "completed", "h": "store", "t": 100.5,
                    "r": "failed"}],
            "t3": [], "t4": [{"e": "admitted", "h": "gateway", "t": 101.0}]}
        vitals = {"cp": [{"t": 100.2, "lag_s": 0.001, "rss_bytes": 2 ** 20},
                         {"t": 100.4, "rss_bytes": -1.0}]}
        chaos = [{"verb": "kill", "t": 100.3, "who": "w"}, {"verb": "x"}]
        loadgen = {"lg": [{"t": 100.1, "accepted": 3, "terminal": 1}]}
        out = both(lambda m: json.dumps(m["timeline"].build_chrome_trace(
            ledgers, chaos=chaos, vitals=vitals, loadgen_samples=loadgen)))
        both(lambda m: m["timeline"].build_chrome_trace({}))
        assert json.loads(out)["otherData"]["tasks"] == 3


# -- exemplars -------------------------------------------------------------------


class TestExemplars:
    def test_same_exposition(self, monkeypatch):
        monkeypatch.setattr(time, "time", lambda: 9.0)

        def run(m):
            reg = m["metrics"].MetricsRegistry()
            hist = reg.histogram("ai4e_request_e2e_seconds", "e2e")
            hist.observe(0.03, route="/v1/x", exemplar={"task_id": "a"})
            hist.observe(0.04, route="/v1/x", exemplar={"task_id": "b"})
            hist.observe(7.0, route="/v1/x", exemplar={"task_id": "c",
                                                       "trace_id": "d"})
            hist.observe(0.2, route="/v1/y")
            return reg.render_prometheus()

        text = both(run)
        lines = text.splitlines()
        i = next(i for i, ln in enumerate(lines) if ln.startswith("# exemp"))
        assert lines[i - 1].startswith("ai4e_request_e2e_seconds_bucket")
        assert 'task_id="b"' in lines[i] and " 0.04 9.0" in lines[i]
        assert sum(ln.startswith("# exemplar") for ln in lines) == 2

    def test_no_exemplar_no_line(self):
        text = both(lambda m: _plain_exposition(m["metrics"]))
        assert "# exemplar" not in text


def _plain_exposition(metrics) -> str:
    reg = metrics.MetricsRegistry()
    reg.histogram("h", "x").observe(0.2, route="/r")
    reg.counter("c", "y").inc(route="/r")
    return reg.render_prometheus()


# -- the config's exporters and the trace verb -----------------------------------


class TestConfigAndCli:
    @pytest.mark.parametrize("env", [
        {}, {"AI4E_OBSERVABILITY_TRACE_ENABLED": "0"},
        {"AI4E_OBSERVABILITY_TRACE_SAMPLE_RATE": "0.25"},
        {"AI4E_OBSERVABILITY_TRACE_EXPORT_PATH": "{tmp}/s.jsonl"},
        {"AI4E_OBSERVABILITY_TRACE_EXPORT_PATH": "{tmp}/s.jsonl",
         "AI4E_OBSERVABILITY_TRACE_OTLP_ENDPOINT":
             "http://127.0.0.1:9/v1/traces"}], ids=lambda e: "-".join(e) or
        "defaults")
    def test_apply_installs_the_same_tracer(self, env, tmp_path,
                                            monkeypatch):
        import atexit
        monkeypatch.setattr(atexit, "register", lambda fn: None)
        env = {k: v.format(tmp=tmp_path) for k, v in env.items()}

        def run(m):
            m["config"].FrameworkConfig.from_env(env).observability.apply()
            tracer = m["tracing"].get_tracer()
            exporter = tracer.exporter
            names = ([type(e).__name__ for e in exporter.exporters]
                     if hasattr(exporter, "exporters")
                     else type(exporter).__name__)
            rate = tracer.sample_rate
            close = getattr(exporter, "close", None)
            if close is not None:
                close()
            m["tracing"].configure_tracer(exporter=None, sample_rate=None)
            return names, rate

        both(run)

    def test_trace_verb_over_a_span_log(self, tmp_path, capsys):
        path = tmp_path / "spans.jsonl"
        path.write_text("".join(json.dumps(s.to_dict()) + "\n"
                                for s in spans_of(port_tracing)))
        for argv in (["--export", str(path), "--task-id", "t1"],
                     ["--export", str(path), "--list"],
                     ["--export", str(path), "--trace-id", "b" * 32]):
            out = {}
            for side in ("jax", "port"):
                SIDES[side]["cli"].main(["trace", *argv])
                out[side] = capsys.readouterr().out
            assert out["port"] == out["jax"] and out["port"]

    def test_trace_verb_live_ledger(self):
        """``trace --url --task-id`` in a child process against a port
        control plane: exit 0, every hop rendered; an unknown task exits
        with the gateway's 404."""
        async def main():
            platform = port_pa.LocalPlatform(port_pa.PlatformConfig(
                observability=True))
            task = platform.store.upsert(PortTask(task_id="t1",
                                                  endpoint="/v1/a"))
            platform.store.append_ledger(task.task_id, [
                port_ledger.ledger_event(e, h, t=t, reason=r, ms=ms)
                for e, h, t, r, ms in STAMPS])
            server = TestServer(platform.gateway.app)
            await server.start_server()
            try:
                url = str(server.make_url("")).rstrip("/")
                env = {**os.environ,
                       "PYTHONPATH": str(ROOT) + os.pathsep
                       + os.environ.get("PYTHONPATH", "")}
                runs = []
                for tid in ("t1", "nope"):
                    proc = await asyncio.create_subprocess_exec(
                        sys.executable, "-m", "ai4e_tpu_torch", "trace",
                        "--task-id", tid, "--url", url, cwd=ROOT, env=env,
                        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                    out, err = await asyncio.wait_for(proc.communicate(), 120)
                    runs.append((proc.returncode, out.decode(),
                                 err.decode()))
                return runs
            finally:
                await server.close()

        (rc, out, err), (rc404, _, err404) = asyncio.run(main())
        assert rc == 0, err
        assert out == port_ledger.render_ledger(
            "t1", [port_ledger.ledger_event(e, h, t=t, reason=r, ms=ms)
                   for e, h, t, r, ms in STAMPS], status="created") + "\n"
        for e, *_ in STAMPS:
            assert e in out
        assert rc404 != 0 and "HTTP 404" in err404

    def test_trace_verb_needs_a_task_or_a_log(self, monkeypatch):
        monkeypatch.delenv("AI4E_OBSERVABILITY_TRACE_EXPORT_PATH",
                           raising=False)
        for argv in (["trace", "--url", "http://127.0.0.1:9"], ["trace"]):
            msgs = {}
            for side in ("jax", "port"):
                with pytest.raises(SystemExit) as exc:
                    SIDES[side]["cli"].main(argv)
                msgs[side] = str(exc.value)
            assert msgs["port"] == msgs["jax"]
