"""Spans, propagation, and exporters — one trace per task; a copy of
``ai4e_tpu/observability/tracing.py``.

- every endpoint execution is wrapped in a span (the gateway's
  ``create_task``, the dispatcher's ``dispatch``, the service shell's
  endpoint span);
- trace context crosses process boundaries in the B3 headers
  (``x-b3-traceid`` / ``x-b3-spanid`` / ``x-b3-sampled``), which meshes
  such as Istio propagate;
- span durations double as latency metrics (``ai4e_span_seconds``).

``device_trace`` puts a named range into a ``torch.profiler`` trace, so
a request span and its device work line up in one timeline; the JAX
package defines its counterpart and calls it nowhere on its path, and so
does the port.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field

log = logging.getLogger("ai4e_tpu_torch.trace")

# Same header names Istio/B3 uses (configuration.yaml:10-13) so meshes that
# already speak B3 interoperate with no translation.
TRACE_HEADER = "x-b3-traceid"
SPAN_HEADER = "x-b3-spanid"
PARENT_HEADER = "x-b3-parentspanid"
SAMPLED_HEADER = "x-b3-sampled"


def _new_trace_id() -> str:
    return uuid.uuid4().hex


def _new_span_id() -> str:
    return os.urandom(8).hex()


@dataclass
class Span:
    name: str
    service: str
    trace_id: str
    span_id: str
    parent_id: str | None = None
    task_id: str | None = None
    start: float = 0.0          # epoch seconds
    duration: float = 0.0       # seconds
    status: str = "ok"          # ok | error
    error: str | None = None
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "name": self.name, "service": self.service,
            "trace_id": self.trace_id, "span_id": self.span_id,
            "start": self.start, "duration": self.duration,
            "status": self.status,
        }
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.task_id:
            d["task_id"] = self.task_id
        if self.error:
            d["error"] = self.error
        if self.attrs:
            d["attrs"] = self.attrs
        return d


# -- exporters ---------------------------------------------------------------


class LogExporter:
    """Spans to the Python log, one INFO line a span (the default)."""

    def export(self, span: Span) -> None:
        log.info("span %s/%s trace=%s task=%s %.1fms %s",
                 span.service, span.name, span.trace_id,
                 span.task_id or "-", span.duration * 1e3, span.status)


class JsonlExporter:
    """Append-only JSONL span log; one line per span, safe across
    threads."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8")

    def export(self, span: Span) -> None:
        line = json.dumps(span.to_dict(), separators=(",", ":"))
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            self._fh.close()


class FanoutExporter:
    """Ship every span to several sinks (e.g. a local JSONL log AND the
    OTLP collector); one sink failing must not starve the others."""

    def __init__(self, exporters):
        self.exporters = list(exporters)

    def export(self, span: Span) -> None:
        for exporter in self.exporters:
            try:
                exporter.export(span)
            except Exception:  # noqa: BLE001 — telemetry must not break serving
                log.exception("span export failed in %s",
                              type(exporter).__name__)

    def close(self) -> None:
        for exporter in self.exporters:
            close = getattr(exporter, "close", None)
            if close is None:
                continue
            try:
                close()
            except Exception:  # noqa: BLE001 — one sink must not starve the rest
                log.exception("exporter close failed in %s",
                              type(exporter).__name__)


class InMemoryExporter:
    """Test sink."""

    def __init__(self):
        self.spans: list[Span] = []

    def export(self, span: Span) -> None:
        self.spans.append(span)

    def by_trace(self, trace_id: str) -> list[Span]:
        return [s for s in self.spans if s.trace_id == trace_id]

    def by_task(self, task_id: str) -> list[Span]:
        return [s for s in self.spans if s.task_id == task_id]


# -- tracer ------------------------------------------------------------------

# (trace_id, span_id, sampled) of the active span in this execution context.
_CURRENT: contextvars.ContextVar[tuple[str, str, bool] | None] = \
    contextvars.ContextVar("ai4e_trace_current", default=None)


class Tracer:
    """Creates spans, propagates context, exports on close.

    Works identically in sync and async code: the active span lives in a
    ``contextvars.ContextVar``, which asyncio tasks inherit and isolate
    automatically.
    """

    def __init__(self, service: str, exporter=None,
                 sample_rate: float | None = None, metrics=None):
        self.service = service
        # None → follow the process tracer *live* (resolved per span), so
        # configure_tracer() after component construction applies everywhere.
        # Same rule for metrics: a component tracer built WITH a registry
        # (every assembly-owned component passes its own) lands
        # ai4e_span_seconds there; without one it follows the process
        # tracer, then the process default — resolved per observation, not
        # frozen at construction, so construction order does not matter.
        self.exporter = exporter
        self.sample_rate = sample_rate
        self.metrics = metrics
        # (resolved registry, its histogram) — avoids re-taking the
        # registry's get-or-create lock on every span observation while
        # still following a live configure_tracer(metrics=...) rebinding.
        self._span_hist_cache: tuple | None = None

    def _effective_exporter(self):
        if self.exporter is not None:
            return self.exporter
        if self is not _GLOBAL and _GLOBAL.exporter is not None:
            return _GLOBAL.exporter
        return _DEFAULT_EXPORTER

    def _effective_metrics(self):
        # When self IS the global tracer, self.metrics and _GLOBAL.metrics
        # are the same attribute, so one or-chain covers every case.
        from ..metrics import DEFAULT_REGISTRY
        return self.metrics or _GLOBAL.metrics or DEFAULT_REGISTRY

    def _span_seconds(self):
        reg = self._effective_metrics()
        cached = self._span_hist_cache
        if cached is None or cached[0] is not reg:
            cached = (reg, reg.histogram(
                "ai4e_span_seconds", "Span durations by span name"))
            self._span_hist_cache = cached
        return cached[1]

    def _effective_sample_rate(self) -> float:
        if self.sample_rate is not None:
            return self.sample_rate
        if self is not _GLOBAL and _GLOBAL.sample_rate is not None:
            return _GLOBAL.sample_rate
        return 1.0

    # -- propagation -------------------------------------------------------

    def headers(self) -> dict[str, str]:
        """Outbound headers for the active span (inject before any HTTP hop)."""
        cur = _CURRENT.get()
        if cur is None:
            return {}
        trace_id, span_id, sampled = cur
        return {TRACE_HEADER: trace_id, SPAN_HEADER: span_id,
                SAMPLED_HEADER: "1" if sampled else "0"}

    @staticmethod
    def parent_from(headers) -> tuple[str, str, bool] | None:
        """Parse inbound x-b3 headers (case-insensitive mappings like aiohttp's
        work directly)."""
        trace_id = headers.get(TRACE_HEADER)
        if not trace_id:
            return None
        span_id = headers.get(SPAN_HEADER, "")
        sampled = headers.get(SAMPLED_HEADER, "1") != "0"
        return (trace_id, span_id, sampled)

    # -- spans -------------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, task_id: str | None = None,
             headers=None, **attrs):
        """Open a span; yields the ``Span`` (mutable — add attrs mid-flight).

        Parent resolution order: explicit inbound ``headers`` → the active
        span in this context → new root trace. The sampling decision is made
        once at the root and inherited.
        """
        parent = self.parent_from(headers) if headers else None
        if parent is None:
            parent = _CURRENT.get()
        if parent is not None:
            trace_id, parent_id, sampled = parent
            parent_id = parent_id or None
        else:
            trace_id, parent_id = _new_trace_id(), None
            sampled = _sample(trace_id, self._effective_sample_rate())
        if self._effective_sample_rate() <= 0.0:
            # Hard off (trace_enabled=0) beats inherited x-b3-sampled:1 —
            # a B3-speaking mesh stamps every request as sampled, and the
            # kill switch must still kill local export.
            sampled = False

        span = Span(name=name, service=self.service, trace_id=trace_id,
                    span_id=_new_span_id(), parent_id=parent_id,
                    task_id=task_id, start=time.time(), attrs=dict(attrs))
        token = _CURRENT.set((trace_id, span.span_id, sampled))
        t0 = time.perf_counter()
        try:
            yield span
        except BaseException as exc:
            span.status = "error"
            span.error = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            _CURRENT.reset(token)
            span.duration = time.perf_counter() - t0
            self._span_seconds().observe(span.duration, name=name,
                                         service=self.service)
            if sampled:
                try:
                    self._effective_exporter().export(span)
                except Exception:  # noqa: BLE001 — telemetry must not break serving
                    log.exception("span export failed")

    def current_trace_id(self) -> str | None:
        cur = _CURRENT.get()
        return cur[0] if cur else None


def _sample(trace_id: str, rate: float) -> bool:
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    # Deterministic per-trace: every service in the hop chain keeps or drops
    # the same traces.
    return (int(trace_id[:8], 16) / 0xFFFFFFFF) < rate


# -- process-global tracer ---------------------------------------------------

_DEFAULT_EXPORTER = LogExporter()
_GLOBAL = Tracer("ai4e")
_UNSET = object()


def get_tracer() -> Tracer:
    return _GLOBAL


def configure_tracer(service: str | None = None, exporter=_UNSET,
                     sample_rate=_UNSET, metrics=_UNSET) -> Tracer:
    """Reconfigure the process tracer in place. Component tracers built
    without an explicit exporter/sample_rate/metrics (every
    service/gateway/dispatcher default) follow these settings live. Pass
    ``None`` explicitly to reset a field to its default (LogExporter /
    rate 1.0 / the process-default metrics registry)."""
    if service is not None:
        _GLOBAL.service = service
    if exporter is not _UNSET:
        _GLOBAL.exporter = exporter
    if sample_rate is not _UNSET:
        _GLOBAL.sample_rate = sample_rate
    if metrics is not _UNSET:
        _GLOBAL.metrics = metrics
    return _GLOBAL


# -- profiler bridge ---------------------------------------------------------


@contextlib.contextmanager
def device_trace(name: str):
    """Annotate work so it lines up with request spans in a
    ``torch.profiler`` trace (``torch.profiler.record_function``); costs
    a range push and pop when no profiler is active. torch is imported
    here, not with the module: the control plane never loads it."""
    import torch.profiler

    with torch.profiler.record_function(name):
        yield
