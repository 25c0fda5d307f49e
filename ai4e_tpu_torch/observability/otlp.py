"""OTLP/HTTP trace exporter — spans to an OpenTelemetry collector; a copy
of ``ai4e_tpu/observability/otlp.py``.

Spans go over OTLP/HTTP JSON (``POST {endpoint}`` with an
``ExportTraceServiceRequest`` body), and the collector fans out to any
trace backend.

- Telemetry must never block serving: ``export`` is an O(1) enqueue; a
  background thread batches and ships. On overflow the OLDEST spans drop
  (newest context survives) and ``dropped`` counts them.
- No OTLP SDK: the wire format is plain JSON over HTTP (stdlib urllib);
  span and trace ids are already OTLP's widths (16/32 hex characters).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from collections import deque

from .tracing import Span

log = logging.getLogger("ai4e_tpu_torch.trace.otlp")

_STATUS_OK = 1
_STATUS_ERROR = 2


def _hex_id(value: str, width: int) -> str:
    """Normalize an id to exactly ``width`` lowercase hex chars — OTLP
    requires 32/16 and rejects the WHOLE batch otherwise. Inbound B3 headers
    are client-supplied: a 64-bit (16-hex) B3 trace id zero-pads, anything
    malformed maps through a hash so correlation within the trace is kept
    without poisoning the batch."""
    v = (value or "").lower()
    if len(v) <= width:
        try:
            int(v or "0", 16)
            return v.rjust(width, "0")
        except ValueError:
            pass
    import hashlib
    return hashlib.md5(v.encode()).hexdigest()[:width]


def span_to_otlp(span: Span) -> dict:
    """One tracing.Span → one OTLP JSON span."""
    attrs = [{"key": "service.component",
              "value": {"stringValue": span.service}}]
    if span.task_id:
        # TaskId is THE correlation key of this platform (every reference
        # log line carries it, AppInsightsLogger.cs:43-55).
        attrs.append({"key": "ai4e.task_id",
                      "value": {"stringValue": span.task_id}})
    for k, v in span.attrs.items():
        attrs.append({"key": str(k), "value": {"stringValue": str(v)}})
    start_ns = int(span.start * 1e9)
    out = {
        "traceId": _hex_id(span.trace_id, 32),
        "spanId": _hex_id(span.span_id, 16),
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(start_ns + int(span.duration * 1e9)),
        "attributes": attrs,
        "status": ({"code": _STATUS_ERROR, "message": span.error or ""}
                   if span.status == "error" else {"code": _STATUS_OK}),
    }
    if span.parent_id:
        out["parentSpanId"] = _hex_id(span.parent_id, 16)
    return out


def spans_to_request(spans: list[Span]) -> dict:
    """Batch → ExportTraceServiceRequest JSON, grouped by service name (one
    OTLP resource per service so the collector attributes spans correctly)."""
    by_service: dict[str, list[dict]] = {}
    for span in spans:
        by_service.setdefault(span.service, []).append(span_to_otlp(span))
    return {"resourceSpans": [
        {
            "resource": {"attributes": [
                {"key": "service.name", "value": {"stringValue": service}}]},
            "scopeSpans": [{"scope": {"name": "ai4e_tpu"},
                            "spans": otlp_spans}],
        }
        for service, otlp_spans in by_service.items()]}


class OtlpHttpExporter:
    """Batching OTLP/HTTP JSON exporter.

    ``endpoint`` is the full traces URL (e.g.
    ``http://ai4e-otel-collector:4318/v1/traces``).
    """

    def __init__(self, endpoint: str, flush_interval: float = 2.0,
                 max_batch: int = 512, max_queue: int = 4096,
                 timeout: float = 10.0):
        self.endpoint = endpoint
        self.flush_interval = flush_interval
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.timeout = timeout
        self.dropped = 0          # overflow drops (oldest first)
        self.export_errors = 0    # failed POST batches (spans lost)
        self.exported = 0         # spans successfully shipped
        self._queue: deque[Span] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._run,
                                        name="ai4e-otlp-export", daemon=True)
        self._thread.start()

    def export(self, span: Span) -> None:
        with self._cond:
            if self._closed:
                return
            if len(self._queue) >= self.max_queue:
                self._queue.popleft()
                self.dropped += 1
            self._queue.append(span)
            if len(self._queue) >= self.max_batch:
                self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                if not self._closed and len(self._queue) < self.max_batch:
                    self._cond.wait(self.flush_interval)
                batch = [self._queue.popleft()
                         for _ in range(min(len(self._queue),
                                            self.max_batch))]
                closed = self._closed
            if batch:
                self._post(batch)
            if closed:
                with self._cond:
                    if not self._queue:
                        return

    def _post(self, batch: list[Span]) -> None:
        body = json.dumps(spans_to_request(batch)).encode()
        req = urllib.request.Request(
            self.endpoint, data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
            self.exported += len(batch)
        except Exception as exc:  # noqa: BLE001 — telemetry must not break serving
            self.export_errors += 1
            # Drop the batch: retrying would back up behind a dead collector
            # and the queue bound would shed newer (more useful) spans.
            log.warning("OTLP export of %d spans to %s failed: %s",
                        len(batch), self.endpoint, exc)

    def close(self, timeout: float = 5.0) -> None:
        """Flush what's queued and stop the export thread."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout)
