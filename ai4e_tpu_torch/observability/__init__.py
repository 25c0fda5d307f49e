"""Observability — a copy of ``ai4e_tpu/observability/``: distributed
tracing keyed by TaskId (B3 headers across the gateway → dispatcher →
worker hops, spans as metrics, JSONL and OTLP exporters), the per-task hop
ledger, the tail-sampled flight recorder, the SLO burn-rate engine, the
queue-depth gauges and the per-process vitals, the fleet collector
(``federation.py``), ``top`` and the ``timeline`` verb, over a rig
directory too. Nothing here imports torch at module level: the control
plane never loads it.
"""

from .depth_logger import DepthLogger
from .flight import FlightRecorder
from .hub import RequestObservability
from .ledger import HopLedger, ledger_event, render_ledger
from .slo import SloEngine, SloObjective, parse_objectives
from .tracing import (
    PARENT_HEADER,
    SAMPLED_HEADER,
    SPAN_HEADER,
    TRACE_HEADER,
    FanoutExporter,
    InMemoryExporter,
    JsonlExporter,
    LogExporter,
    Span,
    Tracer,
    configure_tracer,
    device_trace,
    get_tracer,
)

__all__ = [
    "DepthLogger",
    "FanoutExporter",
    "FlightRecorder",
    "HopLedger",
    "InMemoryExporter",
    "JsonlExporter",
    "LogExporter",
    "PARENT_HEADER",
    "RequestObservability",
    "SAMPLED_HEADER",
    "SPAN_HEADER",
    "SloEngine",
    "SloObjective",
    "Span",
    "TRACE_HEADER",
    "Tracer",
    "configure_tracer",
    "device_trace",
    "get_tracer",
    "ledger_event",
    "parse_objectives",
    "render_ledger",
]
