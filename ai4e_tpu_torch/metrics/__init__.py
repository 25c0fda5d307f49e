from .registry import (DEFAULT_REGISTRY, Counter, Gauge, Histogram,
                       MetricsRegistry)
from .reporter import (ProcessingCounters, ProcessingReporterClient,
                       RequestReporterService)

__all__ = ["DEFAULT_REGISTRY", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "ProcessingCounters",
           "ProcessingReporterClient", "RequestReporterService"]
