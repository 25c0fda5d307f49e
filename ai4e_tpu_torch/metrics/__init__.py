from .registry import (DEFAULT_REGISTRY, Counter, Gauge, Histogram,
                       MetricsRegistry)

__all__ = ["DEFAULT_REGISTRY", "Counter", "Gauge", "Histogram",
           "MetricsRegistry"]
