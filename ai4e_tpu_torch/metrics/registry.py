"""Metrics registry — counters, gauges, histograms with label dims,
exported in Prometheus text format. A copy of ``ai4e_tpu/metrics/
registry.py``, so the port imports nothing of the JAX package."""

from __future__ import annotations

import threading
import time
from collections import defaultdict

LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict[str, str] | None) -> LabelKey:
    return tuple(sorted((labels or {}).items()))


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[LabelKey, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] += amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def collect(self):
        with self._lock:
            return [("counter", self.name, dict(k), v) for k, v in self._values.items()]


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[LabelKey, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] += amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def collect(self):
        with self._lock:
            return [("gauge", self.name, dict(k), v) for k, v in self._values.items()]


class Histogram:
    """Fixed-bucket histogram (seconds by default)."""

    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                       2.5, 5.0, 10.0, 30.0, 60.0, float("inf"))

    def __init__(self, name: str, help_: str = "", buckets=DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(buckets)
        self._counts: dict[LabelKey, list[int]] = {}
        self._sums: dict[LabelKey, float] = defaultdict(float)
        # Exemplars: (labelkey, bucket index) -> the LAST observation that
        # landed there carrying one, so a bucket in /metrics links to a
        # task id the trace verb or the flight recorder takes. Only
        # callers that pass one populate it; without them the exposition
        # is byte-identical.
        self._exemplars: dict[LabelKey, dict[int, tuple[dict, float, float]]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: dict | None = None,
                **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    if exemplar:
                        self._exemplars.setdefault(key, {})[i] = (
                            dict(exemplar), value, time.time())
                    break
            self._sums[key] += value

    def quantile(self, q: float, **labels: str) -> float:
        """The ``q`` quantile, approximated by the upper edge of the bucket
        in which it falls (0.0 before any observation)."""
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.get(key)
            if not counts:
                return 0.0
            target = q * sum(counts)
            run = 0
            for i, c in enumerate(counts):
                run += c
                if run >= target:
                    return self.buckets[i]
            return self.buckets[-1]

    def collect(self):
        with self._lock:
            out = []
            for key, counts in self._counts.items():
                data = {"buckets": list(zip(self.buckets, counts)),
                        "sum": self._sums[key], "count": sum(counts)}
                exemplars = self._exemplars.get(key)
                if exemplars:
                    data["exemplars"] = dict(exemplars)
                out.append(("histogram", self.name, dict(key), data))
            return out


class Timer:
    """A ``with`` block's wall seconds observed into ``hist`` under
    ``labels``."""

    def __init__(self, hist: Histogram, **labels: str):
        self.hist, self.labels = hist, labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self._t0, **self.labels)
        return False


class MetricsRegistry:
    """Named registry; the service shell, batcher and runtime share one."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "",
                  buckets=Histogram.DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, lambda: Histogram(name, help_, buckets),
                                   Histogram)

    def _get_or_create(self, name, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {type(m).__name__}")
            return m

    def render_prometheus(self) -> str:
        """Prometheus text exposition."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        kind_by_cls = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {kind_by_cls[type(m)]}")
            for kind, name, labels, value in m.collect():
                label_s = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
                label_s = "{" + label_s + "}" if label_s else ""
                if kind == "histogram":
                    cum = 0
                    exemplars = value.get("exemplars") or {}
                    for i, (edge, c) in enumerate(value["buckets"]):
                        cum += c
                        le = "+Inf" if edge == float("inf") else repr(edge)
                        inner = dict(labels, le=le)
                        ls = ",".join(f'{k}="{v}"' for k, v in sorted(inner.items()))
                        lines.append(f"{name}_bucket{{{ls}}} {cum}")
                        if i in exemplars:
                            # A standalone comment line under its bucket:
                            # the classic text format has no exemplar
                            # syntax, and OpenMetrics' trailing `# {...}`
                            # would fail a classic scrape; every classic
                            # parser skips a full-line comment.
                            ex_labels, ex_value, ex_ts = exemplars[i]
                            exs = ",".join(f'{k}="{v}"' for k, v
                                           in sorted(ex_labels.items()))
                            lines.append(
                                f"# exemplar {name}_bucket{{{ls}}} "
                                f"{{{exs}}} {ex_value} {ex_ts}")
                    lines.append(f"{name}_sum{label_s} {value['sum']}")
                    lines.append(f"{name}_count{label_s} {value['count']}")
                else:
                    lines.append(f"{name}{label_s} {value}")
        return "\n".join(lines) + "\n"


DEFAULT_REGISTRY = MetricsRegistry()
