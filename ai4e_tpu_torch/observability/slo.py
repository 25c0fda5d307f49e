"""SLO objectives + multi-window burn-rate engine; a copy of
``ai4e_tpu/observability/slo.py``.

The platform emits latency histograms and outcome counters; an operator
still has to decide "is this fine". An SLO makes that decision a
declared number: per-route objectives live in ``PlatformConfig``
(``slo_objectives``), the engine periodically snapshots the registry's
own histograms/counters, and exports **burn rate** — how many times
faster than sustainable the error budget is being spent — over a fast
and a slow window (the classic multi-window multi-burn alert shape:
page when BOTH burn, so a blip doesn't page and a slow leak doesn't
hide). With ``slo_ladder`` a sustained breach feeds the degradation
ladder as further miss evidence, so the brownout reacts to SLO burn, not
only to deadline-miss predictions.

Objective grammar (``AI4E_PLATFORM_SLO_OBJECTIVES``)::

    "<route>=<latency_ms>:<target_pct>[,...]"   latency objective
    "<route>=goodput:<target_pct>[,...]"        goodput objective

e.g. ``/v1/echo-async=250:99,/v1/echo=goodput:99.9`` — 99 % of
``/v1/echo-async`` requests end-to-end under 250 ms, and 99.9 % of
``/v1/echo`` requests reach a good terminal outcome.

Sources (both maintained by ``hub.RequestObservability``):

- latency: ``ai4e_request_e2e_seconds{route}`` bucket counts — "good"
  is the cumulative count at the smallest bucket edge >= the threshold
  (the bucket-edge approximation every Prometheus SLO recording rule
  makes; pick thresholds on bucket edges for exactness);
- goodput: ``ai4e_request_outcomes_total{route,outcome}`` — good is
  ``ok``, bad is ``late`` / ``expired`` / ``failed`` / ``shed``.

Burn math: with target t, the error budget is ``1 - t``; over a window
with g good of n total events, ``bad_ratio = 1 - g/n`` and
``burn_rate = bad_ratio / (1 - t)``. Burn 1.0 = spending the budget
exactly as fast as the SLO allows; 14.4 over 5 m is the classic page.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry

log = logging.getLogger("ai4e_tpu_torch.slo")

E2E_HISTOGRAM = "ai4e_request_e2e_seconds"
OUTCOMES_COUNTER = "ai4e_request_outcomes_total"
BAD_OUTCOMES = ("late", "expired", "failed", "shed")


@dataclass(frozen=True)
class SloObjective:
    route: str
    kind: str                  # "latency" | "goodput"
    target: float              # good fraction, e.g. 0.99
    latency_s: float = 0.0     # latency objectives only

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.target)


def parse_objectives(spec: str | None) -> list[SloObjective]:
    """Parse the config grammar; raises ValueError with the offending
    clause — a malformed objective must fail at assembly, not silently
    monitor nothing."""
    out: list[SloObjective] = []
    for clause in (spec or "").split(","):
        clause = clause.strip()
        if not clause:
            continue
        route, sep, rhs = clause.partition("=")
        route = route.strip()
        if not sep or not route.startswith("/"):
            raise ValueError(
                f"bad SLO objective {clause!r}: expected "
                "'/route=<latency_ms>:<target_pct>' or "
                "'/route=goodput:<target_pct>'")
        what, sep2, pct = rhs.partition(":")
        if not sep2:
            raise ValueError(
                f"bad SLO objective {clause!r}: missing ':<target_pct>'")
        try:
            target = float(pct) / 100.0
        except ValueError as exc:
            raise ValueError(
                f"bad SLO objective {clause!r}: target {pct!r} is not a "
                "number") from exc
        if not (0.0 < target < 1.0):
            raise ValueError(
                f"bad SLO objective {clause!r}: target must be in "
                "(0, 100) percent exclusive")
        if what.strip().lower() == "goodput":
            out.append(SloObjective(route=route, kind="goodput",
                                    target=target))
            continue
        try:
            latency_ms = float(what)
        except ValueError as exc:
            raise ValueError(
                f"bad SLO objective {clause!r}: {what!r} is neither a "
                "latency in ms nor 'goodput'") from exc
        if latency_ms <= 0:
            raise ValueError(
                f"bad SLO objective {clause!r}: latency must be > 0 ms")
        out.append(SloObjective(route=route, kind="latency", target=target,
                                latency_s=latency_ms / 1000.0))
    seen: set[tuple[str, str]] = set()
    for obj in out:
        key = (obj.route, obj.kind)
        if key in seen:
            # The engine keys its snapshot rings and gauges by
            # (route, kind): a second objective of the same kind on one
            # route would silently share a ring (mixed-threshold
            # baselines → bogus burn) and flap the gauge per tick.
            raise ValueError(
                f"duplicate SLO objective for route {obj.route!r} kind "
                f"{obj.kind!r}: one objective per (route, kind)")
        seen.add(key)
    return out


class SloEngine:
    """Snapshots the registry on a tick, keeps a bounded ring of
    snapshots, and exposes windowed burn rates as ``ai4e_slo_*``
    gauges. No background task of its own — the platform assembly owns
    the tick loop (``start()``/``stop()``), and tests drive ``tick(now)``
    with an injected clock."""

    def __init__(self, objectives: list[SloObjective],
                 metrics: MetricsRegistry | None = None,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 tick_s: float = 5.0,
                 clock=time.monotonic):
        if not objectives:
            raise ValueError("SloEngine needs at least one objective")
        if not (0 < fast_window_s <= slow_window_s):
            raise ValueError(
                f"SLO windows need 0 < fast <= slow, got "
                f"{fast_window_s}/{slow_window_s}")
        self.objectives = list(objectives)
        self.metrics = metrics or DEFAULT_REGISTRY
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.tick_s = max(0.05, tick_s)
        self._clock = clock
        # Per objective: ring of (now, good, total) cumulative snapshots
        # covering at least the slow window. One ring per (route, kind)
        # — duplicates would silently share it (parse_objectives
        # refuses them; this guards direct constructions too).
        keep = int(slow_window_s / self.tick_s) + 2
        self._snaps: dict[tuple[str, str], deque] = {}
        for o in objectives:
            key = (o.route, o.kind)
            if key in self._snaps:
                raise ValueError(
                    f"duplicate SLO objective for route {o.route!r} "
                    f"kind {o.kind!r}")
            self._snaps[key] = deque(maxlen=keep)
        self._task: asyncio.Task | None = None
        self._ladder = None
        self._burn = self.metrics.gauge(
            "ai4e_slo_burn_rate",
            "Error-budget burn rate per objective and window "
            "(1.0 = spending exactly the budget)")
        self._bad = self.metrics.gauge(
            "ai4e_slo_bad_ratio",
            "Windowed bad-event fraction per objective")
        self._breaches = self.metrics.counter(
            "ai4e_slo_breaches_total",
            "Ticks on which fast AND slow windows both burned > 1")

    def attach_ladder(self, ladder) -> None:
        """Feed sustained breaches to the degradation ladder as miss
        evidence (``slo_ladder``; the assembly wires it under
        orchestration): each tick, an objective with traffic contributes
        its tick's events, a miss when both windows burn."""
        self._ladder = ladder

    # -- snapshot sources ----------------------------------------------------

    def _cumulative(self, objective: SloObjective) -> tuple[float, float]:
        """(good, total) cumulative counts for the objective right now."""
        if objective.kind == "latency":
            hist = self.metrics.histogram(E2E_HISTOGRAM, "")
            good = total = 0.0
            for _kind, _name, labels, data in hist.collect():
                if labels.get("route") != objective.route:
                    continue
                total += data["count"]
                for edge, count in _cumulative_buckets(data["buckets"]):
                    if edge >= objective.latency_s:
                        good += count
                        break
            return good, total
        counter = self.metrics.counter(OUTCOMES_COUNTER, "")
        good = bad = 0.0
        for _kind, _name, labels, value in counter.collect():
            if labels.get("route") != objective.route:
                continue
            if labels.get("outcome") == "ok":
                good += value
            elif labels.get("outcome") in BAD_OUTCOMES:
                bad += value
        return good, good + bad

    # -- ticking -------------------------------------------------------------

    def tick(self, now: float | None = None) -> dict:
        """One evaluation pass; returns {(route, kind): {window: burn}}
        for tests/introspection."""
        now = self._clock() if now is None else now
        out: dict = {}
        for obj in self.objectives:
            key = (obj.route, obj.kind)
            good, total = self._cumulative(obj)
            snaps = self._snaps[key]
            snaps.append((now, good, total))
            burns = {}
            for window_name, window_s in (("fast", self.fast_window_s),
                                          ("slow", self.slow_window_s)):
                base = _snapshot_at(snaps, now - window_s)
                d_good = good - base[1]
                d_total = total - base[2]
                if d_total <= 0:
                    bad_ratio = 0.0
                else:
                    bad_ratio = min(1.0, max(0.0, 1.0 - d_good / d_total))
                burn = bad_ratio / obj.budget
                labels = dict(route=obj.route, kind=obj.kind,
                              window=window_name)
                self._burn.set(burn, **labels)
                self._bad.set(bad_ratio, **labels)
                burns[window_name] = burn
            out[key] = burns
            breached = burns["fast"] > 1.0 and burns["slow"] > 1.0
            if breached:
                self._breaches.inc(route=obj.route, kind=obj.kind)
            if self._ladder is not None:
                # Evidence scaled to the tick's event count: one bare note
                # a multi-second tick would decay below the ladder's
                # min_rate floor and never move it. An idle route adds
                # nothing.
                prev_total = snaps[-2][2] if len(snaps) >= 2 else 0.0
                tick_events = total - prev_total
                if tick_events > 0:
                    self._ladder.note(miss=breached, n=tick_events)
        return out

    # -- lifecycle (assembly-owned loop) ------------------------------------

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.tick_s)
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a bad tick must not kill the loop
                log.exception("SLO tick failed")


def _cumulative_buckets(buckets):
    """[(edge, cumulative_count)] from the registry's per-bucket counts."""
    cum = 0
    for edge, count in buckets:
        cum += count
        yield edge, cum


def _snapshot_at(snaps, t: float) -> tuple[float, float, float]:
    """The newest snapshot at or before ``t`` — the window baseline.
    With no snapshot that old (the engine just started), the baseline is
    ZERO: the window is effectively "since start", so an engine brought
    up mid-incident reports the incident instead of a blank first
    window. The snapshot ring is sized past the slow window, so once
    history covers a window this branch never fires again."""
    base = None
    for snap in snaps:
        if snap[0] <= t:
            base = snap
        else:
            break
    return base if base is not None else (t, 0.0, 0.0)
