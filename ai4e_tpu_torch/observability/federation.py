"""Fleet metrics federation; a copy of
``ai4e_tpu/observability/federation.py``.

``FleetCollector`` scrapes every target's ``/metrics`` each
``interval_s``, keeps each process's last series (a dead process keeps its
last counters, a lower bound), and serves ``snapshot()`` (the
``/v1/debug/fleet`` JSON: per-process rates and vitals, fleet totals, the
conservation check) and ``render_merged()`` (one exposition with bounded
``role`` and ``proc`` labels).

The conservation check compares across ticks: every task terminal by
scrape k was admitted before scrape k+1, so ``terminal(k) <=
admitted(k+1)``. Once an admitted-side process is lost (killed, or its
counters reset) a breach is recorded as ``confirmed: false``.

One addition to JAX's: a process's ``requests_total`` falls back last to
``ai4e_http_requests_total``, the counter a worker's service shell keeps,
so a worker's request rate shows.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import time
import urllib.request

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry

log = logging.getLogger("ai4e_tpu_torch.observability.federation")

_SERIES_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[-+0-9.eE]+)$")

_ROLE_RE = re.compile(r"^[a-z_]+")

# Terminal outcomes of ai4e_request_outcomes_total that correspond to a
# finished TASK (the conservation check's terminal side). ``shed`` and
# ``client_error`` never had a task; sync outcomes carry no task either,
# but the rig's conservation surface is async-only.
TASK_TERMINAL_OUTCOMES = ("ok", "late", "expired", "failed")


def parse_prometheus(text: str) -> dict[tuple[str, str], float]:
    """{(metric, sorted-label-string): value} for one exposition page
    (same-key lines sum — histogram buckets keep their ``le``)."""
    out: dict[tuple[str, str], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if m is None:
            continue
        labels = m.group("labels") or ""
        key = (m.group("name"),
               ",".join(sorted(p.strip() for p in labels.split(",") if p)))
        try:
            out[key] = out.get(key, 0.0) + float(m.group("value"))
        except ValueError:
            continue
    return out


def merge_series(per_proc: dict[str, dict[tuple[str, str], float]]
                 ) -> dict[tuple[str, str], float]:
    """Sum same-(name, labels) series across processes — the teardown
    merge's core, shared with the live collector."""
    merged: dict[tuple[str, str], float] = {}
    for series in per_proc.values():
        for key, value in series.items():
            merged[key] = merged.get(key, 0.0) + value
    return merged


def role_of(proc: str) -> str:
    """``gateway0`` → ``gateway``, ``store1r0`` → ``store``,
    ``dispatcher0.1`` → ``dispatcher`` — the bounded label."""
    m = _ROLE_RE.match(proc)
    return m.group(0) if m else "other"


def render_key(key: tuple[str, str]) -> str:
    name, labels = key
    return f"{name}{{{labels}}}" if labels else name


def _series_sum(series: dict[tuple[str, str], float], name: str,
                label_filter: dict[str, str] | None = None) -> float:
    """Sum of every sample of ``name`` whose labels include
    ``label_filter`` (labels are the sorted ``k="v"`` join)."""
    total = 0.0
    wanted = [f'{k}="{v}"' for k, v in (label_filter or {}).items()]
    for (n, labels), value in series.items():
        if n != name:
            continue
        if all(w in labels for w in wanted):
            total += value
    return total


def _scrape(url: str, timeout: float) -> dict[tuple[str, str], float]:
    with urllib.request.urlopen(url + "/metrics",
                                timeout=timeout) as resp:
        return parse_prometheus(resp.read().decode("utf-8", "replace"))


def fetch_json(url: str, timeout: float = 10.0) -> dict | None:
    """One JSON-over-HTTP GET, None on any transport/parse failure —
    the shared best-effort fetch the rig driver's observability sweep
    and the ``top`` dashboard both use (a dead node contributes
    nothing, which is itself recorded)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read())
    except (OSError, ValueError):
        return None


class FleetCollector:
    """Live periodic scraper over ``targets`` (proc name → base URL).

    Synchronous-scrape-in-threads by design: the collector must keep
    observing a fleet whose event-loop health is one of the things it
    reports, and a hung target only blocks its own thread (bounded by
    ``timeout_s``), never the tick loop.
    """

    def __init__(self, targets: dict[str, str],
                 interval_s: float = 2.0, timeout_s: float = 3.0,
                 metrics: MetricsRegistry | None = None,
                 max_procs: int = 256, conservation: bool = True):
        """``conservation=False`` disables the cross-check (the fleet
        view still serves): its inputs are only sound on the rig's
        async-only surface — a deployment serving sync traffic or
        admission refusals feeds ok/failed/expired outcomes that never
        had a ``created`` admission, and the check would cry VIOLATED
        on a healthy platform. ``top --targets`` (ad-hoc, unknown
        surface) turns it off; the rig collector keeps it on."""
        if not targets:
            raise ValueError("FleetCollector needs at least one target")
        self.targets = dict(targets)
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.max_procs = max_procs
        self.conservation = conservation
        self.metrics = metrics or DEFAULT_REGISTRY
        # proc -> {"series", "t", "up", "ever_up"} — series is the last
        # SUCCESSFUL scrape (the monotonic-counter lower bound for dead
        # procs).
        self._state: dict[str, dict] = {}
        self._lock = asyncio.Lock()
        self._task: asyncio.Task | None = None
        self._ticks = 0
        # Conservation state: terminal total at the PREVIOUS tick,
        # whether any admitted-side proc has ever been lost (flips
        # breaches to advisory), and each proc's last admitted value —
        # a DECREASE means the counter reset (supervisor restart with a
        # fresh registry), which loses history exactly like a kill.
        self._prev_terminal: float | None = None
        self._lost_admitted_side = False
        self._prev_admitted_by_proc: dict[str, float] = {}
        self._violations: list[dict] = []
        self._m_up = self.metrics.gauge(
            "ai4e_fleet_up", "Scrape target liveness (1 = last scrape ok)")
        self._m_errors = self.metrics.counter(
            "ai4e_fleet_scrape_errors_total", "Failed scrapes by proc")
        self._m_admitted = self.metrics.gauge(
            "ai4e_fleet_admitted",
            "Fleet-wide tasks admitted (gateway created outcomes; "
            "last-seen lower bound for dead procs)")
        self._m_terminal = self.metrics.gauge(
            "ai4e_fleet_terminal",
            "Fleet-wide terminal task outcomes (ok/late/expired/failed)")
        self._m_inflight = self.metrics.gauge(
            "ai4e_fleet_in_flight", "admitted - terminal at the last tick")
        self._m_violations = self.metrics.counter(
            "ai4e_fleet_conservation_violations_total",
            "Conservation breaches (terminal outran admitted) by "
            "confirmed=true/false — false = counters were lost with a "
            "killed proc, advisory only")

    # -- scraping ------------------------------------------------------------

    async def scrape_once(self) -> None:
        """One tick: scrape every target concurrently (threads), update
        state + conservation under the lock."""
        names = list(self.targets)
        results = await asyncio.gather(
            *(asyncio.to_thread(_scrape, self.targets[n], self.timeout_s)
              for n in names),
            return_exceptions=True)
        now = time.time()
        async with self._lock:
            self._ticks += 1
            for name, result in zip(names, results):
                entry = self._state.setdefault(
                    name, {"series": {}, "t": 0.0, "up": False,
                           "ever_up": False})
                if isinstance(result, BaseException):
                    if entry["up"] or not entry["ever_up"]:
                        log.debug("scrape of %s failed: %s", name, result)
                    if entry["ever_up"] and entry["up"] \
                            and role_of(name) == "gateway":
                        # An admitted-side proc just went dark with an
                        # un-scraped tail of admissions.
                        self._lost_admitted_side = True
                    entry["up"] = False
                    self._m_up.set(0, proc=name)
                    self._m_errors.inc(proc=name)
                    continue
                entry.update(series=result, t=now, up=True, ever_up=True)
                self._m_up.set(1, proc=name)
            self._check_conservation(now)

    def _check_conservation(self, now: float) -> None:
        admitted = 0.0
        terminal = 0.0
        for name, entry in self._state.items():
            series = entry["series"]
            proc_admitted = _series_sum(series,
                                        "ai4e_gateway_requests_total",
                                        {"outcome": "created"})
            prev = self._prev_admitted_by_proc.get(name)
            if prev is not None and proc_admitted < prev:
                # A monotonic counter went BACKWARD: the proc restarted
                # with a fresh registry (supervisor crash-restart — the
                # scrape can succeed against the replacement without
                # ever failing against the corpse, so the up→down
                # transition heuristic misses it). Its prior admissions
                # are lost history; breaches become advisory.
                self._lost_admitted_side = True
            self._prev_admitted_by_proc[name] = proc_admitted
            admitted += proc_admitted
            for outcome in TASK_TERMINAL_OUTCOMES:
                terminal += _series_sum(series,
                                        "ai4e_request_outcomes_total",
                                        {"outcome": outcome})
        self._m_admitted.set(admitted)
        self._m_terminal.set(terminal)
        self._m_inflight.set(admitted - terminal)
        if not self.conservation:
            self._prev_terminal = terminal
            return
        # Sound cross-tick bound: everything terminal by the PREVIOUS
        # tick was admitted before THIS tick's admitted read.
        if self._prev_terminal is not None \
                and self._prev_terminal > admitted:
            confirmed = not self._lost_admitted_side
            if len(self._violations) >= 200:
                self._violations.pop(0)  # bounded: newest 200 kept
            self._violations.append({
                "t": round(now, 2),
                "kind": "terminal_exceeds_admitted",
                "terminal_prev_tick": self._prev_terminal,
                "admitted": admitted,
                "confirmed": confirmed,
            })
            self._m_violations.inc(confirmed=str(confirmed).lower())
            log.warning(
                "fleet conservation breach (%s): %.0f terminal outcomes "
                "by the previous tick vs %.0f admissions ever issued",
                "confirmed" if confirmed else
                "advisory - admitted-side counters were lost",
                self._prev_terminal, admitted)
        self._prev_terminal = terminal

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``/v1/debug/fleet`` JSON: per-proc key stats + fleet
        totals + conservation verdict. Key stats only (the full merged
        exposition is the ``/v1/debug/fleet/metrics`` page) so a 1 Hz
        dashboard poll stays cheap."""
        per_proc = {}
        for name, entry in self._state.items():
            s = entry["series"]
            outcomes = {o: _series_sum(s, "ai4e_request_outcomes_total",
                                       {"outcome": o})
                        for o in TASK_TERMINAL_OUTCOMES + ("shed",)}
            burn = max((v for (n, _l), v in s.items()
                        if n == "ai4e_slo_burn_rate"), default=None)
            per_proc[name] = {
                "role": role_of(name),
                "up": entry["up"],
                "last_scrape": round(entry["t"], 2),
                "requests_total":
                    _series_sum(s, "ai4e_gateway_requests_total")
                    or _series_sum(s, "ai4e_balancer_requests_total")
                    or _series_sum(s, "ai4e_dispatch_total")
                    or _series_sum(s, "ai4e_rig_worker_requests_total")
                    or _series_sum(s, "ai4e_http_requests_total"),
                "admitted": _series_sum(s, "ai4e_gateway_requests_total",
                                        {"outcome": "created"}),
                "outcomes": {k: v for k, v in outcomes.items() if v},
                "loop_lag_max_s":
                    _series_sum(s, "ai4e_process_loop_lag_max_seconds")
                    or None,
                "rss_bytes": _series_sum(s, "ai4e_process_rss_bytes")
                    or None,
                "open_fds": _series_sum(s, "ai4e_process_open_fds")
                    or None,
                "cpu_seconds":
                    _series_sum(s, "ai4e_process_cpu_seconds_total")
                    or None,
                "slo_burn_max": burn,
            }
        admitted = self._m_admitted.value()
        terminal = self._m_terminal.value()
        return {
            "t": round(time.time(), 2),
            "ticks": self._ticks,
            "targets": len(self.targets),
            "per_proc": per_proc,
            "fleet": {
                "admitted": admitted,
                "terminal": terminal,
                "in_flight": admitted - terminal,
                "up": sum(1 for e in self._state.values() if e["up"]),
            },
            "conservation": {
                "checked": self.conservation,
                "violations": list(self._violations),
                "confirmed_violations": [v for v in self._violations
                                         if v["confirmed"]],
                "degraded": self._lost_admitted_side,
                "ok": not any(v["confirmed"] for v in self._violations),
            },
        }

    def render_merged(self) -> str:
        """One exposition page of every proc's series with ``role`` and
        ``proc`` labels appended — what a Prometheus scraping only the
        collector sees of the whole fleet. Cardinality is bounded: role
        comes from the (fixed) role alphabet and procs beyond
        ``max_procs`` collapse into ``proc="other"``."""
        lines: list[str] = []
        overflow: dict[tuple[str, str], float] = {}
        for i, (name, entry) in enumerate(sorted(self._state.items())):
            if i >= self.max_procs:
                for key, value in entry["series"].items():
                    overflow[key] = overflow.get(key, 0.0) + value
                continue
            role = role_of(name)
            for (metric, labels), value in sorted(entry["series"].items()):
                extra = f'proc="{name}",role="{role}"'
                label_s = f"{labels},{extra}" if labels else extra
                lines.append(f"{metric}{{{label_s}}} {value}")
        for (metric, labels), value in sorted(overflow.items()):
            extra = 'proc="other",role="other"'
            label_s = f"{labels},{extra}" if labels else extra
            lines.append(f"{metric}{{{label_s}}} {value}")
        return "\n".join(lines) + "\n"

    def merged(self) -> dict[tuple[str, str], float]:
        return merge_series({n: e["series"]
                             for n, e in self._state.items()})

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        if self._task is not None:
            return
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while True:
            try:
                await self.scrape_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — one bad tick must not kill the collector; the next tick retries
                log.exception("fleet scrape tick failed")
            await asyncio.sleep(self.interval_s)
