"""Chrome-trace / Perfetto timeline export; a copy of
``ai4e_tpu/observability/timeline.py``: ``build_chrome_trace``, a pure
function over hop-ledger timelines and vitals rings, and
``build_from_rig_dir``, the ``timeline`` verb's body, which reads a run's
directory (``rig.json``, ``ledgers.json``, ``vitals.json``).

Track mapping:

- pid 1 ``chaos``            — instant events at each chaos verb's time;
- pid 2 ``tasks``            — one complete (``X``) slice per task from
  its first to last ledger event, greedily packed into lanes so
  concurrent tasks stack instead of overlap;
- pid 10+ per hop            — instants for point events on the task's
  lane, slices for events carrying ``ms`` durations;
- pid 100+ per proc          — vitals counter tracks
  (``loop_lag_ms`` / ``rss_mb``) and load-generator sample curves.

Timestamps are microseconds relative to the earliest event. The same
input gives byte-identical output to the JAX package's.
"""

from __future__ import annotations

import json


_CHAOS_PID = 1
_TASKS_PID = 2
_HOP_PID0 = 10
_PROC_PID0 = 100


def _lanes(intervals: list[tuple[float, float, str]]) -> dict[str, int]:
    """Greedy interval-graph coloring: task_id -> lane (tid) such that
    overlapping tasks get distinct lanes. Input: (start, end, id)."""
    lanes: dict[str, int] = {}
    busy_until: list[float] = []
    for start, end, tid in sorted(intervals):
        for lane, until in enumerate(busy_until):
            if until <= start:
                busy_until[lane] = end
                lanes[tid] = lane + 1
                break
        else:
            busy_until.append(end)
            lanes[tid] = len(busy_until)
    return lanes


def build_chrome_trace(ledgers: dict[str, list[dict]],
                       chaos: list[dict] | None = None,
                       vitals: dict[str, list[dict]] | None = None,
                       loadgen_samples: dict[str, list[dict]] | None = None
                       ) -> dict:
    """Compose the trace-event document. ``ledgers``: task_id → hop
    events (the ``{"e","h","t","r"?,"ms"?}`` vocabulary); ``chaos``:
    the rig timeline's fired events (``verb`` + wall-clock ``t``);
    ``vitals``: proc name → ``VitalsSampler.recent()`` rings;
    ``loadgen_samples``: loadgen name → 1 Hz accepted/terminal curves."""
    chaos = chaos or []
    vitals = vitals or {}
    loadgen_samples = loadgen_samples or {}

    # Epoch anchor: earliest timestamp anywhere (phases start ms early).
    stamps = [ev.get("t", 0.0) for evs in ledgers.values() for ev in evs]
    stamps += [e["t"] for e in chaos if e.get("t")]
    stamps += [s["t"] for ss in vitals.values() for s in ss if s.get("t")]
    stamps += [s["t"] for ss in loadgen_samples.values()
               for s in ss if s.get("t")]
    t0 = min(stamps) if stamps else 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 1)

    events: list[dict] = []

    def meta(pid: int, name: str) -> None:
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": name}})

    meta(_CHAOS_PID, "chaos")
    meta(_TASKS_PID, "tasks")

    # -- hops (stable pid per hop name) --------------------------------------
    hops = sorted({ev.get("h", "?") for evs in ledgers.values()
                   for ev in evs})
    hop_pid = {h: _HOP_PID0 + i for i, h in enumerate(hops)}
    for h, pid in hop_pid.items():
        meta(pid, f"hop:{h}")

    # -- task lanes ----------------------------------------------------------
    spans = []
    for tid, evs in ledgers.items():
        if not evs:
            continue
        start = min(ev.get("t", 0.0) for ev in evs)
        end = max(ev.get("t", 0.0) + ev.get("ms", 0.0) / 1e3 for ev in evs)
        spans.append((start, max(end, start), tid))
    lane = _lanes(spans)

    for start, end, tid in spans:
        evs = sorted(ledgers[tid], key=lambda ev: ev.get("t", 0.0))
        terminal = next((ev.get("r") for ev in reversed(evs)
                         if ev.get("e") == "completed"), None)
        events.append({
            "ph": "X", "pid": _TASKS_PID, "tid": lane[tid],
            "ts": us(start), "dur": max(1.0, (end - start) * 1e6),
            "name": terminal or "in-flight",
            "args": {"task_id": tid, "events": len(evs)}})
        for ev in evs:
            pid = hop_pid.get(ev.get("h", "?"), _HOP_PID0)
            name = ev.get("e", "?")
            args = {"task_id": tid}
            if ev.get("r") is not None:
                args["r"] = ev["r"]
            if "ms" in ev:
                # A measured phase: a slice ENDING at the stamp+ms per
                # the ledger's t-is-start contract (render_ledger's
                # end-to-end math).
                events.append({
                    "ph": "X", "pid": pid, "tid": lane[tid],
                    "ts": us(ev.get("t", 0.0)),
                    "dur": max(1.0, ev["ms"] * 1e3),
                    "name": name, "args": args})
            else:
                events.append({
                    "ph": "i", "s": "t", "pid": pid, "tid": lane[tid],
                    "ts": us(ev.get("t", 0.0)),
                    "name": name, "args": args})

    # -- chaos verbs ---------------------------------------------------------
    for e in chaos:
        if not e.get("t"):
            continue  # never fired (cancelled timeline)
        events.append({
            "ph": "i", "s": "g", "pid": _CHAOS_PID, "tid": 0,
            "ts": us(e["t"]),
            "name": e.get("verb", "?"),
            "args": {k: v for k, v in e.items()
                     if k not in ("verb", "t")}})

    # -- vitals + loadgen counters -------------------------------------------
    proc_pid = {}
    for i, proc in enumerate(sorted(set(vitals) | set(loadgen_samples))):
        proc_pid[proc] = _PROC_PID0 + i
        meta(proc_pid[proc], f"proc:{proc}")
    for proc, samples in vitals.items():
        pid = proc_pid[proc]
        for s in samples:
            if "lag_s" in s:
                events.append({"ph": "C", "pid": pid, "tid": 0,
                               "ts": us(s["t"]), "name": "loop_lag_ms",
                               "args": {"lag": round(s["lag_s"] * 1e3,
                                                     3)}})
            if s.get("rss_bytes", -1) >= 0:
                events.append({"ph": "C", "pid": pid, "tid": 0,
                               "ts": us(s["t"]), "name": "rss_mb",
                               "args": {"rss": round(
                                   s["rss_bytes"] / 1048576.0, 1)}})
    for proc, samples in loadgen_samples.items():
        pid = proc_pid[proc]
        for s in samples:
            events.append({"ph": "C", "pid": pid, "tid": 0,
                           "ts": us(s["t"]), "name": "tasks",
                           "args": {"accepted": s.get("accepted", 0),
                                    "terminal": s.get("terminal", 0)}})

    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"source": "ai4e_tpu timeline",
                          "epoch_t0": t0,
                          "tasks": len(spans), "hops": hops,
                          "procs": sorted(proc_pid)}}


def build_from_rig_dir(rig_dir: str) -> dict:
    """Compose the timeline from a run's directory: ``ledgers.json``
    (``{"Ledgers": {task_id: events}}``, a store's ``dump_ledgers``),
    ``vitals.json``, and ``rig.json``'s chaos timeline and load-generator
    sample curves. The ``timeline`` verb's one-call body."""
    import os

    def load(name: str, default):
        path = os.path.join(rig_dir, name)
        if not os.path.exists(path):
            return default
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)

    rig = load("rig.json", {})
    ledgers = load("ledgers.json", {}).get("Ledgers", {})
    vitals = load("vitals.json", {})
    samples = {}
    for w in rig.get("verdict", {}).get("windows", ()):  # load curves
        name = f"loadgen{w.get('loadgen', '?')}"
        if w.get("samples"):
            samples[name] = w["samples"]
    return build_chrome_trace(ledgers, chaos=rig.get("chaos"),
                              vitals=vitals, loadgen_samples=samples)
