"""``python -m ai4e_tpu_torch top``: a terminal dashboard over the fleet
snapshot; a copy of ``ai4e_tpu/observability/top.py``.

Sources: ``--collector URL`` (a running collector's ``/v1/debug/fleet``)
or ``--targets name=url,name=url`` (an in-process ``FleetCollector``).
JAX's ``--spec topology.json`` reads a rig topology, which the port does
not have yet (ROADMAP A19's rig).

Per process: up, requests/s (the delta between two snapshots), task
goodput % (ok over terminal outcomes), max SLO burn, event-loop lag, RSS,
fds. ``render_top`` is a pure function of two snapshots. Unlike JAX's,
``--once`` takes two snapshots ``interval`` apart and prints the second
against the first, so its one frame carries rates.
"""

from __future__ import annotations

import asyncio
import sys
import time


def _fmt_bytes(n) -> str:
    if n is None or n <= 0:
        return "-"
    return f"{n / (1024.0 * 1024.0):.0f}M"


def _fmt_lag(s) -> str:
    if s is None:
        return "-"
    return f"{s * 1e3:.0f}ms" if s < 10 else f"{s:.0f}s"


def _rate(cur: dict, prev: dict | None, name: str) -> str:
    if prev is None:
        return "-"
    dt = cur.get("t", 0.0) - prev.get("t", 0.0)
    if dt <= 0:
        return "-"
    a = cur["per_proc"].get(name, {}).get("requests_total") or 0.0
    b = prev["per_proc"].get(name, {}).get("requests_total") or 0.0
    return f"{max(0.0, a - b) / dt:.1f}"


def render_top(snapshot: dict, prev: dict | None = None) -> str:
    """One dashboard frame from a fleet snapshot (+ the previous one
    for rates)."""
    fleet = snapshot.get("fleet", {})
    cons = snapshot.get("conservation", {})
    if not cons.get("checked", True):
        status = "unchecked"  # non-rig surface: inputs are not sound
    else:
        status = "OK" if cons.get("ok", True) else "VIOLATED"
        if cons.get("degraded"):
            status += " (degraded: counters lost with killed/restarted procs)"
    lines = [
        f"fleet  t={snapshot.get('t', 0.0):.0f}  "
        f"up {fleet.get('up', 0)}/{snapshot.get('targets', 0)}  "
        f"admitted {fleet.get('admitted', 0.0):.0f}  "
        f"terminal {fleet.get('terminal', 0.0):.0f}  "
        f"in-flight {fleet.get('in_flight', 0.0):.0f}  "
        f"conservation {status}",
        f"{'proc':<16} {'role':<11} {'up':<3} {'req/s':>7} "
        f"{'goodput':>8} {'burn':>6} {'lag':>7} {'rss':>7} {'fds':>5}",
    ]
    for name in sorted(snapshot.get("per_proc", ())):
        p = snapshot["per_proc"][name]
        outcomes = p.get("outcomes") or {}
        terminal = sum(v for k, v in outcomes.items() if k != "shed")
        good = outcomes.get("ok", 0.0)
        goodput = f"{100.0 * good / terminal:.1f}%" if terminal else "-"
        burn = p.get("slo_burn_max")
        fds = p.get("open_fds")
        lines.append(
            f"{name:<16} {p.get('role', '?'):<11} "
            f"{'up' if p.get('up') else 'DN':<3} "
            f"{_rate(snapshot, prev, name):>7} {goodput:>8} "
            f"{f'{burn:.1f}' if burn is not None else '-':>6} "
            f"{_fmt_lag(p.get('loop_lag_max_s')):>7} "
            f"{_fmt_bytes(p.get('rss_bytes')):>7} "
            f"{f'{fds:.0f}' if fds else '-':>5}")
    violations = cons.get("confirmed_violations") or []
    if violations:
        lines.append(f"!! {len(violations)} confirmed conservation "
                     f"violation(s); latest: {violations[-1]}")
    return "\n".join(lines)


async def run_top(collector: str | None = None,
                  spec: str | None = None,
                  targets: str | None = None,
                  interval: float = 2.0, once: bool = False,
                  out=None) -> int:
    """The CLI body; returns an exit code. Exactly one source must be
    given."""
    from .federation import fetch_json

    out = out or (lambda s: print(s, flush=True))
    own = None
    if spec:
        print("top: --spec reads a rig topology; the rig is not ported "
              "(ROADMAP A19): pass --targets name=url,...", file=sys.stderr)
        return 2
    if collector:
        url = collector.rstrip("/") + "/v1/debug/fleet"

        async def fetch() -> dict:
            snap = await asyncio.to_thread(fetch_json, url, 5.0)
            if snap is None:
                raise OSError(f"no fleet snapshot at {url}")
            return snap
    elif targets:
        from .federation import FleetCollector
        try:
            target_map = dict(pair.split("=", 1)
                              for pair in targets.split(",") if pair)
        except ValueError:
            print("top: --targets wants name=url,name=url "
                  f"(got {targets!r})", file=sys.stderr)
            return 2
        # Ad-hoc targets: the surface is unknown (sync traffic and
        # admission refusals feed outcomes with no admissions), so the
        # conservation check's inputs are not sound: view only.
        own = FleetCollector(target_map, interval_s=interval,
                             conservation=False)

        async def fetch() -> dict:
            await own.scrape_once()
            return own.snapshot()
    else:
        print("top: pass --collector URL or --targets name=url,...",
              file=sys.stderr)
        return 2

    prev = None
    try:
        while True:
            t0 = time.monotonic()
            try:
                snap = await fetch()
            except OSError as exc:
                out(f"top: fleet source unreachable: {exc}")
                if once:
                    return 1
                await asyncio.sleep(interval)
                continue
            if once and prev is None:
                # The one frame's rates need a second snapshot.
                prev = snap
                await asyncio.sleep(interval)
                continue
            frame = render_top(snap, prev)
            if once:
                out(frame)
                return 0
            # Clear and home, then the frame: a live dashboard, not a log.
            out("\x1b[2J\x1b[H" + frame)
            prev = snap
            await asyncio.sleep(max(0.2, interval -
                                    (time.monotonic() - t0)))
    except (KeyboardInterrupt, asyncio.CancelledError):
        return 0
