"""The rig driver — ``python -m ai4e_tpu_torch.rig up``; a copy of
``ai4e_tpu/rig/run.py`` (``make rig`` runs JAX's).

Launches the topology as real OS processes under the ``Supervisor``,
drives the multi-process loadgen through the balancer, replays the
seeded chaos timeline at rate, and records the whole run — topology,
per-loadgen windows (offered vs achieved + error taxonomy), the chaos
events with their actual fire times, the per-shard + global invariant
verdict, and the merged per-role metrics — as ONE JSON artifact
(``bench_results/r12-*`` acceptance shape: the scale claim is a file,
not a README paragraph).

Boot order is dependency order: stores first (primaries, then replicas,
each health-gated), then workers, dispatchers, gateways, the balancer,
and only then the loadgens. Teardown is the supervisor's hard contract —
every exit path (success, chaos gone wrong, ^C) runs it, and it verifies
the ports actually drained.
"""

from __future__ import annotations

import asyncio
import glob
import json
import logging
import os
import time

from . import chaos as rig_chaos
from . import verdict as rig_verdict
from ..observability.federation import fetch_json as _fetch_json
from .supervisor import Supervisor, python_argv
from .topology import Topology

log = logging.getLogger("ai4e_tpu_torch.rig.run")


def _spawn_topology(topo: Topology, sup: Supervisor) -> None:
    spec = topo.spec_path()

    def spawn(name: str, role: str, port: int | None, *extra: str,
              drain_url: str | None = None) -> None:
        argv = python_argv("ai4e_tpu_torch.rig", role, "--spec", spec, *extra)
        sup.spawn(name, argv, log_path=os.path.join(topo.workdir,
                                                    f"{name}.log"),
                  port=port,
                  health_url=(f"http://{topo.host}:{port}/healthz"
                              if port else None),
                  drain_url=drain_url)

    # Stores before everything (dependency order); primaries before
    # replicas so the replica's first wire poll finds a stream.
    for s in range(topo.shards):
        spawn(f"store{s}", "storenode", topo.shard_port(s),
              "--shard", str(s), "--index", "-1")
    for s in range(topo.shards):
        sup.wait_healthy(f"store{s}")
    for s in range(topo.shards):
        for r in range(topo.replicas):
            spawn(f"store{s}r{r}", "storenode", topo.replica_port(s, r),
                  "--shard", str(s), "--index", str(r))
    for s in range(topo.shards):
        for w in range(topo.workers):
            # drain_url: the supervisor's hard teardown drains workers
            # FIRST (wave 0) through this verb before any SIGTERM —
            # their in-flight deliveries finish, refused ones redeliver.
            from .workernode import DRAIN_PATH
            port = topo.worker_port(s, w)
            spawn(f"worker{s}.{w}", "workernode", port,
                  "--shard", str(s), "--index", str(w),
                  drain_url=f"http://{topo.host}:{port}{DRAIN_PATH}")
        for d in range(topo.dispatchers):
            spawn(f"dispatcher{s}.{d}", "dispatchernode",
                  topo.dispatcher_port(s, d),
                  "--shard", str(s), "--index", str(d))
    for g in range(topo.gateways):
        spawn(f"gateway{g}", "gatewaynode", topo.gateway_port(g),
              "--index", str(g))
    spawn("balancer", "balancer", topo.balancer_port())
    if topo.collector:
        # Last: its first scrape should find a healthy fleet, so a
        # boot-time unreachable gateway doesn't flip the conservation
        # check to advisory before traffic even starts.
        spawn("collector", "collector", topo.collector_port())
    for name in list(sup.children):
        sup.wait_healthy(name)


def _spawn_loadgens(topo: Topology, sup: Supervisor) -> list[str]:
    names = []
    for i in range(topo.loadgens):
        name = f"loadgen{i}"
        sup.spawn(name,
                  python_argv("ai4e_tpu_torch.rig", "loadgen", "--spec",
                              topo.spec_path(), "--index", str(i)),
                  log_path=os.path.join(topo.workdir, f"{name}.log"))
        # Run-to-completion child: exiting is its JOB — the crash-loop
        # monitor must neither restart nor count it.
        sup.expect_death(name)
        names.append(name)
    return names


async def _await_loadgens(topo: Topology, sup: Supervisor,
                          names: list[str]) -> None:
    """Wait for every loadgen to exit — ramp + window + the bounded
    terminal drain, plus startup/flush headroom."""
    deadline = time.monotonic() + (topo.ramp + topo.duration
                                   + topo.task_timeout + 90.0)
    while time.monotonic() < deadline:
        if all(not sup.children[n].alive() for n in names):
            return
        # One monitor pass per second: restart crashed platform children
        # (bounded), raise on a crash-loop. Chaos kills and loadgen exits
        # are marked expected and skipped.
        restarted = sup.check()
        if restarted:
            log.warning("monitor restarted: %s", restarted)
        await asyncio.sleep(1.0)
    raise TimeoutError("loadgens did not finish inside their budget")


async def _drain_backlogs(topo: Topology, timeout: float) -> dict:
    """Poll every live shard node's ``/v1/taskstore/depths`` until no
    non-terminal work remains (or ``timeout``). Returns what was left."""
    import urllib.request

    def backlog() -> int:
        remaining = 0
        for s in range(topo.shards):
            for base in topo.shard_urls(s):
                try:
                    with urllib.request.urlopen(
                            base + "/v1/taskstore/depths",
                            timeout=5) as resp:
                        depths = json.loads(resp.read())
                except OSError:
                    continue  # dead node (chaos) — its replica answers
                remaining += sum(
                    counts.get("created", 0) + counts.get("running", 0)
                    for counts in depths.values())
                break  # one live node per shard is authoritative
        return remaining

    deadline = time.monotonic() + timeout
    left = await asyncio.to_thread(backlog)
    while left > 0 and time.monotonic() < deadline:
        await asyncio.sleep(2.0)
        left = await asyncio.to_thread(backlog)
    return {"drained": left == 0, "left": left}


async def _collect_observability(topo: Topology) -> dict:
    """Pre-teardown sweep of the fleet's memory-only observability
    state: hop ledgers (they die with the store processes), per-role
    vitals rings, flight-recorder rings, and the collector's live fleet
    snapshot. Everything best-effort — a chaos-killed node contributes
    nothing, which is itself recorded."""
    out: dict = {"ledgers": {}, "vitals": {}, "flight": {}, "fleet": None}

    def get(url: str):
        return asyncio.to_thread(_fetch_json, url, 5.0)

    # All fetches are independent — gather them (against saturated
    # survivors every endpoint can take seconds, and a serial sweep of
    # ~20 URLs would add tens of seconds before the verdict).
    async def shard_ledgers(s: int) -> dict:
        for base in topo.shard_urls(s):
            dump = await get(base + "/v1/rig/ledgers")
            if dump is not None:
                return dump.get("Ledgers", {})
            # next node: one live node per shard carries the timelines
        return {}

    urls = topo.metrics_urls()
    flight_names = [n for n in urls if n.startswith(("gateway", "store"))]
    fleet, ledger_dumps, vitals, flights = await asyncio.gather(
        (get(topo.collector_url() + "/v1/debug/fleet")
         if topo.collector else asyncio.sleep(0)),
        asyncio.gather(*(shard_ledgers(s) for s in range(topo.shards))),
        asyncio.gather(*(get(base + "/v1/debug/vitals")
                         for base in urls.values())),
        asyncio.gather(*(get(urls[n] + "/v1/debug/flight")
                         for n in flight_names)))
    out["fleet"] = fleet if topo.collector else None
    for dump in ledger_dumps:
        out["ledgers"].update(dump)
    for name, vit in zip(urls, vitals):
        if vit is not None and vit.get("recent"):
            out["vitals"][name] = vit["recent"]
    for name, flight in zip(flight_names, flights):
        if flight is not None and "entries" in flight:
            out["flight"][name] = flight
    return out


async def run_rig(topo: Topology, out_dir: str | None = None) -> dict:
    os.makedirs(topo.workdir, exist_ok=True)
    # A stale run's journals/windows would contaminate the verdict.
    for pattern in ("*.jsonl", "*.jsonl.replica*", "loadgen-*.json",
                    "*.log", "*.salvage.json", "timeline.json",
                    "fleet.json", "flight-*.json", "ledgers.json",
                    "vitals.json"):
        for path in glob.glob(os.path.join(topo.workdir, pattern)):
            os.unlink(path)
    topo.save(topo.spec_path())

    started_at = time.time()
    events = rig_chaos.build_timeline(topo) if topo.chaos else []
    result: dict = {"topology": topo.to_dict(), "started_at": started_at,
                    "chaos": events}
    with Supervisor(host=topo.host) as sup:
        _spawn_topology(topo, sup)
        log.info("topology up: %d processes", len(sup.children))
        names = _spawn_loadgens(topo, sup)
        window_opens_at = time.time() + topo.ramp
        chaos_task = None
        if events:
            chaos_task = asyncio.get_running_loop().create_task(
                rig_chaos.run_timeline(topo, sup, events, window_opens_at))
        rollout_task = None
        if topo.rollout:
            from . import rollout as rig_rollout
            rollout_task = asyncio.get_running_loop().create_task(
                rig_rollout.run_rollout(topo, sup, window_opens_at))
        try:
            await _await_loadgens(topo, sup, names)
        finally:
            if chaos_task is not None:
                chaos_task.cancel()
                try:
                    await chaos_task
                except asyncio.CancelledError:
                    pass
            if rollout_task is not None:
                # The upgrade should finish well inside the loadgen
                # window + drain budget; a wedged driver is cancelled and
                # recorded as such (the rollout gate then fails the run).
                try:
                    result["rollout"] = await asyncio.wait_for(
                        asyncio.shield(rollout_task), timeout=60.0)
                except (asyncio.TimeoutError, asyncio.CancelledError):
                    rollout_task.cancel()
                    result["rollout"] = {"scenario": topo.rollout,
                                         "outcome": "timed_out"}
        # Backlog drain: an accepted task's invariant is "eventually
        # terminal", and on a CPU-bound box the queues legitimately
        # outlive the loadgens. Wait (bounded) for every shard's created
        # backlog to hit zero BEFORE teardown, so the journals carry each
        # promise's resolution — a drain that times out leaves the stuck
        # tasks to the verdict, which is exactly what should fail then.
        result["drain"] = await _drain_backlogs(
            topo, timeout=float(topo.extra.get("drain_timeout_s", 120.0)))
        # Scrape while the survivors are still up; chaos-killed processes
        # are recorded as unreachable, which is itself evidence.
        result["metrics"] = rig_verdict.scrape_and_merge(
            rig_verdict.metrics_urls(topo))
        # The observability sweep must also beat teardown: hop ledgers,
        # vitals rings, and flight rings are memory-only state.
        observed = await _collect_observability(topo)
        result["fleet"] = observed["fleet"]
        loadgen_failures = [n for n in names
                            if sup.children[n].proc.returncode]
        result["loadgen_failures"] = loadgen_failures
    # Journals are scanned AFTER teardown: no writer left, every lineage
    # at its final byte.
    result["verdict"] = rig_verdict.compute_verdict(topo)
    result["finished_at"] = time.time()
    # The live collector's conservation cross-check feeds the verdict:
    # CONFIRMED breaches (terminal outcomes outran admissions with no
    # counter loss to excuse it) fail the run beside the journal
    # reconciliation; advisory ones (counters died with a chaos-killed
    # proc) are recorded but never gate — the journals stay
    # authoritative (docs/deployment.md).
    conservation = ((observed["fleet"] or {}).get("conservation")
                    or {"ok": True, "violations": []})
    result["verdict"]["conservation"] = conservation
    rollout_gate_ok = True
    if topo.rollout:
        from . import rollout as rig_rollout
        rollout_gate_ok, why = rig_rollout.rollout_ok(
            topo, result.get("rollout"))
        result.setdefault("rollout", {})["gate"] = {
            "ok": rollout_gate_ok, "reason": why}
        log.log(logging.INFO if rollout_gate_ok else logging.WARNING,
                "rollout gate: %s (%s)",
                "ok" if rollout_gate_ok else "FAILED", why)
    result["ok"] = bool(result["verdict"]["ok"]
                        and conservation.get("ok", True)
                        and not loadgen_failures
                        and rollout_gate_ok)
    _write_observability_artifacts(topo, result, observed, out_dir)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, "rig.json")
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(result, fh, indent=1)
        log.info("rig artifact written to %s", out_path)
    return result


def _write_observability_artifacts(topo: Topology, result: dict,
                                   observed: dict,
                                   out_dir: str | None) -> None:
    """The run as one loadable Perfetto timeline + the raw pieces. The
    artifact directory always gets them; on a RED verdict they ALSO
    land in the workdir beside the journals/logs — the teardown
    artifacts CI uploads, so a red run ships the timelines that explain
    it, not just the journals that convict it."""
    from ..observability.timeline import build_chrome_trace

    samples = {}
    for w in result.get("verdict", {}).get("windows", ()):
        if w.get("samples"):
            samples[f"loadgen{w.get('loadgen', '?')}"] = w["samples"]
    timeline = build_chrome_trace(observed["ledgers"],
                                  chaos=result.get("chaos"),
                                  vitals=observed["vitals"],
                                  loadgen_samples=samples)

    def dump_into(directory: str) -> None:
        os.makedirs(directory, exist_ok=True)

        def write(name: str, payload) -> None:
            with open(os.path.join(directory, name), "w",
                      encoding="utf-8") as fh:
                json.dump(payload, fh)

        write("timeline.json", timeline)
        write("ledgers.json", {"Ledgers": observed["ledgers"]})
        if result.get("rollout"):
            write("rollout.json", result["rollout"])
        write("vitals.json", observed["vitals"])
        if observed["fleet"] is not None:
            write("fleet.json", observed["fleet"])
        for name, flight in observed["flight"].items():
            write(f"flight-{name}.json", flight)

    if out_dir:
        dump_into(out_dir)
        log.info("timeline.json (%d tasks, %d procs) written to %s",
                 timeline["otherData"]["tasks"],
                 len(timeline["otherData"]["procs"]), out_dir)
    if not result["ok"]:
        dump_into(topo.workdir)
        log.warning("verdict violated: flight rings + fleet snapshot + "
                    "timeline dumped into %s", topo.workdir)


def summarize(result: dict) -> str:
    v = result["verdict"]
    offered = sum(w["window"]["offered_rate"] for w in v["windows"]
                  if w.get("window"))
    achieved = sum(w["window"]["achieved_rate"] for w in v["windows"]
                   if w.get("window"))
    lines = [
        f"rig {'OK' if result['ok'] else 'VIOLATED'}: "
        f"offered {offered:.0f}/s achieved {achieved:.0f}/s, "
        f"{v['accepted']} accepted, {v['terminal']} terminal, "
        f"{v['duplicates']} duplicate completions, "
        f"{v['violation_count']} violations"]
    for s, meta in sorted(v["per_shard"].items()):
        lines.append(
            f"  shard {s}: accepted={meta['accepted']} "
            f"terminal={meta['terminal']} dup={meta['duplicates']} "
            f"epochs={meta['epochs']} "
            f"{'promoted' if meta['promoted'] else 'primary held'} "
            f"(monotonic={meta['epochs_strictly_monotonic']})")
    for event in result.get("chaos", ()):
        lines.append(f"  chaos @+{event['at']}s {event['verb']} "
                     f"{'ok' if event.get('ok') else 'FAILED'}")
    rollout = result.get("rollout")
    if rollout:
        gate = rollout.get("gate", {})
        lines.append(
            f"  rollout [{rollout.get('scenario')}]: "
            f"{rollout.get('outcome')} "
            f"(weights {rollout.get('weight_history', [])}, "
            f"{len(rollout.get('upgraded', []))} upgraded, "
            f"{len(rollout.get('reverted', []))} reverted) — gate "
            f"{'ok' if gate.get('ok') else 'FAILED'}: "
            f"{gate.get('reason', '')}")
    cons = v.get("conservation")
    if cons is not None:
        lines.append(
            f"  fleet conservation: "
            f"{'ok' if cons.get('ok', True) else 'VIOLATED'} "
            f"({len(cons.get('violations', []))} recorded"
            f"{', degraded — counters lost with killed procs' if cons.get('degraded') else ''})")
    return "\n".join(lines)
