"""The rig's rolling-upgrade driver — the rollout controller against
REAL OS processes (docs/deployment.md#rollouts); a copy of
``ai4e_tpu/rig/rollout.py``.

``RigFleet`` is the controller's fleet adapter over the live topology:

- ``drain``    — POST the worker's drain verb (``workernode.DRAIN_PATH``);
  the worker flips to 503 + ``X-Draining`` and the dispatcher both
  redelivers the refused tasks to peers AND ejects the replica from
  placement (``resilience/health.mark_draining``) — no breaker trip;
- ``upgrade``  — SIGKILL + respawn through the supervisor with a bumped
  ``AI4E_ROLLOUT_GENERATION`` (``Supervisor.respawn`` env overrides
  stick, so a crash-loop restart keeps the new generation);
- ``set_split``— POST every dispatcher's ``/v1/rollout/weights`` with the
  url→generation map + the canary share (``rollout/canary.py`` rescales
  the weighted pick);
- ``burn``     — scrape every worker's ``ai4e_rollout_outcomes_total``
  and turn the canary generation's error ratio into fast (last two
  samples) and slow (since rollout start) burn rates against the
  configured error budget — the multi-window shape the production SLO
  engine exports (``observability/slo.py``);
- ``breaker_open`` — scrape the dispatchers' breaker-state gauge for any
  open breaker on a canary-generation backend;
- ``stamp``    — rollout/rollback hop-ledger evidence appended to a
  marker task the driver admitted THROUGH the gateway (so the fleet's
  conservation cross-check stays balanced); the pre-teardown ledger
  sweep carries it into ``ledgers.json``/``timeline.json``.

Scenarios (``topo.rollout``): ``clean`` upgrades every worker and must
promote; ``bad-canary`` seeds ``topo.rollout_error_rate`` of 500s into
generations >= ``rollout_bad_generation`` and must auto-rollback before
the canary's share passes 50%.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import urllib.request

from ..observability.federation import parse_prometheus
from ..observability.ledger import ROLLBACK, ROLLOUT, ledger_event
from ..rollout.controller import RolloutController, RolloutPolicy
from .supervisor import Supervisor
from .topology import Topology
from .wire import RingStoreClient
from .workernode import DRAIN_PATH, GENERATION_ENV

log = logging.getLogger("ai4e_tpu_torch.rig.rollout")

#: Error budget the burn windows divide by — 5% canary error ratio is a
#: burn of 1.0 (override via ``topo.extra["rollout_error_budget"]``).
DEFAULT_ERROR_BUDGET = 0.05


def _http_json(url: str, body: dict | None = None,
               timeout: float = 10.0) -> dict | None:
    """Blocking JSON request (run via ``asyncio.to_thread``); None on any
    transport failure — every rollout verb is retried/recorded, never
    allowed to wedge the driver."""
    try:
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            url, data=data, method="POST" if body is not None else "GET",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except (OSError, ValueError):
        return None


def _fetch_text(url: str, timeout: float = 5.0) -> str:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.read().decode("utf-8", "replace")
    except OSError:
        return ""


class RigFleet:
    """Fleet adapter (``rollout/controller.py`` duck-type) over the live
    rig: worker ids are supervisor child names (``worker{s}.{w}``)."""

    def __init__(self, topo: Topology, sup: Supervisor,
                 ring: RingStoreClient, old_generation: int = 1):
        self.topo = topo
        self.sup = sup
        self.ring = ring
        self.old_generation = old_generation
        self.events: list[dict] = []      # recorded into rollout.json
        self.marker_task_id: str | None = None
        self._generations: dict[str, int] = {}   # child name -> generation
        # (t, ok, err) cumulative samples for the canary generation —
        # fast burn reads the last two, slow burn reads first vs last.
        self._burn_samples: list[tuple[float, float, float]] = []
        self.error_budget = float(
            topo.extra.get("rollout_error_budget", DEFAULT_ERROR_BUDGET))

    # -- addressing ---------------------------------------------------------

    def workers(self) -> list[str]:
        return [f"worker{s}.{w}" for s in range(self.topo.shards)
                for w in range(self.topo.workers)]

    def _ports(self, name: str) -> int:
        shard, index = name.removeprefix("worker").split(".")
        return self.topo.worker_port(int(shard), int(index))

    def _base_url(self, name: str) -> str:
        return f"http://{self.topo.host}:{self._ports(name)}"

    def _backend_url(self, name: str) -> str:
        """The exact backend id the shard's dispatcher weighs
        (``topo.worker_urls`` entry — base + route)."""
        return self._base_url(name) + self.topo.route

    def _dispatcher_urls(self) -> list[str]:
        return [f"http://{self.topo.host}:{self.topo.dispatcher_port(s, d)}"
                for s in range(self.topo.shards)
                for d in range(self.topo.dispatchers)]

    def generation_of(self, name: str) -> int:
        return self._generations.get(name, self.old_generation)

    # -- controller verbs ---------------------------------------------------

    async def _dispatcher_post(self, extra: dict) -> None:
        """POST every dispatcher's rollout verb with the CURRENT
        url→generation map plus ``extra`` — every call refreshes the map,
        so a reverted worker re-enters its generation group immediately
        (a stale map would pin it at the canary's zeroed share)."""
        body = {
            "generations": {self._backend_url(n): self.generation_of(n)
                            for n in self.workers()},
            **extra,
        }
        results = await asyncio.gather(
            *(asyncio.to_thread(_http_json, url + "/v1/rollout/weights",
                                body)
              for url in self._dispatcher_urls()))
        if not any(results):
            log.warning("no dispatcher accepted the rollout verb %s", body)

    async def drain(self, worker: str) -> bool:
        # Eject from placement FIRST (covers drain + kill + respawn —
        # without the mark, deliveries into the restart window become
        # connect errors, the breaker opens, and the guard reads a
        # healthy upgrade as a canary breach), then run the drain verb.
        ttl = self.topo.rollout_drain_timeout_ms / 1000.0 + 60.0
        await self._dispatcher_post(
            {"draining": {self._backend_url(worker): ttl}})
        summary = await asyncio.to_thread(
            _http_json, self._base_url(worker) + DRAIN_PATH,
            {"timeout_ms": self.topo.rollout_drain_timeout_ms},
            max(10.0, self.topo.rollout_drain_timeout_ms / 1000.0 + 5.0))
        return bool(summary and summary.get("clean"))

    async def _restart_at(self, worker: str, generation: int) -> None:
        await asyncio.to_thread(self.sup.kill, worker)
        # SIGKILL is asynchronous: wait for the reap before respawning
        # (the supervisor refuses to respawn a child it still sees
        # alive; the chaos verbs dodge this with their respawn gap).
        child = self.sup.children[worker]
        deadline = time.monotonic() + 10.0
        while child.alive() and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        await asyncio.to_thread(
            self.sup.respawn, worker,
            {GENERATION_ENV: str(int(generation))})
        self._generations[worker] = int(generation)

    async def upgrade(self, worker: str, generation: int) -> None:
        await self._restart_at(worker, generation)

    async def revert(self, worker: str, generation: int) -> None:
        await self._restart_at(worker, generation)

    async def wait_healthy(self, worker: str) -> bool:
        try:
            await asyncio.to_thread(self.sup.wait_healthy, worker, 30.0)
        except Exception:  # noqa: BLE001 — an unhealthy upgrade is a rollback trigger, not a driver crash
            log.warning("%s not healthy after restart", worker)
            return False
        # Re-admit: clear the drain mark and the breaker history the
        # restart window may have minted — a fresh process earns a
        # clean slate (resilience/health.reset).
        await self._dispatcher_post(
            {"undrain": [self._backend_url(worker)]})
        return True

    async def set_split(self, generation: int, share: float) -> None:
        await self._dispatcher_post({"canary_generation": int(generation),
                                     "share": float(share)})

    async def burn(self, generation: int) -> dict:
        """Canary error ratio → fast/slow burn. ok/error counts come from
        every worker's ``ai4e_rollout_outcomes_total`` for the canary
        generation's label; a dead/unreachable worker contributes
        nothing (its counters are at their last value anyway)."""
        ok = err = 0.0
        pages = await asyncio.gather(
            *(asyncio.to_thread(_fetch_text,
                                self._base_url(n) + "/metrics")
              for n in self.workers()))
        wanted = str(int(generation))
        for page in pages:
            for (name, labels), value in parse_prometheus(page).items():
                if name != "ai4e_rollout_outcomes_total":
                    continue
                if f'generation="{wanted}"' not in labels:
                    continue
                if 'outcome="ok"' in labels:
                    ok += value
                elif 'outcome="error"' in labels:
                    err += value
        self._burn_samples.append((time.monotonic(), ok, err))

        def ratio(d_ok: float, d_err: float) -> float:
            total = d_ok + d_err
            return (d_err / total) if total > 0 else 0.0

        fast = slow = 0.0
        if len(self._burn_samples) >= 2:
            t0, ok0, err0 = self._burn_samples[-2]
            fast = ratio(ok - ok0, err - err0) / self.error_budget
            t0, ok0, err0 = self._burn_samples[0]
            slow = ratio(ok - ok0, err - err0) / self.error_budget
        return {"fast": fast, "slow": slow}

    def breaker_open(self, generation: int) -> bool:
        """Any OPEN breaker (state 2) on a canary-generation backend —
        scraped synchronously from the dispatchers (the guard tick calls
        this once per second; the pages are small)."""
        canary = {f"{self.topo.host}:{self._ports(n)}"
                  for n in self.workers()
                  if self.generation_of(n) == int(generation)}
        for url in self._dispatcher_urls():
            for (name, labels), value in parse_prometheus(
                    _fetch_text(url + "/metrics")).items():
                if name != "ai4e_resilience_breaker_state" or value < 2:
                    continue
                # The gauge's backend label is the URI's netloc
                # (resilience/health._label).
                if any(f'backend="{b}"' in labels for b in canary):
                    return True
        return False

    async def stamp(self, event: str, reason: str) -> None:
        record = {"t": round(time.time(), 2), "event": event,
                  "reason": reason}
        self.events.append(record)
        log.info("rollout: %s — %s", event, reason)
        if self.marker_task_id:
            try:
                await self.ring.append_ledger(
                    self.marker_task_id,
                    [ledger_event(event, "rollout", reason=reason)])
            except Exception:  # noqa: BLE001 — ledger evidence is fail-open telemetry, the rollout.json record above is authoritative
                log.debug("rollout ledger stamp dropped", exc_info=True)


async def _admit_marker_task(topo: Topology) -> str | None:
    """One REAL task through the balancer — its TaskId anchors the
    rollout/rollback ledger evidence on an owning shard, and because it
    was admitted by a gateway (and completes through a worker), the
    fleet conservation cross-check stays balanced."""
    body = await asyncio.to_thread(
        _http_json, topo.balancer_url() + topo.route,
        {"rollout": "marker"}, 30.0)
    if body is None or "TaskId" not in body:
        log.warning("could not admit the rollout marker task")
        return None
    return str(body["TaskId"])


async def run_rollout(topo: Topology, sup: Supervisor,
                      window_opens_at: float) -> dict:
    """Drive one rolling upgrade against the live rig and return the
    record for ``rig.json``/``rollout.json``. Starts a beat after the
    measured window opens so the upgrade happens UNDER load — that is
    the scenario."""
    delay = window_opens_at + 1.0 - time.time()
    if delay > 0:
        await asyncio.sleep(delay)
    ring = RingStoreClient(topo.all_shard_urls(), slots=topo.slots)
    record: dict = {"scenario": topo.rollout, "started_at": time.time()}
    try:
        fleet = RigFleet(topo, sup, ring, old_generation=1)
        fleet.marker_task_id = await _admit_marker_task(topo)
        policy = RolloutPolicy(
            drain_timeout_ms=topo.rollout_drain_timeout_ms,
            canary_steps=topo.rollout_steps,
            step_hold_s=topo.rollout_hold_s,
            guard_tick_s=min(1.0, max(0.2, topo.rollout_hold_s / 5.0)),
            burn_fast_max=1.0, burn_slow_max=1.0)
        controller = RolloutController(fleet, generation=2,
                                       old_generation=1, policy=policy)
        result = await controller.run()
        record.update({
            "outcome": result.outcome,
            "generation": result.generation,
            "reason": result.reason,
            "upgraded": result.upgraded,
            "reverted": result.reverted,
            "weight_history": result.weight_history,
            "marker_task": fleet.marker_task_id,
            "events": fleet.events,
        })
    except Exception as exc:  # noqa: BLE001 — a wedged driver must not abort the run; the missing outcome fails the rollout gate instead
        log.exception("rollout driver failed")
        record["outcome"] = "driver_error"
        record["reason"] = repr(exc)
    finally:
        record["finished_at"] = time.time()
        await ring.aclose()
    return record


def rollout_ok(topo: Topology, record: dict | None) -> tuple[bool, str]:
    """The scenario gate folded into the rig verdict: clean upgrades must
    promote every worker; a bad canary must roll back before its traffic
    share passes 50%."""
    if not topo.rollout:
        return True, "no rollout scenario"
    if not record:
        return False, "rollout scenario configured but no record produced"
    if topo.rollout == "clean":
        if record.get("outcome") != "promoted":
            return False, (f"clean rollout did not promote: "
                           f"{record.get('outcome')} "
                           f"({record.get('reason', '')})")
        missing = [w for w in
                   (f"worker{s}.{w}" for s in range(topo.shards)
                    for w in range(topo.workers))
                   if w not in record.get("upgraded", ())]
        if missing:
            return False, f"clean rollout left workers behind: {missing}"
        return True, "promoted"
    if record.get("outcome") != "rolled_back":
        return False, (f"bad canary was not rolled back: "
                       f"{record.get('outcome')}")
    weights = record.get("weight_history", [])
    if weights and max(weights) > 50.0:
        return False, (f"rollback landed after the canary share passed "
                       f"50% (history {weights})")
    if len(record.get("reverted", ())) < len(record.get("upgraded", ())):
        return False, "rollback did not revert every upgraded worker"
    return True, f"rolled back at {max(weights) if weights else 0:g}%"
