"""CPU-echo worker PROCESS — the rig's backend tier; a copy of
``ai4e_tpu/rig/workernode.py``.

Deliberately the smallest honest backend: it receives the dispatcher's
POST, burns ``work_ms`` of CPU when the topology asks for service time,
stores the echoed payload as the task result and completes the task —
**conditionally** (``update_task_status_if created → completed``), the
remote-store-safe form of the terminal-clobber guard: a redelivered
execution racing the original can never produce a second client-visible
completion, which is exactly invariant 3 the chaos replay checks. All
store writes go through ``RingStoreClient``, so a task whose slot moved
mid-delivery lands its completion on the owning shard.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time

from aiohttp import web

from ..metrics import MetricsRegistry
from ..observability.ledger import EXECUTE, ledger_event
from ..rollout.canary import generation_label
from ..rollout.drain import DRAINING_HEADER, DrainState
from ..taskstore import TaskNotFound, TaskStatus
from .topology import Topology
from .wire import RingStoreClient

log = logging.getLogger("ai4e_tpu_torch.rig.worker")

COMPLETED_STATUS = "completed by rig echo worker"

# The rig worker's drain/resume verbs — same shape as the production
# worker's (runtime/worker.py); the supervisor's teardown and the
# rolling-upgrade driver (rig/rollout.py) POST these.
DRAIN_PATH = "/v1/worker/drain"
RESUME_PATH = "/v1/worker/resume"

# Env var the rolling-upgrade driver bumps on respawn — which deploy
# generation this worker PROCESS serves (the rig analogue of
# ServableModel.generation).
GENERATION_ENV = "AI4E_ROLLOUT_GENERATION"


class EchoWorker:
    def __init__(self, topo: Topology, shard: int):
        self.topo = topo
        self.shard = shard
        self.metrics = MetricsRegistry()
        self.ring = RingStoreClient(topo.all_shard_urls(), slots=topo.slots)
        self._served = self.metrics.counter(
            "ai4e_rig_worker_requests_total",
            "Echo-worker deliveries by outcome")
        # --- rollout state (docs/deployment.md#rollouts) ------------------
        # Which deploy generation this PROCESS serves; the rolling-upgrade
        # driver bumps it through the supervisor's respawn env overrides.
        self.generation = int(os.environ.get(GENERATION_ENV, "1") or 1)
        self.drain_state = DrainState()
        self._inflight = 0
        self._rollout_outcomes = self.metrics.counter(
            "ai4e_rollout_outcomes_total",
            "Deliveries by deploy generation and outcome")
        self._drain_gauge = self.metrics.gauge(
            "ai4e_rollout_drain_state",
            "0 active, 1 draining, 2 drained")
        # Scenario B's bad canary: at the designated generation, fail a
        # seeded fraction of deliveries with a breaker-visible 500 so the
        # guard's burn/breaker signals have something real to trip on.
        self._error_rate = (topo.rollout_error_rate
                            if (topo.rollout_error_rate > 0
                                and self.generation
                                >= topo.rollout_bad_generation > 0)
                            else 0.0)
        self._err_rng = random.Random(
            f"{topo.seed}:{shard}:{self.generation}:bad-canary")
        if self._error_rate > 0:
            log.warning("worker shard %d generation %d: injecting %.0f%% "
                        "error rate (bad-canary scenario)",
                        shard, self.generation, self._error_rate * 100)
        self.app = web.Application(client_max_size=64 * 1024 * 1024)
        self.app.router.add_get("/healthz", self._health)
        self.app.router.add_get("/metrics", self._metrics)
        self.app.router.add_post(DRAIN_PATH, self._drain)
        self.app.router.add_get(DRAIN_PATH, self._drain_status)
        self.app.router.add_post(RESUME_PATH, self._resume)
        route = topo.route.rstrip("/")
        self.app.router.add_post(route, self._run)
        self.app.router.add_post(route + "/{tail:.*}", self._run)
        self.app.on_cleanup.append(self._cleanup)
        # Strong refs to in-flight fire-and-forget ledger stamps
        # (AIL004 — the loop holds tasks weakly).
        self._stamps: set[asyncio.Task] = set()

    async def _health(self, _: web.Request) -> web.Response:
        return web.json_response({"status": "healthy", "shard": self.shard,
                                  "generation": self.generation,
                                  "draining": self.drain_state.is_draining})

    async def _drain(self, request: web.Request) -> web.Response:
        """Graceful drain: stop admitting deliveries (503 + X-Draining so
        the dispatcher redelivers to a peer AND ejects us from placement),
        then wait — bounded — for in-flight deliveries to finish."""
        timeout_s = 5.0
        try:
            body = await request.json()
            if isinstance(body, dict) and "timeout_ms" in body:
                timeout_s = max(0.0, float(body["timeout_ms"]) / 1000.0)
        except (ValueError, TypeError):
            pass  # empty/non-JSON body — the default budget applies
        t0 = time.monotonic()
        self.drain_state.begin()
        self._drain_gauge.set(float(self.drain_state.state_code))
        while (time.monotonic() - t0 < timeout_s
               and (self._inflight > 0
                    or self.drain_state.reloads_in_flight > 0)):
            await asyncio.sleep(0.02)
        clean = self._inflight == 0
        self.drain_state.mark_drained()
        self._drain_gauge.set(float(self.drain_state.state_code))
        return web.json_response({
            "state": self.drain_state.state, "clean": clean,
            "inflight": self._inflight, "generation": self.generation,
            "drain_s": round(time.monotonic() - t0, 3)})

    async def _drain_status(self, _: web.Request) -> web.Response:
        return web.json_response({"state": self.drain_state.state,
                                  "inflight": self._inflight,
                                  "generation": self.generation})

    async def _resume(self, _: web.Request) -> web.Response:
        self.drain_state.resume()
        self._drain_gauge.set(float(self.drain_state.state_code))
        return web.json_response({"state": self.drain_state.state})

    async def _metrics(self, _: web.Request) -> web.Response:
        return web.Response(text=self.metrics.render_prometheus(),
                            content_type="text/plain")

    async def _cleanup(self, _app) -> None:
        await self.ring.aclose()

    async def _run(self, request: web.Request) -> web.Response:
        gen_label = generation_label(self.generation)
        if self.drain_state.is_draining:
            # Saturation-neutral refusal (503, not 5xx-failure): the
            # dispatcher redelivers this exact task to a peer, and the
            # X-Draining marker ejects us from placement WITHOUT opening
            # a breaker — draining is on purpose, not a fault.
            self._served.inc(outcome="draining")
            self._rollout_outcomes.inc(generation=gen_label,
                                       outcome="draining")
            return web.json_response(
                {"ok": False, "reason": "worker draining; retry a peer"},
                status=503,
                headers={"Retry-After": "1", DRAINING_HEADER: "1"})
        if self._error_rate > 0 and self._err_rng.random() < self._error_rate:
            # Bad-canary injection: a real failure (500) — breaker-visible
            # and burn-visible — and NO result write, so the redelivered
            # execution completes the task on a healthy generation.
            self._served.inc(outcome="injected_error")
            self._rollout_outcomes.inc(generation=gen_label,
                                       outcome="error")
            return web.json_response(
                {"ok": False, "reason": "injected canary fault"}, status=500)
        self._inflight += 1
        try:
            resp = await self._execute(request)
        finally:
            self._inflight -= 1
        if resp.status == 200:
            self._rollout_outcomes.inc(generation=gen_label, outcome="ok")
        return resp

    async def _execute(self, request: web.Request) -> web.Response:
        task_id = request.headers.get("taskId", "")
        body = await request.read()
        if not task_id:
            return web.json_response({"error": "taskId header required"},
                                     status=400)
        t0 = time.perf_counter()
        if self.topo.work_ms > 0:
            # Real CPU burn off the event loop — service time that actually
            # contends for the core, not a sleep that hides it.
            await asyncio.to_thread(self._burn, self.topo.work_ms / 1000.0)
        if self.topo.observability and len(self._stamps) < 256:
            # The worker's service-time slice on the task's timeline,
            # fire-and-forget to the owning shard node (the hot path at
            # rig rates must not wait on telemetry; beyond the in-flight
            # cap the stamp is dropped — a wedged shard must not
            # accumulate stamp tasks). ms-carrying events follow the
            # t-is-start contract (render_ledger/timeline.py compute
            # end = t + ms), so back-date t to the burn start.
            elapsed = time.perf_counter() - t0
            stamp = asyncio.get_running_loop().create_task(
                self.ring.append_ledger(task_id, [ledger_event(
                    EXECUTE, "worker", t=time.time() - elapsed,
                    ms=elapsed * 1e3)]))
            self._stamps.add(stamp)
            stamp.add_done_callback(self._stamps.discard)
        try:
            await self.ring.set_result(
                task_id, body or b"{}",
                content_type=request.content_type or "application/json")
        except TaskNotFound:
            # Unknown to every shard RIGHT NOW. That is either a truly
            # evicted task (no promise left) or a moved task mid-handoff
            # whose copy window outlasted the ring client's patience — a
            # 200 here would let the dispatcher complete the message and
            # strand the latter forever. 503 instead: the broker
            # redelivers with backoff, landing after the flip; a real
            # ghost exhausts its delivery budget and is dropped.
            self._served.inc(outcome="unknown_task")
            return web.json_response(
                {"ok": False, "reason": "unknown task"}, status=503,
                headers={"Retry-After": "1"})
        updated = await self.ring.update_task_status_if(
            task_id, TaskStatus.CREATED, COMPLETED_STATUS,
            TaskStatus.COMPLETED)
        if updated is None:
            # Already terminal — a duplicate delivery's write must NOT
            # land (invariant 3). The 200 still completes the message.
            self._served.inc(outcome="duplicate")
            return web.json_response({"ok": True, "duplicate": True})
        self._served.inc(outcome="completed")
        return web.json_response({"ok": True, "TaskId": task_id})

    @staticmethod
    def _burn(seconds: float) -> None:
        deadline = time.perf_counter() + seconds
        x = 0
        while time.perf_counter() < deadline:
            x += 1


class MeshEchoWorker(EchoWorker):
    """The meshworker role variant (``topo.mesh``, docs/mesh_serving.md):
    EchoWorker plus the mesh endpoint's health contract, driven by the
    SAME JAX-free state machine the production worker runs
    (``runtime/mesh/{spec,coordinator,redelivery}.py``) so the rig fleet
    chaos-proves it across real processes:

    - an injected poisoned delivery (``topo.mesh_poison_nths``, the rig
      analogue of ``AI4E_FAULT_MESH_POISON_NTHS``) answers **503
      result-invalidated** — saturation-neutral, so the broker
      redelivers exactly that task and breakers stay closed; the
      original never writes a result, so the redelivered execution's
      conditional completion can never double-complete (invariant 3);
    - ``unhealthy_after`` consecutive poisons flip ``EndpointHealth``
      and the worker answers **500** — a breaker *failure*, so the
      dispatcher ejects this endpoint and fails over to its peers —
      until ``mesh_recovery_s`` elapses and a probe delivery (the
      "follower restart") runs clean, which heals it.
    """

    def __init__(self, topo: Topology, shard: int):
        super().__init__(topo, shard)
        from ..runtime.mesh import (EndpointHealth, MeshCoordinator,
                                    parse_mesh_spec)
        self.layout = parse_mesh_spec(topo.mesh)
        self.health = EndpointHealth()
        # One virtual follower (process 1) carries the injected poison —
        # the same attribution the production endpoint's single-host
        # fault injection uses.
        self.coordinator = MeshCoordinator(self.layout, health=self.health,
                                           process_count=2)
        self._deliveries = 0
        self._poison_nths = frozenset(
            int(s) for s in topo.mesh_poison_nths.split(",") if s.strip())
        self._unhealthy_at = 0.0
        self._healthy_gauge = self.metrics.gauge(
            "ai4e_rig_mesh_healthy", "1 while the mesh endpoint is healthy")
        self._healthy_gauge.set(1.0)
        if self._poison_nths:
            log.warning("meshworker shard %d: poisoning deliveries %s",
                        shard, sorted(self._poison_nths))

    async def _health(self, _: web.Request) -> web.Response:
        body = {"status": "healthy", "shard": self.shard,
                "mesh": self.layout.describe(),
                "mesh_healthy": self.health.healthy}
        if not self.health.healthy:
            body["mesh_unhealthy_reason"] = self.health.reason
        # Always 200: the supervisor's liveness gate is process health;
        # mesh ejection is the DISPATCHER's breaker decision, driven by
        # the 500s below.
        return web.json_response(body)

    async def _run(self, request: web.Request) -> web.Response:
        if not self.health.healthy:
            if (time.monotonic() - self._unhealthy_at
                    < self.topo.mesh_recovery_s):
                # 500, not 503: resilience/health.py treats 503/429 as
                # saturation-neutral — only a >=500 failure opens the
                # dispatcher's breaker and ejects this endpoint.
                self._served.inc(outcome="unhealthy")
                return web.json_response(
                    {"ok": False, "reason": "mesh endpoint unhealthy: "
                                            + self.health.reason},
                    status=500)
            # Recovery window over — this delivery is the follower-restart
            # probe: fall through; a clean run heals via observe_poison.
        self._deliveries += 1
        if self._deliveries in self._poison_nths:
            was_healthy = self.health.healthy
            self.coordinator.observe_poison([0, 1])
            if was_healthy and not self.health.healthy:
                self._unhealthy_at = time.monotonic()
                self._healthy_gauge.set(0.0)
            self._served.inc(outcome="poisoned")
            return web.json_response(
                {"ok": False,
                 "reason": "result invalidated: a worker host degraded "
                           "while executing this row's shard"},
                status=503, headers={"Retry-After": "1"})
        self.coordinator.observe_poison([0, 0])
        self._healthy_gauge.set(1.0)
        return await super()._run(request)


async def run_workernode(topo: Topology, shard: int, index: int) -> None:
    from .nodevitals import attach_vitals
    from .supervisor import serve_until_signal
    worker = (MeshEchoWorker(topo, shard) if topo.mesh
              else EchoWorker(topo, shard))
    attach_vitals(worker.app, topo, worker.metrics)
    await serve_until_signal(worker.app, topo.host,
                             topo.worker_port(shard, index))
