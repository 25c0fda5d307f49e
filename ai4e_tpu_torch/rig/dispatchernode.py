"""Dispatcher PROCESS — one shard's queue drainer over the wire; a copy
of ``ai4e_tpu/rig/dispatchernode.py``.

The unmodified ``broker.Dispatcher`` (with its full duplicate-suppression
/ backpressure / dead-letter semantics) running against:

- ``WireBroker`` — leases popped from the shard store node's
  ``/v1/rig/broker/*`` surface (the lease lives server-side, so a SIGKILL
  of this process loses nothing: the lease expires and the message
  redelivers to another dispatcher — exactly the chaos verb the rig
  replays);
- ``RingStoreClient`` as the task manager — status writes ring-route by
  TaskId, so a task whose slot moved mid-delivery still lands its
  transition on the owning shard;
- the shard's CPU-echo worker set as resilient weighted backends
  (connect-failover between workers, terminal-probe duplicate
  suppression on redeliveries).
"""

from __future__ import annotations

import logging

from aiohttp import web

from ..broker.dispatcher import Dispatcher
from ..metrics import MetricsRegistry
from ..resilience import BackendHealth, ResiliencePolicy
from ..rollout.canary import CanaryWeights
from ..taskstore import endpoint_path
from .topology import Topology
from .wire import RingStoreClient, WireBroker

log = logging.getLogger("ai4e_tpu_torch.rig.dispatcher")


async def run_dispatchernode(topo: Topology, shard: int, index: int) -> None:
    from .supervisor import serve_until_signal

    metrics = MetricsRegistry()
    ring = RingStoreClient(topo.all_shard_urls(), slots=topo.slots)
    broker = WireBroker(topo.shard_urls(shard),
                        lease_seconds=topo.lease_seconds)
    health = BackendHealth(ResiliencePolicy(retry_base_s=0.05,
                                            retry_cap_s=1.0),
                           metrics=metrics)
    # Canary split (rollout/, docs/deployment.md#rollouts): the rolling-
    # upgrade driver POSTs generation assignments + the canary share to
    # /v1/rollout/weights; placement rescales the weighted worker pool
    # through the attached CanaryWeights on every pick.
    canary = CanaryWeights()
    health.attach_canary(canary)
    observability = None
    if topo.observability:
        # The hub's stamps (popped/delivered/retry/failover/...) ride
        # fire-and-forget wire appends to the owning shard node; its
        # store listener is inert here (the ring client's add_listener
        # is a no-op — terminal accounting lives on the shard nodes).
        from ..observability.hub import RequestObservability
        observability = RequestObservability(ring, metrics=metrics)
    dispatcher = Dispatcher(
        broker, endpoint_path(topo.route), topo.worker_urls(shard), ring,
        retry_delay=topo.retry_delay,
        concurrency=topo.dispatcher_concurrency,
        request_timeout=30.0, metrics=metrics, resilience=health,
        observability=observability)

    app = web.Application()

    async def health_route(_: web.Request) -> web.Response:
        return web.json_response({"status": "healthy", "shard": shard,
                                  "busy": dispatcher._busy})

    async def metrics_route(_: web.Request) -> web.Response:
        return web.Response(text=metrics.render_prometheus(),
                            content_type="text/plain")

    async def rollout_weights(request: web.Request) -> web.Response:
        try:
            body = await request.json()
            if not isinstance(body, dict):
                raise ValueError("body must be an object")
            for uri, gen in (body.get("generations") or {}).items():
                canary.set_generation(str(uri), int(gen))
            # Pre-restart eject / post-restart re-admit: the rollout
            # driver marks a backend draining BEFORE it drains + kills
            # the process (deliveries route to peers for the TTL, no
            # connect-error breaker trips from the restart window) and
            # resets it once the replacement answers /healthz.
            for uri, ttl in (body.get("draining") or {}).items():
                health.mark_draining(str(uri), float(ttl))
            for uri in body.get("undrain") or ():
                health.reset(str(uri))
            if body.get("clear"):
                canary.clear_split()
            elif body.get("canary_generation") is not None:
                canary.set_split(int(body["canary_generation"]),
                                 float(body.get("share", 0.0)))
        except (ValueError, TypeError) as exc:
            return web.json_response({"error": str(exc)}, status=400)
        generation, share = canary.split
        return web.json_response({"canary_generation": generation,
                                  "share": share})

    app.router.add_get("/healthz", health_route)
    app.router.add_get("/metrics", metrics_route)
    app.router.add_post("/v1/rollout/weights", rollout_weights)
    from .nodevitals import attach_vitals
    attach_vitals(app, topo, metrics)

    async def start(_app) -> None:
        await dispatcher.start()

    async def stop(_app) -> None:
        await dispatcher.stop()
        await broker.aclose()
        await ring.aclose()

    app.on_startup.append(start)
    app.on_cleanup.append(stop)
    await serve_until_signal(app, topo.host,
                             topo.dispatcher_port(shard, index))
