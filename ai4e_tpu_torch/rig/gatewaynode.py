"""One gateway replica PROCESS (docs/deployment.md); a copy of
``ai4e_tpu/rig/gatewaynode.py``.

The ordinary ``Gateway`` class over the rig's ``RingStoreClient`` instead
of an in-process store: every store verb crosses the task-store HTTP
surface ring-routed by TaskId, and the long-poll parks on the locally
tailed wire change feed — so a replica that did NOT admit a task still
wakes its long-poll with the record (the satellite regression in
``tests/test_longpoll.py`` proves the mechanism; the rig exercises it
across real processes). Each gateway carries its own per-role
``MetricsRegistry``; the rig's fleet collector (and the verdict's
post-hoc merge) scrape every node's ``/metrics`` into one coherent view.

Observability (``topo.observability``, default on): the gateway gets the
same ``RequestObservability`` hub the single-process assembly wires —
``admitted``/``published`` hop-ledger stamps ride fire-and-forget wire
appends to the OWNING shard node (the timeline lives beside the record),
refusals feed a local flight-recorder ring served at
``GET /v1/debug/flight``, and a vitals sampler exports
``ai4e_process_*``. The store-side half (terminal stamps, e2e latency,
outcome counters) lives on the shard nodes, which own the records.
"""

from __future__ import annotations

import logging

from ..gateway.router import Gateway
from ..metrics import MetricsRegistry
from .nodevitals import attach_vitals
from .topology import Topology
from .wire import RingStoreClient

log = logging.getLogger("ai4e_tpu_torch.rig.gateway")


def build_gateway(topo: Topology) -> tuple[Gateway, RingStoreClient]:
    ring = RingStoreClient(topo.all_shard_urls(), slots=topo.slots)
    gateway = Gateway(ring, metrics=MetricsRegistry())
    # The recorded task Endpoint is nominal (dispatchers rebase onto their
    # shard's worker set); its PATH is what names the broker queue.
    gateway.add_async_route(topo.route, topo.worker_urls(0)[0])
    if topo.tenants:
        # Per-replica tenancy edge: THIS process resolves subscription
        # keys and enforces the token-bucket quota locally (no shared
        # bucket across gateways — the fleet admits up to gateways × rps
        # per tenant, the per-instance rate-limit semantic stated in
        # docs/tenancy.md). Outcome accounting stays on the record-owning
        # side; the edge counters (ai4e_tenant_admissions_total) land in
        # this node's registry and merge in the verdict scrape.
        from ..tenancy import Tenancy
        gateway.set_tenancy(Tenancy.from_spec(topo.tenants,
                                              metrics=gateway.metrics))
    if topo.observability:
        from ..observability.flight import FlightRecorder
        from ..observability.hub import RequestObservability
        gateway.set_observability(RequestObservability(
            ring, metrics=gateway.metrics,
            flight=FlightRecorder(capacity=256, metrics=gateway.metrics)))
    return gateway, ring


async def run_gatewaynode(topo: Topology, index: int) -> None:
    from .supervisor import serve_until_signal

    gateway, ring = build_gateway(topo)
    attach_vitals(gateway.app, topo, gateway.metrics)

    async def start_tails(_app) -> None:
        await ring.start_feed_tails()

    async def stop_tails(_app) -> None:
        await ring.aclose()

    gateway.app.on_startup.append(start_tails)
    gateway.app.on_cleanup.append(stop_tails)
    await serve_until_signal(gateway.app, topo.host,
                             topo.gateway_port(index))
