"""Fleet-telemetry collector PROCESS (docs/deployment.md collector row);
a copy of ``ai4e_tpu/rig/collectornode.py``.

The observability plane's aggregation point: a ``FleetCollector``
(``observability/federation.py``) scraping every other role's
``/metrics`` on ``topo.scrape_interval``, serving:

- ``GET /v1/debug/fleet``          — the live fleet snapshot JSON
  (per-proc vitals/rates, fleet totals, the conservation cross-check) —
  what ``python -m ai4e_tpu_torch top`` polls and what the rig driver saves
  beside the verdict;
- ``GET /v1/debug/fleet/metrics``  — the merged exposition with
  bounded-cardinality ``proc``/``role`` labels (point ONE Prometheus
  here instead of N+scattered ports);
- ``GET /metrics``                 — the collector's OWN registry
  (``ai4e_fleet_*`` + its vitals), scraped by the verdict like every
  role's.

The collector is an observer: chaos never targets it, and the fleet
serves identically without it (``--no-collector`` / ``collector=False``
— the observability-off identity claim, proven in tests)."""

from __future__ import annotations

import logging

from aiohttp import web

from ..metrics import MetricsRegistry
from ..observability.federation import FleetCollector
from .nodevitals import attach_vitals
from .topology import Topology

log = logging.getLogger("ai4e_tpu_torch.rig.collector")

FLEET_PATH = "/v1/debug/fleet"


def build_collector_app(topo: Topology
                        ) -> tuple[web.Application, FleetCollector]:
    metrics = MetricsRegistry()
    targets = {name: url for name, url in topo.metrics_urls().items()
               if name != "collector"}
    collector = FleetCollector(targets,
                               interval_s=topo.scrape_interval,
                               metrics=metrics)
    app = web.Application()

    async def health(_: web.Request) -> web.Response:
        return web.json_response({"status": "healthy",
                                  "targets": len(targets)})

    async def own_metrics(_: web.Request) -> web.Response:
        return web.Response(text=metrics.render_prometheus(),
                            content_type="text/plain")

    async def fleet(_: web.Request) -> web.Response:
        return web.json_response(collector.snapshot())

    async def fleet_metrics(_: web.Request) -> web.Response:
        return web.Response(text=collector.render_merged(),
                            content_type="text/plain")

    app.router.add_get("/healthz", health)
    app.router.add_get("/metrics", own_metrics)
    app.router.add_get(FLEET_PATH, fleet)
    app.router.add_get(FLEET_PATH + "/metrics", fleet_metrics)
    attach_vitals(app, topo, metrics)

    async def start(_app) -> None:
        await collector.start()

    async def stop(_app) -> None:
        await collector.stop()

    app.on_startup.append(start)
    app.on_cleanup.append(stop)
    return app, collector


async def run_collectornode(topo: Topology) -> None:
    from .supervisor import serve_until_signal
    app, _collector = build_collector_app(topo)
    await serve_until_signal(app, topo.host, topo.collector_port())
