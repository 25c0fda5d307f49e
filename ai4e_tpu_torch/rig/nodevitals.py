"""Per-role vitals attachment (a copy of ``ai4e_tpu/rig/nodevitals.py``)
— every rig process samples its own
runtime vitals (``observability/vitals.py``) into its per-role registry
and serves the recent-sample ring at ``GET /v1/debug/vitals``, which the
driver collects pre-teardown for the Perfetto timeline's counter tracks
(``observability/timeline.py``). One helper so all six roles wire it
identically."""

from __future__ import annotations

from aiohttp import web

from ..metrics import MetricsRegistry
from ..observability.vitals import VitalsSampler
from .topology import Topology

VITALS_PATH = "/v1/debug/vitals"


def attach_vitals(app: web.Application, topo: Topology,
                  metrics: MetricsRegistry) -> VitalsSampler | None:
    """Create a sampler on the role's registry, register the dump route,
    and tie the sample loop to the app's lifecycle. Call BEFORE any
    catch-all route is added (the balancer's proxy tail). No-op when the
    topology runs observability-off: ``--no-observability`` means a
    telemetry-free fleet — no sampler task, no route, no
    ``ai4e_process_*`` series — the roles as they are without telemetry."""
    if not topo.observability:
        return None
    sampler = VitalsSampler(metrics=metrics,
                            interval_s=topo.vitals_interval)

    async def vitals_route(_: web.Request) -> web.Response:
        return web.json_response({"recent": sampler.recent()})

    app.router.add_get(VITALS_PATH, vitals_route)

    async def _start(_app) -> None:
        await sampler.start()

    async def _stop(_app) -> None:
        await sampler.stop()

    app.on_startup.append(_start)
    app.on_cleanup.append(_stop)
    return sampler
