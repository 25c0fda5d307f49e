"""Front balancer PROCESS — the rig's one client-facing address; a copy
of ``ai4e_tpu/rig/balancer.py``.

The role the reference fills with its managed front door (Istio ingress /
APIM): round-robin every request across the gateway replicas, and retry a
CONNECT-phase failure against the next replica — a killed gateway costs
its in-flight requests (the client's poll loop re-polls through here and
lands on a survivor), never the address. Only connect failures fail over;
a response that began is returned as-is — the balancer must not replay a
request a gateway may have admitted (the same rule the gateway's own sync
proxy applies).
"""

from __future__ import annotations

import asyncio
import itertools
import logging

import aiohttp
from aiohttp import web

from ..metrics import MetricsRegistry
from .topology import Topology

log = logging.getLogger("ai4e_tpu_torch.rig.balancer")

_HOP_HEADERS = ("host", "content-length", "transfer-encoding", "connection")


class Balancer:
    def __init__(self, topo: Topology):
        self.topo = topo
        self.metrics = MetricsRegistry()
        self._rr = itertools.cycle(range(topo.gateways))
        self._requests = self.metrics.counter(
            "ai4e_balancer_requests_total",
            "Balancer requests by upstream gateway and outcome")
        self._session: aiohttp.ClientSession | None = None
        self.app = web.Application(client_max_size=64 * 1024 * 1024)
        self.app.router.add_get("/healthz", self._health)
        self.app.router.add_get("/metrics", self._metrics)
        # Vitals BEFORE the catch-all: aiohttp resolves in registration
        # order, and /v1/debug/vitals must answer here, not proxy.
        from .nodevitals import attach_vitals
        attach_vitals(self.app, topo, self.metrics)
        self.app.router.add_route("*", "/{tail:.*}", self._proxy)
        self.app.on_cleanup.append(self._cleanup)

    async def _health(self, _: web.Request) -> web.Response:
        return web.json_response({"status": "healthy",
                                  "gateways": self.topo.gateways})

    async def _metrics(self, _: web.Request) -> web.Response:
        return web.Response(text=self.metrics.render_prometheus(),
                            content_type="text/plain")

    async def _get_session(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=90),
                connector=aiohttp.TCPConnector(limit=0))
        return self._session

    async def _cleanup(self, _app) -> None:
        if self._session is not None:
            await self._session.close()

    async def _proxy(self, request: web.Request) -> web.Response:
        body = await request.read()
        headers = {k: v for k, v in request.headers.items()
                   if k.lower() not in _HOP_HEADERS}
        session = await self._get_session()
        last: Exception | None = None
        for _ in range(self.topo.gateways):
            g = next(self._rr)
            target = (self.topo.gateway_urls()[g]
                      + request.path_qs)
            try:
                async with session.request(request.method, target,
                                           data=body,
                                           headers=headers) as resp:
                    payload = await resp.read()
                self._requests.inc(gateway=str(g),
                                   outcome=str(resp.status))
                # Forward the gateway's response headers: shed provenance
                # (X-Shed-Reason) and quota drain (Retry-After) are part
                # of the refusal contract clients key off — a front door
                # that strips them breaks the tenant taxonomy. The body
                # arrives decoded, so content-* framing stays ours.
                resp_headers = {
                    k: v for k, v in resp.headers.items()
                    if k.lower() not in _HOP_HEADERS
                    and k.lower() not in ("content-type",
                                          "content-encoding")}
                return web.Response(status=resp.status, body=payload,
                                    content_type=resp.content_type,
                                    headers=resp_headers)
            except aiohttp.ClientConnectorError as exc:
                # Connect-phase failure ONLY: the gateway never saw the
                # request — safe to offer it to the next replica. A reset
                # of an ESTABLISHED connection (ClientOSError/
                # ConnectionResetError — e.g. the chaos SIGKILL landing
                # after the body was sent) must NOT come through here: the
                # gateway may already have admitted the task, and a replay
                # would mint a second one.
                last = exc
                self._requests.inc(gateway=str(g), outcome="unreachable")
                continue
            except (aiohttp.ClientError, ConnectionResetError, OSError,
                    asyncio.TimeoutError) as exc:
                # Mid-response failure: the gateway may have admitted the
                # task — surface 502, never replay.
                self._requests.inc(gateway=str(g), outcome="broken")
                return web.Response(status=502,
                                    text=f"gateway dropped mid-response: "
                                         f"{exc}")
        return web.Response(status=503,
                            text=f"no gateway reachable: {last}",
                            headers={"Retry-After": "1"})


async def run_balancer(topo: Topology) -> None:
    from .supervisor import serve_until_signal
    balancer = Balancer(topo)
    await serve_until_signal(balancer.app, topo.host, topo.balancer_port())
