"""Request reporter: the cross-replica in-flight request counter. A copy of
``ai4e_tpu/metrics/reporter.py``.

One aiohttp app over a thread-safe counter table:

- ``POST /v1/processing`` {Cluster, Path, IncrementBy, DecrementBy} -> the
  new value;
- ``GET  /v1/processing?cluster=&path=`` -> the current value;
- ``GET  /metrics`` exports every counter as ``ai4e_current_requests``
  gauge samples, the aggregated load signal an external scaler reads.

``ProcessingReporterClient`` is the service shell's side: fire-and-forget
deltas, so a slow or dead reporter never blocks the request path.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time

import aiohttp
from aiohttp import web

from ..utils.http import SessionHolder
from .registry import DEFAULT_REGISTRY, MetricsRegistry

log = logging.getLogger("ai4e_tpu_torch.reporter")


class ProcessingCounters:
    """Thread-safe counter table.

    The raw sum is kept unclamped, so a decrement that overtakes its
    increment (independent async POSTs can reorder) nets back to zero.
    Reads clamp at zero and treat a counter idle for ``stale_after``
    seconds as zero, so a reporter restart mid-flight or lost decrements
    decay to a correct quiescent signal."""

    def __init__(self, metrics: MetricsRegistry | None = None,
                 stale_after: float = 600.0):
        self._values: dict[tuple[str, str], tuple[int, float]] = {}
        self._lock = threading.Lock()
        self.stale_after = stale_after
        self.metrics = metrics or DEFAULT_REGISTRY
        self._gauge = self.metrics.gauge(
            "ai4e_current_requests",
            "Cross-replica in-flight requests per cluster/path")

    def adjust(self, cluster: str, path: str,
               increment: int = 0, decrement: int = 0) -> int:
        delta = increment - decrement
        now = time.monotonic()
        with self._lock:
            raw, ts = self._values.get((cluster, path), (0, now))
            if now - ts > self.stale_after:
                raw = 0  # stale residue (lost deltas / restart skew)
            raw += delta
            self._values[(cluster, path)] = (raw, now)
        value = max(0, raw)
        self._gauge.set(value, cluster=cluster, path=path)
        return value

    def value(self, cluster: str, path: str) -> int:
        with self._lock:
            raw, ts = self._values.get((cluster, path), (0, time.monotonic()))
        if time.monotonic() - ts > self.stale_after:
            return 0
        return max(0, raw)

    def snapshot(self) -> dict[tuple[str, str], int]:
        with self._lock:
            keys = list(self._values)
        return {k: self.value(*k) for k in keys}


class RequestReporterService:
    """The reporter as a deployable HTTP component, one per cluster."""

    def __init__(self, counters: ProcessingCounters | None = None,
                 metrics: MetricsRegistry | None = None):
        self.metrics = metrics or DEFAULT_REGISTRY
        self.counters = counters or ProcessingCounters(self.metrics)
        self.app = web.Application()
        self.app.router.add_post("/v1/processing", self._upsert)
        self.app.router.add_get("/v1/processing", self._get)
        self.app.router.add_get("/metrics", self._metrics)
        self.app.router.add_get("/healthz", self._health)

    async def _upsert(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.Response(status=400, text="bad processing update")
        cluster = body.get("Cluster", "")
        path = body.get("Path", "")
        if not path:
            return web.Response(status=400, text="Path is required")
        value = self.counters.adjust(
            cluster, path,
            increment=int(body.get("IncrementBy", 0)),
            decrement=int(body.get("DecrementBy", 0)))
        return web.json_response({"Cluster": cluster, "Path": path,
                                  "CurrentRequests": value})

    async def _get(self, request: web.Request) -> web.Response:
        cluster = request.query.get("cluster", "")
        path = request.query.get("path", "")
        if not path:
            return web.Response(status=400, text="path is required")
        return web.json_response({
            "Cluster": cluster, "Path": path,
            "CurrentRequests": self.counters.value(cluster, path)})

    async def _metrics(self, _: web.Request) -> web.Response:
        return web.Response(text=self.metrics.render_prometheus(),
                            content_type="text/plain")

    async def _health(self, _: web.Request) -> web.Response:
        return web.json_response({"status": "healthy"})


class ProcessingReporterClient:
    """The service shell's reporter hook: fire-and-forget deltas to the
    reporter URI; failures are logged, never raised."""

    def __init__(self, reporter_uri: str, cluster: str = "local"):
        self.reporter_uri = reporter_uri.rstrip("/")
        self.cluster = cluster
        self._sessions = SessionHolder(timeout=10.0)
        self._pending: set[asyncio.Task] = set()

    def report(self, path: str, increment: int = 0,
               decrement: int = 0) -> None:
        """Schedule the delta POST on the running loop; a no-op off it."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            log.debug("reporter delta for %s dropped: no running loop", path)
            return
        t = loop.create_task(self._send(path, increment, decrement))
        self._pending.add(t)
        t.add_done_callback(self._pending.discard)

    async def _send(self, path: str, increment: int, decrement: int) -> None:
        payload = {"Cluster": self.cluster, "Path": path,
                   "IncrementBy": increment, "DecrementBy": decrement}
        try:
            session = await self._sessions.get()
            async with session.post(f"{self.reporter_uri}/v1/processing",
                                    json=payload) as resp:
                await resp.read()
                if resp.status != 200:
                    log.warning("reporter returned %d for %s", resp.status,
                                path)
        except (aiohttp.ClientError, asyncio.TimeoutError) as exc:
            log.warning("reporter unreachable: %s", exc)

    async def current(self, path: str) -> int | None:
        """Read the aggregated counter back."""
        try:
            session = await self._sessions.get()
            async with session.get(
                    f"{self.reporter_uri}/v1/processing",
                    params={"cluster": self.cluster, "path": path}) as resp:
                if resp.status != 200:
                    return None
                return (await resp.json())["CurrentRequests"]
        except (aiohttp.ClientError, asyncio.TimeoutError):
            return None

    async def drain(self, timeout: float = 5.0) -> None:
        if self._pending:
            await asyncio.wait(list(self._pending), timeout=timeout)

    async def close(self) -> None:
        for t in list(self._pending):
            t.cancel()
        if self._pending:
            await asyncio.gather(*self._pending, return_exceptions=True)
        await self._sessions.close()
