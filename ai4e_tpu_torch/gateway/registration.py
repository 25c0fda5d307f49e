"""API registration: publishing a model API onto the platform edge. A copy
of ``ai4e_tpu/gateway/registration.py``.

A typed ``ApiDefinition`` is rendered into gateway routes. The public URL
shape is ``/{version}/{organization}/{api}``, with operations as path
tails under it: the gateway and dispatcher graft tails on, so operations
need no registration of their own.
"""

from __future__ import annotations

import json
from dataclasses import dataclass


@dataclass
class ApiDefinition:
    """One published API: who owns it, what it is called, where it runs."""

    organization: str            # e.g. "camera-trap"
    api: str                     # e.g. "detection"
    backend_host: str            # worker base, e.g. "http://worker:8081"
    version: str = "v1"
    mode: str = "async"          # "sync" | "async"
    operations: tuple = ()       # documented operation tails
    backend_path: str = ""       # path on the worker; default /{version}/{api}
    # Queue-transport dispatch knobs (publish_async_api's).
    concurrency: int | None = None
    retry_delay: float | None = None
    autoscale: dict | None = None

    @property
    def public_prefix(self) -> str:
        return f"/{self.version}/{self.organization}/{self.api}"

    @property
    def backend_uri(self) -> str:
        path = self.backend_path or f"/{self.version}/{self.api}"
        return self.backend_host.rstrip("/") + path

    @classmethod
    def from_dict(cls, rec: dict) -> "ApiDefinition":
        rec = dict(rec)
        if "operations" in rec:
            rec["operations"] = tuple(rec["operations"])
        return cls(**rec)


def routes_from_definitions(defs: list[ApiDefinition]) -> dict:
    """Render definitions to the control plane's ``routes.json`` shape."""
    apis = []
    for d in defs:
        entry: dict = {"prefix": d.public_prefix, "backend": d.backend_uri,
                       "mode": d.mode}
        if d.concurrency is not None:
            entry["concurrency"] = d.concurrency
        if d.retry_delay is not None:
            entry["retry_delay"] = d.retry_delay
        if d.autoscale is not None:
            entry["autoscale"] = d.autoscale
        apis.append(entry)
    return {"apis": apis}


def register_definitions(platform, defs: list[ApiDefinition]) -> None:
    """Publish definitions directly onto a ``LocalPlatform``."""
    for d in defs:
        if d.mode == "sync":
            platform.publish_sync_api(d.public_prefix, d.backend_uri)
            continue
        autoscale = None
        if d.autoscale is not None:
            from ..scaling import AutoscalePolicy
            autoscale = AutoscalePolicy(**d.autoscale)
        platform.publish_async_api(
            d.public_prefix, d.backend_uri,
            retry_delay=d.retry_delay, concurrency=d.concurrency,
            autoscale=autoscale)


def load_definitions(path: str) -> list[ApiDefinition]:
    """Load an ``apis.json``: ``{"apis": [{organization, api, backend_host,
    ...}, ...]}``."""
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    return [ApiDefinition.from_dict(rec) for rec in spec.get("apis", [])]
