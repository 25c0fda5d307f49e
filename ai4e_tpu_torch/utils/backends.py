"""Weighted backend sets: canary and blue/green traffic splitting. A copy
of ``ai4e_tpu/utils/backends.py``.

A route or dispatcher may name several backends with weights (say 95% of
traffic to the fleet, 5% to one worker serving a candidate checkpoint),
and every delivery picks independently. One rule keeps the task plane
coherent: every backend of a set shares one endpoint path (only hosts
differ), because the queue name, the recorded task ``Endpoint`` and the
rebase rule (``broker.dispatcher.rebase_endpoint``) are all derived from
the path.

Stdlib only, as the JAX package's copy is.
"""

from __future__ import annotations

import random
from typing import Iterable

from ..taskstore.task import endpoint_path

Weighted = list[tuple[str, float]]


def normalize_backends(backend_uri: str | Iterable) -> Weighted:
    """One backend URI, or an iterable of ``"uri"`` / ``{"uri", "weight"}``
    / ``(uri, weight)`` entries -> a validated ``[(uri, weight), ...]``.

    Weights are relative; an entry may be 0 (registered, receiving no
    traffic: the drained side of a blue/green flip); at least one weight
    must be positive; every URI must share one endpoint path."""
    if isinstance(backend_uri, str):
        return [(backend_uri, 1.0)]
    if (isinstance(backend_uri, list) and backend_uri
            and all(isinstance(e, tuple) and len(e) == 2
                    and isinstance(e[0], str) and isinstance(e[1], float)
                    for e in backend_uri)):
        # Already normalized: registration hands sets down several layers.
        # A copy, so a caller mutating its own list after registration
        # cannot rewrite live routing weights.
        return list(backend_uri)
    out: Weighted = []
    for entry in backend_uri:
        if isinstance(entry, str):
            uri, weight = entry, 1.0
        elif isinstance(entry, dict):
            uri, weight = entry["uri"], float(entry.get("weight", 1.0))
        else:
            uri, weight = entry[0], float(entry[1])
        if weight < 0:
            raise ValueError(f"negative backend weight for {uri!r}")
        out.append((uri, weight))
    if not out:
        raise ValueError("backend list is empty")
    if all(w == 0 for _, w in out):
        raise ValueError("every backend has weight 0 — nothing can serve")
    paths = {endpoint_path(u) for u, _ in out}
    if len(paths) > 1:
        raise ValueError(
            "canary backends must share one endpoint path (only hosts may "
            f"differ): got {sorted(paths)}")
    return out


def pick_backend(backends: Weighted, rng: random.Random | None = None) -> str:
    """One weighted independent pick. A one-backend set makes no RNG call,
    so the common deployment pays nothing for the feature."""
    if len(backends) == 1:
        return backends[0][0]
    uris, weights = zip(*backends)
    return (rng or random).choices(uris, weights=weights, k=1)[0]
