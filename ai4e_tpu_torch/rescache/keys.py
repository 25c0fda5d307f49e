"""Canonical request hashing, the result cache's identity function — a copy
of ``ai4e_tpu/rescache/keys.py``. A key is byte-equal to the JAX package's
for the same inputs (the same sha256 over the same length-framed fields,
the same JSON canonicalisation, the same ``"{family}|{hex}"`` form), so a
JAX dispatcher and a port gateway meeting in one deployment share one key
namespace.

The digest covers four dimensions:

- **family**: which servable or route answers the request (the worker keys
  on the model name, the gateway on the backend endpoint path, which is
  also the queue name: one invalidation namespace per rollout unit);
- **checkpoint**: which weights answer it (the worker keys on
  ``params_version``, so a reload changes every key; the gateway does not
  know the serving version and relies on the reload's invalidation);
- **wire format**: the payload's media type;
- **normalized payload bytes**: JSON re-serialized with sorted keys and
  compact separators, so ``{"a":1,"b":2}`` and ``{ "b": 2, "a": 1 }``
  collide; binary payloads hash as they are.
"""

from __future__ import annotations

import hashlib
import json

# Request header that opts a single request out of the result cache entirely
# (no read, no store). ``Cache-Control: no-cache`` / ``no-store`` are honored
# with the same meaning.
BYPASS_HEADER = "X-Cache-Bypass"
# Response header stamping the cache outcome: hit | miss | coalesced | bypass.
CACHE_STATUS_HEADER = "X-Cache"


def cache_bypass_requested(headers) -> bool:
    """True when the request opted out of the cache (``X-Cache-Bypass`` set,
    or a ``Cache-Control`` carrying no-cache/no-store). ``headers`` is any
    case-insensitive mapping (aiohttp's CIMultiDict, urllib's message)."""
    raw = (headers.get(BYPASS_HEADER) or "").strip().lower()
    if raw and raw not in ("0", "false", "no", "off"):
        # Explicit falsy values mean "do not bypass" — a middleware that
        # normalizes boolean headers to "0" must not silently disable the
        # cache for 100% of traffic.
        return True
    cc = (headers.get("Cache-Control") or "").lower()
    return "no-cache" in cc or "no-store" in cc


def normalize_media_type(content_type: str) -> str:
    """Media type without parameters: ``application/json; charset=utf-8`` →
    ``application/json`` (parameters never change the payload semantics the
    cache cares about; charset differences show up in the bytes)."""
    return (content_type or "").split(";", 1)[0].strip().lower()


def canonical_payload(body: bytes, content_type: str = "") -> bytes:
    """Payload bytes with wire-level noise removed.

    JSON media types (``*/json`` and ``*+json``) re-serialize with sorted
    keys and compact separators, so semantically identical documents hash
    identically. Anything that fails to parse — or any binary wire — hashes
    as the raw bytes (never raises)."""
    media = normalize_media_type(content_type)
    if media.endswith("/json") or media.endswith("+json"):
        try:
            return json.dumps(
                json.loads(body.decode("utf-8")),
                sort_keys=True, separators=(",", ":"),
            ).encode("utf-8")
        except (ValueError, UnicodeDecodeError):
            return body
    return body


def request_key(family: str, payload: bytes, content_type: str = "",
                checkpoint: str = "", extra: str = "") -> str:
    """Stable digest over (family, checkpoint, wire format, normalized
    payload[, extra]). ``extra`` carries request addressing that changes the
    answer but lives outside the body — the gateway passes the operation
    tail + query string (``?conf=0.9`` is a different request).

    Fields are length-framed before hashing so no concatenation of values
    can collide with a different split of the same bytes."""
    h = hashlib.sha256()
    for field in (family.encode("utf-8"),
                  checkpoint.encode("utf-8"),
                  normalize_media_type(content_type).encode("utf-8"),
                  extra.encode("utf-8"),
                  canonical_payload(payload, content_type)):
        h.update(len(field).to_bytes(8, "big"))
        h.update(field)
    return f"{family}|{h.hexdigest()}"


def family_of(key: str) -> str:
    """The invalidation namespace a key belongs to."""
    return key.rsplit("|", 1)[0]
