"""Inference result cache and single-flight request coalescing — the
port's copy of ``ai4e_tpu/rescache``: canonical keys (``keys``), the
bounded store with its in-flight registry (``cache``) and the store
listener that fills it (``wiring``)."""

from .cache import ResultCache
from .keys import (BYPASS_HEADER, CACHE_STATUS_HEADER, cache_bypass_requested,
                   canonical_payload, family_of, normalize_media_type,
                   request_key)
from .wiring import attach_store

__all__ = [
    "ResultCache",
    "attach_store",
    "request_key",
    "canonical_payload",
    "normalize_media_type",
    "family_of",
    "cache_bypass_requested",
    "BYPASS_HEADER",
    "CACHE_STATUS_HEADER",
]
