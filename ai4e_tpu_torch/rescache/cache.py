"""Inference result cache with single-flight bookkeeping — ``ResultCache``
of ``ai4e_tpu/rescache/cache.py``: a bounded, invalidatable result store
plus the in-flight registry that lets N concurrent identical requests ride
ONE execution.

- **LRU + TTL + byte budget.** Entries are evicted least-recently-used when
  either the entry count or the byte budget overflows; expired entries are
  dropped lazily on access and eagerly when an insert needs room. A single
  entry larger than ``max_entry_bytes`` is refused outright.
- **Per-family invalidation.** Every key carries its family (model name or
  endpoint path, ``keys.family_of``); ``invalidate_family`` drops the whole
  namespace and its in-flight registrations in one call, and bumps the
  family's generation so a fill computed before it refuses itself
  (``put(if_generation=)``). The worker's reload verb calls it, so no
  result of the old weights is served after a swap.
- **Single-flight registry.** ``register_inflight(key, task_id)`` marks an
  execution as owning a key; ``leader_for`` lets the gateway hand late
  arrivals the SAME task record; the store listener
  (``wiring.attach_store``) fills the cache and releases the registration
  on the leader's terminal transition (``fill_inflight``).
- **Thread-safe.** Store listeners may fire from any thread; everything is
  guarded by one lock.

Metrics, as in JAX: ``ai4e_rescache_requests_total{outcome}``
(hit|miss|coalesced|bypass), ``ai4e_rescache_evictions_total{reason}``
(lru|bytes|ttl|invalidated|replaced|oversize), ``ai4e_rescache_entries``,
``ai4e_rescache_bytes``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from .keys import family_of


@dataclass
class _Entry:
    payload: bytes
    content_type: str
    family: str
    inserted_at: float
    # Families beyond the key's own that CONTRIBUTED to this result — a
    # pipeline composite is keyed under stage 1's endpoint but computed by
    # every downstream stage too; reloading ANY of them must drop it
    # (``invalidate_family`` matches these as well as ``family``).
    extra_families: tuple = ()


class ResultCache:
    """Bounded result store + in-flight request registry (one per process,
    shared by the gateway, dispatchers, and workers it serves)."""

    def __init__(self, max_entries: int = 4096,
                 max_bytes: int = 256 * 1024 * 1024,
                 ttl_s: float | None = 300.0,
                 max_entry_bytes: int | None = None,
                 metrics: MetricsRegistry | None = None,
                 clock=time.monotonic):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.ttl_s = ttl_s
        # Default: no single entry may take more than 1/8 of the byte budget
        # — a cache that holds at most a handful of giant batch outputs would
        # thrash instead of serving the interactive hot set.
        self.max_entry_bytes = (max_entry_bytes if max_entry_bytes is not None
                                else max(1, max_bytes // 8))
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self._bytes = 0
        # Single-flight: key -> task_id of the one execution owning it.
        self._inflight: dict[str, str] = {}
        # Per-family invalidation generation: bumped by invalidate_family so
        # a fill computed BEFORE an invalidation can prove it is stale and
        # refuse itself (``put(..., if_generation=)``). Families are routes/
        # models — a handful of keys, never unbounded.
        self._family_gen: dict[str, int] = {}
        metrics = metrics or DEFAULT_REGISTRY
        self._requests = metrics.counter(
            "ai4e_rescache_requests_total",
            "Result-cache lookups by outcome (hit/miss/coalesced/bypass)")
        self._evictions = metrics.counter(
            "ai4e_rescache_evictions_total",
            "Result-cache evictions by reason")
        self._entries_gauge = metrics.gauge(
            "ai4e_rescache_entries", "Result-cache live entries")
        self._bytes_gauge = metrics.gauge(
            "ai4e_rescache_bytes", "Result-cache resident payload bytes")

    # -- result store ------------------------------------------------------

    def get(self, key: str, count: bool = True) -> tuple[bytes, str] | None:
        """``(payload, content_type)`` or None; refreshes LRU recency.
        ``count=False`` skips the hit/miss counters — internal lookups
        (dispatcher redelivery check, worker sync path) pass it so one
        external request never records several outcomes and the hit ratio
        stays a statement about the gateway edge (docs/METRICS.md)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and self._expired(entry):
                self._drop(key, "ttl")
                # Keep the gauges honest through a read-only lull: without
                # this, lazy expiry leaves entries/bytes reporting pre-TTL
                # values until the next put/invalidate/sweep.
                self._sync_gauges()
                entry = None
            if entry is None:
                if count:
                    self._requests.inc(outcome="miss")
                return None
            self._entries.move_to_end(key)
            if count:
                self._requests.inc(outcome="hit")
            return entry.payload, entry.content_type

    def peek(self, key: str) -> bool:
        """Presence test without touching counters or recency (tests,
        introspection)."""
        with self._lock:
            entry = self._entries.get(key)
            return entry is not None and not self._expired(entry)

    def put(self, key: str, payload: bytes,
            content_type: str = "application/json",
            if_generation: int | None = None,
            extra_families: tuple = ()) -> bool:
        """Insert/overwrite; returns False when the entry is over the
        per-entry size cap (refused, nothing evicted for it) or when
        ``if_generation`` no longer matches the family's invalidation
        generation — a fill computed before a checkpoint reload invalidated
        the family is STALE and must not land (the sync proxy captures the
        generation when it becomes the single-flight leader)."""
        if len(payload) > self.max_entry_bytes:
            self._evictions.inc(reason="oversize")
            return False
        with self._lock:
            if (if_generation is not None
                    and if_generation != self._family_gen_locked(
                        family_of(key))):
                return False
            self._put_locked(key, payload, content_type, extra_families)
        return True

    def _put_locked(self, key: str, payload: bytes, content_type: str,
                    extra_families: tuple = ()) -> None:
        prev = self._entries.pop(key, None)
        if prev is not None:
            self._bytes -= len(prev.payload)
            self._evictions.inc(reason="replaced")
        self._entries[key] = _Entry(payload, content_type,
                                    family_of(key), self._clock(),
                                    tuple(extra_families))
        self._bytes += len(payload)
        self._shrink()
        self._sync_gauges()

    def generation(self, key: str) -> int:
        """The invalidation generation of ``key``'s family — capture before
        computing a result, pass back via ``put(if_generation=)`` so an
        invalidation that landed in between refuses the stale fill."""
        return self.family_generation(family_of(key))

    def family_generation(self, family: str) -> int:
        """Effective invalidation generation of a family NAME (not a key).
        Prefix-aware: invalidating ``/v1/x`` also advances ``/v1/x/tail`` —
        tailed request families belong to their base route's rollout unit."""
        with self._lock:
            return self._family_gen_locked(family)

    def _family_gen_locked(self, family: str) -> int:
        return sum(gen for fam, gen in self._family_gen.items()
                   if self._family_matches(family, fam))

    @staticmethod
    def _family_matches(family: str, invalidated: str) -> bool:
        """Whether invalidating ``invalidated`` covers ``family`` — exact, or
        ``family`` is a tailed sub-path of it (``/v1/x/op`` under ``/v1/x``)."""
        return (family == invalidated
                or family.startswith(invalidated + "/"))

    def invalidate_family(self, family: str) -> int:
        """Drop every entry a family contributed to — the checkpoint-reload
        hook. Matches the entry's own family (tailed sub-paths included) AND
        its ``extra_families`` (a pipeline composite keyed under stage 1 is
        dropped when a downstream stage's weights swap). Also clears the
        family's in-flight registrations: a leader executing on the OLD
        weights must not adopt post-swap subscribers (they re-execute on the
        new weights instead)."""
        with self._lock:
            self._family_gen[family] = self._family_gen.get(family, 0) + 1
            victims = [
                k for k, e in self._entries.items()
                if self._family_matches(e.family, family)
                or any(self._family_matches(x, family)
                       for x in e.extra_families)]
            for key in victims:
                self._drop(key, "invalidated")
            for key in [k for k in self._inflight
                        if self._family_matches(family_of(k), family)]:
                del self._inflight[key]
            self._sync_gauges()
            return len(victims)

    def sweep(self) -> int:
        """Eagerly drop expired entries (operational hook; lazy expiry covers
        normal operation). Returns entries dropped."""
        with self._lock:
            victims = [k for k, e in self._entries.items() if self._expired(e)]
            for key in victims:
                self._drop(key, "ttl")
            self._sync_gauges()
            return len(victims)

    # -- single-flight registry --------------------------------------------

    def register_inflight(self, key: str, task_id: str) -> bool:
        """Mark ``task_id`` as the one execution owning ``key``; False when
        another leader already holds it (caller should coalesce instead)."""
        with self._lock:
            if key in self._inflight:
                return False
            self._inflight[key] = task_id
            return True

    def leader_for(self, key: str) -> str | None:
        with self._lock:
            return self._inflight.get(key)

    def release_inflight(self, key: str, task_id: str) -> bool:
        """Drop the registration iff ``task_id`` still owns it (a stale
        release after re-registration must not orphan the new leader).
        Returns whether the caller owned it."""
        with self._lock:
            if self._inflight.get(key) == task_id:
                del self._inflight[key]
                return True
            return False

    def fill_inflight(self, key: str, task_id: str, payload: bytes,
                      content_type: str = "application/json",
                      family_gens: dict | None = None) -> bool:
        """Atomically: iff ``task_id`` still owns ``key``'s single-flight
        registration, store the result and release the registration. The
        async path's fill point (``wiring.attach_store``) — ownership is the
        staleness proof: a checkpoint reload's ``invalidate_family`` clears
        the registration, so a task that was already executing on the OLD
        weights fails this check and its result never lands (and a
        journal-restored task with no registration leaves the cache cold,
        never stale). ``family_gens`` extends the proof to DOWNSTREAM
        pipeline stages: ``{family: generation-at-handoff}`` captured when
        the task hopped to each stage — a stage whose weights swapped since
        its handoff refuses the fill (the registration only guards stage
        1's family). The checked families become the entry's
        ``extra_families`` so later reloads drop it too. False = nothing
        stored (a stale fill also releases the registration, so the next
        identical request re-executes on the new weights)."""
        if len(payload) > self.max_entry_bytes:
            with self._lock:
                owned = self._inflight.get(key) == task_id
                if owned:
                    del self._inflight[key]
            self._evictions.inc(reason="oversize")
            return False
        with self._lock:
            if self._inflight.get(key) != task_id:
                return False
            del self._inflight[key]
            if family_gens and any(
                    self._family_gen_locked(fam) != gen
                    for fam, gen in family_gens.items()):
                return False
            self._put_locked(key, payload, content_type,
                             tuple(family_gens) if family_gens else ())
            return True

    def count_hit(self) -> None:
        """Gateway-edge outcome counters: the edge calls ``get(count=False)``
        (a lookup that coalesces must not ALSO count as a miss) and records
        exactly one of hit/miss/coalesced/bypass once the outcome is known."""
        self._requests.inc(outcome="hit")

    def count_miss(self) -> None:
        self._requests.inc(outcome="miss")

    def count_coalesced(self) -> None:
        self._requests.inc(outcome="coalesced")

    def count_bypass(self) -> None:
        self._requests.inc(outcome="bypass")

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """Counter snapshot (bench/ops surface): hits, misses, coalesced,
        bypass, entries, resident bytes, in-flight keys."""
        with self._lock:
            entries, resident = len(self._entries), self._bytes
            inflight = len(self._inflight)
        return {
            "hits": self._requests.value(outcome="hit"),
            "misses": self._requests.value(outcome="miss"),
            "coalesced": self._requests.value(outcome="coalesced"),
            "bypass": self._requests.value(outcome="bypass"),
            "entries": entries,
            "bytes": resident,
            "inflight": inflight,
        }

    # -- internals (caller holds self._lock) --------------------------------

    def _expired(self, entry: _Entry) -> bool:
        return (self.ttl_s is not None
                and self._clock() - entry.inserted_at >= self.ttl_s)

    def _drop(self, key: str, reason: str) -> None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        self._bytes -= len(entry.payload)
        self._evictions.inc(reason=reason)

    def _shrink(self) -> None:
        # TTL victims first — evicting a live LRU entry while expired ones
        # squat on the budget would shrink the effective cache for nothing.
        if self._bytes > self.max_bytes or len(self._entries) > self.max_entries:
            for key in [k for k, e in self._entries.items()
                        if self._expired(e)]:
                self._drop(key, "ttl")
        while len(self._entries) > self.max_entries:
            self._drop(next(iter(self._entries)), "lru")
        while self._bytes > self.max_bytes and self._entries:
            self._drop(next(iter(self._entries)), "bytes")

    def _sync_gauges(self) -> None:
        self._entries_gauge.set(len(self._entries))
        self._bytes_gauge.set(self._bytes)
