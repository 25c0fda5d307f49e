"""Task store to result cache coupling — ``attach_store`` of
``ai4e_tpu/rescache/wiring.py``.

The async path's cache fill is event-driven: the gateway stamps a
``CacheKey`` on the task it creates and registers the task as its key's
leader; the worker stores the result and completes the task as ever; and
this listener, on the store's change feed (the one the gateway's
long-polls ride), copies the result into the cache and releases the
registration the moment the task turns terminal. One fill point covers
every producer (the worker, the dispatcher serving from the cache). A
failed leader releases its key, so the next identical request executes.
A journal replay fires no listeners, and a standby's replicated
completions find no registration of their own (its gateway creates no
tasks): a restarted or promoted control plane starts with a cold cache,
never a stale one, and a request cached before the restart executes
again.

The pipeline hop bookkeeping (``hop_gens``) is JAX's fill rule for a
composite task keyed under stage 1 whose later stages may reload
mid-flight; it stays inert until the port runs pipeline DAGs (ROADMAP
A18.12).
"""

from __future__ import annotations

import logging

from ..taskstore import TaskStatus
from ..taskstore.task import endpoint_path
from .keys import family_of

log = logging.getLogger("ai4e_tpu_torch.rescache")


def attach_store(store, cache) -> None:
    """Subscribe ``cache`` to ``store``'s change feed. The store must offer
    ``add_listener`` and ``get_result``."""

    # Pipeline provenance: a composite task's cache key carries stage 1's
    # family, but the RESULT is computed by every downstream stage the task
    # hops to (``AddPipelineTask`` rewrites the endpoint). Record each
    # downstream family — with the cache generation AT the handoff — so the
    # fill can prove no stage's weights swapped mid-flight, and the entry
    # remembers which families can invalidate it later. Keyed by task id;
    # entries are dropped on the same terminal transition that fills/releases,
    # so this holds only in-flight pipeline hops (journal replay fires no
    # listeners — a restart simply starts empty alongside the cold cache).
    hop_gens: dict[str, dict[str, int]] = {}

    def on_task_change(task) -> None:
        key = getattr(task, "cache_key", "")
        if not key:
            return
        status = task.canonical_status
        if status not in TaskStatus.TERMINAL:
            fam = endpoint_path(task.endpoint)
            if fam and fam != family_of(key):
                gens = hop_gens.setdefault(task.task_id, {})
                if fam not in gens:
                    gens[fam] = cache.family_generation(fam)
            return
        gens = hop_gens.pop(task.task_id, None)
        if status == TaskStatus.COMPLETED:
            try:
                found = store.get_result(task.task_id)
            except Exception:  # noqa: BLE001 — cache fill must not break the store
                log.exception("could not read result of %s for cache fill",
                              task.task_id)
                found = None
            if found is not None and cache.fill_inflight(
                    key, task.task_id, found[0], found[1],
                    family_gens=gens):
                # Fill + release happened atomically. The ownership check is
                # the staleness proof: a checkpoint reload invalidates the
                # family AND clears its registrations, so a task that was
                # already executing on the old weights fails it and its
                # result never lands — and ``family_gens`` extends the same
                # proof to downstream pipeline stages reloaded mid-flight.
                # The same check leaves the cache cold (never stale) for
                # journal-restored/requeued tasks that completed without a
                # registration.
                return
        # Terminal without a fill: the key is no longer in flight. A failed
        # leader releases so the NEXT identical request re-executes instead
        # of coalescing onto a corpse forever.
        cache.release_inflight(key, task.task_id)

    store.add_listener(on_task_change)
