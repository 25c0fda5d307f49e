"""Poisoned-row contract + mesh-endpoint health — the device-free half of
the mesh serving plane's failure semantics; a copy of
``ai4e_tpu/runtime/mesh/redelivery.py``.

A mesh batch can partially degrade: a follower process dies or fails its
shard fetch mid-batch and its rows execute on a zeros shard — any
"result" for those rows would be a confidently wrong answer. The
contract:

- the batcher fails exactly the poisoned rows' futures with
  ``RowPoisoned`` (the other rows complete normally);
- the worker's async path catches it and **redelivers the task** through
  ``redeliver_poisoned`` — a terminality probe followed by the same
  same-endpoint republish the BatcherSaturated path uses — instead of
  failing the task. A task whose record is already terminal (a duplicate
  delivery completed it concurrently) is NOT republished: never a
  duplicate client-visible completion.

This module is stdlib-only, so surfaces without a device runtime can
import it.
"""

from __future__ import annotations

import logging

log = logging.getLogger("ai4e_tpu_torch.mesh")


class RowPoisoned(RuntimeError):
    """One row of a batch was invalidated by a degraded mesh host. The
    row's task must be redelivered, not completed and not terminally
    failed — subclassing RuntimeError keeps existing whole-batch failure
    handling working for callers that don't know about partial degrade."""

    def __init__(self, message: str = "result invalidated: a worker host "
                 "degraded while executing this row's shard"):
        super().__init__(message)


class EndpointHealth:
    """The mesh endpoint's admission health flag. Flipped unhealthy by the
    coordinator (follower death / repeated poisoned batches); read by the
    worker's admission check, which answers 500 so the dispatcher's
    breaker records a FAILURE and ejects the endpoint (a 503 would be
    saturation-neutral — see ``resilience/health.py.observe_status``:
    saturation means "peers are melting too", a dead follower means "this
    endpoint specifically cannot answer correctly")."""

    def __init__(self) -> None:
        self.healthy = True
        self.reason = ""

    def mark_unhealthy(self, reason: str) -> None:
        if self.healthy:
            log.error("mesh endpoint unhealthy: %s", reason)
        self.healthy = False
        self.reason = reason

    def mark_healthy(self) -> None:
        if not self.healthy:
            log.info("mesh endpoint recovered (was: %s)", self.reason)
        self.healthy = True
        self.reason = ""


async def redeliver_poisoned(task_manager, task_id: str,
                             fallback_endpoint: str) -> bool:
    """Hand a poisoned row's task back to the broker for redelivery.

    Probes the task record ONCE: a terminal record means a concurrent
    path (duplicate delivery, another replica) already finished the task
    — republishing would re-execute completed work and risk a duplicate
    client-visible completion, so the poison outcome is dropped in its
    favor. Otherwise the task is republished to its recorded endpoint
    (same-endpoint republish with empty body → original-body replay →
    redelivery, the BatcherSaturated idiom). Returns True when the task
    was republished.

    The probe and the republish are two store calls with a suspension
    between them — the republish itself is safe to race a concurrent
    completion because redelivery consumers suppress duplicates against
    the terminal record (``update_task_status_if``), which the
    interleaving regression in tests/test_race_regressions.py pins.
    """
    from ...taskstore.task import TaskStatus
    record = await task_manager.get_task_status(task_id)
    status = TaskStatus.canonical((record or {}).get("Status", ""))
    if status in TaskStatus.TERMINAL:
        log.info("poisoned row for task %s dropped: task already %s "
                 "(duplicate-suppressed)", task_id, status)
        return False
    endpoint = (record or {}).get("Endpoint") or fallback_endpoint
    await task_manager.add_pipeline_task(task_id, endpoint)
    log.warning("task %s redelivered to %s after a poisoned mesh row",
                task_id, endpoint)
    return True
