"""Graceful drain — the worker-side rollout state machine. A copy of
``ai4e_tpu/rollout/drain.py``.

A draining worker must (docs/deployment.md#drain):

1. stop admitting: new submits raise ``DrainingError`` and the HTTP
   surface answers 503 + ``Retry-After`` + ``X-Draining`` (saturation-
   neutral for breakers — draining is an eject-from-placement signal,
   never a failure);
2. retire every UNCUT pending example immediately (the broker redelivers
   each task to a peer), while batches
   already cut to the device finish normally;
3. wait — bounded by ``AI4E_ROLLOUT_DRAIN_TIMEOUT_MS`` — for in-flight
   device work AND any in-flight hot reload to complete; stragglers past
   the budget are force-retired and redeliver per task too.

Stdlib-only, as the JAX package's copy is.
"""

from __future__ import annotations

import asyncio
import time

# Refusal marker for a draining worker's 503s: dispatchers that observe
# it eject the backend from placement for a TTL (resilience/health.py
# ``mark_draining``) instead of hammering a worker that told them it is
# leaving. Deliberately distinct from X-Not-Primary (a rotate marker)
# and X-Shed-Reason (an overload marker): draining is neither.
DRAINING_HEADER = "X-Draining"

ACTIVE = "active"
DRAINING = "draining"
DRAINED = "drained"

_STATE_CODES = {ACTIVE: 0, DRAINING: 1, DRAINED: 2}


class DrainingError(Exception):
    """A submit was refused — or a pending entry retired — because the
    worker is draining. The async path redelivers the task through the
    broker (per task, like a poisoned row); the sync path answers 503 +
    Retry-After so the caller's proxy retries a peer."""


class DrainState:
    """The drain lifecycle shared by every surface of one worker process:
    the batcher(s), the decode engines, the reload endpoint, and the
    admission checks all consult ONE of these.

    Two suspension-point-atomicity contracts (docs/concurrency.md) live
    here, both with ``explore_interleavings`` regressions:

    - ``begin()`` is synchronous: the flip and the moment new submits
      start refusing are one event-loop step — there is no window where
      a submit admitted "before" the flip lands in a pending queue the
      drain already swept;
    - ``try_begin_reload()`` checks the drain state AND registers the
      reload with no await between: a reload racing a drain either
      lands fully before the drain (which then waits for it) or is
      refused with 409 — a weight swap can never complete on a worker
      that already reported itself drained.
    """

    def __init__(self, clock=time.monotonic):
        self._state = ACTIVE
        self._reloads = 0
        self._clock = clock
        self.began_at = 0.0

    # -- state --------------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    @property
    def state_code(self) -> int:
        return _STATE_CODES[self._state]

    @property
    def is_draining(self) -> bool:
        """True from the drain flip on (draining OR drained) — every
        admission/refusal surface keys on this."""
        return self._state != ACTIVE

    def begin(self) -> bool:
        """Flip into draining; False when already past active (the verb
        is idempotent — a second POST reports state, it does not restart
        the drain)."""
        if self._state != ACTIVE:
            return False
        self._state = DRAINING
        self.began_at = self._clock()
        return True

    def mark_drained(self) -> None:
        if self._state == DRAINING:
            self._state = DRAINED

    def resume(self) -> None:
        """Back to serving — the rollback path re-arms a worker whose
        drain was aborted (re-weighted to the old generation) without a
        process restart."""
        self._state = ACTIVE
        self.began_at = 0.0

    # -- reload interlock ----------------------------------------------------

    @property
    def reloads_in_flight(self) -> int:
        return self._reloads

    def try_begin_reload(self) -> bool:
        """Admit a hot reload unless draining. Check + register are one
        synchronous step (no await): the drain's completion wait reads
        ``reloads_in_flight`` and must never see 0 while a reload that
        passed the check is still swapping weights."""
        if self._state != ACTIVE:
            return False
        self._reloads += 1
        return True

    def end_reload(self) -> None:
        self._reloads = max(0, self._reloads - 1)


def retire_pending(pending_by_model: dict, exc_factory=DrainingError) -> int:
    """Fail every uncut pending future with ``exc_factory()`` and clear
    the queues IN PLACE — the flusher and this retire see the same list
    objects, so the take-and-clear must be one synchronous step (no
    await between reading a queue and emptying it): an interleaved batch
    cut would otherwise deliver a device result into a future this
    sweep already failed. Futures the cut already resolved are skipped
    (``done()``), never double-resolved. Returns the retire count."""
    retired = 0
    for entries in list(pending_by_model.values()):
        taken, entries[:] = list(entries), []
        for entry in taken:
            fut = getattr(entry, "future", entry)
            if not fut.done():
                fut.set_exception(exc_factory())
                retired += 1
    return retired


async def drain_worker(state: DrainState, batchers=(), engines=(),
                       timeout_s: float = 30.0, poll_s: float = 0.05,
                       clock=time.monotonic) -> dict:
    """The drain verb's body: flip the state, retire uncut work, wait —
    bounded — for in-flight device batches, active decode sequences and
    any in-flight reload, then force-retire stragglers (each redelivers
    through the broker per task, handled by the callers awaiting their
    futures). Idempotent: a second call while draining just waits on the
    same condition.

    ``batchers``/``engines`` duck-type ``begin_drain() -> int``,
    ``drain_complete: bool`` and (engines only) ``force_drain() -> int``.
    """
    state.begin()
    retired = 0
    for b in batchers:
        retired += b.begin_drain()
    for e in engines:
        retired += e.begin_drain()
    deadline = clock() + max(0.0, timeout_s)
    while clock() < deadline:
        if (state.reloads_in_flight == 0
                and all(b.drain_complete for b in batchers)
                and all(e.drain_complete for e in engines)):
            break
        await asyncio.sleep(poll_s)
    forced = 0
    for e in engines:
        forced += e.force_drain()
    complete = (state.reloads_in_flight == 0
                and all(b.drain_complete for b in batchers)
                and all(e.drain_complete for e in engines))
    state.mark_drained()
    return {"state": state.state, "retired": retired, "forced": forced,
            "clean": complete,
            "drain_s": round(clock() - state.began_at, 3)}
