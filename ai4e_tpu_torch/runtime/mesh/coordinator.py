"""Multi-process mesh boot + health — a copy of
``ai4e_tpu/runtime/mesh/coordinator.py``.

Role split on a ``process_count > 1`` mesh (unchanged from the multihost
data plane): process 0 — the **primary** — serves HTTP and drives batch
execution; every other process — a **follower** — mirrors executions in
``MultihostRuntime.follower_loop``. What the coordinator adds is the
*health* half of that contract:

- every ``_gather_poison`` outcome flows through ``observe_poison``
  (the ``poison_listener`` hook on ``MultihostRuntime``): a process that
  poisons ``unhealthy_after`` consecutive batches is treated as dead —
  its rows keep poisoning every batch it should have computed, so
  continuing to admit traffic just burns redeliveries;
- a dead follower flips ``EndpointHealth`` unhealthy; the worker's
  admission check then answers 500, dispatcher breakers record failures,
  and the endpoint is ejected from routing (``resilience/health.py``) —
  in-flight poisoned rows are redelivered per-task by the worker
  (``redelivery.redeliver_poisoned``), so nothing is silently lost;
- one clean batch (no poison flags) marks the endpoint healthy again:
  a follower restart re-enters the SPMD loop and the first good gather
  is the recovery proof the half-open breaker probe will observe.

The coordinator is device-free (process identity is injected), so any
driver runs the same state machine the production worker runs.
"""

from __future__ import annotations

import logging

from .redelivery import EndpointHealth
from .spec import MeshLayout

log = logging.getLogger("ai4e_tpu_torch.mesh")


class MeshCoordinator:
    """Follower-health bookkeeping for one mesh endpoint."""

    def __init__(self, layout: MeshLayout,
                 health: EndpointHealth | None = None,
                 process_count: int = 1, process_index: int = 0,
                 unhealthy_after: int = 3):
        if unhealthy_after < 1:
            raise ValueError("unhealthy_after must be >= 1")
        self.layout = layout
        self.health = health or EndpointHealth()
        self.process_count = process_count
        self.process_index = process_index
        self.unhealthy_after = unhealthy_after
        self._consecutive: dict[int, int] = {}

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0

    def attach(self, multihost_runtime) -> None:
        """Subscribe to the multihost data plane's poison gathers."""
        multihost_runtime.poison_listener = self.observe_poison

    def observe_poison(self, flags) -> None:
        """One ``_gather_poison`` outcome: ``flags[proc]`` nonzero means
        that process poisoned its shard of this batch."""
        any_poison = False
        for proc, flag in enumerate(flags):
            if flag:
                any_poison = True
                n = self._consecutive.get(proc, 0) + 1
                self._consecutive[proc] = n
                if n >= self.unhealthy_after:
                    self.health.mark_unhealthy(
                        f"mesh process {proc} poisoned {n} consecutive "
                        f"batches (presumed dead)")
            else:
                self._consecutive[proc] = 0
        if not any_poison and not self.health.healthy:
            self.health.mark_healthy()

    def note_follower_death(self, proc: int, reason: str = "") -> None:
        """Out-of-band death signal (supervisor observed the process
        exit) — flips health immediately, no threshold."""
        self._consecutive[proc] = self.unhealthy_after
        self.health.mark_unhealthy(
            f"mesh process {proc} died{': ' + reason if reason else ''}")

    def describe(self) -> dict:
        return {"process_count": self.process_count,
                "process_index": self.process_index,
                "primary": self.is_primary,
                "healthy": self.health.healthy,
                "reason": self.health.reason,
                "unhealthy_after": self.unhealthy_after}
