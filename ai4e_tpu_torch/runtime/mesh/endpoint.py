"""MeshServable endpoint — the runtime facade a mesh worker serves through;
a copy of ``ai4e_tpu/runtime/mesh/endpoint.py``.

``MeshEndpoint`` slots into the existing ``MicroBatcher``/``ModelRuntime``
contract: the batcher and worker hold it where they held the runtime, and
every capability they probe for — fused ``run_batch_report``, phased
``run_batch_phases``, the split-phase h2d/execute/d2h surface of the
double-buffered batcher — delegates through, so the device path is
byte-identical to the unwrapped runtime when nothing degrades. What the
facade adds:

- **registration validation**: ``register_meshed`` checks the declared
  ``MeshLayout`` against the runtime's actual mesh and resolves the
  servable's regex partition rules against the real param tree before
  any placement happens — an unmapped tp param fails registration with
  every missing path named, never the request path;
- **poison accounting**: batch poison reports (real, from the multihost
  data plane; or injected via ``AI4E_FAULT_MESH_POISON_NTHS`` on the
  one-rank substrate) flow to the ``MeshCoordinator`` so repeated
  degradation flips the endpoint unhealthy;
- **per-process phase stamps**: the multihost runtime's per-process
  device phases drain through here for the batcher to stamp into each
  request's hop ledger (``h2d``/``execute`` with ``reason="proc=N"``).

Fault injection mirrors ``AI4E_FAULT_FETCH_FAIL_NTHS``: 1-based batch
ordinals (comma-separated) whose batch gets one poisoned row — empty in
production; the tests drive the redelivery contract with it.
"""

from __future__ import annotations

import logging
import os

from .coordinator import MeshCoordinator
from .redelivery import EndpointHealth
from .spec import MeshLayout, MeshSpecError

log = logging.getLogger("ai4e_tpu_torch.mesh")


def _fault_poison_nths() -> frozenset[int]:
    raw = os.environ.get("AI4E_FAULT_MESH_POISON_NTHS", "")
    return frozenset(int(s) for s in raw.split(",") if s.strip())


class MeshEndpoint:
    """Runtime facade binding a validated layout + health to a runtime
    (``ModelRuntime`` or ``MultihostRuntime``)."""

    def __init__(self, runtime, layout: MeshLayout,
                 health: EndpointHealth | None = None,
                 coordinator: MeshCoordinator | None = None):
        self._runtime = runtime
        self.layout = layout
        self.health = (health if health is not None
                       else getattr(coordinator, "health", None)
                       or EndpointHealth())
        self.coordinator = coordinator or MeshCoordinator(
            layout, health=self.health)
        self._validate_mesh()
        self._batch_count = 0  # fault-injection ordinal
        self._poison_nths = _fault_poison_nths()
        if self._poison_nths:
            log.warning("mesh fault injection armed: poisoning batches %s",
                        sorted(self._poison_nths))

    def _validate_mesh(self) -> None:
        """The declared serving layout must BE the runtime's mesh — a
        worker advertising dp=8 while executing on dp=4 would mis-pad
        buckets and mis-report its cost tier."""
        from ...parallel.sharding import mesh_shape
        shape = mesh_shape(self._runtime.mesh)
        actual = {"dp": shape.get("dp", 1) * shape.get("fsdp", 1),
                  "tp": shape.get("tp", 1), "sp": shape.get("sp", 1)}
        declared = {"dp": self.layout.dp, "tp": self.layout.tp,
                    "sp": self.layout.sp}
        if actual != declared:
            raise MeshSpecError(
                f"mesh layout {declared} does not match the runtime mesh "
                f"{actual} (mesh shape {shape})")

    def __getattr__(self, name: str):
        return getattr(self._runtime, name)

    # -- registration --------------------------------------------------------

    def register_meshed(self, servable, partition_rules=None):
        """Validate + register a servable on this mesh endpoint.

        ``partition_rules`` (or the servable's own
        ``param_sharding_rules``) in the regex form are resolved against
        the servable's flax-shaped param tree FIRST
        (``placement.match_partition_rules``) so completeness errors carry
        every unmapped param path; the substring-dict form passes through
        unchanged. Delegates to the runtime's ``register`` for placement
        and bucket alignment to the data-axis multiple."""
        rules = (partition_rules if partition_rules is not None
                 else servable.param_sharding_rules)
        if isinstance(rules, (list, tuple)):
            from .placement import match_partition_rules
            match_partition_rules(rules, servable.flax_from_state_dict(
                servable.module.state_dict()))
        if rules is not None:
            servable.param_sharding_rules = rules
        return self._runtime.register(servable)

    # -- introspection -------------------------------------------------------

    def describe(self) -> dict:
        out = dict(self.layout.describe())
        out.update({"healthy": self.health.healthy,
                    "process_count": self.coordinator.process_count})
        if not self.health.healthy:
            out["unhealthy_reason"] = self.health.reason
        return out

    # -- execution (poison injection + coordinator accounting) ---------------

    def _inject(self, rows: int, poisoned: frozenset) -> frozenset:
        """Apply fault injection and report the batch's poison outcome to
        the coordinator. Injected poison is attributed to a virtual
        follower (process 1) so the one-rank substrate exercises
        the same health state machine a real degraded follower drives;
        real multihost poison is reported by the ``poison_listener`` hook
        instead (``coordinator.attach``), not double-counted here."""
        self._batch_count += 1
        if self._batch_count in self._poison_nths:
            poisoned = frozenset(poisoned | {(self._batch_count - 1) % rows})
            log.warning("fault injection: poisoned row %d of batch %d",
                        (self._batch_count - 1) % rows, self._batch_count)
        if self._poison_nths:
            flags = [0, 1] if poisoned else [0, 0]
            self.coordinator.observe_poison(flags)
        return poisoned

    def run_batch_report(self, name: str, batch):
        runner = getattr(self._runtime, "run_batch_report", None)
        if runner is not None:
            out, poisoned = runner(name, batch)
        else:
            out, poisoned = self._runtime.run_batch(name, batch), frozenset()
        return out, self._inject(batch.shape[0], poisoned)

    def run_batch_phases(self, name: str, batch):
        phased = getattr(self._runtime, "run_batch_phases", None)
        if phased is not None:
            out, poisoned, phases = phased(name, batch)
        else:
            # MultihostRuntime has no phased surface (followers mirror
            # single fused calls): the batch runs undecomposed.
            out, poisoned = self._runtime.run_batch_report(name, batch)
            phases = {}
        return out, self._inject(batch.shape[0], poisoned), phases

    def supports_split_phases(self) -> bool:
        probe = getattr(self._runtime, "supports_split_phases", None)
        return bool(probe()) if probe is not None else False

    def drain_process_phases(self):
        drain = getattr(self._runtime, "drain_process_phases", None)
        return drain() if drain is not None else []
