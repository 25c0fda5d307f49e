"""Multi-process deployment rig; a copy of ``ai4e_tpu/rig/``
(docs/deployment.md).

Every bench since r6 carried the same caveat: the horizontal-scale story —
process-separable journals, per-shard fencing epochs, feed fan-out — had
only ever been exercised inside ONE process. This package runs the
platform as genuinely separate OS processes and replays the chaos
vocabulary against them at rate:

- ``topology.py``  — the resolved process/port layout, written to one JSON
  spec file every child derives its whole configuration from;
- ``supervisor.py`` — process supervision as a robustness surface: spawn,
  health-gate, crash-loop detection, port-conflict eviction, and a hard
  teardown that cannot leak processes (the lesson ``scripts/soak.sh``
  used to encode by hand);
- ``wire.py``      — the ring-routed store client gateway replicas,
  dispatcher pools, and workers share (slot-fence-aware re-routing, the
  wire change-feed tail), plus the wire broker the dispatcher processes
  pop leases from;
- ``storenode.py`` — one shard's store process (journaled primary or
  wire-tailing replica that promotes itself) with its broker and the
  rig's feed/broker/slot HTTP surfaces;
- ``gatewaynode.py`` / ``balancer.py`` / ``dispatchernode.py`` /
  ``workernode.py`` / ``loadgen.py`` — the remaining roles;
- ``chaos.py``     — the seeded fault timeline (gateway kill,
  shard-primary SIGKILL, live slot move, dispatcher kill) at rate;
- ``soak.py``      — ``scripts/soak.sh``'s engine on rig supervision
  (the script is now a thin CLI wrapper);
- ``verdict.py``   — the cross-process InvariantChecker verdict: client
  accept/terminal reconciliation + a journal-file scan for duplicate
  terminal transitions and fencing-epoch monotonicity, per shard and
  global, plus the per-role /metrics scrape-and-merge;
- ``run.py``       — the driver (``python -m ai4e_tpu_torch.rig up``, ``make
  rig``) that assembles all of it and records the bench artifact.

The rig is pure opt-in: nothing here is imported by the single-process
assembly, and ``task_shards=1`` platforms are byte-identical with the rig
package present.
"""

from .supervisor import Supervisor  # noqa: F401
from .topology import Topology  # noqa: F401
