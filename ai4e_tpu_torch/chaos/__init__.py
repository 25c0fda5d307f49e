"""Deterministic fault injection for tests and the chip smoke; a copy of
``ai4e_tpu/chaos/`` that acts on the port's platform, stores and journal.
Never wired by ``PlatformConfig``: a production assembly carries no chaos
code path.

- ``injector``   — the seeded ``FaultInjector`` and its wrappers for the
  HTTP hop (error status, refused connection, latency, lost response) and
  the queue publish surface (duplicate delivery);
- ``harness``    — ``RestartableBackend`` (a worker that dies and comes
  back on the same port), dispatcher kill and restart, shard primary
  kill, slot moves;
- ``invariants`` — ``InvariantChecker`` on the store's change feed: every
  accepted task terminates, none is lost, none completes twice; per
  shard, and replica chain convergence;
- ``disk``       — seeded faults on the journal's write path (torn or
  short write, ENOSPC, EIO on fsync, a lost page cache);
- ``crashpoint`` — the crash-point sweep over a journaled store.
"""

from .crashpoint import check_reboot, crash_offsets, drive_workload, sweep
from .disk import (DiskFaultInjector, DiskFaultRule, FaultyFile,
                   attach_journal_faults, lose_page_cache)
from .harness import (RestartableBackend, kill_dispatcher, kill_shard_primary,
                      kill_worker, rebalance_slot, restart_dispatcher,
                      restart_worker)
from .injector import (ChaosSession, ChaosSessionHolder, Decision,
                       FaultInjector, FaultRule, wrap_platform_http,
                       wrap_publish_duplicates)
from .invariants import InvariantChecker

__all__ = [
    "FaultInjector", "FaultRule", "Decision", "ChaosSession",
    "ChaosSessionHolder", "wrap_platform_http", "wrap_publish_duplicates",
    "RestartableBackend", "kill_dispatcher", "restart_dispatcher",
    "kill_worker", "restart_worker", "kill_shard_primary", "rebalance_slot",
    "InvariantChecker",
    "DiskFaultInjector", "DiskFaultRule", "FaultyFile",
    "attach_journal_faults", "lose_page_cache",
    "sweep", "drive_workload", "crash_offsets", "check_reboot",
]
