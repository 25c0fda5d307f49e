"""Cross-process invariant verdict (docs/deployment.md); a copy of
``ai4e_tpu/rig/verdict.py``.

The in-process chaos harness attaches an ``InvariantChecker`` to the
store's listener surface; across processes there is no shared listener —
but there IS something better: every shard's journal is the durable,
hash-chain-verified record of every transition that was ever
acknowledged. The rig verdict therefore reconciles three sources:

1. **the clients' promise set** — every TaskId a loadgen's POST was
   answered 200 with (``loadgen-*.json``), plus the terminal status the
   client itself observed;
2. **the shards' journal lineages** — for each shard, the authoritative
   transition history: the primary's journal, or — when a replica
   promoted — the promoted replica's journal (which contains the
   absorbed primary history verbatim plus its own post-promotion
   records). Terminal transitions, duplicate terminals, and the fencing
   epoch sequence are all read from here;
3. **every process's ``/metrics``** — scraped per role and merged into
   one coherent registry view (the per-role-registries half of the
   tentpole), saved beside the verdict.

The verdict object is the existing ``chaos.InvariantChecker`` — fed from
the journals instead of a listener — so "0 lost, 0 duplicated, per shard
and globally" means exactly what it means in ``tests/test_shard_chaos``.

One cross-process subtlety: a live ``move_slot`` journals the moved
records on BOTH shards (the source's original history + the
destination's import). An import applies without notifying — it is not a
client-visible transition — so a terminal record for the same (task,
status) appearing in a *different* shard's lineage is a migration copy,
not a duplicate; only a second terminal within one lineage (or a
conflicting terminal status anywhere) violates invariant 3.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import urllib.request

from ..chaos.invariants import InvariantChecker
from ..taskstore import TaskNotFound, TaskStatus
from ..taskstore.journal import scan_journal
from ..taskstore.sharding import stable_hash
from ..taskstore.task import APITask
from .topology import Topology

log = logging.getLogger("ai4e_tpu_torch.rig.verdict")


# -- journal lineages -------------------------------------------------------


def shard_lineage(topo: Topology, shard: int) -> tuple[str, bool]:
    """(journal path of the shard's authoritative lineage, promoted?).
    A replica journal containing an ``Epoch > 0`` record promoted itself
    and carries the full absorbed history + its own records; otherwise
    the primary's file is the lineage."""
    for r in range(topo.replicas):
        path = topo.replica_journal_path(shard, r)
        if not os.path.exists(path):
            continue
        scan = scan_journal(path, keep_records=True)
        if any(rec.get("Epoch", 0) > 0 for rec in scan.decoded
               if "Epoch" in rec):
            return path, True
    return topo.journal_path(shard), False


def _is_task_record(rec: dict) -> bool:
    # Full upsert records AND Slim status-transition records both carry
    # TaskId + Status and both represent one applied transition; Evict /
    # Result / Epoch records do not.
    return ("TaskId" in rec and "Status" in rec and "Epoch" not in rec
            and not rec.get("Evict") and not rec.get("Result"))


def scan_lineage(path: str) -> dict:
    """One shard lineage → ordered terminal transitions + epoch sequence
    + final task states."""
    if not os.path.exists(path):
        return {"terminals": [], "epochs": [], "final": {}, "records": 0,
                "clean": True}
    scan = scan_journal(path, keep_records=True)
    terminals: list[tuple[str, str]] = []   # (task_id, canonical) in order
    epochs: list[int] = []
    final: dict[str, APITask] = {}
    for rec in scan.decoded:
        if "Epoch" in rec:
            epochs.append(int(rec["Epoch"]))
            continue
        if not _is_task_record(rec):
            if rec.get("Evict"):
                final.pop(rec.get("TaskId", ""), None)
            continue
        task = APITask.from_dict(rec)
        final[task.task_id] = task
        if task.canonical_status in TaskStatus.TERMINAL:
            terminals.append((task.task_id, task.canonical_status))
    return {"terminals": terminals, "epochs": epochs, "final": final,
            "records": scan.records, "clean": scan.clean,
            "bad_reason": scan.bad_reason}


class _FinalStateStore:
    """Duck-typed store for ``InvariantChecker.violations``'s lost-vs-stuck
    probe: the union of every lineage's final states."""

    def __init__(self, lineages: list[dict]):
        self._tasks: dict[str, APITask] = {}
        for lin in lineages:
            self._tasks.update(lin["final"])

    def get(self, task_id: str) -> APITask:
        task = self._tasks.get(task_id)
        if task is None:
            raise TaskNotFound(task_id)
        return task

    def add_listener(self, _listener) -> None:  # checker.attach compat
        pass


# -- the verdict ------------------------------------------------------------


def compute_verdict(topo: Topology) -> dict:
    """Reconcile loadgen promises against the journal lineages; returns
    the verdict dict the rig artifact records (``ok`` gates CI)."""
    accepted: set[str] = set()
    client_terminal: dict[str, str] = {}
    loadgens = sorted(glob.glob(os.path.join(topo.workdir,
                                             "loadgen-*.json")))
    windows = []
    for path in loadgens:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        accepted.update(data.get("accepted", ()))
        client_terminal.update(data.get("terminal", {}))
        windows.append({"loadgen": data.get("loadgen"),
                        **({"tenant": data["tenant"]}
                           if data.get("tenant") else {}),
                        "window": data.get("window"),
                        "samples": data.get("samples")})

    lineages = []
    per_shard_meta = {}
    for shard in range(topo.shards):
        path, promoted = shard_lineage(topo, shard)
        lin = scan_lineage(path)
        lin["shard"] = shard
        lineages.append(lin)
        per_shard_meta[shard] = {
            "lineage": path, "promoted": promoted,
            "records": lin["records"], "clean": lin["clean"],
            "epochs": lin["epochs"],
            "epochs_strictly_monotonic": all(
                b > a for a, b in zip(lin["epochs"], lin["epochs"][1:])),
        }

    def shard_of(task_id: str) -> int:
        # Initial ring assignment — stable attribution for the per-shard
        # verdict; a moved slot's tasks stay attributed to their origin
        # (the move itself is reported in the chaos timeline).
        return (stable_hash(task_id) % topo.slots) % topo.shards

    checker = InvariantChecker(shard_of=shard_of)
    checker.attach(_FinalStateStore(lineages))
    for tid in accepted:
        checker.note_accepted(tid)

    # Feed terminal transitions per lineage, filtering migration copies:
    # the FIRST occurrence of a given (task, status) in another lineage is
    # the import of an already-terminal task — not a second client-visible
    # completion. Everything else (a repeat within a lineage, a different
    # terminal status anywhere) feeds the checker as-is.
    seen_elsewhere: dict[str, str] = {}
    for lin in lineages:
        seen_here: set[str] = set()
        for tid, status in lin["terminals"]:
            prior = seen_elsewhere.get(tid)
            if prior == status and tid not in seen_here:
                seen_here.add(tid)
                continue  # migration copy from another shard's lineage
            seen_here.add(tid)
            checker.on_task_event(APITask(task_id=tid, status=status,
                                          backend_status=status))
        for tid, status in lin["terminals"]:
            seen_elsewhere.setdefault(tid, status)

    violations = checker.violations()
    by_shard = checker.by_shard()
    epoch_ok = all(m["epochs_strictly_monotonic"]
                   for m in per_shard_meta.values())
    journal_clean = all(lin["clean"] for lin in lineages)

    # Client-observed completions the journals never acknowledged would be
    # a durability lie in the other direction — check it explicitly.
    journal_terminal = {tid for lin in lineages
                        for tid, _ in lin["terminals"]}
    phantom = sorted(tid for tid, st in client_terminal.items()
                     if "completed" in st and tid not in journal_terminal)

    ok = (not violations and epoch_ok and journal_clean and not phantom)
    return {
        "ok": ok,
        "accepted": len(accepted),
        "terminal": len(checker.terminal),
        "duplicates": len(checker.duplicate_completions),
        "violations": violations[:50],
        "violation_count": len(violations),
        "phantom_client_completions": phantom[:20],
        "per_shard": {str(s): {**per_shard_meta[s],
                               **by_shard.get(s, {"accepted": 0,
                                                  "terminal": 0,
                                                  "duplicates": 0})}
                      for s in range(topo.shards)},
        "windows": windows,
    }


# -- per-role metrics scrape + merge ----------------------------------------
#
# The parse/merge core lives in observability/federation.py now — the
# LIVE FleetCollector (the collector rig role, `ai4e_tpu_torch top`) and this
# post-hoc teardown merge are the same code; only the timing differs.


def scrape_and_merge(urls: dict[str, str],
                     timeout: float = 5.0) -> dict:
    """Scrape each role's ``/metrics`` and merge into one view: same
    (metric, labels) series SUM across processes — the single coherent
    metrics surface the one-process assembly used to get for free from
    its one registry. Returns ``{"merged": {...}, "per_role": {...},
    "unreachable": [...]}`` with merged keys rendered as
    ``name{labels}``."""
    from ..observability.federation import (merge_series, parse_prometheus,
                                            render_key)
    per_proc: dict[str, dict] = {}
    per_role: dict[str, int] = {}
    unreachable: list[str] = []
    for role, base in urls.items():
        try:
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=timeout) as resp:
                series = parse_prometheus(
                    resp.read().decode("utf-8", "replace"))
        except OSError:
            # A chaos-killed process is SUPPOSED to be unreachable — the
            # merge records the gap instead of failing the scrape.
            unreachable.append(role)
            continue
        per_proc[role] = series
        per_role[role] = len(series)
    merged = merge_series(per_proc)
    return {"merged": {render_key(k): v for k, v in sorted(merged.items())},
            "per_role_series": per_role,
            "unreachable": unreachable}


def metrics_urls(topo: Topology) -> dict[str, str]:
    """Every scrapeable node in the topology, by role name (the
    topology owns the map; the live collector uses the same one)."""
    return topo.metrics_urls()
