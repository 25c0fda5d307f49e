"""The crash-point sweep; a copy of ``ai4e_tpu/chaos/crashpoint.py``.

A seeded workload runs on a ``JournaledTaskStore``; the journal is then
cut at every record boundary and at seeded mid-record offsets, and each
cut must reboot: every acknowledged mutation whose bytes fit the prefix is
there, no task is in two status sets or shows a state from beyond the cut,
and a fresh ``FollowerTaskStore`` absorbing the rebooted journal ends with
the same chain head and snapshot. The same seed gives the same offsets
and verdicts as the JAX package's sweep.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field

from ..taskstore import TaskStatus
from ..taskstore.journal import JournalCorruptError
from ..taskstore.store import FollowerTaskStore, JournaledTaskStore
from ..taskstore.task import APITask
from .invariants import dump_directory


@dataclass
class AckEvent:
    """One acknowledged mutation: the journal byte size the moment the
    store returned success (= the prefix that must preserve it)."""
    marker: int
    kind: str                 # create | transition | result | evict
    status: str | None = None
    result: bytes | None = None


@dataclass
class WorkloadTrace:
    """Everything the reboot check needs about the driven run."""
    journal_path: str
    fsync: str
    seed: int
    journal_bytes: bytes = b""
    # task_id -> ordered AckEvents (markers strictly increase).
    events: dict[str, list[AckEvent]] = field(default_factory=dict)

    def expectation_at(self, task_id: str, crash_at: int
                       ) -> AckEvent | None:
        """The last acknowledged event whose bytes fit the surviving
        prefix — what the rebooted store must show."""
        last = None
        for ev in self.events[task_id]:
            if ev.marker <= crash_at:
                last = ev
        return last


def drive_workload(journal_path: str, seed: int, fsync: str = "always",
                   ops: int = 40) -> WorkloadTrace:
    """Run a seeded mutation mix (creates, completions, failures, result
    writes, evictions) against a fresh journaled store, recording each
    ack beside the journal size at that instant. Every append is flushed
    before the caller unblocks, so the file size IS the ack marker."""
    from ..metrics import MetricsRegistry
    rng = random.Random(seed)
    trace = WorkloadTrace(journal_path=journal_path, fsync=fsync, seed=seed)
    store = JournaledTaskStore(journal_path, fsync=fsync,
                               metrics=MetricsRegistry())
    live: list[str] = []

    def marker() -> int:
        return store._stat_bytes

    for i in range(ops):
        choice = rng.random()
        if choice < 0.45 or not live:
            body = rng.randbytes(rng.randrange(4, 64))
            task = store.upsert(APITask(endpoint="/v1/sweep/x", body=body,
                                        status="created", publish=False))
            trace.events[task.task_id] = [
                AckEvent(marker(), "create", "created")]
            live.append(task.task_id)
        elif choice < 0.75:
            tid = rng.choice(live)
            terminal = rng.random() < 0.7
            status = (TaskStatus.COMPLETED if terminal and rng.random() < 0.8
                      else TaskStatus.FAILED if terminal
                      else TaskStatus.RUNNING)
            store.update_status(tid, f"{status} - sweep op {i}", status)
            trace.events[tid].append(AckEvent(
                marker(), "transition", status))
            if terminal:
                live.remove(tid)
        elif choice < 0.9:
            tid = rng.choice(live)
            payload = rng.randbytes(rng.randrange(8, 48))
            store.set_result(tid, payload)
            trace.events[tid].append(AckEvent(
                marker(), "result", None, payload))
        else:
            # Evict everything terminal right now (retention with age 0):
            # the journal gains Evict records; a prefix that holds one
            # must show the task GONE, a prefix that cuts it must not.
            evicted = [t for t, evs in trace.events.items()
                       if evs[-1].status in TaskStatus.TERMINAL
                       and evs[-1].kind != "evict"]
            store.evict_terminal_older_than(0.0)
            for tid in evicted:
                trace.events[tid].append(AckEvent(marker(), "evict"))
    store.close()
    with open(journal_path, "rb") as fh:
        trace.journal_bytes = fh.read()
    _rebase_evict_markers(trace)
    return trace


def _rebase_evict_markers(trace: WorkloadTrace) -> None:
    """A batch eviction appends one Evict record PER victim inside one
    store-lock hold; ``drive_workload`` only sees the journal size after the
    whole batch. Rebase each task's evict marker onto its own record's
    end offset — a crash landing between two of the batch's appends must
    expect exactly the evictions whose records fit the prefix."""
    from ..taskstore.journal import verify_line
    data = trace.journal_bytes
    offset = 0
    while offset < len(data):
        nl = data.find(b"\n", offset)
        if nl == -1:
            break
        line = data[offset:nl].decode("utf-8").strip()
        end = nl + 1
        if line:
            rec, _chain, _legacy = verify_line(line, None)
            if rec.get("Evict"):
                for ev in trace.events.get(rec.get("TaskId", ""), ()):
                    if ev.kind == "evict":
                        ev.marker = end
        offset = end


def crash_offsets(trace: WorkloadTrace, rng: random.Random,
                  mid_points: int = 12) -> list[int]:
    """Every record boundary (kill between appends) plus ``mid_points``
    seeded strictly-mid-record offsets (kill mid-write / short write) —
    including offset 0 (crash before the first byte) and EOF (clean)."""
    data = trace.journal_bytes
    boundaries = [0]
    at = 0
    while True:
        nl = data.find(b"\n", at)
        if nl == -1:
            break
        boundaries.append(nl + 1)
        at = nl + 1
    mids = set()
    lines = [(boundaries[i], boundaries[i + 1])
             for i in range(len(boundaries) - 1)
             if boundaries[i + 1] - boundaries[i] > 2]
    for _ in range(mid_points):
        if not lines:
            break
        start, end = rng.choice(lines)
        mids.add(rng.randrange(start + 1, end - 1))
    return sorted(set(boundaries) | mids)


def check_reboot(trace: WorkloadTrace, crash_at: int, scratch_path: str
                 ) -> list[str]:
    """Crash the journaled store at byte ``crash_at`` (prefix truncation —
    the superset model covering kill-mid-write AND lost page cache) and
    verify the reboot contract. Returns human-readable violations."""
    from ..metrics import MetricsRegistry
    violations: list[str] = []
    with open(scratch_path, "wb") as fh:
        fh.write(trace.journal_bytes[:crash_at])
    try:
        store = JournaledTaskStore(scratch_path, metrics=MetricsRegistry())
    except JournalCorruptError as exc:
        return [f"crash@{crash_at}: reboot REFUSED a prefix-truncated "
                f"journal (must salvage, not quarantine): {exc}"]
    except Exception as exc:  # noqa: BLE001; ai4e: noqa[AIL005] — the exception IS the finding: it returns as a sweep violation
        return [f"crash@{crash_at}: reboot crash-looped: {exc!r}"]
    try:
        for tid in trace.events:
            expect = trace.expectation_at(tid, crash_at)
            try:
                record = store.get(tid)
            except Exception:  # noqa: BLE001; ai4e: noqa[AIL005] — absence is the probed signal; a miss feeds the ACKED-TASK-LOST check below
                record = None
            if expect is None or expect.kind == "evict":
                # Nothing acknowledged inside the prefix (or an
                # acknowledged eviction): the id must be absent — a
                # present record would be state from BEYOND the crash
                # point or a resurrected eviction.
                if record is not None and expect is not None:
                    violations.append(
                        f"crash@{crash_at}: task {tid} evicted at "
                        f"{expect.marker} but resurrected after reboot")
                continue
            if record is None:
                violations.append(
                    f"crash@{crash_at}: ACKED TASK LOST — {tid} "
                    f"acknowledged at journal byte {expect.marker} "
                    f"<= crash point, absent after reboot")
                continue
            want = _last_status_at(trace, tid, crash_at)
            if want is not None and record.canonical_status != want:
                violations.append(
                    f"crash@{crash_at}: task {tid} status "
                    f"{record.canonical_status!r} != last acknowledged "
                    f"{want!r}")
            want_result = _last_result_at(trace, tid, crash_at)
            if want_result is not None:
                found = store.get_result(tid)
                if found is None or found[0] != want_result:
                    violations.append(
                        f"crash@{crash_at}: task {tid} acknowledged "
                        "result missing or altered after reboot")
        violations.extend(_set_consistency(store, crash_at))
        violations.extend(_replica_convergence(store, scratch_path,
                                               crash_at))
    finally:
        store.close()
    return violations


def _last_status_at(trace: WorkloadTrace, tid: str,
                    crash_at: int) -> str | None:
    last = None
    for ev in trace.events[tid]:
        if ev.marker <= crash_at and ev.status is not None:
            last = ev.status
    return last


def _last_result_at(trace: WorkloadTrace, tid: str,
                    crash_at: int) -> bytes | None:
    last = None
    for ev in trace.events[tid]:
        if ev.marker <= crash_at and ev.kind == "result":
            last = ev.result
    return last


def _set_consistency(store: JournaledTaskStore, crash_at: int) -> list[str]:
    """Each task in exactly ONE status set, and that set matching its
    record — the structural "no duplicate/conflicting completion" check
    (a task in two sets is the replay-side shape of a double terminal)."""
    out = []
    memberships: dict[str, list[str]] = {}
    for (path, status), members in store._sets.items():
        for tid in members:
            memberships.setdefault(tid, []).append(status)
    for tid, record in store._tasks.items():
        sets = memberships.get(tid, [])
        if len(sets) != 1 or sets[0] != record.canonical_status:
            out.append(f"crash@{crash_at}: task {tid} status-set "
                       f"memberships {sets} vs record "
                       f"{record.canonical_status!r}")
    for tid in memberships:
        if tid not in store._tasks:
            out.append(f"crash@{crash_at}: orphan status-set entry {tid}")
    return out


def _replica_convergence(store: JournaledTaskStore, journal_path: str,
                         crash_at: int) -> list[str]:
    """A fresh follower absorbing the rebooted journal must end chain-
    head-identical with an identical task snapshot — the per-shard
    convergence claim, provable store-by-store."""
    from ..metrics import MetricsRegistry
    out = []
    replica_path = journal_path + ".replica-check"
    replica = FollowerTaskStore(replica_path, metrics=MetricsRegistry())
    try:
        replica.reset()
        with open(journal_path, encoding="utf-8") as fh:
            lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
        try:
            replica.absorb_lines(lines)
        except JournalCorruptError as exc:
            return [f"crash@{crash_at}: replica refused the REBOOTED "
                    f"(salvaged) journal: {exc}"]
        if replica.replica_chain_head != store.chain_head:
            out.append(
                f"crash@{crash_at}: replica chain head "
                f"{replica.replica_chain_head} != primary "
                f"{store.chain_head}")
        mine = {t.task_id: t.canonical_status for t in store.snapshot()}
        theirs = {t.task_id: t.canonical_status
                  for t in replica.snapshot()}
        if mine != theirs:
            out.append(f"crash@{crash_at}: replica snapshot diverges "
                       f"({len(mine)} vs {len(theirs)} tasks or "
                       "differing statuses)")
    finally:
        replica.close()
        for suffix in ("", ".salvage.json"):
            try:
                os.unlink(replica_path + suffix)
            except OSError:
                pass
    return out


def sweep(workdir: str, seed: int, fsync: str = "always", ops: int = 40,
          mid_points: int = 12) -> tuple[int, list[str]]:
    """Full sweep for one seed: drive the workload, then crash/reboot at
    every boundary + seeded mid-record offsets. Returns
    ``(crash_points_checked, violations)`` — green is ``(N, [])``."""
    rng = random.Random(seed ^ 0x5EED)
    journal = os.path.join(workdir, f"sweep-{seed}.journal")
    trace = drive_workload(journal, seed, fsync=fsync, ops=ops)
    offsets = crash_offsets(trace, rng, mid_points=mid_points)
    violations: list[str] = []
    scratch = os.path.join(workdir, f"sweep-{seed}.crash")
    for crash_at in offsets:
        point = check_reboot(trace, crash_at, scratch)
        if point:
            _dump_sweep_artifacts(trace, crash_at, scratch, point)
        violations.extend(point)
        for suffix in ("", ".salvage.json"):
            try:
                os.unlink(scratch + suffix)
            except OSError:
                pass
    return len(offsets), violations


def _dump_sweep_artifacts(trace: WorkloadTrace, crash_at: int,
                          scratch: str, violations: list[str]) -> None:
    """Ship a red crash point's evidence to ``dump_directory()``: the
    exact crashed journal prefix, the boot-salvage report it produced, and
    the violation list — a red sweep is debuggable without a local
    repro."""
    import json
    import shutil
    directory = dump_directory()
    try:
        os.makedirs(directory, exist_ok=True)
        tag = f"sweep-seed{trace.seed}-{trace.fsync.replace(':', '_')}-at{crash_at}"
        with open(os.path.join(directory, tag + ".violations.json"), "w",
                  encoding="utf-8") as fh:
            json.dump({"seed": trace.seed, "fsync": trace.fsync,
                       "crash_at": crash_at,
                       "violations": violations}, fh, indent=1)
        for src, suffix in ((scratch, ".journal"),
                            (scratch + ".salvage.json", ".salvage.json")):
            if os.path.exists(src):
                shutil.copyfile(src, os.path.join(directory, tag + suffix))
    except OSError:
        import logging
        logging.getLogger("ai4e_tpu_torch.chaos").exception(
            "could not write crash-point sweep artifacts to %s", directory)
