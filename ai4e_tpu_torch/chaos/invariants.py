"""The invariants a chaos run must uphold, checked from the store's own
change feed; a copy of ``ai4e_tpu/chaos/invariants.py``.

1. **every accepted task terminates** — a POST that returned a TaskId
   reaches completed, failed, dead-letter or expired;
2. **no task is lost** — an accepted task the store no longer knows and
   that was never seen terminal vanished;
3. **no duplicate client-visible completion** — a task enters the
   terminal set exactly once.

Attach before traffic starts (listeners see transitions from then on);
``note_accepted`` records each TaskId the client was given.
"""

from __future__ import annotations

import os
import tempfile

from ..taskstore import TaskNotFound, TaskStatus


def dump_directory() -> str:
    """Where a red chaos run writes its evidence: ``AI4E_CHAOS_DUMP_DIR``,
    else ``ai4e-chaos`` under the process's temporary directory, where
    JAX's package writes to a fixed directory."""
    return (os.environ.get("AI4E_CHAOS_DUMP_DIR")
            or os.path.join(tempfile.gettempdir(), "ai4e-chaos"))


class InvariantChecker:
    def __init__(self, shard_of=None, flight=None, dump_dir=None):
        """``shard_of`` (optional, ``shard_of(task_id) -> int``): the hash
        ring's owner function — when given, every verdict is ALSO
        available per shard (``by_shard``/``assert_shard_ok``), so a
        sharded chaos run can prove the invariants hold for each shard
        independently and for an exact keyspace range across a rebalance
        (``violations_for``).

        ``flight`` (optional ``observability.FlightRecorder``): dumped
        alongside the violation report when an assertion trips, so a red
        seeded run ships the request timelines that explain it.
        ``dump_dir`` overrides the artifact directory (default: the
        ``AI4E_CHAOS_DUMP_DIR`` env var, else ``ai4e-chaos`` under the
        temporary directory: ``dump_directory``)."""
        self._store = None
        self.shard_of = shard_of
        self.flight = flight
        self.dump_dir = dump_dir
        self.accepted: set[str] = set()
        # First terminal status seen per task (listener feed).
        self.terminal: dict[str, str] = {}
        # (task_id, first_terminal, second_terminal) per violation.
        self.duplicate_completions: list[tuple[str, str, str]] = []

    def attach(self, store) -> "InvariantChecker":
        store.add_listener(self.on_task_event)
        self._store = store
        return self

    def note_accepted(self, task_id: str) -> None:
        """The client holds this TaskId (POST answered 200)."""
        self.accepted.add(task_id)

    def on_task_event(self, task) -> None:
        # May fire from any thread (store listeners run outside the lock);
        # dict/set mutation here is single-item and GIL-atomic.
        status = task.canonical_status
        if status not in TaskStatus.TERMINAL:
            return
        first = self.terminal.get(task.task_id)
        if first is None:
            self.terminal[task.task_id] = status
        else:
            self.duplicate_completions.append((task.task_id, first, status))

    # -- verdicts -----------------------------------------------------------

    def violations(self, task_ids=None) -> list[str]:
        """All violations, or — with ``task_ids`` — only those inside that
        keyspace range (the moved-slot check a rebalance scenario runs)."""
        wanted = None if task_ids is None else set(task_ids)
        out = []
        for tid in sorted(self.accepted):
            if wanted is not None and tid not in wanted:
                continue
            if tid in self.terminal:
                continue
            # Never seen terminal: distinguish "still limbo" from "gone".
            try:
                record = self._store.get(tid) if self._store else None
            except TaskNotFound:
                record = None
            if record is None:
                out.append(f"task {tid} LOST: accepted, never terminal, "
                           "and unknown to the store")
            else:
                out.append(f"task {tid} never reached a terminal status "
                           f"(stuck at {record.canonical_status!r})")
        for tid, first, second in self.duplicate_completions:
            if wanted is not None and tid not in wanted:
                continue
            out.append(f"task {tid} completed twice (client-visible): "
                       f"{first!r} then {second!r}")
        return out

    def assert_ok(self) -> None:
        problems = self.violations()
        if problems:
            dumped = self.dump_debug(problems)
            raise AssertionError(
                "chaos invariants violated"
                + (f" (debug artifacts: {dumped})" if dumped else "")
                + ":\n  " + "\n  ".join(problems))

    def dump_debug(self, problems: list[str]) -> str | None:
        """Write the violation report + the flight-recorder ring (when
        attached) + per-task summaries to the dump directory — the
        evidence a red chaos run leaves behind, so the failure is
        debuggable without a local repro. Returns the directory, or
        None when dumping itself failed (a dump failure must never mask
        the violation it is documenting)."""
        import json
        import time

        directory = self.dump_dir or dump_directory()
        try:
            os.makedirs(directory, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            report = {
                "violations": problems,
                "summary": self.summary(),
                "accepted": sorted(self.accepted),
                "terminal": dict(self.terminal),
                "duplicates": list(self.duplicate_completions),
            }
            with open(os.path.join(directory,
                                   f"violations-{stamp}.json"),
                      "w", encoding="utf-8") as fh:
                json.dump(report, fh, indent=1)
            if self.flight is not None:
                with open(os.path.join(directory, f"flight-{stamp}.json"),
                          "w", encoding="utf-8") as fh:
                    json.dump(self.flight.dump(), fh, indent=1)
            return directory
        except OSError:
            import logging
            logging.getLogger("ai4e_tpu_torch.chaos").exception(
                "could not write chaos debug artifacts to %s", directory)
            return None

    def summary(self) -> dict:
        return {"accepted": len(self.accepted),
                "terminal": len(self.terminal),
                "duplicates": len(self.duplicate_completions)}

    # -- durable-truth verdicts (docs/durability.md) ------------------------

    def chain_divergences(self, store) -> list[str]:
        """Chain-verified replica convergence, per shard: every replica's
        verified-stream chain head must equal its primary's own-file head
        once the links have drained (equal heads ⇔ byte-identical
        absorbed history — the primary/replica divergence detector the
        record envelope exists for). ``store`` is the sharded facade;
        links are drained here so the check is not racing the tail loop.
        Replicas that never absorbed an enveloped line (fresh standby on
        an idle shard) are unanchored and skipped."""
        out: list[str] = []
        for group in getattr(store, "groups", ()):
            primary_head = getattr(group.active, "chain_head", None)
            if primary_head is None:
                continue
            for link in group.links:
                try:
                    link.drain()
                except Exception as exc:  # noqa: BLE001; ai4e: noqa[AIL005] — the exception IS the finding: it returns as a convergence violation
                    out.append(f"shard {group.index}: replica drain "
                               f"failed: {exc!r}")
                    continue
                head = link.standby.replica_chain_head
                if head is not None and head != primary_head:
                    out.append(
                        f"shard {group.index}: replica chain head {head} "
                        f"diverged from primary {primary_head}")
        return out

    def assert_replicas_converged(self, store) -> None:
        """Raise (with debug artifacts) unless every shard's replicas are
        chain-converged with their primary."""
        problems = self.chain_divergences(store)
        if problems:
            dumped = self.dump_debug(problems)
            raise AssertionError(
                "replica chain convergence violated"
                + (f" (debug artifacts: {dumped})" if dumped else "")
                + ":\n  " + "\n  ".join(problems))

    # -- per-shard verdicts (sharded runs; requires shard_of) ---------------

    def by_shard(self) -> dict[int, dict]:
        """Accepted/terminal/duplicate counts per shard — the invariant
        summary refactored onto the ring, so a shard-primary-kill run can
        prove the OTHER shards' keyspace was untouched."""
        if self.shard_of is None:
            raise ValueError("InvariantChecker was built without shard_of")
        out: dict[int, dict] = {}
        for tid in self.accepted:
            s = out.setdefault(self.shard_of(tid),
                               {"accepted": 0, "terminal": 0,
                                "duplicates": 0})
            s["accepted"] += 1
            if tid in self.terminal:
                s["terminal"] += 1
        for tid, _first, _second in self.duplicate_completions:
            s = out.setdefault(self.shard_of(tid),
                               {"accepted": 0, "terminal": 0,
                                "duplicates": 0})
            s["duplicates"] += 1
        return out

    def assert_shard_ok(self, shard: int) -> None:
        """Invariants restricted to ONE shard's keyspace: every accepted
        task of that shard terminal, none lost, zero duplicates."""
        if self.shard_of is None:
            raise ValueError("InvariantChecker was built without shard_of")
        ids = [tid for tid in self.accepted if self.shard_of(tid) == shard]
        problems = self.violations(ids)
        if problems:
            dumped = self.dump_debug(problems)
            raise AssertionError(
                f"shard {shard} invariants violated"
                + (f" (debug artifacts: {dumped})" if dumped else "")
                + ":\n  " + "\n  ".join(problems))
