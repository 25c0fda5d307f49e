"""Sharded task store — ``ai4e_tpu/taskstore/sharding.py``: N independent
shards over one consistent-hash ring, so the loss of one shard primary
degrades 1/N of the keyspace for the length of a promotion and the other
shards never notice.

- ``ShardRing``: TaskId -> hash slot (BLAKE2b, never Python's salted
  ``hash``) -> owning shard through a slot table. A rebalance moves whole
  slots ("move slot S from shard A to shard B").
- ``ShardGroup``: one shard's primary (a journaled, epoch-fenced
  ``FollowerTaskStore`` at ``{journal_path}.shard{i}``) and its passive
  replicas (``.replica{j}``), each absorbing the primary's journal through
  a ``ShardReplicaLink``; without ``journal_path`` the shards are
  in-memory stores and cannot fail over.
- ``ShardedTaskStore``: the facade the platform holds where it held one
  store. Per-task verbs route by ring lookup; aggregate queries (depths,
  endpoints, snapshots, unfinished tasks) fan out; listeners fan in
  through one relay per shard, which also publishes to that shard's
  ``ShardChangeFeed`` (``feed.py``).

Split-brain is prevented per shard and across a rebalance:

- failover: the promoted replica mints a journaled epoch above everything
  the dead primary wrote, and the dead primary's store refuses every
  mutation (``StoreClosedError``); the promotion first drains the dead
  primary's journal file into the replica, so no acknowledged write is
  lost;
- rebalance: the ring flips while the OLD owner's store lock is held, and
  every shard store re-checks ownership under its own lock on every
  mutation (``InMemoryTaskStore._check_owner`` -> ``NotOwnerError``). A
  write that routed to the old owner before the flip blocks on that lock
  and is refused after it; the facade re-routes it to the new owner, which
  received the whole range (a bulk copy, then a delta while the old owner
  was frozen) before the flip became visible.

Residual windows, as in JAX:

- memory-only records (``durable=False`` cache hits) do not migrate; a
  moved cache-hit TaskId answers 404 afterwards, as after a restart;
- a rebalanced task's broker message stays on the old shard's sub-queue;
  its delivery still routes every store write through the ring;
- a promoted replica runs without a standby until one is provisioned.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import threading
from typing import Callable, Iterable

from .feed import ShardChangeFeed
from .journal import JournalCorruptError
from .replication import split_complete_lines
from .store import (FollowerTaskStore, InMemoryTaskStore,
                    JournalDegradedError, NotOwnerError, NotPrimaryError,
                    StoreClosedError, TaskNotFound)
from .task import APITask, new_task_id

log = logging.getLogger("ai4e_tpu_torch.taskstore.sharding")


def stable_hash(task_id: str) -> int:
    """Process-independent TaskId hash (BLAKE2b-64). Python's ``hash`` is
    salted per process — two control-plane processes would disagree on
    ownership of every task."""
    return int.from_bytes(
        hashlib.blake2b(task_id.encode("utf-8"), digest_size=8).digest(),
        "big")


class ShardRing:
    """TaskId → slot → shard, with atomic single-slot reassignment.

    The slot table is the consistent-hash structure made explicit (the
    Redis Cluster / 16384-hash-slots shape): adding capacity or rebalancing
    moves whole slots, and only the moved slots' keys change owner —
    everything else is untouched. ``version`` increments on every
    reassignment: the rebalance epoch a stale owner's fence re-checks."""

    def __init__(self, shards: int, slots: int = 64):
        if shards < 1:
            raise ValueError("shards must be >= 1")
        if slots < shards:
            raise ValueError(f"slots ({slots}) must be >= shards ({shards})")
        self.shards = shards
        self.slots = slots
        self._assign = [i % shards for i in range(slots)]
        self.version = 0
        self._lock = threading.Lock()

    def slot_for(self, task_id: str) -> int:
        return stable_hash(task_id) % self.slots

    def shard_for(self, task_id: str) -> int:
        return self._assign[self.slot_for(task_id)]

    def shard_of_slot(self, slot: int) -> int:
        return self._assign[slot]

    def slots_of(self, shard: int) -> list[int]:
        return [s for s, owner in enumerate(self._assign) if owner == shard]

    def assign(self, slot: int, shard: int) -> None:
        """Reassign one slot. The caller (``move_slot``) holds the OLD
        owner's store lock around this, which is what makes the flip
        atomic with respect to that store's write fence."""
        if not 0 <= shard < self.shards:
            raise ValueError(f"shard {shard} out of range")
        with self._lock:
            self._assign[slot] = shard
            self.version += 1

    def assignments(self) -> list[int]:
        return list(self._assign)


class ShardReplicaLink:
    """One passive replica's journal tail — the in-process analogue of
    ``replication.JournalReplicator``, reading the primary's journal FILE
    (which outlives the primary: it is the shard's durable truth) instead
    of the HTTP stream. Same consume-whole-lines rule, same generation
    resync contract (a compaction rewrite restarts the reader at offset 0
    of what is then a full snapshot).

    **Wire mode** (``primary_url=``): the same link absorbing the same
    protocol over the socket — ``GET /v1/taskstore/journal`` with the
    offset/generation/limit contract ``replication.py`` defines — for a
    standby living in a DIFFERENT process than its shard primary.
    Checksum/chain verification, the corrupt-line park, and the
    generation resync behave identically to file mode; what changes is
    reach (any host) and the failover drain (a dead primary's HTTP stream
    is unreachable, so a same-host standby drains the journal *file*
    instead — ``absorb_journal_file``).
    Fetches are synchronous (urllib) by design: ``sync_once`` is sync
    absorb work and event-loop callers already wrap it in
    ``asyncio.to_thread``."""

    def __init__(self, group: "ShardGroup | None", standby: FollowerTaskStore,
                 primary_url: str | None = None, api_key: str | None = None,
                 wire_timeout: float = 10.0,
                 chunk_limit: int = 4 * 1024 * 1024):
        if group is None and primary_url is None:
            raise ValueError("a ShardReplicaLink needs a group (file mode) "
                             "or a primary_url (wire mode)")
        self.group = group
        self.standby = standby
        self.primary_url = primary_url.rstrip("/") if primary_url else None
        self._wire_headers = ({"Ocp-Apim-Subscription-Key": api_key}
                              if api_key else {})
        self._wire_timeout = wire_timeout
        self._chunk_limit = chunk_limit
        # For log lines in wire mode (no group to name the shard).
        self.shard_index = group.index if group is not None else -1
        self.generation = -1
        self.offset = 0
        self._buffer = b""
        # (generation, offset) this link is PARKED at after a verified
        # journal line failed its checksum/chain (the file's bytes will
        # not change — re-reading re-fails): the verified prefix stays
        # absorbed, progress stops loudly, and a failover drain promotes
        # on that prefix — torn-tail semantics. A compaction rewrite
        # (generation bump) clears the park.
        self._corrupt_at: tuple[int, int] | None = None
        # Serializes tail-loop polls (executor thread) against the failover
        # drain (caller's thread): both advance offset/_buffer through
        # sync_once, and interleaving them would double-absorb or skip
        # lines.
        self._sync_lock = threading.Lock()

    def sync_once(self) -> int:
        """Absorb any new journal bytes; returns bytes consumed (0 = caught
        up). Synchronous file work — callers on an event loop wrap it in
        ``asyncio.to_thread`` (the replicator absorbs the same way)."""
        with self._sync_lock:
            if self.primary_url is not None:
                return self._sync_once_wire()
            return self._sync_once_locked()

    # -- wire mode ----------------------------------------------------------

    def _fetch_wire(self, limit: int) -> tuple[int, int, int, bytes]:
        """One journal-stream poll: ``(generation, served_from, size,
        chunk)``. Raises ``OSError`` when the primary is unreachable (the
        tail loop retries; a failover drain gives up and falls back to
        the journal file)."""
        import urllib.error
        import urllib.parse
        import urllib.request

        from .replication import JOURNAL_PATH
        params = urllib.parse.urlencode({
            "offset": str(self.offset),
            "generation": str(self.generation),
            "wait": "0",
            "limit": str(limit),
            # Fencing evidence, same as the HTTP replicator: a link that
            # outlived a failover demotes the deposed primary it polls.
            "epoch": str(self.standby.epoch)})
        req = urllib.request.Request(
            f"{self.primary_url}{JOURNAL_PATH}?{params}",
            headers=self._wire_headers)
        try:
            with urllib.request.urlopen(
                    req, timeout=self._wire_timeout) as resp:
                gen = int(resp.headers.get("X-Journal-Generation", "0"))
                served_from = int(resp.headers.get("X-Journal-Offset",
                                                   str(self.offset)))
                size = int(resp.headers.get("X-Journal-Size", "0"))
                chunk = resp.read()
        except urllib.error.HTTPError as exc:
            raise OSError(
                f"journal stream at {self.primary_url} answered "
                f"HTTP {exc.code}") from exc
        return gen, served_from, size, chunk

    def _sync_once_wire(self) -> int:
        parked = self._corrupt_at == (self.generation, self.offset)
        # While parked, probe with a 1-byte limit: the only thing that can
        # clear a park is a generation bump (compaction rewrote the bytes),
        # and re-reading the primary's ever-growing unabsorbed suffix every
        # poll is the cost the file mode's pre-open check avoids.
        gen, served_from, size, chunk = self._fetch_wire(
            1 if parked else self._chunk_limit)
        if gen != self.generation or served_from != self.offset:
            if served_from != 0:
                # The server restarts mismatched readers at 0; anything
                # else is a contract violation (replication.py).
                raise OSError(
                    f"journal reset served from offset {served_from}")
            if self.generation != -1:
                log.info("shard %d wire replica: journal generation "
                         "%d -> %d; resyncing", self.shard_index,
                         self.generation, gen)
            self.standby.reset()
            self._buffer = b""
            self.generation = gen
            self.offset = 0
            self._corrupt_at = None
            if parked and size > len(chunk):
                # A parked probe's 1-byte limit truncated the resync
                # chunk; drop it and let the next poll read full-width.
                chunk = b""
            parked = False
        if parked or not chunk:
            return 0
        lines, self._buffer = split_complete_lines(self._buffer + chunk)
        if lines:
            try:
                self.standby.absorb_lines(lines)
            except JournalCorruptError as exc:
                self._corrupt_at = (self.generation, self.offset)
                self._buffer = b""
                log.error(
                    "shard %d wire replica: journal line failed "
                    "verification at ~offset %d of %s (%s); replica parks "
                    "on the verified prefix until the journal is repaired "
                    "or compacted (docs/durability.md)", self.shard_index,
                    self.offset, self.primary_url, exc)
                return 0
        self.offset += len(chunk)
        return len(chunk)

    # -- file mode ----------------------------------------------------------

    def _sync_once_locked(self) -> int:
        primary = self.group.primary
        # Generation + open under the primary's lock: compaction swaps the
        # file under that lock (http.py journal_stream does the same). A
        # dead primary's lock is uncontended and its generation frozen.
        with primary._lock:
            gen = primary.journal_generation
            if self._corrupt_at == (gen, self.offset):
                # Parked on a verified-corrupt record of THIS generation;
                # the bytes cannot heal in place. Checked before any
                # open/read — a parked link must not re-read the primary's
                # ever-growing unabsorbed suffix on every tail poll. A
                # compaction rewrite (generation bump) clears the park; a
                # failover drain stops here on the verified prefix.
                return 0
            try:
                fh = open(self.group.journal_path, "rb")
            except FileNotFoundError:
                return 0
        try:
            if gen != self.generation:
                if self.generation != -1:
                    log.info("shard %d replica: journal generation %d -> %d;"
                             " resyncing", self.group.index, self.generation,
                             gen)
                self.standby.reset()
                self._buffer = b""
                self.generation = gen
                self.offset = 0
                # A park belongs to the generation it was observed in; a
                # stale tuple could otherwise match a fresh (gen, offset)
                # pair and silently stall a healthy replica forever.
                self._corrupt_at = None
            fh.seek(self.offset)
            chunk = fh.read()
        finally:
            fh.close()
        if not chunk:
            return 0
        lines, self._buffer = split_complete_lines(self._buffer + chunk)
        if lines:
            try:
                self.standby.absorb_lines(lines)
            except JournalCorruptError as exc:
                # absorb applied the verified prefix and refused the bad
                # line. Park the link (never absorb it silently — that
                # would ratify the primary's bit-rot on the replica too);
                # the un-absorbed suffix re-absorbs idempotently if the
                # generation ever changes.
                self._corrupt_at = (self.generation, self.offset)
                self._buffer = b""
                log.error(
                    "shard %d replica: journal line failed verification "
                    "at ~offset %d of %s (%s); replica parks on the "
                    "verified prefix until the journal is repaired or "
                    "compacted (docs/durability.md)", self.group.index,
                    self.offset, self.group.journal_path, exc)
                return 0
        self.offset += len(chunk)
        return len(chunk)

    def drain(self) -> None:
        """Final catch-up before promotion: the primary is dead (no more
        appends — every acknowledged write was flushed before its caller
        returned), so reading to EOF yields its exact final state."""
        while self.sync_once():
            pass


def absorb_journal_file(standby: FollowerTaskStore, path: str) -> int:
    """Full resync of ``standby`` from a journal FILE — the failover drain
    a wire-mode replica runs when its shard primary is DEAD: the HTTP
    stream died with the process, but the journal file is the shard's
    durable truth and (on a shared filesystem — one host's processes)
    still holds every acknowledged write. Reset-and-replay from offset 0
    is always correct, exactly the HTTP replicator's reconnect contract:
    the wire link's byte offset belongs to a generation the reader can no
    longer verify against a live server, so no tail-continuation is
    attempted. Whole lines only — an unterminated torn tail is left
    behind, torn-tail semantics. Returns lines absorbed. A
    ``JournalCorruptError`` mid-file leaves the verified prefix applied
    and re-raises: the caller decides whether to promote on the prefix
    (the park contract) or refuse."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        return 0
    lines, _tail = split_complete_lines(data)
    standby.reset()
    if lines:
        standby.absorb_lines(lines)
    return len(lines)


class ShardGroup:
    """One shard: primary + passive replicas + failover bookkeeping."""

    def __init__(self, index: int, journal_path: str | None = None,
                 replicas: int = 1, compact_every: int = 5000,
                 store_kwargs: dict | None = None):
        self.index = index
        kw = dict(store_kwargs or {})
        self.links: list[ShardReplicaLink] = []
        if journal_path:
            self.journal_path = f"{journal_path}.shard{index}"
            self.primary: InMemoryTaskStore = FollowerTaskStore(
                self.journal_path, start_as_primary=True,
                compact_every=compact_every, **kw)
            for j in range(replicas):
                standby = FollowerTaskStore(
                    f"{self.journal_path}.replica{j}",
                    compact_every=compact_every, **kw)
                self.links.append(ShardReplicaLink(self, standby))
        else:
            # Journal-less shards scale the keyspace but cannot fail over
            # (nothing durable to promote from) — the same durability
            # trade the unsharded in-memory store already makes. The
            # journal-only knobs (fsync policy, journal metrics) have
            # nothing to attach to here.
            kw.pop("fsync", None)
            kw.pop("metrics", None)
            self.journal_path = None
            self.primary = InMemoryTaskStore(**kw)
        self.active: InMemoryTaskStore = self.primary
        self.dead = False
        self._lock = threading.Lock()

    @property
    def epoch(self) -> int:
        return getattr(self.active, "epoch", 0)

    def mark_dead(self) -> None:
        """SIGKILL semantics for the chaos harness: the primary's journal
        handle closes and every subsequent mutation refuses with
        ``StoreClosedError`` — no further writes are acknowledged, exactly
        the window a real process kill leaves. The journal FILE survives
        (it is the shard's durable truth) for the replica's final drain."""
        self.active.close()
        self.dead = True

    def close(self) -> None:
        self.active.close()
        for link in self.links:
            link.standby.close()


class ShardedTaskStore:
    """The facade the platform holds where it used to hold one store.

    Same verb surface as ``InMemoryTaskStore`` (plus the HA extras the
    assembly duck-types): per-TaskId verbs route by ring lookup with
    bounded re-route on ``NotOwnerError`` (rebalance) and inline failover
    promotion on ``StoreClosedError`` (shard primary death); aggregate
    queries fan out; listeners and the publisher fan in/out through one
    relay per shard."""

    # Bounded re-route: one rebalance flip or one failover per attempt;
    # anything needing more than this many is a real fault to surface.
    _ROUTE_ATTEMPTS = 4

    def __init__(self, shards: int, slots: int = 64,
                 journal_path: str | None = None, replicas: int = 1,
                 tail_interval: float = 0.25, feed_recent: int = 4096,
                 compact_every: int = 5000, result_backend=None,
                 result_offload_threshold: int | None = None,
                 fsync: str | None = None, metrics=None):
        self.ring = ShardRing(shards, slots=slots)
        store_kwargs = dict(result_backend=result_backend,
                            result_offload_threshold=result_offload_threshold,
                            fsync=fsync, metrics=metrics)
        self.groups = [
            ShardGroup(i, journal_path=journal_path, replicas=replicas,
                       compact_every=compact_every,
                       store_kwargs=store_kwargs)
            for i in range(shards)]
        self.feeds = [ShardChangeFeed(i, recent=feed_recent)
                      for i in range(shards)]
        self.tail_interval = tail_interval
        self._listeners: list[Callable[[APITask], None]] = []
        self._publisher = None
        self._rebalance_lock = threading.Lock()
        self._tail_tasks: list[asyncio.Task] = []
        self._tail_stop: asyncio.Event | None = None
        for group in self.groups:
            self._adopt(group.active, group.index)

    # -- shard adoption (fence + publisher + listener relay) ---------------

    def _adopt(self, store: InMemoryTaskStore, index: int) -> None:
        """Wire one store in as shard ``index``'s active primary. The relay
        is attached HERE — never to standbys, whose absorb-path
        notifications would duplicate every event the primary already
        relayed."""
        store.set_write_fence(
            lambda task_id, _i=index: self.ring.shard_for(task_id) == _i)
        store.set_publisher(self._publish)
        store.add_listener(
            lambda task, _i=index: self._relay(task, _i))

    def _publish(self, task: APITask) -> None:
        if self._publisher is not None:
            self._publisher(task)

    def _relay(self, task: APITask, shard_index: int) -> None:
        # Mirror StoreSideEffects._notify's isolation: one listener's
        # failure must not starve the rest (or the feed).
        for listener in self._listeners:
            try:
                listener(task)
            except Exception:  # noqa: BLE001 — observers must not break the store
                log.exception("sharded-store listener failed for %s",
                              task.task_id)
        try:
            # Feed of the task's CURRENT ring owner, not the notifying
            # shard: a watcher parks on feed_for(task_id), and a terminal
            # transition applied by the old owner in the same instant a
            # rebalance lands must reach the feed that watcher chose.
            self.feeds[self.ring.shard_for(task.task_id)].publish(task)
        except Exception:  # noqa: BLE001 — same isolation as above
            log.exception("shard feed publish failed for %s", task.task_id)

    # -- routing core -------------------------------------------------------

    def shard_for(self, task_id: str) -> int:
        """Owning shard index — also the broker's sub-queue router."""
        return self.ring.shard_for(task_id)

    def feed_for(self, task_id: str) -> ShardChangeFeed:
        """The owning shard's change feed (gateway long-poll attaches
        here — N feeds serve every watcher)."""
        return self.feeds[self.ring.shard_for(task_id)]

    def shard_stores(self) -> list[InMemoryTaskStore]:
        """Active per-shard stores, for per-shard SCANS (the reaper). All
        per-task ACTIONS must still route through the facade — a direct
        write to a scanned store is exactly the stale-owner hazard the
        fence exists to refuse."""
        return [g.active for g in self.groups]

    def _route(self, task_id: str, op):
        """Run ``op(store)`` against the owning shard, re-routing across a
        concurrent rebalance and promoting through a dead primary. Reads
        are fenced too, by outcome rather than by lock: a miss (raise or
        None) answered by a store the ring no longer points at may be the
        handoff window — the moved range was forgotten there — so a miss
        only stands when the answering store is STILL the owner."""
        last: Exception | None = None
        for _ in range(self._ROUTE_ATTEMPTS):
            group = self.groups[self.ring.shard_for(task_id)]
            if group.dead and not self._fail_over(group):
                # No replica to promote: surface the dead shard loudly
                # rather than serving from a corpse.
                raise StoreClosedError(
                    f"shard {group.index} primary is dead and has no "
                    "promotable replica")
            try:
                result = op(group.active)
            except NotOwnerError as exc:
                # Rebalance flipped ownership between our ring lookup and
                # the store's fence check; a fresh lookup finds the new
                # owner (which imported the full range before the flip).
                last = exc
                continue
            except TaskNotFound:
                if self.groups[self.ring.shard_for(task_id)] is not group:
                    # The slot moved while we were asking: the task was
                    # forgotten HERE but lives on the new owner — a 404 to
                    # the client would be a lie. Re-route.
                    continue
                raise
            except (StoreClosedError, NotPrimaryError) as exc:
                last = exc
                if not self._fail_over(group):
                    raise
                continue
            except JournalDegradedError as exc:
                # Disk fault on the shard primary (ENOSPC/EIO): it is
                # fenced read-only — for the sharded facade that is a
                # dead writer WHEN a replica can take over. Only then is
                # it closed (journal handle released; the FILE holds
                # every acknowledged write for the drain) and promoted
                # over. With NO promotable replica the primary must stay
                # open: it is still serving reads and is recover()able —
                # closing it would convert a transient disk fault into a
                # permanent full-shard outage. The typed degraded error
                # surfaces instead, so the HTTP layer answers the 503 +
                # X-Shed-Reason: journal-degraded contract.
                if not group.dead and not group.links:
                    raise
                last = exc
                if not group.dead:
                    log.error(
                        "shard %d: primary is journal-degraded (%s); "
                        "failing over to a replica", group.index, exc)
                    group.mark_dead()
                if not self._fail_over(group):
                    raise
                continue
            if (result is None
                    and self.groups[self.ring.shard_for(task_id)]
                    is not group):
                # None-shaped miss (get_result/open_result, a conditional
                # verb's refusal) from a store that lost the slot mid-call:
                # the new owner holds the migrated state — ask it. The
                # conditional verbs are safe to re-run: they re-check their
                # condition against the migrated state.
                continue
            return result
        raise StoreClosedError(
            f"could not route task {task_id!r} after "
            f"{self._ROUTE_ATTEMPTS} attempts") from last

    # -- failover -----------------------------------------------------------

    def _fail_over(self, group: ShardGroup) -> bool:
        """Promote a replica over a dead shard primary. Returns True when
        the group has a live active store on exit (this call promoted, or
        another thread already had). Sequence mirrors the whole-store
        watchdog: drain the durable journal tail first (zero loss — every
        acknowledged write was flushed), promote (minting the fencing
        epoch), and only then adopt + swap, so no write lands on the
        standby before it holds the full state."""
        with group._lock:
            if not group.dead:
                return True
            standby = None
            while group.links:
                link = group.links.pop(0)
                candidate = link.standby
                try:
                    link.drain()
                except Exception:  # noqa: BLE001 — promote anyway: the standby holds its last-absorbed state, and refusing leaves the shard with NO writer
                    log.exception(
                        "shard %d: final journal drain failed; promoting "
                        "the replica on its last absorbed state",
                        group.index)
                try:
                    candidate.promote()
                except JournalDegradedError as exc:
                    # The STANDBY's own disk faulted minting the fencing
                    # epoch: promote() unwound it to an intact (degraded)
                    # follower. Letting the error escape here would both
                    # abort the failover AND silently discard the popped
                    # replica — instead try the next one; with none left
                    # the shard is loudly writer-less (False → the
                    # caller's StoreClosedError).
                    log.error(
                        "shard %d: replica's journal disk faulted during "
                        "promotion (%s); trying the next replica",
                        group.index, exc)
                    continue
                standby = candidate
                break
            if standby is None:
                return False
            self._adopt(standby, group.index)
            group.primary = standby
            # Remaining replicas (replicas > 1) must re-home onto the NEW
            # primary's journal file and resync from its snapshot — their
            # offsets into the dead primary's file mean nothing there.
            group.journal_path = getattr(standby, "_journal_path",
                                         group.journal_path)
            for other in group.links:
                other.generation = -1
            group.active = standby
            group.dead = False
            log.warning(
                "shard %d: primary dead; promoted replica at fencing "
                "epoch %d", group.index, standby.epoch)
            return True

    # -- replication lifecycle ----------------------------------------------

    async def start_replication(self) -> None:
        """Start every replica's journal tail loop on the running loop."""
        self._tail_stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for group in self.groups:
            for link in group.links:
                self._tail_tasks.append(
                    loop.create_task(self._tail(link)))

    async def _tail(self, link: ShardReplicaLink) -> None:
        stop = self._tail_stop
        while not stop.is_set():
            try:
                await asyncio.to_thread(link.sync_once)
            except RuntimeError:
                # absorb-after-promote / reset-after-promote: this standby
                # was promoted out from under its tail loop — done.
                return
            except Exception:  # noqa: BLE001 — keep tailing through transient I/O errors
                log.exception("shard %d replica tail failed; retrying",
                              link.group.index)
            try:
                await asyncio.wait_for(stop.wait(), self.tail_interval)
                return
            except asyncio.TimeoutError:
                continue

    async def stop_replication(self) -> None:
        if self._tail_stop is not None:
            self._tail_stop.set()
        for task in self._tail_tasks:
            task.cancel()
        for task in self._tail_tasks:
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001; ai4e: noqa[AIL005] — awaiting our own cancelled loops; the outcome is irrelevant at teardown
                pass
        self._tail_tasks = []

    # -- live rebalance -----------------------------------------------------

    def move_slot(self, slot: int, dest_index: int) -> int:
        """Move one hash slot's keyspace range to ``dest_index`` under load;
        returns tasks moved. Two phases:

        1. **bulk copy** — export the range (brief source lock), import on
           the destination; traffic keeps flowing to the source;
        2. **atomic handoff** — under the SOURCE's store lock: export the
           delta (records that changed since the copy — object identity,
           every mutation replaces the record object), import it on the
           destination (nested dest lock; the only place two shard locks
           nest, always source→dest, so no cycle), flip the ring, and
           forget the range on the source. The source's write fence checks
           ownership under this same lock, so a concurrent write either
           lands before the flip (and is exported in the delta) or is
           refused after it and re-routed by the facade.
        """
        if not 0 <= slot < self.ring.slots:
            raise ValueError(f"slot {slot} out of range")
        with self._rebalance_lock:
            src_index = self.ring.shard_of_slot(slot)
            if src_index == dest_index:
                return 0
            # The whole move retries across a shard failover landing mid
            # migration: phase 2 re-verifies (under the source lock) that
            # the stores it snapshot are still the shards' active stores —
            # a promotion swapped one out means the snapshot (or the
            # import target) is a corpse's frozen state, and proceeding
            # would flip the ring onto a copy missing the promoted
            # store's writes.
            last: Exception | None = None
            for _attempt in range(3):
                moved = self._try_move_slot(slot, src_index, dest_index)
                if moved is not None:
                    return moved
                last = StoreClosedError(
                    f"shard store swapped mid-rebalance of slot {slot}")
            raise StoreClosedError(
                f"rebalance of slot {slot} kept racing shard failovers"
            ) from last

    def _try_move_slot(self, slot: int, src_index: int,
                       dest_index: int) -> int | None:
        """One migration attempt; None = a failover swapped a store mid
        copy and the caller should retry (the bulk copy is re-imported
        idempotently over the stale one)."""
        # Both ends must be live writers: a dead source would explode at
        # the forget (after the copy), a dead destination at the import —
        # fail over first, or refuse up front.
        for group in (self.groups[src_index], self.groups[dest_index]):
            if group.dead and not self._fail_over(group):
                raise StoreClosedError(
                    f"shard {group.index} primary is dead with no "
                    "promotable replica; cannot rebalance")
        src = self.groups[src_index].active
        dest = self.groups[dest_index].active
        # Phase 1: bulk copy. Snapshot record/result object identities
        # for delta detection — every store mutation replaces the
        # stored object, so `is` comparison is exact.
        with src._lock:
            ids1 = self._slot_ids(src, slot)
            tasks1 = {tid: src._tasks[tid] for tid in ids1}
            results1 = {}
            for tid in ids1:
                for key in src._result_keys.get(tid, ()):
                    results1[key] = src._results.get(key)
            recs1 = src.export_task_records(ids1)
        try:
            dest.import_task_records(recs1)
        except (StoreClosedError, NotPrimaryError):
            return None  # destination died mid-copy; retry fails it over
        except JournalDegradedError:
            # Destination's disk faulted mid-import: same as a death for
            # rebalance purposes — mark it so the retry fails it over to
            # a replica before re-copying.
            self.groups[dest_index].mark_dead()
            return None
        # Phase 2: atomic handoff under the source lock. Until the ring
        # flips, the range transiently exists on BOTH shards (aggregate
        # queries briefly double-count it — docs/sharding.md residual
        # windows); a failure BEFORE the flip rolls the phase-1 copy
        # back off the destination so nothing double-counts forever.
        flipped = False
        try:
            with src._lock:
                if (self.groups[src_index].active is not src
                        or self.groups[dest_index].active is not dest
                        or self.groups[src_index].dead
                        or self.groups[dest_index].dead):
                    # A promotion swapped a store between the phases.
                    # ``close()`` serializes on the store lock, so once
                    # this check passes the SOURCE cannot die before the
                    # handoff completes; the stale phase-1 copy is either
                    # on a corpse (dest swapped — irrelevant) or will be
                    # re-imported from the promoted source on retry.
                    return None
                ids2 = self._slot_ids(src, slot)
                delta_ids = [tid for tid in ids2
                             if tasks1.get(tid) is not src._tasks[tid]]
                delta = src.export_task_records(delta_ids)
                delta_set = set(delta_ids)
                for tid in ids2:
                    if tid in delta_set:
                        continue  # its results rode the full re-export
                    for key in src._result_keys.get(tid, ()):
                        cur = src._results.get(key)
                        if (results1.get(key) is not cur
                                and cur is not None):
                            delta.append(src._result_record(
                                key, cur[0], cur[1]))
                dest.import_task_records(delta)
                alive = set(ids2)
                evicted_between = [tid for tid in ids1
                                   if tid not in alive]
                if evicted_between:
                    # Evicted on the source AFTER the bulk copy (the
                    # retention sweep): the destination must not keep
                    # the phase-1 replica, or a task a client already
                    # saw 404 would resurrect once the ring flips.
                    dest.forget_tasks(evicted_between)
                self.ring.assign(slot, dest_index)
                flipped = True
                src.forget_tasks(ids2)
        except BaseException:
            if not flipped:
                # The ring never moved: undo the bulk copy or the
                # destination keeps (and journals, and replays) an
                # orphan replica of a range it does not own.
                try:
                    dest.forget_tasks(ids1)
                except Exception:  # noqa: BLE001 — best-effort rollback; the raise below carries the real fault
                    log.exception(
                        "rebalance rollback of slot %d on shard %d "
                        "failed; orphan copies may double-count until "
                        "retention evicts them", slot, dest_index)
            else:
                # Flipped but the source cleanup failed: ownership is
                # correct (fence blocks stale writes); the leftovers
                # are garbage the terminal-retention sweep collects.
                log.exception(
                    "rebalance of slot %d: source forget failed after "
                    "the flip; stale (fenced) copies remain on shard "
                    "%d until retention evicts them", slot, src_index)
            raise
        # The moved range's future transitions publish to the DESTINATION
        # feed now: stale terminal records in the source feed's replay map
        # would outlive any redrive of these tasks (and answer a long-poll
        # with the previous run's record if the slot ever moves back).
        self.feeds[src_index].invalidate(set(ids1) | set(ids2))
        moved = len(ids2)
        log.info("rebalanced slot %d: shard %d -> %d (%d tasks, ring "
                 "version %d)", slot, src_index, dest_index, moved,
                 self.ring.version)
        return moved

    def _slot_ids(self, store: InMemoryTaskStore, slot: int) -> list[str]:
        # Caller holds store._lock. O(shard's tasks); a per-slot index
        # would make this O(range) — not needed at current scale
        # (docs/sharding.md).
        return [tid for tid in store._tasks
                if self.ring.slot_for(tid) == slot]

    # -- store verb surface (per-task: ring-routed) ------------------------

    def upsert(self, task: APITask) -> APITask:
        if not task.task_id:
            # Mint here, not in the shard store: the id IS the routing key.
            task.task_id = new_task_id()
        return self._route(task.task_id, lambda s: s.upsert(task))

    def update_status(self, task_id: str, status: str,
                      backend_status: str | None = None) -> APITask:
        return self._route(
            task_id, lambda s: s.update_status(task_id, status,
                                               backend_status))

    def update_status_if(self, task_id: str, expected_status: str,
                         status: str,
                         backend_status: str | None = None) -> APITask | None:
        return self._route(
            task_id, lambda s: s.update_status_if(task_id, expected_status,
                                                  status, backend_status))

    def requeue_if(self, task_id: str, expected_status: str) -> APITask | None:
        return self._route(
            task_id, lambda s: s.requeue_if(task_id, expected_status))

    def get(self, task_id: str) -> APITask:
        return self._route(task_id, lambda s: s.get(task_id))

    def get_original_body(self, task_id: str) -> bytes:
        # The store's miss shape here is b"" (not a raise, not None) — map
        # it to None so _route's ownership re-check applies: an empty
        # answer from a store that just lost the slot must re-route to the
        # owner holding the migrated OrigHex, not stand as "no body".
        def op(store):
            body = store.get_original_body(task_id)
            return body if body else None

        return self._route(task_id, op) or b""

    def set_result(self, task_id: str, result: bytes,
                   content_type: str = "application/json",
                   stage: str | None = None) -> None:
        return self._route(
            task_id, lambda s: s.set_result(task_id, result,
                                            content_type=content_type,
                                            stage=stage))

    def set_result_ref(self, task_id: str,
                       content_type: str = "application/json",
                       stage: str | None = None) -> None:
        return self._route(
            task_id, lambda s: s.set_result_ref(task_id,
                                                content_type=content_type,
                                                stage=stage))

    def get_result(self, task_id: str,
                   stage: str | None = None) -> tuple[bytes, str] | None:
        return self._route(task_id,
                           lambda s: s.get_result(task_id, stage=stage))

    def open_result(self, task_id: str, stage: str | None = None):
        return self._route(task_id,
                           lambda s: s.open_result(task_id, stage=stage))

    def append_ledger(self, task_id: str, events: list[dict]) -> int:
        """Hop-ledger append, ring-routed like every per-TaskId mutation
        (observability/ledger.py). Residual: a rebalance moving the slot
        mid-flight leaves the already-stamped events on the old owner —
        acceptable for fail-open telemetry (docs/observability.md), the
        same contract as losing a timeline to a restart."""
        return self._route(task_id,
                           lambda s: s.append_ledger(task_id, events))

    def get_ledger(self, task_id: str) -> list[dict]:
        def op(store):
            # Empty → None so _route's ownership re-check applies (the
            # migrated timeline lives with the new owner when it moved
            # before any post-move stamp; see get_original_body).
            events = store.get_ledger(task_id)
            return events if events else None

        return self._route(task_id, op) or []

    # -- side-effect plumbing ----------------------------------------------

    def set_publisher(self, publisher) -> None:
        self._publisher = publisher

    @property
    def has_publisher(self) -> bool:
        """Whether a republished task reaches a broker (the port's
        ``StoreSideEffects`` surface, which an in-process worker reads)."""
        return self._publisher is not None

    def add_listener(self, listener: Callable[[APITask], None]) -> None:
        self._listeners.append(listener)

    # -- aggregate queries (fan-out) ---------------------------------------

    def set_len(self, endpoint_path: str, status: str) -> int:
        return sum(g.active.set_len(endpoint_path, status)
                   for g in self.groups)

    def set_members(self, endpoint_path: str, status: str) -> list[str]:
        out: list[str] = []
        for g in self.groups:
            out.extend(g.active.set_members(endpoint_path, status))
        return out

    def endpoints(self) -> list[str]:
        paths: set[str] = set()
        for g in self.groups:
            paths.update(g.active.endpoints())
        return sorted(paths)

    def depths(self) -> dict[str, dict[str, int]]:
        out: dict[str, dict[str, int]] = {}
        for g in self.groups:
            for path, counts in g.active.depths().items():
                agg = out.setdefault(path, {s: 0 for s in counts})
                for status, n in counts.items():
                    agg[status] = agg.get(status, 0) + n
        return out

    def snapshot(self) -> Iterable[APITask]:
        out: list[APITask] = []
        for g in self.groups:
            out.extend(g.active.snapshot())
        return out

    def unfinished_tasks(self) -> list[APITask]:
        out: list[APITask] = []
        for g in self.groups:
            out.extend(g.active.unfinished_tasks())
        return out

    def evict_terminal_older_than(self, age_s: float) -> int:
        return sum(g.active.evict_terminal_older_than(age_s)
                   for g in self.groups)

    @property
    def replayed_task_ids(self) -> set[str]:
        """Union of journal-restored ids across shards — the platform's
        restart re-seed reads this exactly as on the single store."""
        out: set[str] = set()
        for g in self.groups:
            out.update(getattr(g.active, "replayed_task_ids", ()) or ())
        return out

    def compact(self) -> None:
        for g in self.groups:
            compact = getattr(g.active, "compact", None)
            if compact is not None:
                compact()

    def close(self) -> None:
        for g in self.groups:
            g.close()

    # -- chaos / introspection ----------------------------------------------

    def kill_shard_primary(self, index: int) -> None:
        """Chaos hook: SIGKILL shard ``index``'s primary (see
        ``ShardGroup.mark_dead``). The next write routed there performs
        the failover promotion inline."""
        self.groups[index].mark_dead()

    def topology(self) -> dict:
        """Ring + per-shard role/epoch/feed state — the ``/v1/taskstore/
        shards`` endpoint's body."""
        return {
            "shards": self.ring.shards,
            "slots": self.ring.assignments(),
            "version": self.ring.version,
            "groups": [
                {"shard": g.index,
                 "epoch": g.epoch,
                 "dead": g.dead,
                 "replicas": len(g.links),
                 "journal": g.journal_path,
                 # Hash-chain heads (docs/durability.md): the primary's
                 # own-file head beside each replica's verified-stream
                 # head — divergence is a string comparison right here.
                 "chain_head": getattr(g.active, "chain_head", None),
                 "replica_chain_heads": [
                     link.standby.replica_chain_head for link in g.links],
                 "degraded": bool(getattr(g.active, "degraded", False)),
                 "feed_seq": self.feeds[g.index].seq,
                 "watchers": self.feeds[g.index].watcher_count}
                for g in self.groups],
        }

    def journal_stats(self) -> dict:
        """Aggregate per-shard journal stats (bench's ``journal`` block):
        sums across shards, max append p99, any-degraded."""
        shards = []
        for g in self.groups:
            stats = getattr(g.active, "journal_stats", None)
            if stats is not None:
                shards.append(stats())
        if not shards:
            return {}
        return {
            "bytes_appended": sum(s["bytes_appended"] for s in shards),
            "fsyncs": sum(s["fsyncs"] for s in shards),
            "compactions": sum(s["compactions"] for s in shards),
            "salvages": sum(s["salvages"] for s in shards),
            "fsync_policy": shards[0]["fsync_policy"],
            "append_p99_ms": max(s["append_p99_ms"] for s in shards),
            "degraded": any(s["degraded"] for s in shards),
            "per_shard_chain_heads": [s["chain_head"] for s in shards],
        }
