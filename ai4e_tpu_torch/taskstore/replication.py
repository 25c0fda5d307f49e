"""Control-plane replication — ``ai4e_tpu/taskstore/replication.py``:
journal streaming, follower sync, failover and fencing.

- the primary's HTTP surface streams its journal
  (``GET /v1/taskstore/journal?offset=&generation=&wait=&epoch=``,
  ``http.py``);
- ``JournalReplicator`` tails that stream into a ``FollowerTaskStore`` on
  the standby, a long poll behind the primary; a generation change (the
  primary compacted) or a line that fails verification resyncs it from
  offset 0;
- ``FailoverWatchdog`` probes the primary and, after ``down_after``
  failed probes in a row, promotes the follower, but only once it has
  caught up at least once: a standby that never synced holds no state
  worth crowning;
- ``FencingProber`` runs on the promoted standby: it knocks on the old
  primary's ``/v1/taskstore/role`` and demotes it (with the new primary's
  URL, so it rejoins as a follower) whenever it claims primary on an older
  epoch.

Replication is asynchronous: on failover the standby may lack the last
poll's records. Those tasks answer 404 on the standby and their clients
create them again; a record is absorbed whole or not at all.
"""

from __future__ import annotations

import asyncio
import logging

import aiohttp

from ..metrics import DEFAULT_REGISTRY
from ..utils.http import SessionHolder
from .journal import JournalCorruptError
from .store import FollowerTaskStore

log = logging.getLogger("ai4e_tpu_torch.taskstore.replication")

JOURNAL_PATH = "/v1/taskstore/journal"


def split_complete_lines(buffer: bytes) -> tuple[list[str], bytes]:
    """Split a journal-stream buffer into the complete lines it holds and
    the unterminated remainder: a record is absorbed whole or not at all,
    so a chunk boundary mid-record never half-applies."""
    consumed = buffer.rfind(b"\n") + 1
    if not consumed:
        return [], buffer
    return buffer[:consumed].decode("utf-8").splitlines(), buffer[consumed:]


class JournalReplicator:
    """Tail the primary's journal stream into a ``FollowerTaskStore``.

    On (re)connect the follower is reset and resynced from offset 0: the
    primary may have compacted while we were away (generation mismatch),
    and local restart-compaction means our own byte count never equals the
    primary's offset — a full resync is always correct, and the journal is
    control-plane sized (it compacts to one record per live task). While
    the primary is unreachable the follower simply holds its last state —
    promotable at any moment.
    """

    def __init__(self, store: FollowerTaskStore, primary_url: str,
                 poll_wait: float = 10.0, api_key: str | None = None,
                 chunk_limit: int = 4 * 1024 * 1024, metrics=None):
        self.store = store
        self.primary_url = primary_url.rstrip("/")
        self.poll_wait = poll_wait
        self.chunk_limit = chunk_limit
        # The assembly passes its registry; standalone, the process one.
        metrics = metrics or DEFAULT_REGISTRY
        self._offset_gauge = metrics.gauge(
            "ai4e_replication_offset_bytes",
            "Journal bytes this follower has absorbed")
        self._lag_gauge = metrics.gauge(
            "ai4e_replication_lag_bytes",
            "Primary journal bytes not yet absorbed (0 = caught up)")
        headers = ({"Ocp-Apim-Subscription-Key": api_key}
                   if api_key else None)
        self._sessions = SessionHolder(headers=headers)
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()
        # Exposed for tests/metrics: bytes applied and the primary's
        # generation we are tracking. -1 = never connected.
        self.offset = 0
        self.generation = -1
        # Set once CAUGHT UP — offset reached the primary's journal size
        # for the current generation. Merely completing one poll is not
        # enough: the initial snapshot can span many chunk_limit-sized
        # polls, and the watchdog must not arm promotion on a follower
        # holding an arbitrary snapshot prefix.
        self.synced = asyncio.Event()

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopped.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001; ai4e: noqa[AIL005] — awaiting our own cancelled loop; the outcome is irrelevant at teardown
                pass
            self._task = None

    async def _run(self) -> None:
        buffer = b""
        backoff = 0.5
        while not self._stopped.is_set():
            try:
                session = await self._sessions.get()
                params = {"offset": str(self.offset),
                          "generation": str(self.generation),
                          "wait": str(self.poll_wait),
                          "limit": str(self.chunk_limit),
                          # Fencing evidence: if we outlived a failover and
                          # are polling a deposed primary, our higher epoch
                          # demotes it (http.py journal_stream).
                          "epoch": str(self.store.epoch)}
                async with session.get(
                        self.primary_url + JOURNAL_PATH, params=params,
                        timeout=aiohttp.ClientTimeout(
                            total=self.poll_wait + 30)) as resp:
                    if resp.status != 200:
                        raise aiohttp.ClientError(
                            f"journal stream returned {resp.status}")
                    gen = int(resp.headers.get("X-Journal-Generation", "0"))
                    served_from = int(resp.headers.get(
                        "X-Journal-Offset", str(self.offset)))
                    size = int(resp.headers.get("X-Journal-Size", "0"))
                    chunk = await resp.read()
                if gen != self.generation or served_from != self.offset:
                    # Generation change (primary compacted) or first
                    # connect: full resync from the snapshot at offset 0.
                    # A follower mid-resync holds an arbitrary snapshot
                    # prefix — it is NOT a legal promotion target until it
                    # catches up again, even if it was fully synced on the
                    # previous generation.
                    self.synced.clear()
                    if self.generation != -1:
                        log.info("journal generation %s -> %s; resyncing",
                                 self.generation, gen)
                    self.store.reset()
                    buffer = b""
                    self.generation = gen
                    self.offset = served_from
                    if served_from != 0:
                        # Server always restarts mismatched readers at 0;
                        # anything else is a contract violation.
                        raise aiohttp.ClientError(
                            f"journal reset served from offset {served_from}")
                if chunk:
                    lines, buffer = split_complete_lines(buffer + chunk)
                    if lines:
                        # Absorb off the event loop: applying a large resync
                        # chunk is file+dict work that must not stall the
                        # replica's serving loop.
                        await asyncio.to_thread(self.store.absorb_lines, lines)
                    self.offset += len(chunk)
                if self.offset >= size:
                    # Caught up to the primary's journal as of this poll —
                    # only now is this follower a safe promotion target.
                    self.synced.set()
                self._offset_gauge.set(float(self.offset))
                self._lag_gauge.set(float(max(0, size - self.offset)))
                backoff = 0.5
            except asyncio.CancelledError:
                raise
            except JournalCorruptError as exc:
                # A streamed line failed checksum/chain verification
                # (store.absorb_lines): the verified prefix applied;
                # NEVER absorb the bad line silently. Force the
                # generation-mismatch resync path — reset + re-read from
                # offset 0 of the primary's file; transient stream
                # corruption heals on the re-read, persistent primary
                # disk corruption keeps failing loudly here until the
                # primary's own boot-salvage/quarantine (or its next
                # compaction rewrite) repairs the file.
                log.error("journal stream from %s failed VERIFICATION "
                          "(%s); forcing full resync", self.primary_url,
                          exc)
                self.synced.clear()
                self.generation = -1
                buffer = b""
                try:
                    await asyncio.wait_for(self._stopped.wait(), backoff)
                except asyncio.TimeoutError:
                    pass
                backoff = min(backoff * 2, 10.0)
            except Exception as exc:  # noqa: BLE001 — keep tailing through outages
                log.warning("journal stream from %s failed (%s); retrying",
                            self.primary_url, exc)
                self.generation = -1  # force clean resync on reconnect
                try:
                    await asyncio.wait_for(self._stopped.wait(), backoff)
                except asyncio.TimeoutError:
                    pass
                backoff = min(backoff * 2, 10.0)

    async def aclose(self) -> None:
        await self.stop()
        await self._sessions.close()


class FailoverWatchdog:
    """Promote the follower when the primary stops answering.

    Probes ``GET {primary}/v1/taskstore/journal?offset=0&wait=0`` every
    ``interval`` seconds; after ``down_after`` consecutive failures it stops
    replication, promotes the store, and fires ``on_promote`` (the host
    re-seeds dispatch from ``unfinished_tasks()``).
    """

    def __init__(self, replicator: JournalReplicator,
                 interval: float = 2.0, down_after: int = 3,
                 on_promote=None):
        self.replicator = replicator
        self.interval = interval
        self.down_after = down_after
        self.on_promote = on_promote
        self.promoted = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopped.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001; ai4e: noqa[AIL005] — awaiting our own cancelled loop; the outcome is irrelevant at teardown
                pass
            self._task = None

    async def _probe(self) -> bool:
        try:
            session = await self.replicator._sessions.get()
            async with session.get(
                    self.replicator.primary_url + JOURNAL_PATH,
                    params={"offset": "0", "wait": "0", "limit": "1"},
                    timeout=aiohttp.ClientTimeout(total=5.0)) as resp:
                return resp.status == 200
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            return False

    async def _run(self) -> None:
        failures = 0
        while not self._stopped.is_set():
            try:
                await asyncio.wait_for(self._stopped.wait(), self.interval)
                return
            except asyncio.TimeoutError:
                pass
            if not self.replicator.synced.is_set():
                # Never synced since boot: promoting would crown an EMPTY
                # store (e.g. both replicas rolling, standby ready first —
                # the primary being briefly unreachable at our boot is not
                # a failover). Wait for one full sync before arming.
                continue
            if await self._probe():
                failures = 0
                continue
            failures += 1
            if failures < self.down_after:
                continue
            log.warning("primary %s down after %d probes; promoting follower",
                        self.replicator.primary_url, failures)
            await self.replicator.stop()
            self.replicator.store.promote()
            if self.on_promote is not None:
                res = self.on_promote()
                if asyncio.iscoroutine(res):
                    await res
            self.promoted.set()
            return


class FencingProber:
    """Actively fence the deposed primary after a promotion.

    Passive fencing (clients echoing ``X-Store-Epoch``) closes the
    split-brain window only when fencing evidence happens to reach the old
    primary; this prober closes it deterministically: it polls the peer's
    ``/v1/taskstore/role`` and, whenever the peer claims ``primary`` with
    an epoch older than ours, POSTs ``/v1/taskstore/demote`` with our epoch
    (and ``advertise_url``, so the peer's platform rejoins us as a follower
    automatically — ``platform_assembly.demote_now``). It keeps running for
    the life of the primary: a deposed peer that REBOOTS as primary from
    stale config is re-fenced on the next probe."""

    def __init__(self, store, peer_url: str, advertise_url: str | None = None,
                 api_key: str | None = None, interval: float = 2.0):
        self.store = store
        self.peer_url = peer_url.rstrip("/")
        self.advertise_url = advertise_url
        self.interval = interval
        headers = ({"Ocp-Apim-Subscription-Key": api_key}
                   if api_key else None)
        self._sessions = SessionHolder(headers=headers)
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()
        self.fenced = asyncio.Event()  # set each time a demote lands

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopped.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001; ai4e: noqa[AIL005] — awaiting our own cancelled loop; the outcome is irrelevant at teardown
                pass
            self._task = None

    async def aclose(self) -> None:
        await self.stop()
        await self._sessions.close()

    async def _probe_once(self) -> None:
        session = await self._sessions.get()
        timeout = aiohttp.ClientTimeout(total=5.0)
        async with session.get(self.peer_url + "/v1/taskstore/role",
                               timeout=timeout) as resp:
            if resp.status != 200:
                return
            peer = await resp.json()
        peer_epoch = int(peer.get("epoch", 0))
        # Two reasons to knock: the peer still claims primary on a stale
        # epoch (fence it), or it was already fenced — e.g. passively, by a
        # client's epoch header — but has no replication feed yet (nudge it
        # to rejoin us; only meaningful when it runs a platform lifecycle
        # and we have a URL to offer).
        needs_fence = (peer.get("role") == "primary"
                       and peer_epoch < self.store.epoch)
        needs_rejoin = (peer.get("role") == "follower"
                        and peer.get("replicating") is False
                        and self.advertise_url is not None
                        and peer_epoch <= self.store.epoch)
        if not (needs_fence or needs_rejoin):
            return
        payload = {"epoch": self.store.epoch}
        if self.advertise_url:
            payload["primary_url"] = self.advertise_url
        if needs_fence:
            log.warning("peer %s still claims primary at epoch %s; fencing "
                        "with epoch %s", self.peer_url, peer_epoch,
                        self.store.epoch)
        async with session.post(self.peer_url + "/v1/taskstore/demote",
                                json=payload, timeout=timeout) as resp:
            if resp.status == 200:
                self.fenced.set()
            elif resp.status == 409:
                # StaleEpochError from the peer: OUR epoch is not newer —
                # this prober is the stale side of the split. Do not keep
                # knocking as if the peer were merely unreachable; the
                # next role probe will show the real epoch and stand down.
                log.warning(
                    "peer %s refused demotion (409): our epoch %s is the "
                    "stale side", self.peer_url, self.store.epoch)

    async def _run(self) -> None:
        while not self._stopped.is_set():
            try:
                await self._probe_once()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — peer unreachable is the normal case
                # Debug, not warning: while the peer is partitioned/down this
                # fires every probe interval for as long as the outage lasts —
                # but the evidence must exist somewhere when fencing is the
                # thing being debugged (AIL005).
                log.debug("fencing probe of %s failed: %s", self.peer_url, exc)
            try:
                await asyncio.wait_for(self._stopped.wait(), self.interval)
                return
            except asyncio.TimeoutError:
                pass
