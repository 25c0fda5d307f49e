"""One shard's store PROCESS — journaled primary or wire-tailing replica;
a copy of ``ai4e_tpu/rig/storenode.py``.

This is the role the single-process ``ShardGroup`` becomes when the shard
boundary is a socket (docs/deployment.md). Each store node serves:

- the full task-store HTTP surface (``taskstore/http.py`` — upsert/update/
  task/result + the journal-stream replication surface), so gateways,
  dispatchers, workers and wire replicas all speak the contracts that
  already exist;
- ``GET  /v1/rig/feed``  — ndjson stream of this node's terminal task
  transitions (the wire form of ``ShardChangeFeed``; gateways tail it so a
  replica that did not admit a task still wakes its long-poll);
- ``GET  /v1/rig/slots`` — this node's slot-fence table (``{"fenced":
  {slot: owner|null}}``), what ring clients re-fetch after a 409
  ``X-Not-Owner``;
- ``POST /v1/rig/slots`` — fence propagation (the move driver tells
  sibling nodes about a flip so a later-promoted replica owns the right
  keyspace);
- ``POST /v1/rig/broker/pop`` / ``POST /v1/rig/broker/done`` — the wire
  broker surface dispatcher processes lease from (the queue itself lives
  HERE, beside the store whose publisher feeds it — a lease dies with the
  leasing dispatcher and redelivers server-side);
- ``POST /v1/rig/move_slot`` / ``POST /v1/rig/import`` — the live
  cross-process rebalance. Unlike the in-process ``move_slot`` (delta
  handoff under the source lock), the wire form fences the slot FIRST
  (writes 409 for the copy window — ring clients back off and retry),
  copies, then flips: a brief unavailability window instead of a
  two-shard lock nest, stated in docs/deployment.md.

A **replica** node tails its primary's journal stream with the wire-mode
``ShardReplicaLink`` and runs a watchdog: once the stream has been
unreachable for ``rig_watchdog_s``, it drains the primary's journal FILE
(the shard's durable truth — ``absorb_journal_file``), promotes itself
(minting the next fencing epoch), and re-seeds its broker from
``unfinished_tasks()`` exactly as a restarted platform does. Store
clients re-home onto it via the replica-rotation contract they already
implement.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time

from aiohttp import web

from ..broker.queue import InMemoryBroker, Message
from ..metrics import MetricsRegistry
from ..taskstore import TaskNotFound, TaskStatus
from ..taskstore.http import make_app
from ..taskstore.journal import JournalCorruptError
from ..taskstore.sharding import (ShardReplicaLink, absorb_journal_file,
                                  stable_hash)
from ..taskstore.store import FollowerTaskStore
from .topology import Topology
from .wire import BROKER_DONE_PATH, BROKER_POP_PATH, FEED_PATH, SLOTS_PATH

log = logging.getLogger("ai4e_tpu_torch.rig.storenode")

MOVE_SLOT_PATH = "/v1/rig/move_slot"
IMPORT_PATH = "/v1/rig/import"
LEDGERS_PATH = "/v1/rig/ledgers"


class SlotFence:
    """This node's view of slot ownership — the write fence and the
    ``/v1/rig/slots`` body. ``owned`` starts from the topology's static
    assignment; a live move flips entries and records them in ``fenced``
    (owner None = the copy window) for ring clients to re-fetch."""

    def __init__(self, topo: Topology, shard: int):
        self.shard = shard
        self.slots = topo.slots
        self.owned = {s for s in range(topo.slots)
                      if s % topo.shards == shard}
        self.fenced: dict[int, int | None] = {}

    def slot_for(self, task_id: str) -> int:
        return stable_hash(task_id) % self.slots

    def owns(self, task_id: str) -> bool:
        return self.slot_for(task_id) in self.owned

    def set_owner(self, slot: int, owner: int | None) -> None:
        if owner == self.shard:
            self.owned.add(slot)
        else:
            self.owned.discard(slot)
        self.fenced[slot] = owner

    def to_dict(self) -> dict:
        return {"shard": self.shard,
                "owned": sorted(self.owned),
                "fenced": {str(s): o for s, o in self.fenced.items()}}


class _FeedStream:
    """Terminal-transition fan-out to wire subscribers. The store listener
    may fire from any thread (absorb runs in an executor); events cross
    to each subscriber's queue via ``call_soon_threadsafe``."""

    def __init__(self):
        self._subs: set[asyncio.Queue] = set()
        self._loop: asyncio.AbstractEventLoop | None = None

    def bind_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop

    def on_task(self, task) -> None:
        if task.canonical_status not in TaskStatus.TERMINAL:
            return
        loop = self._loop
        if loop is None or not self._subs:
            return
        line = (json.dumps(task.to_dict()) + "\n").encode("utf-8")

        def fan_out() -> None:
            for q in list(self._subs):
                q.put_nowait(line)

        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if loop is running:
            fan_out()
        else:
            try:
                loop.call_soon_threadsafe(fan_out)
            except RuntimeError:
                pass  # loop closed mid-teardown — subscribers are gone too

    async def serve(self, request: web.Request) -> web.StreamResponse:
        resp = web.StreamResponse(
            headers={"Content-Type": "application/x-ndjson"})
        await resp.prepare(request)
        q: asyncio.Queue = asyncio.Queue()
        self._subs.add(q)
        try:
            while True:
                try:
                    line = await asyncio.wait_for(q.get(), 5.0)
                except asyncio.TimeoutError:
                    line = b"{}\n"  # heartbeat keeps the tail's read alive
                await resp.write(line)
        except ConnectionResetError:
            return resp  # tail went away (gateway kill/rotation) — normal
        except asyncio.CancelledError:
            raise
        finally:
            self._subs.discard(q)


class _PrimaryGatedStore:
    """The store as the observability hub sees it: listener callbacks
    fire only while this node is the shard's PRIMARY. A replica's store
    fires the same listeners while ABSORBING the primary's stream — and
    the primary already counted those transitions in ITS registry, so an
    ungated hub would double-count every terminal outcome fleet-wide
    once per replica (the conservation cross-check's exact failure
    mode). The tail between the dead primary's last scrape and a
    promotion is honestly LOST from the fleet counters — documented in
    docs/deployment.md; the journal-based verdict stays authoritative.
    Everything except ``add_listener`` passes through untouched."""

    def __init__(self, store):
        self._store = store

    def add_listener(self, callback) -> None:
        def gated(task) -> None:
            if self._store.role == "primary":
                callback(task)

        self._store.add_listener(gated)

    def __getattr__(self, name):
        return getattr(self._store, name)


class StoreNode:
    def __init__(self, topo: Topology, shard: int, index: int):
        """``index`` -1 = the shard's primary; >= 0 = replica ``index``."""
        self.topo = topo
        self.shard = shard
        self.index = index
        self.is_replica = index >= 0
        self.metrics = MetricsRegistry()
        self.fence = SlotFence(topo, shard)
        path = (topo.replica_journal_path(shard, index) if self.is_replica
                else topo.journal_path(shard))
        # compact_every is huge ON PURPOSE: the journal is the run's full
        # transition history — the verdict's duplicate-terminal scan and
        # epoch-monotonicity check read it after the run, and a compaction
        # rewrite (one record per task) would erase exactly the evidence
        # the rig exists to record (docs/deployment.md).
        self.store = FollowerTaskStore(
            path, start_as_primary=not self.is_replica,
            compact_every=int(self.topo.extra.get("compact_every",
                                                  50_000_000)),
            metrics=self.metrics)
        self.store.set_write_fence(self.fence.owns)
        fair = None
        if topo.tenants:
            # Weighted-fair lanes (tenancy/lanes.py) on THIS shard's
            # queue: the upsert's Tenant field rode the wire with the
            # record, so the publisher stamps each message's lane and the
            # DRR dequeue holds the weight ratio inside the shard —
            # exactly where the backlog lives in the rig.
            from ..tenancy import Tenancy
            fair = Tenancy.from_spec(topo.tenants).lanes
        self.broker = InMemoryBroker(
            max_delivery_count=int(topo.extra.get("max_delivery_count", 20)),
            lease_seconds=topo.lease_seconds, metrics=self.metrics,
            fair=fair)
        self.broker.register_queue(self._route_path())
        self.broker.set_dead_letter_handler(self._dead_letter)
        self.store.set_publisher(self.broker.publish)
        self.feed = _FeedStream()
        self.store.add_listener(self.feed.on_task)
        self.flight = None
        self.observability = None
        if topo.observability:
            # The record-owning half of the observability plane: the
            # hub's store listener stamps `completed` onto each
            # timeline, observes created→terminal e2e latency, counts
            # ai4e_request_outcomes_total (the conservation check's
            # terminal side), and keeps this shard's flight-recorder
            # ring — all primary-gated so replica absorption never
            # double-counts (see _PrimaryGatedStore).
            from ..observability.flight import FlightRecorder
            from ..observability.hub import RequestObservability
            self.flight = FlightRecorder(capacity=256,
                                         metrics=self.metrics)
            self.observability = RequestObservability(
                _PrimaryGatedStore(self.store), metrics=self.metrics,
                flight=self.flight)
        self.link: ShardReplicaLink | None = None
        if self.is_replica:
            self.link = ShardReplicaLink(
                None, self.store,
                primary_url=topo.shard_urls(shard)[0],
                wire_timeout=5.0)
        self._watchdog_task: asyncio.Task | None = None
        self._leased: dict[tuple[str, int], Message] = {}
        self._m_promotions = self.metrics.counter(
            "ai4e_rig_promotions_total",
            "Replica self-promotions after a primary watchdog trip")
        self._m_moves = self.metrics.counter(
            "ai4e_rig_slot_moves_total",
            "Live slot moves this node participated in, by side")

    def _route_path(self) -> str:
        from ..taskstore import endpoint_path
        return endpoint_path(self.topo.route)

    def _dead_letter(self, msg: Message) -> None:
        # Conditional: a dead-letter racing a late completion must not
        # clobber the terminal status the client may already have read
        # (AIL003 — the same guard every dispatcher path applies).
        self.store.update_status_if(msg.task_id, TaskStatus.CREATED,
                                    TaskStatus.DEAD_LETTER,
                                    TaskStatus.FAILED)

    # -- rig HTTP surface ---------------------------------------------------

    def build_app(self) -> web.Application:
        app = web.Application(client_max_size=64 * 1024 * 1024)
        make_app(self.store, app=app)
        app.router.add_get(FEED_PATH, self.feed.serve)
        app.router.add_get(SLOTS_PATH, self._get_slots)
        app.router.add_post(SLOTS_PATH, self._set_slot)
        app.router.add_post(BROKER_POP_PATH, self._broker_pop)
        app.router.add_post(BROKER_DONE_PATH, self._broker_done)
        app.router.add_post(MOVE_SLOT_PATH, self._move_slot)
        app.router.add_post(IMPORT_PATH, self._import_records)
        app.router.add_get(LEDGERS_PATH, self._dump_ledgers)
        app.router.add_get("/v1/debug/flight", self._flight_dump)
        app.router.add_get("/healthz", self._health)
        app.router.add_get("/metrics", self._metrics)
        from .nodevitals import attach_vitals
        attach_vitals(app, self.topo, self.metrics)
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        return app

    async def _on_startup(self, _app) -> None:
        loop = asyncio.get_running_loop()
        self.broker.bind_loop(loop)
        self.feed.bind_loop(loop)
        if self.is_replica:
            self._watchdog_task = loop.create_task(self._tail_and_watch())

    async def _on_cleanup(self, _app) -> None:
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
            try:
                await self._watchdog_task
            except asyncio.CancelledError:
                pass
        self.store.close()

    async def _health(self, _: web.Request) -> web.Response:
        return web.json_response(
            {"status": "healthy", "shard": self.shard,
             "role": self.store.role, "epoch": self.store.epoch})

    async def _metrics(self, _: web.Request) -> web.Response:
        return web.Response(text=self.metrics.render_prometheus(),
                            content_type="text/plain")

    async def _get_slots(self, _: web.Request) -> web.Response:
        return web.json_response(self.fence.to_dict())

    async def _dump_ledgers(self, request: web.Request) -> web.Response:
        """Every resident hop-ledger timeline (bounded) — the driver's
        pre-teardown sweep for the Perfetto timeline export: the ledgers
        are memory-only and die with this process."""
        try:
            limit = int(request.query.get("limit", "5000"))
        except ValueError:
            return web.json_response({"error": "bad limit"}, status=400)
        ledgers = self.store.dump_ledgers(limit=limit)
        return web.json_response({"Shard": self.shard,
                                  "Ledgers": ledgers,
                                  "count": len(ledgers)})

    async def _flight_dump(self, _: web.Request) -> web.Response:
        if self.flight is None:
            return web.json_response(
                {"error": "observability off"}, status=404)
        return web.json_response(self.flight.dump())

    async def _set_slot(self, request: web.Request) -> web.Response:
        """Fence propagation: the move driver (or the source node) flips a
        sibling's table after a live move, so a replica promoted LATER
        owns the moved keyspace correctly."""
        try:
            payload = json.loads(await request.read() or b"{}")
            slot = int(payload["slot"])
            owner = payload["owner"]
            owner = None if owner is None else int(owner)
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            return web.json_response({"error": "slot and owner required"},
                                     status=400)
        # Under the store lock: a mutation mid-flight has either passed the
        # fence (and lands before the flip) or re-checks after it — no
        # half-fenced write (the in-process move_slot holds the same lock
        # around its ring flip for the same reason).
        with self.store._lock:
            self.fence.set_owner(slot, owner)
        return web.json_response({"ok": True})

    # -- wire broker --------------------------------------------------------

    async def _broker_pop(self, request: web.Request) -> web.Response:
        try:
            payload = json.loads(await request.read() or b"{}")
            queue = payload.get("queue") or self._route_path()
            wait = min(float(payload.get("wait", 0.0)), 30.0)
        except (json.JSONDecodeError, TypeError, ValueError):
            return web.json_response({"error": "bad pop body"}, status=400)
        if self.store.role != "primary":
            return web.Response(status=204)  # nothing to lease on a follower
        msg = await self.broker.receive(queue, timeout=wait or 0.05)
        if msg is None:
            return web.Response(status=204)
        self._leased[(queue, msg.seq)] = msg
        return web.json_response({
            "TaskId": msg.task_id, "Endpoint": msg.endpoint,
            "BodyHex": msg.body.hex(), "ContentType": msg.content_type,
            "EnqueuedAt": msg.enqueued_at,
            "DeliveryCount": msg.delivery_count, "Seq": msg.seq,
            "LeaseExpires": msg.lease_expires, "Queue": msg.queue_name,
            "CacheKey": msg.cache_key, "DeadlineAt": msg.deadline_at,
            "Priority": msg.priority, "Tenant": msg.tenant})

    async def _broker_done(self, request: web.Request) -> web.Response:
        try:
            payload = json.loads(await request.read() or b"{}")
            queue = payload.get("queue") or self._route_path()
            seq = int(payload["seq"])
            outcome = payload.get("outcome", "complete")
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            return web.json_response({"error": "bad done body"}, status=400)
        msg = self._leased.pop((queue, seq), None)
        if msg is None:
            # Lease state died with a previous primary, or the reaper
            # already redelivered: the no-op IS the contract — duplicate
            # suppression absorbs the redelivery.
            return web.json_response({"ok": False, "reason": "unknown seq"})
        if outcome == "abandon":
            self.broker.abandon(msg)
        else:
            self.broker.complete(msg)
        return web.json_response({"ok": True})

    # -- live rebalance (wire move_slot) ------------------------------------

    async def _move_slot(self, request: web.Request) -> web.Response:
        """Move one slot's keyspace to another shard, cross-process.
        Sequence: fence (writes 409 for the window), export, import on
        the destination (rotating across its node URLs — its primary may
        be a promoted replica), flip + forget, propagate the flip to
        every sibling node. Failure before the flip rolls the fence back."""
        try:
            payload = json.loads(await request.read() or b"{}")
            slot = int(payload["slot"])
            dest = int(payload["dest"])
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            return web.json_response({"error": "slot and dest required"},
                                     status=400)
        if self.store.role != "primary":
            return web.json_response({"error": "not primary"}, status=503,  # ai4e: noqa[AIL015] — X-Not-Primary is a rotate marker: the wire client tries the next node NOW, waiting would be wrong
                                     headers={"X-Not-Primary": "1"})
        if slot not in self.fence.owned:
            return web.json_response(
                {"error": f"slot {slot} is not owned here"}, status=409)
        if not 0 <= dest < self.topo.shards or dest == self.shard:
            return web.json_response({"error": "bad dest"}, status=400)
        with self.store._lock:
            self.fence.set_owner(slot, None)  # copy window: writes 409
        try:
            ids = [tid for tid in list(self.store._tasks)
                   if self.fence.slot_for(tid) == slot]
            recs = self.store.export_task_records(ids)
            imported = await self._post_import(dest, slot, recs)
        except Exception as exc:  # noqa: BLE001 — roll the fence back; the slot must not stay ownerless
            with self.store._lock:
                self.fence.set_owner(slot, self.shard)
            log.exception("move of slot %d to shard %d failed; fence "
                          "rolled back", slot, dest)
            return web.json_response({"error": f"import failed: {exc}"},
                                     status=502)
        with self.store._lock:
            self.fence.set_owner(slot, dest)
        self.store.forget_tasks(ids)
        self._m_moves.inc(side="source")
        await self._propagate_fence(slot, dest)
        log.info("moved slot %d -> shard %d (%d tasks, %d records)",
                 slot, dest, len(ids), imported)
        return web.json_response({"ok": True, "moved": len(ids),
                                  "records": imported})

    async def _post_import(self, dest: int, slot: int,
                           recs: list[dict]) -> int:
        import aiohttp
        body = json.dumps({"slot": slot, "records": recs})
        last: Exception | None = None
        async with aiohttp.ClientSession() as session:
            for base in self.topo.shard_urls(dest):
                try:
                    async with session.post(
                            base + IMPORT_PATH, data=body,
                            timeout=aiohttp.ClientTimeout(total=30)) as resp:
                        if resp.status == 503:
                            continue  # follower — try the next node
                        payload = await resp.json()
                        if resp.status != 200:
                            raise RuntimeError(
                                f"import answered {resp.status}: {payload}")
                        return int(payload.get("applied", 0))
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError) as exc:
                    last = exc
                    continue
        raise RuntimeError(f"no destination node accepted the import "
                           f"({last!r})")

    async def _import_records(self, request: web.Request) -> web.Response:
        try:
            payload = json.loads(await request.read() or b"{}")
            slot = int(payload["slot"])
            recs = payload.get("records", [])
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            return web.json_response({"error": "bad import body"},
                                     status=400)
        if self.store.role != "primary":
            return web.json_response({"error": "not primary"}, status=503,  # ai4e: noqa[AIL015] — X-Not-Primary is a rotate marker: the wire client tries the next node NOW, waiting would be wrong
                                     headers={"X-Not-Primary": "1"})
        applied = self.store.import_task_records(recs)
        with self.store._lock:
            self.fence.set_owner(slot, self.shard)
        # Transport responsibility moves WITH the keyspace: in-process the
        # old shard's sub-queue outlives the move, but here the source's
        # broker dies with its process — an imported non-terminal task
        # whose only message lived there would be stranded. Republish on
        # OUR broker; if the source's message still drains too, that is
        # one duplicate delivery and duplicate suppression's job.
        republished = 0
        for rec in recs:
            tid = rec.get("TaskId", "")
            if not tid or rec.get("Result") or rec.get("Evict"):
                continue
            try:
                task = self.store.get(tid)
            except TaskNotFound:
                continue
            if task.canonical_status not in TaskStatus.TERMINAL:
                self.broker.publish(task)
                republished += 1
        self._m_moves.inc(side="dest")
        return web.json_response({"ok": True, "applied": applied,
                                  "republished": republished})

    async def _propagate_fence(self, slot: int, owner: int) -> None:
        """Best-effort fence flip on every sibling node of both shards —
        a replica promoted after this move must own the right range. A
        node that is down simply misses it (it also missed the records;
        the residual is documented in docs/deployment.md)."""
        import aiohttp
        port = (self.topo.replica_port(self.shard, self.index)
                if self.is_replica else self.topo.shard_port(self.shard))
        my_url = f"http://{self.topo.host}:{port}"
        targets = []
        for s in {self.shard, owner}:
            targets.extend(self.topo.shard_urls(s))
        body = json.dumps({"slot": slot, "owner": owner})
        async with aiohttp.ClientSession() as session:
            for base in targets:
                if base == my_url:
                    continue
                try:
                    async with session.post(
                            base + SLOTS_PATH, data=body,
                            timeout=aiohttp.ClientTimeout(total=5)):
                        pass
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError) as exc:  # best-effort propagation; a dead sibling missed the records too and the residual is documented
                    log.debug("fence propagation to %s failed: %s",
                              base, exc)

    # -- replica tail + watchdog self-promotion -----------------------------

    async def _tail_and_watch(self) -> None:
        """Wire journal tail with a down-detector: ``rig_watchdog_s`` of
        consecutive unreachable polls → the primary is presumed dead →
        drain its journal FILE and promote."""
        # Staggered succession: replica r waits one extra watchdog period
        # per index, and probes its elders before promoting — so N
        # replicas of one shard cannot double-promote into a split brain
        # (the in-process ``_fail_over`` gets this for free by popping one
        # link under a lock; across processes the stagger + probe is the
        # ordering).
        watchdog_s = (float(self.topo.extra.get("watchdog_s", 2.0))
                      * (self.index + 1))
        interval = float(self.topo.extra.get("tail_interval", 0.2))
        down_since: float | None = None
        while True:
            try:
                await asyncio.to_thread(self.link.sync_once)
                down_since = None
            except asyncio.CancelledError:
                raise
            except OSError as exc:
                now = time.monotonic()
                if down_since is None:
                    down_since = now
                    log.warning("shard %d replica %d: primary stream "
                                "unreachable (%s); watchdog armed",
                                self.shard, self.index, exc)
                elif now - down_since >= watchdog_s:
                    if await self._primary_alive():
                        # Starved, not dead: the r13 observability plane
                        # caught the rig's primaries at 1.7 s+ event-loop
                        # lag under saturation — enough for the stream
                        # tail to time out past watchdog_s while the
                        # primary still serves. Promoting then is a
                        # SPLIT BRAIN (two writers, mass task loss — a
                        # red r13 take recorded exactly that). A
                        # SIGKILLed primary refuses the probe instantly,
                        # so real failover pays ~one RTT; a wedged-but-
                        # listening one delays failover by at most the
                        # probe timeout per watchdog period
                        # (docs/deployment.md residual).
                        log.warning(
                            "shard %d replica %d: primary stream dark "
                            "%.1fs but /healthz still answers — starved,"
                            " not dead; watchdog re-armed",
                            self.shard, self.index, now - down_since)
                        down_since = None
                    else:
                        await self._promote()
                        return
            except RuntimeError:
                return  # promoted out from under the tail (absorb refused)
            except Exception:  # noqa: BLE001 — keep tailing through transient absorb errors
                log.exception("shard %d replica %d: tail failed; retrying",
                              self.shard, self.index)
            await asyncio.sleep(interval)

    async def _primary_alive(self) -> bool:
        """Last-chance liveness probe before self-promotion: does the
        primary still answer ``/healthz`` as a primary, given a generous
        timeout? Distinguishes dead (connection refused — promote now)
        from starved (late 200 — re-arm)."""
        import aiohttp
        timeout = float(self.topo.extra.get("promote_probe_timeout_s",
                                            10.0))
        try:
            async with aiohttp.ClientSession() as session:
                async with session.get(
                        self.link.primary_url + "/healthz",
                        timeout=aiohttp.ClientTimeout(
                            total=timeout)) as resp:
                    if resp.status != 200:
                        return False
                    payload = await resp.json()
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                ValueError):
            return False
        # A deposed/demoted holdover answering as a follower is not a
        # live primary — promotion should proceed.
        return payload.get("role") == "primary"

    async def _promote(self) -> None:
        """The failover: drain the dead primary's journal file (durable
        truth — every acknowledged write is in it), promote (minting the
        next fencing epoch), re-seed the broker from unfinished tasks —
        the exact sequence the in-process ``_fail_over`` runs, with the
        file drain standing in for the unreachable stream."""
        elder = await self._find_promoted_elder()
        if elder is not None:
            # An earlier replica already promoted: re-home the tail onto
            # it instead of minting a competing epoch.
            log.warning("shard %d replica %d: elder replica at %s already "
                        "primary; re-homing the tail", self.shard,
                        self.index, elder)
            self.link.primary_url = elder
            self.link.generation = -1  # full resync from the new lineage
            loop = asyncio.get_running_loop()
            self._watchdog_task = loop.create_task(self._tail_and_watch())
            return
        primary_journal = self.topo.journal_path(self.shard)
        try:
            lines = await asyncio.to_thread(
                absorb_journal_file, self.store, primary_journal)
        except JournalCorruptError as exc:
            # Park contract: the verified prefix is applied; promote on it
            # rather than leaving the shard writer-less.
            log.error("shard %d replica %d: journal drain hit a corrupt "
                      "record (%s); promoting on the verified prefix",
                      self.shard, self.index, exc)
            lines = -1
        self.store.promote()
        self._m_promotions.inc()
        reseeded = 0
        for task in self.store.unfinished_tasks():
            self.broker.publish(task)
            reseeded += 1
        log.warning(
            "shard %d replica %d PROMOTED at epoch %d (drained %s journal "
            "lines, re-seeded %d unfinished tasks)", self.shard, self.index,
            self.store.epoch, lines, reseeded)

    async def _find_promoted_elder(self) -> str | None:
        """URL of a lower-index replica that already answered
        ``role: primary``, else None. Unreachable elders are skipped —
        they may be dead too; the stagger gives a live one time to claim
        the role first."""
        if self.index == 0:
            return None
        import aiohttp
        async with aiohttp.ClientSession() as session:
            for r in range(self.index):
                base = self.topo.shard_urls(self.shard)[1 + r]
                try:
                    async with session.get(
                            base + "/v1/taskstore/role",
                            timeout=aiohttp.ClientTimeout(total=2)) as resp:
                        if resp.status != 200:
                            continue
                        if (await resp.json()).get("role") == "primary":
                            return base
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError):  # a dead elder is exactly the case the probe exists to rule out; fall through to the next candidate
                    continue
        return None


async def run_storenode(topo: Topology, shard: int, index: int) -> None:
    from .supervisor import serve_until_signal
    node = StoreNode(topo, shard, index)
    port = (topo.replica_port(shard, index) if index >= 0
            else topo.shard_port(shard))
    await serve_until_signal(node.build_app(), topo.host, port)
