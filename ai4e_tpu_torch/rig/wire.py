"""Wire clients the rig's processes share (docs/deployment.md); a copy
of ``ai4e_tpu/rig/wire.py``.

``RingStoreClient`` is the store the gateway replicas hold where the
single-process assembly holds ``InMemoryTaskStore``/``ShardedTaskStore``
— the same consistent-hash routing (``taskstore.sharding.stable_hash``
over a fixed slot table) with every verb crossing the task-store HTTP
surface instead of a method call. Three behaviors make it survive the
chaos vocabulary:

- **replica rotation** (per shard): URL lists are primary-first; connect
  errors and 503 ``X-Not-Primary`` rotate, which re-homes the client
  onto a promoted replica with no reconfiguration (the
  ``_HttpStoreClient`` contract workers already use);
- **slot-fence re-routing**: a mutation answered 409 ``X-Not-Owner``
  (the live ``move_slot`` window) re-fetches the answering node's fence
  table (``GET /v1/rig/slots``), flips the local ring and retries — the
  wire analogue of ``ShardedTaskStore._route``'s ``NotOwnerError``
  re-route, including the owner-unknown copy window (bounded backoff);
- **outcome-checked reads**: a miss (204) from a store that may have
  just handed the slot away re-checks the fence table before standing,
  the wire form of the facade's read fencing.

``WireChangeFeedTail`` tails each shard node's terminal-event stream
(``GET /v1/rig/feed``, ndjson) into ONE local ``ShardChangeFeed`` the
gateway's long-poll parks on — so a gateway replica that did not admit a
task still wakes with the record, and a task that migrates shards
mid-wait wakes from whichever node's stream carries the event.

``WireBroker`` gives a dispatcher PROCESS the broker surface
``broker.Dispatcher`` consumes — pop (lease) over HTTP, completion/
abandon acknowledged fire-and-forget: a lost ack simply lets the lease
expire on the shard node, whose redelivery the dispatcher's duplicate
suppression already handles; dead-lettering (and its terminal task
write) is server-side, where the delivery budget lives.
"""

from __future__ import annotations

import asyncio
import json
import logging

import aiohttp

from ..broker.queue import Message
from ..service.task_manager import TaskManagerBase, _HttpStoreClient
from ..taskstore import APITask, NotPrimaryError, TaskNotFound, TaskStatus
from ..taskstore.feed import ShardChangeFeed
from ..taskstore.sharding import stable_hash
from ..taskstore.task import new_task_id

log = logging.getLogger("ai4e_tpu_torch.rig.wire")

FEED_PATH = "/v1/rig/feed"
SLOTS_PATH = "/v1/rig/slots"
BROKER_POP_PATH = "/v1/rig/broker/pop"
BROKER_DONE_PATH = "/v1/rig/broker/done"


def _raise_refusal(resp) -> None:
    """Typed refusals the routed transport can still hand back: a plain
    503 is the owning store refusing load (journal-degraded / draining —
    the X-Not-Primary flavor was already rotated inside ``_request``),
    and a 409 carrying X-Not-Owner is a slot fence the ``_routed``
    attempt budget could not resolve. Both map to the standby contract
    (``NotPrimaryError`` → gateway 503 + Retry-After), never a raw 500;
    a bare 409 (conditional-update precondition) passes through."""
    if resp.status == 503:
        after = resp.headers.get("Retry-After")
        raise NotPrimaryError(
            "shard store refused the request"
            + (f" (retry after {after}s)" if after else ""))
    if resp.status == 409 and resp.headers.get("X-Not-Owner"):
        raise NotPrimaryError("slot fence unresolved for routed request")


class RingStoreClient(TaskManagerBase):
    """Ring-routed task-store client over N shard store processes."""

    _ROUTE_ATTEMPTS = 8

    def __init__(self, shard_urls: list[list[str]], slots: int,
                 api_key: str | None = None, feed_recent: int = 4096):
        if not shard_urls:
            raise ValueError("at least one shard URL list is required")
        self.slots = slots
        self._assign = [i % len(shard_urls) for i in range(slots)]
        self._clients = [_HttpStoreClient(urls, api_key=api_key)
                         for urls in shard_urls]
        # One local feed for ALL shards: the long-poll waiter must wake
        # whichever node's stream carries the event — a task that
        # migrated mid-wait publishes on the destination's stream.
        self._feed = ShardChangeFeed(0, recent=feed_recent)
        self._tails: list[asyncio.Task] = []
        self._tail_stop: asyncio.Event | None = None
        # Slots the last fence-table fetch reported owner-less (a live
        # move's copy window): misses inside them are indeterminate and
        # retried rather than stood by (_routed).
        self._ownerless: set[int] = set()

    # -- ring ---------------------------------------------------------------

    def slot_for(self, task_id: str) -> int:
        return stable_hash(task_id) % self.slots

    def shard_for(self, task_id: str) -> int:
        return self._assign[self.slot_for(task_id)]

    async def _refresh_slots(self, shard: int) -> bool:
        """Pull the fence table from ``shard``'s node; returns whether any
        local assignment flipped. Owner-less fences (the copy window) flip
        nothing — the caller backs off and retries."""
        try:
            resp, body = await self._clients[shard]._request(
                "GET", SLOTS_PATH)
            if resp.status != 200:
                return False
            fenced = json.loads(body).get("fenced", {})
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                ValueError) as exc:
            log.debug("slot refresh from shard %d failed: %s", shard, exc)
            return False
        changed = False
        for slot_s, owner in fenced.items():
            try:
                slot = int(slot_s)
            except ValueError:
                continue
            if not 0 <= slot < self.slots:
                continue
            if owner is None:
                self._ownerless.add(slot)
                continue
            self._ownerless.discard(slot)
            if self._assign[slot] != owner:
                self._assign[slot] = int(owner)
                changed = True
        return changed

    async def _routed(self, task_id: str, method: str, path: str,
                      check_miss: bool = False, **kw):
        """One ring-routed store round trip with fence re-routing. With
        ``check_miss``, a miss (204 no-such-task, 404 unknown-task) from
        a store that may have just handed the slot away re-checks the
        fence table once before standing — the wire form of the sharded
        facade's outcome-checked misses: a node that forgot a moved range
        answers "unknown" BEFORE its ownership fence fires, and without
        this re-check a worker completing a moved task against a stale
        ring would take that 404 at face value and strand the task."""
        rechecked = False
        last = None
        for _ in range(self._ROUTE_ATTEMPTS):
            shard = self.shard_for(task_id)
            resp, body = await self._clients[shard]._request(
                method, path, **kw)
            if resp.status == 409 and resp.headers.get("X-Not-Owner"):
                last = resp
                if not await self._refresh_slots(shard):
                    await asyncio.sleep(0.1)  # owner-less copy window
                continue
            if resp.status in (204, 404) and check_miss:
                slot = self.slot_for(task_id)
                if not rechecked:
                    rechecked = True
                    if await self._refresh_slots(shard) \
                            and self.shard_for(task_id) != shard:
                        continue  # the slot moved; the new owner may know it
                if slot in self._ownerless:
                    # Copy window: the range is mid-handoff and a miss is
                    # indeterminate — back off and re-ask until the fence
                    # resolves (bounded by the attempt budget).
                    last = resp
                    await asyncio.sleep(0.1)
                    await self._refresh_slots(shard)
                    continue
            return resp, body
        raise NotPrimaryError(
            f"could not route task {task_id!r}: slot fenced after "
            f"{self._ROUTE_ATTEMPTS} attempts (last {getattr(last, 'status', '?')})")

    # -- gateway-facing verb surface ---------------------------------------

    async def upsert(self, task: APITask) -> APITask:
        if not task.task_id:
            # Mint here: the id IS the routing key (the sharded facade
            # does exactly this before its ring lookup).
            task.task_id = new_task_id()
        payload = task.to_dict()
        payload["Body"] = task.body.decode("utf-8",
                                           errors="surrogateescape")
        payload["PublishToGrid"] = task.publish
        try:
            resp, body = await self._routed(
                task.task_id, "POST", "/v1/taskstore/upsert",
                data=json.dumps(payload))
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as exc:
            # The shard is mid-promotion and the rotation patience ran
            # out: surface the standby contract, not a raw 500 — the
            # gateway answers 503 + Retry-After and the client re-POSTs.
            raise NotPrimaryError(str(exc)) from exc
        _raise_refusal(resp)
        if resp.status != 200:
            raise RuntimeError(
                f"upsert failed: HTTP {resp.status} "
                f"{body[:200].decode('utf-8', 'replace')}")
        return APITask.from_dict(json.loads(body))

    async def get(self, task_id: str) -> APITask:
        resp, body = await self._routed(
            task_id, "GET", "/v1/taskstore/task",
            check_miss=True, params={"taskId": task_id})
        if resp.status == 204:
            raise TaskNotFound(task_id)
        if resp.status != 200:
            raise TaskNotFound(task_id)
        return APITask.from_dict(json.loads(body))

    async def set_result(self, task_id: str, result: bytes,
                         content_type: str = "application/json",
                         stage: str | None = None) -> None:
        params = {"taskId": task_id}
        if stage:
            params["stage"] = stage
        resp, body = await self._routed(
            task_id, "POST", "/v1/taskstore/result", params=params,
            check_miss=True,
            data=result, headers={"Content-Type": content_type})
        _raise_refusal(resp)
        if resp.status == 404:
            raise TaskNotFound(task_id)
        if resp.status != 200:
            raise RuntimeError(f"set_result failed: HTTP {resp.status}")

    def set_len(self, endpoint_path: str, status: str) -> int:
        """Sync by contract (the admission pressure check calls it
        inline); the rig runs gateways admission-off, so an empty backlog
        is the correct degraded answer rather than a wire round trip."""
        return 0

    async def get_ledger(self, task_id: str) -> list[dict]:
        """The task's hop-ledger timeline, fetched from the OWNING shard
        node (it lives beside the record in that store's memory). The
        wire form of the sharded facade's empty→None ownership re-check:
        an empty timeline from a node that may have just handed the slot
        away re-checks the fence table once and re-asks the new owner —
        without it, ``trace --task-id`` against the rig answered ``[]``
        for every task (the fail-open this closes). Still
        fail-open on transport errors: the ledger is telemetry, and a
        mid-failover read answers empty, never raises."""
        rechecked = False
        while True:
            try:
                resp, body = await self._routed(
                    task_id, "GET", "/v1/taskstore/ledger",
                    params={"taskId": task_id})
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                    NotPrimaryError):
                return []
            if resp.status != 200:
                return []
            try:
                events = json.loads(body).get("Events") or []
            except ValueError:
                return []
            if events or rechecked:
                return events
            rechecked = True
            shard = self.shard_for(task_id)
            if not await self._refresh_slots(shard) \
                    or self.shard_for(task_id) == shard:
                return []

    async def append_ledger(self, task_id: str, events: list[dict]) -> int:
        """Hop-ledger append ring-routed to the owning shard — how the
        rig gateway's admitted/published stamps (and the echo worker's
        execute stamp) land beside the record. Fail-open like every
        ledger path: a stamp that cannot land is dropped, serving is
        untouched."""
        try:
            resp, body = await self._routed(
                task_id, "POST", "/v1/taskstore/ledger", check_miss=True,
                data=json.dumps({"TaskId": task_id, "Events": events}))
            _raise_refusal(resp)
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                NotPrimaryError):
            return 0
        if resp.status != 200:
            return 0
        try:
            return int(json.loads(body).get("appended", 0))
        except (ValueError, TypeError):
            return 0

    def add_listener(self, listener) -> None:
        """No-op: cross-process components ride the wire feed instead."""

    def feed_for(self, task_id: str) -> ShardChangeFeed:
        return self._feed

    # -- TaskManagerBase (dispatcher/worker-facing) -------------------------

    async def get_task_status(self, task_id: str) -> dict | None:
        resp, body = await self._routed(
            task_id, "GET", "/v1/taskstore/task",
            check_miss=True, params={"taskId": task_id})
        if resp.status != 200:
            return None
        return json.loads(body)

    async def _upsert(self, task: APITask) -> dict:
        return (await self.upsert(task)).to_dict()

    async def _update(self, task_id: str, status: str,
                      backend_status: str | None = None) -> dict:
        payload = {"TaskId": task_id, "Status": status,
                   "BackendStatus": backend_status
                   or TaskStatus.canonical(status)}
        resp, body = await self._routed(
            task_id, "POST", "/v1/taskstore/update",
            check_miss=True, data=json.dumps(payload))
        _raise_refusal(resp)
        if resp.status == 204:
            raise KeyError(f"task not found: {task_id}")
        if resp.status != 200:
            raise RuntimeError(f"update failed: HTTP {resp.status}")
        return json.loads(body)

    async def update_task_status_if(self, task_id: str,
                                    expected_status: str, status: str,
                                    backend_status: str | None = None
                                    ) -> dict | None:
        payload = {"TaskId": task_id, "Status": status,
                   "BackendStatus": backend_status
                   or TaskStatus.canonical(status),
                   "ExpectedStatus": expected_status}
        resp, body = await self._routed(
            task_id, "POST", "/v1/taskstore/update",
            check_miss=True, data=json.dumps(payload))
        _raise_refusal(resp)  # fence-409 is NOT the precondition branch
        if resp.status in (409, 204):
            return None
        if resp.status != 200:
            raise RuntimeError(f"conditional update failed: "
                               f"HTTP {resp.status}")
        return json.loads(body)

    # -- wire change-feed tails --------------------------------------------

    async def start_feed_tails(self) -> None:
        """One tail task per shard, rotating across that shard's node URLs
        (a promoted replica serves the stream too — its absorb path fires
        the same listeners)."""
        self._tail_stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for shard in range(len(self._clients)):
            self._tails.append(loop.create_task(self._tail(shard)))

    async def _tail(self, shard: int) -> None:
        stop = self._tail_stop
        client = self._clients[shard]
        idx = 0
        while not stop.is_set():
            base = client._endpoints[idx % len(client._endpoints)]
            try:
                session = await client._get_session()
                async with session.get(
                        base + FEED_PATH,
                        timeout=aiohttp.ClientTimeout(total=None,
                                                      sock_read=30)) as resp:
                    if resp.status != 200:
                        raise aiohttp.ClientError(
                            f"feed answered {resp.status}")
                    async for raw in resp.content:
                        if stop.is_set():
                            return
                        line = raw.strip()
                        if not line or line == b"{}":
                            continue  # heartbeat
                        try:
                            task = APITask.from_dict(json.loads(line))
                        except (ValueError, KeyError, TypeError):
                            continue
                        self._feed.publish(task)
            except asyncio.CancelledError:
                raise
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as exc:
                log.debug("feed tail shard %d via %s dropped: %s",
                          shard, base, exc)
                idx += 1  # rotate: the primary may be dead, a replica up
                try:
                    await asyncio.wait_for(stop.wait(), 0.5)
                    return
                except asyncio.TimeoutError:
                    continue

    async def aclose(self) -> None:
        if self._tail_stop is not None:
            self._tail_stop.set()
        for task in self._tails:
            task.cancel()
        for task in self._tails:
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001; ai4e: noqa[AIL005] — awaiting our own cancelled tails at teardown
                pass
        self._tails = []
        for client in self._clients:
            await client.close()


class WireBroker:
    """The broker surface a dispatcher PROCESS consumes, over one shard
    node's ``/v1/rig/broker/*`` routes (rotating to the promoted replica
    like every wire client). ``receive`` long-polls a lease; ``complete``/
    ``abandon`` acknowledge fire-and-forget — a lost ack lets the lease
    expire server-side, and the redelivery is exactly the duplicate the
    dispatcher's suppression path exists for. Dead-lettering is entirely
    server-side (the delivery budget and its terminal task write live
    with the queue), so ``abandon`` always reports "requeued" here."""

    def __init__(self, shard_urls: list[str], lease_seconds: float = 5.0,
                 api_key: str | None = None):
        self._client = _HttpStoreClient(shard_urls, api_key=api_key,
                                        failover_cycles=3,
                                        failover_delay=0.5)
        self.lease_seconds = lease_seconds
        # Strong refs to in-flight fire-and-forget acks (the loop holds
        # tasks weakly; AIL004).
        self._acks: set[asyncio.Task] = set()

    async def receive(self, queue_name: str,
                      timeout: float | None = None) -> Message | None:
        try:
            resp, body = await self._client._request(
                "POST", BROKER_POP_PATH,
                data=json.dumps({"queue": queue_name,
                                 "wait": timeout or 0.0}))
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as exc:
            # Mid-failover / node down: the dispatcher loop treats None
            # as an idle poll and re-enters — never dies on transport.
            log.debug("broker pop failed: %s", exc)
            await asyncio.sleep(0.5)
            return None
        if resp.status != 200:
            if resp.status not in (204, 503):
                log.warning("broker pop answered HTTP %d", resp.status)
                await asyncio.sleep(0.2)
            return None
        d = json.loads(body)
        return Message(
            task_id=d["TaskId"], endpoint=d["Endpoint"],
            body=bytes.fromhex(d.get("BodyHex", "")),
            content_type=d.get("ContentType", "application/json"),
            enqueued_at=float(d.get("EnqueuedAt", 0.0)),
            delivery_count=int(d.get("DeliveryCount", 1)),
            seq=int(d.get("Seq", 0)),
            lease_expires=float(d.get("LeaseExpires", 0.0)),
            queue_name=d.get("Queue", queue_name),
            cache_key=d.get("CacheKey", ""),
            deadline_at=float(d.get("DeadlineAt", 0.0)),
            priority=int(d.get("Priority", 1)),
            tenant=d.get("Tenant", ""))

    def _ack(self, msg: Message, outcome: str) -> None:
        async def send() -> None:
            try:
                await self._client._request(
                    "POST", BROKER_DONE_PATH,
                    data=json.dumps({"queue": msg.queue_name,
                                     "seq": msg.seq,
                                     "outcome": outcome}))
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as exc:
                # Lost ack = lease expiry = a redelivery the duplicate
                # suppression path absorbs; log so an ack blackout is
                # visible when redelivery rates spike (AIL005).
                log.debug("broker %s ack for seq %d lost: %s",
                          outcome, msg.seq, exc)

        task = asyncio.get_running_loop().create_task(send())
        self._acks.add(task)
        task.add_done_callback(self._acks.discard)

    def complete(self, msg: Message) -> None:
        self._ack(msg, "complete")

    def abandon(self, msg: Message) -> bool:
        self._ack(msg, "abandon")
        return True  # dead-letter bookkeeping is server-side

    async def aclose(self) -> None:
        if self._acks:
            await asyncio.gather(*self._acks, return_exceptions=True)
        await self._client.close()
