"""HTTP facade over the task store — ``make_app`` of
``ai4e_tpu/taskstore/http.py``, cut to the routes a worker behind the
control plane uses:

- ``POST /v1/taskstore/upsert`` — create/transition a task (task JSON body);
- ``POST /v1/taskstore/update`` — atomic status-only transition by TaskId,
  conditional when the body carries ``ExpectedStatus`` (409 when it no
  longer holds);
- ``GET  /v1/taskstore/task?taskId=…`` and ``/v1/taskstore/task/{id}`` —
  the task (204 if absent);
- ``GET  /v1/taskstore/depths`` — per-endpoint status-set depths;
- ``POST /v1/taskstore/result?taskId=…`` and ``GET`` the same — a task's
  result payload (``&stage=`` for a pipeline stage's); the ``GET``
  streams it from the store's ``open_result`` where the store has one (an
  offloaded result is read from its file in chunks), and buffers it
  otherwise (the native store);
- ``POST /v1/taskstore/result-ref`` (``{"TaskId", "ContentType",
  "Stage"}``) registers a result a worker wrote to the shared result
  directory itself: 400 without a TaskId or a result backend, 404 for an
  unknown task, 409 when the blob is not there;
- ``POST /v1/taskstore/redrive`` republishes failed tasks with their
  original bodies: ``{"TaskId"}`` one task (404 unknown, 409 not failed,
  with its ``Status``), an empty body every failed task whose status
  contains ``Contains`` (default: the dead-letter prose; ``""``: all);
- ``POST /v1/taskstore/ledger`` (``{"TaskId", "Events"}``) appends a
  worker's buffered hop-ledger events to the task's timeline (sanitised
  by ``validate_events``; 404 for an unknown task), and ``GET
  /v1/taskstore/ledger?taskId=…`` reads it (``{"TaskId", "Events"}``).

A journaled store (``JournaledTaskStore``, ``FollowerTaskStore``) also
serves the HA surface (``replication.py``):

- ``GET /v1/taskstore/journal?offset=&generation=&wait=&epoch=`` streams
  journal bytes from ``offset``, long-polling up to ``wait`` s when caught
  up; a generation mismatch (the journal was compacted) restarts the
  reader at offset 0 (``X-Journal-Generation``, ``X-Journal-Offset``,
  ``X-Journal-Size``); a newer ``epoch`` is fencing evidence;
- ``POST /v1/taskstore/promote`` makes a follower the primary (with the
  platform's ``lifecycle``: replication stopped first, transport started
  after);
- ``POST /v1/taskstore/demote`` ``{"epoch", "primary_url"}`` fences a
  primary out of the role (409 when the epoch is not newer);
  ``primary_url`` makes the platform rejoin it as a follower;
- ``GET /v1/taskstore/role``: role, epoch, whether a replication feed
  runs, the journal generation, both chain heads, degraded or not.

A mutation that reaches a follower answers 503 ``{"error": "not
primary"}`` with ``X-Not-Primary: 1``, on which (and only on which) store
clients rotate to the next replica; redrive refuses on a follower up
front. A journal-degraded store answers mutations 503 with
``X-Shed-Reason: journal-degraded`` and no ``X-Not-Primary``: it still
serves reads. Every response of a journaled store carries its fencing
epoch in ``X-Store-Epoch``; a request may carry one back, and a primary
that sees a newer epoch demotes itself before the handler runs. The
in-memory and native stores have no epoch and send none.

A mutation refused by a shard store's write fence (``NotOwnerError``: a
live slot move took the TaskId's slot) answers 409 with ``X-Not-Owner:
1``, on which a ring client re-routes. A sharded store
(``sharding.ShardedTaskStore``) also serves ``GET /v1/taskstore/shards``:
the ring's slot table and version and, per shard, its epoch, whether it is
dead, its replicas, journal, chain head beside each replica's, degraded
or not, and its change feed's position and watchers.
"""

from __future__ import annotations

import asyncio
import json

import os

from aiohttp import web

from ..observability.ledger import validate_events
from ..utils.http import read_body_limited
from .store import (InMemoryTaskStore, JournalDegradedError, NotOwnerError,
                    NotPrimaryError, StaleEpochError, TaskNotFound)
from .task import SUB_TASK_SEP, APITask, TaskStatus


def make_app(store: InMemoryTaskStore,
             app: web.Application | None = None,
             max_body_bytes: int = 128 * 1024 * 1024,
             max_result_bytes: int | None = None,
             lifecycle=None) -> web.Application:
    """Build the task-store surface; pass ``app`` to attach the routes to an
    existing application (the gateway's, so one control-plane port serves
    both). ``max_body_bytes`` caps task and transition bodies (0 =
    unlimited), ``max_result_bytes`` result uploads (None: 8x the body
    cap). ``lifecycle`` (the platform) runs role flips: ``await
    lifecycle.promote_now()`` for ``POST /promote`` and ``await
    lifecycle.demote_now(epoch, primary_url)`` for ``POST /demote``;
    without it the handlers flip the bare store."""
    if app is None:
        app = web.Application()
    if max_result_bytes is None:
        max_result_bytes = 8 * max_body_bytes

    def stamped(handler):
        """The fencing wrapper of every route: a newer ``X-Store-Epoch`` on
        the request demotes a primary before the handler runs; the
        response carries the store's epoch."""
        async def wrapper(request: web.Request):
            hdr = request.headers.get("X-Store-Epoch")
            if hdr:
                note = getattr(store, "note_epoch", None)
                if note is not None:
                    try:
                        note(int(hdr))
                    except ValueError:
                        pass
            resp = await handler(request)
            epoch = getattr(store, "epoch", None)
            # A stream response has sent its headers already.
            if epoch is not None and not getattr(resp, "prepared", False):
                resp.headers["X-Store-Epoch"] = str(epoch)
            return resp
        return wrapper

    def not_primary() -> web.Response:
        # 503, not 4xx: the write is valid, this replica cannot take it.
        return web.json_response({"error": "not primary"}, status=503,
                                 headers={"X-Not-Primary": "1"})

    def journal_degraded(exc: JournalDegradedError) -> web.Response:
        # No X-Not-Primary: the store serves reads, clients stay.
        return web.json_response(
            {"error": f"journal degraded: {exc}"}, status=503,
            headers={"X-Shed-Reason": "journal-degraded",
                     "Retry-After": "5"})

    def not_owner(exc: NotOwnerError) -> web.Response:
        # The verb is valid, this store no longer owns the TaskId's slot: a
        # ring client re-reads the slot table and re-routes.
        return web.json_response({"error": f"not owner: {exc}"},
                                 status=409,
                                 headers={"X-Not-Owner": "1"})

    def refused(exc: NotOwnerError | NotPrimaryError
                | JournalDegradedError) -> web.Response:
        """The answer to a mutation a stale shard owner, a follower or a
        degraded store refused."""
        if isinstance(exc, NotOwnerError):
            return not_owner(exc)
        if isinstance(exc, NotPrimaryError):
            return not_primary()
        return journal_degraded(exc)

    def too_large(limit: int) -> web.Response:
        return web.json_response(
            {"error": f"body exceeds {limit} bytes"}, status=413)

    async def read_json(request: web.Request):
        """``(payload, None)`` or ``(None, error response)``."""
        raw = await read_body_limited(request, max_body_bytes)
        if raw is None:
            return None, too_large(max_body_bytes)
        try:
            return json.loads(raw or b"{}"), None
        except json.JSONDecodeError:
            return None, web.json_response({"error": "invalid JSON"},
                                           status=400)

    async def upsert(request: web.Request) -> web.Response:
        payload, err = await read_json(request)
        if err is not None:
            return err
        task = APITask.from_dict(payload)
        if SUB_TASK_SEP in task.task_id:
            # Pipeline stage sub-task ids may be transitioned, never created
            # from outside.
            try:
                store.get(task.task_id)
            except TaskNotFound:
                return web.json_response(
                    {"error": f"TaskId must not contain {SUB_TASK_SEP!r} "
                              "(reserved for pipeline stage sub-tasks)"},
                    status=400)
        try:
            task = store.upsert(task)
        except ValueError as exc:  # reserved characters in a supplied TaskId
            return web.json_response({"error": str(exc)}, status=400)
        except (NotOwnerError, NotPrimaryError, JournalDegradedError) as exc:
            return refused(exc)
        return web.json_response(store.get(task.task_id).to_dict())

    async def update(request: web.Request) -> web.Response:
        payload, err = await read_json(request)
        if err is not None:
            return err
        task_id = payload.get("TaskId", "")
        status = payload.get("Status", "")
        if not task_id or not status:
            return web.json_response({"error": "TaskId and Status required"},
                                     status=400)
        expected = payload.get("ExpectedStatus")
        try:
            if expected:
                task = store.update_status_if(task_id, expected, status,
                                              payload.get("BackendStatus"))
                if task is None:
                    try:
                        current = store.get(task_id).status
                    except TaskNotFound:
                        return web.Response(status=204)
                    return web.json_response(
                        {"error": "status precondition failed",
                         "Status": current}, status=409)
            else:
                task = store.update_status(task_id, status,
                                           payload.get("BackendStatus"))
        except TaskNotFound:
            return web.Response(status=204)
        except (NotOwnerError, NotPrimaryError, JournalDegradedError) as exc:
            return refused(exc)
        return web.json_response(task.to_dict())

    async def get_task(request: web.Request) -> web.Response:
        task_id = (request.query.get("taskId")
                   or request.match_info.get("task_id", ""))
        if not task_id:
            return web.json_response({"error": "taskId required"}, status=400)
        try:
            task = store.get(task_id)
        except TaskNotFound:
            return web.Response(status=204)
        return web.json_response(task.to_dict())

    async def depths(_: web.Request) -> web.Response:
        return web.json_response(store.depths())

    async def put_result(request: web.Request) -> web.Response:
        task_id = request.query.get("taskId", "")
        if not task_id:
            return web.json_response({"error": "taskId required"}, status=400)
        body = await read_body_limited(request, max_result_bytes)
        if body is None:
            return too_large(max_result_bytes)
        try:
            store.set_result(task_id, body,
                             content_type=request.content_type
                             or "application/json",
                             stage=request.query.get("stage") or None)
        except TaskNotFound:
            # An error, not a silent 204: the worker treats 2xx as stored.
            return web.json_response({"error": f"unknown task {task_id}"},
                                     status=404)
        except (NotOwnerError, NotPrimaryError, JournalDegradedError) as exc:
            return refused(exc)
        return web.json_response({"ok": True})

    async def get_result(request: web.Request) -> web.StreamResponse:
        task_id = request.query.get("taskId", "")
        if not task_id:
            return web.json_response({"error": "taskId required"}, status=400)
        stage = request.query.get("stage") or None
        opener = getattr(store, "open_result", None)
        if opener is None:  # a store without streaming (native): buffer
            found = store.get_result(task_id, stage=stage)
            if found is None:
                return web.Response(status=204)
            body, content_type = found
            return web.Response(body=body,
                                headers={"Content-Type": content_type})
        found = opener(task_id, stage=stage)
        if found is None:
            return web.Response(status=204)
        fh, content_type, size = found
        # In chunks: a multi-MB offloaded result must not be held whole in
        # memory per concurrent download.
        resp = web.StreamResponse(
            headers={"Content-Type": content_type,
                     "Content-Length": str(size)})
        try:
            # Inside the try: a client that drops here must not leak the
            # blob's file handle.
            await resp.prepare(request)
            loop = asyncio.get_running_loop()
            while True:
                # Off the event loop: a read from a network mount blocks.
                chunk = await loop.run_in_executor(None, fh.read, 256 * 1024)
                if not chunk:
                    break
                await resp.write(chunk)
        finally:
            fh.close()
        await resp.write_eof()
        return resp

    async def put_result_ref(request: web.Request) -> web.Response:
        """Register a result the worker wrote to the shared backend itself:
        only this small pointer crosses the control network."""
        payload, err = await read_json(request)
        if err is not None:
            return err
        task_id = payload.get("TaskId", "")
        if not task_id:
            return web.json_response({"error": "TaskId required"}, status=400)
        register = getattr(store, "set_result_ref", None)
        if register is None:  # the native store: no ref support
            return web.json_response(
                {"error": "store does not support result refs"}, status=400)
        try:
            register(task_id,
                     content_type=payload.get("ContentType")
                     or "application/json",
                     stage=payload.get("Stage") or None)
        except TaskNotFound:
            return web.json_response({"error": f"unknown task {task_id}"},
                                     status=404)
        except FileNotFoundError as exc:
            # The pointer before its blob (a race or a worker that mounts
            # another directory): 409, so the worker fails loudly instead
            # of leaving a dangling pointer.
            return web.json_response({"error": str(exc)}, status=409)
        except (NotOwnerError, NotPrimaryError, JournalDegradedError) as exc:
            return refused(exc)
        except RuntimeError as exc:  # the store has no backend configured
            return web.json_response({"error": str(exc)}, status=400)
        return web.json_response({"ok": True})

    async def redrive(request: web.Request) -> web.Response:
        """Republish failed tasks: a redrive is ``requeue_if(task_id,
        "failed")``, which flips the task back to created and publishes its
        original body. ``{"TaskId": ...}`` redrives one task (409 unless it
        is failed: completed and running tasks are never run again); an
        empty body sweeps every failed task whose status contains
        ``Contains`` (default: the prose a task gets when its message
        exhausts its delivery budget); ``{"Contains": ""}`` redrives every
        failed task, those that failed in model code too."""
        payload, err = await read_json(request)
        if err is not None:
            return err
        if not isinstance(payload, dict):
            return web.json_response(
                {"error": "body must be a JSON object"}, status=400)
        if getattr(store, "role", "primary") == "follower":
            # Up front: an empty sweep would otherwise answer 200 on a
            # follower, hiding that the operator redrove the wrong replica.
            return not_primary()
        try:
            task_id = payload.get("TaskId")
            if task_id:
                task = store.requeue_if(task_id, "failed")
                if task is None:
                    try:
                        current = store.get(task_id)
                    except TaskNotFound:
                        return web.json_response(
                            {"error": "unknown task"}, status=404)
                    return web.json_response(
                        {"error": "task is not failed",
                         "Status": current.status}, status=409)
                return web.json_response(task.to_dict())
            contains = payload.get("Contains", TaskStatus.DEAD_LETTER_PROSE)
            redriven = []
            for ep in store.endpoints():
                for tid in store.set_members(ep, "failed"):
                    try:
                        current = store.get(tid)
                    except TaskNotFound:
                        continue  # evicted between the scan and the fetch
                    if contains and contains not in current.status:
                        continue
                    if store.requeue_if(tid, "failed") is not None:
                        redriven.append(tid)
        except (NotOwnerError, NotPrimaryError, JournalDegradedError) as exc:
            return refused(exc)
        return web.json_response(
            {"redriven": len(redriven), "task_ids": redriven})

    async def append_ledger(request: web.Request) -> web.Response:
        payload, err = await read_json(request)
        if err is not None:
            return err
        task_id = payload.get("TaskId", "")
        if not task_id:
            return web.json_response({"error": "TaskId required"},
                                     status=400)
        append = getattr(store, "append_ledger", None)
        if append is None:  # the native store: no ledger
            return web.json_response(
                {"error": "store does not support the hop ledger"},
                status=404)
        try:
            kept = append(task_id, validate_events(payload.get("Events")))
        except TaskNotFound:
            return web.json_response({"error": f"unknown task {task_id}"},
                                     status=404)
        except (NotOwnerError, NotPrimaryError, JournalDegradedError) as exc:
            return refused(exc)
        return web.json_response({"ok": True, "appended": kept})

    async def get_ledger(request: web.Request) -> web.Response:
        task_id = request.query.get("taskId", "")
        if not task_id:
            return web.json_response({"error": "taskId required"},
                                     status=400)
        getter = getattr(store, "get_ledger", None)
        return web.json_response({
            "TaskId": task_id,
            "Events": getter(task_id) if getter is not None else []})

    app.router.add_post("/v1/taskstore/upsert", stamped(upsert))
    app.router.add_post("/v1/taskstore/update", stamped(update))
    app.router.add_post("/v1/taskstore/redrive", stamped(redrive))
    app.router.add_get("/v1/taskstore/task", stamped(get_task))
    app.router.add_get("/v1/taskstore/task/{task_id}", stamped(get_task))
    app.router.add_get("/v1/taskstore/depths", stamped(depths))
    app.router.add_post("/v1/taskstore/result", stamped(put_result))
    app.router.add_post("/v1/taskstore/result-ref", stamped(put_result_ref))
    app.router.add_get("/v1/taskstore/result", stamped(get_result))
    app.router.add_post("/v1/taskstore/ledger", stamped(append_ledger))
    app.router.add_get("/v1/taskstore/ledger", stamped(get_ledger))
    if getattr(store, "ring", None) is not None:
        async def shards(_: web.Request) -> web.Response:
            """The ring's layout and each shard's epoch, role and feed
            state: where the keyspace lives and which fencing epoch each
            shard is on."""
            return web.json_response(store.topology())

        app.router.add_get("/v1/taskstore/shards", stamped(shards))
    if getattr(store, "_journal_path", None) is not None:
        _add_replication_routes(app, store, stamped, read_json, lifecycle)
    return app


def _add_replication_routes(app: web.Application, store, stamped, read_json,
                            lifecycle) -> None:
    """The journal stream, promote, demote and role routes of a journaled
    store."""
    journal_path = store._journal_path

    async def journal_stream(request: web.Request) -> web.Response:
        """Raw journal bytes from ``offset`` for a follower's tail loop; a
        generation mismatch restarts the reader at offset 0 of the current
        file, which is a whole snapshot."""
        try:
            offset = int(request.query.get("offset", "0"))
            generation = int(request.query.get("generation", "-1"))
            wait = min(float(request.query.get("wait", "0")), 55.0)
            limit = min(int(request.query.get(
                "limit", str(4 * 1024 * 1024))), 64 * 1024 * 1024)
            peer_epoch = int(request.query.get("epoch", "0"))
        except ValueError:
            return web.json_response({"error": "bad query"}, status=400)
        if peer_epoch:
            # A follower that lived through a failover and polls a deposed
            # primary fences it.
            note = getattr(store, "note_epoch", None)
            if note is not None:
                note(peer_epoch)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + wait
        while True:
            # Generation and open under the store lock, which compaction
            # swaps the file under: the handle matches the generation.
            with store._lock:
                gen = store.journal_generation
                served_from = (0 if generation != gen or offset < 0
                               else offset)
                try:
                    fh = open(journal_path, "rb")  # noqa: ASYNC230  # local journal open under the store lock; generation/offset consistency needs it
                except FileNotFoundError:
                    fh = None
            try:
                if fh is None:
                    chunk, size = b"", 0
                else:
                    size = os.fstat(fh.fileno()).st_size
                    if served_from > size:
                        # Truncated outside the store: restart the reader.
                        served_from = 0
                    fh.seek(served_from)
                    chunk = fh.read(limit)
            finally:
                if fh is not None:
                    fh.close()
            if chunk or loop.time() >= deadline:
                return web.Response(
                    body=chunk, content_type="application/x-ndjson",
                    headers={"X-Journal-Generation": str(gen),
                             "X-Journal-Offset": str(served_from),
                             "X-Journal-Size": str(size)})
            # 4 Hz while caught up: replication lag is tolerated in seconds.
            await asyncio.sleep(0.25)

    async def promote(_: web.Request) -> web.Response:
        """Manual failover: with the platform, the watchdog's whole
        sequence (replication stopped before the flip, transport started
        and unfinished tasks published after)."""
        if lifecycle is not None:
            await lifecycle.promote_now()
        else:
            promote_fn = getattr(store, "promote", None)
            if promote_fn is None:
                return web.json_response(
                    {"error": "store is not a follower replica"}, status=400)
            promote_fn()
        return web.json_response({"ok": True, "role": "primary",
                                  "epoch": getattr(store, "epoch", 0)})

    async def demote(request: web.Request) -> web.Response:
        """Fence this node out of the primary role; 409 when the epoch is
        not newer (the caller is the stale side)."""
        payload, err = await read_json(request)
        if err is not None:
            return err
        try:
            epoch = int(payload["epoch"])
        except (KeyError, TypeError, ValueError):
            return web.json_response({"error": "integer 'epoch' required"},
                                     status=400)
        if getattr(store, "demote", None) is None:
            return web.json_response(
                {"error": "store has no replica role support"}, status=400)
        try:
            if lifecycle is not None:
                await lifecycle.demote_now(epoch,
                                           payload.get("primary_url") or None)
            else:
                store.demote(epoch)
        except StaleEpochError as exc:
            return web.json_response({"error": str(exc)}, status=409)
        return web.json_response({"ok": True, "role": store.role,
                                  "epoch": store.epoch})

    async def role(_: web.Request) -> web.Response:
        # "replicating" tells a fencing prober whether a demoted node still
        # needs the rejoin nudge; None without a platform.
        replicating = (None if lifecycle is None
                       else getattr(lifecycle, "replicator", None)
                       is not None)
        return web.json_response(
            {"role": getattr(store, "role", "primary"),
             "epoch": getattr(store, "epoch", 0),
             "replicating": replicating,
             "generation": store.journal_generation,
             # Equal bytes, equal heads: a follower compares its
             # replica_chain_head with the primary's chain_head.
             "chain_head": getattr(store, "chain_head", None),
             "replica_chain_head": getattr(store, "replica_chain_head",
                                           None),
             "degraded": bool(getattr(store, "degraded", False))})

    app.router.add_get("/v1/taskstore/journal", stamped(journal_stream))
    app.router.add_post("/v1/taskstore/promote", stamped(promote))
    app.router.add_post("/v1/taskstore/demote", stamped(demote))
    app.router.add_get("/v1/taskstore/role", stamped(role))
