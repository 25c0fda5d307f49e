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

The journal, promote, demote, role and shards routes are not served
(ROADMAP A18.1, A18.2): a request for them gets 404, as from a JAX store
that does not serve them; for the same reason redrive has no follower
refusal. The in-memory store has no fencing epoch, so no response
carries ``X-Store-Epoch``.
"""

from __future__ import annotations

import asyncio
import json

from aiohttp import web

from ..observability.ledger import validate_events
from ..utils.http import read_body_limited
from .store import InMemoryTaskStore, TaskNotFound
from .task import SUB_TASK_SEP, APITask, TaskStatus


def make_app(store: InMemoryTaskStore,
             app: web.Application | None = None,
             max_body_bytes: int = 128 * 1024 * 1024,
             max_result_bytes: int | None = None) -> web.Application:
    """Build the task-store surface; pass ``app`` to attach the routes to an
    existing application (the gateway's, so one control-plane port serves
    both). ``max_body_bytes`` caps task and transition bodies (0 =
    unlimited), ``max_result_bytes`` result uploads (None: 8x the body
    cap)."""
    if app is None:
        app = web.Application()
    if max_result_bytes is None:
        max_result_bytes = 8 * max_body_bytes

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

    app.router.add_post("/v1/taskstore/upsert", upsert)
    app.router.add_post("/v1/taskstore/update", update)
    app.router.add_post("/v1/taskstore/redrive", redrive)
    app.router.add_get("/v1/taskstore/task", get_task)
    app.router.add_get("/v1/taskstore/task/{task_id}", get_task)
    app.router.add_get("/v1/taskstore/depths", depths)
    app.router.add_post("/v1/taskstore/result", put_result)
    app.router.add_post("/v1/taskstore/result-ref", put_result_ref)
    app.router.add_get("/v1/taskstore/result", get_result)
    app.router.add_post("/v1/taskstore/ledger", append_ledger)
    app.router.add_get("/v1/taskstore/ledger", get_ledger)
    return app
