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
  result payload;
- ``POST /v1/taskstore/ledger`` (``{"TaskId", "Events"}``) appends a
  worker's buffered hop-ledger events to the task's timeline (sanitised
  by ``validate_events``; 404 for an unknown task), and ``GET
  /v1/taskstore/ledger?taskId=…`` reads it (``{"TaskId", "Events"}``).

The journal, promote, demote, role, redrive, result-ref and shards routes
are not served (ROADMAP A18): a request for them gets 404, as from a JAX
store that does not serve them. The in-memory store has no fencing
epoch, so no response carries ``X-Store-Epoch``.
"""

from __future__ import annotations

import json

from aiohttp import web

from ..observability.ledger import validate_events
from ..utils.http import read_body_limited
from .store import InMemoryTaskStore, TaskNotFound
from .task import SUB_TASK_SEP, APITask


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

    async def get_result(request: web.Request) -> web.Response:
        task_id = request.query.get("taskId", "")
        if not task_id:
            return web.json_response({"error": "taskId required"}, status=400)
        found = store.get_result(task_id,
                                 stage=request.query.get("stage") or None)
        if found is None:
            return web.Response(status=204)
        body, content_type = found
        return web.Response(body=body, headers={"Content-Type": content_type})

    async def append_ledger(request: web.Request) -> web.Response:
        payload, err = await read_json(request)
        if err is not None:
            return err
        task_id = payload.get("TaskId", "")
        if not task_id:
            return web.json_response({"error": "TaskId required"},
                                     status=400)
        try:
            kept = store.append_ledger(
                task_id, validate_events(payload.get("Events")))
        except TaskNotFound:
            return web.json_response({"error": f"unknown task {task_id}"},
                                     status=404)
        return web.json_response({"ok": True, "appended": kept})

    async def get_ledger(request: web.Request) -> web.Response:
        task_id = request.query.get("taskId", "")
        if not task_id:
            return web.json_response({"error": "taskId required"},
                                     status=400)
        return web.json_response({"TaskId": task_id,
                                  "Events": store.get_ledger(task_id)})

    app.router.add_post("/v1/taskstore/upsert", upsert)
    app.router.add_post("/v1/taskstore/update", update)
    app.router.add_get("/v1/taskstore/task", get_task)
    app.router.add_get("/v1/taskstore/task/{task_id}", get_task)
    app.router.add_get("/v1/taskstore/depths", depths)
    app.router.add_post("/v1/taskstore/result", put_result)
    app.router.add_get("/v1/taskstore/result", get_result)
    app.router.add_post("/v1/taskstore/ledger", append_ledger)
    app.router.add_get("/v1/taskstore/ledger", get_ledger)
    return app
