"""Blocking task-manager client for user model code on worker threads; a
copy of ``ai4e_tpu/service/sync_client.py``.

``SyncTaskManager`` has the six verbs of the reference's synchronous
client (AddTask, UpdateTaskStatus, CompleteTask, FailTask,
AddPipelineTask, GetTaskStatus) plus result upload, stdlib only
(``urllib``), against the task store's HTTP surface (``taskstore.http``).
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.parse
import urllib.request

from ..taskstore import TaskStatus

log = logging.getLogger("ai4e_tpu_torch.sync_client")


class SyncTaskManager:
    """Blocking task CRUD against the task-store HTTP service.

    Mirrors ``TaskManagerBase``'s contract (which mirrors the reference's
    manager facade, ``api_task.py:8-38``) with plain methods instead of
    coroutines.
    """

    def __init__(self, base_url: str, timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- wire helpers ------------------------------------------------------

    def _post(self, path: str, payload: dict | bytes,
              content_type: str = "application/json",
              query: dict | None = None) -> tuple[int, bytes]:
        url = f"{self.base_url}{path}"
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = (json.dumps(payload).encode()
                if isinstance(payload, dict) else payload)
        req = urllib.request.Request(
            url, data=data, method="POST",
            headers={"Content-Type": content_type})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read()

    def _get(self, path: str, query: dict) -> tuple[int, bytes]:
        url = f"{self.base_url}{path}?" + urllib.parse.urlencode(query)
        req = urllib.request.Request(url)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read()

    # -- the six verbs -----------------------------------------------------

    def add_task(self, endpoint: str, body: bytes = b"",
                 task_id: str | None = None, publish: bool = False) -> dict:
        """Create a task — or fetch it when the dispatcher already created it
        and passed the ``taskId`` header (``api_task.py:12-20``)."""
        if task_id:
            status = self.get_task_status(task_id)
            if status is not None:
                return status
        payload = {
            "TaskId": task_id or "",
            "Endpoint": endpoint,
            "Status": TaskStatus.CREATED,
            "BackendStatus": TaskStatus.CREATED,
            "Body": body.decode("utf-8", errors="surrogateescape"),
            "PublishToGrid": publish,
        }
        code, data = self._post("/v1/taskstore/upsert", payload)
        if code != 200:
            raise RuntimeError(f"upsert failed: HTTP {code}")
        return json.loads(data)

    def update_task_status(self, task_id: str, status: str,
                           backend_status: str | None = None) -> dict:
        payload = {"TaskId": task_id, "Status": status,
                   "BackendStatus": backend_status
                   or TaskStatus.canonical(status)}
        code, data = self._post("/v1/taskstore/update", payload)
        if code == 204:
            raise KeyError(f"task not found: {task_id}")
        if code != 200:
            raise RuntimeError(f"update failed: HTTP {code}")
        return json.loads(data)

    def complete_task(self, task_id: str, status: str = "completed") -> dict:
        return self.update_task_status(task_id, status, TaskStatus.COMPLETED)

    def fail_task(self, task_id: str, status: str = "failed") -> dict:
        return self.update_task_status(task_id, status, TaskStatus.FAILED)

    def add_pipeline_task(self, task_id: str, next_endpoint: str,
                          body: bytes = b"") -> dict:
        """Hand the task to the next API: rewrite Endpoint, republish; an
        empty body replays the original downstream
        (``distributed_api_task.py:67-100``)."""
        payload = {
            "TaskId": task_id,
            "Endpoint": next_endpoint,
            "Status": TaskStatus.CREATED,
            "BackendStatus": TaskStatus.CREATED,
            "Body": body.decode("utf-8", errors="surrogateescape"),
            "PublishToGrid": True,
        }
        code, data = self._post("/v1/taskstore/upsert", payload)
        if code != 200:
            raise RuntimeError(f"pipeline upsert failed: HTTP {code}")
        return json.loads(data)

    def get_task_status(self, task_id: str) -> dict | None:
        code, data = self._get("/v1/taskstore/task", {"taskId": task_id})
        if code != 200:
            return None
        return json.loads(data)

    # -- results -----------------------------------------------------------

    def set_result(self, task_id: str, result: bytes,
                   content_type: str = "application/json",
                   stage: str | None = None) -> None:
        query = {"taskId": task_id}
        if stage:
            query["stage"] = stage
        code, _ = self._post("/v1/taskstore/result", result,
                             content_type=content_type, query=query)
        if code == 404:
            log.warning("result for unknown task %s dropped by store", task_id)
            return
        if not (200 <= code < 300):
            raise RuntimeError(f"set_result failed: HTTP {code}")

    def get_result(self, task_id: str,
                   stage: str | None = None) -> bytes | None:
        query = {"taskId": task_id}
        if stage:
            query["stage"] = stage
        code, data = self._get("/v1/taskstore/result", query)
        return data if code == 200 else None
