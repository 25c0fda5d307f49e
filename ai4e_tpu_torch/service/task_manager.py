"""Task-manager facade used inside API services — a copy of
``ai4e_tpu/service/task_manager.py`` with its two backends:

- ``LocalTaskManager`` — direct calls into an in-process
  ``InMemoryTaskStore`` (a standalone worker, tests);
- ``HttpTaskManager`` — an aiohttp client of the control plane's task-store
  surface (``taskstore/http.py``, or the JAX package's), with
  ``HttpResultStore`` beside it for results and ``DirectResultStore``,
  which writes large results to a shared result directory and registers
  only a pointer.

Both are async; sync user code goes through the service shell's executor.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import logging
from urllib.parse import urlparse

import aiohttp

from ..taskstore import APITask, InMemoryTaskStore, TaskNotFound, TaskStatus
from ..utils.http import SessionHolder

log = logging.getLogger("ai4e_tpu_torch.task_manager")


class StoreRefusalError(RuntimeError):
    """A typed store refusal a caller must not mistake for a generic
    failure: carries the refusing status and the store's Retry-After."""

    def __init__(self, message: str, *, status: int,
                 retry_after: str | None = None):
        super().__init__(message)
        self.status = status
        self.retry_after = retry_after


def _raise_refusal(resp) -> None:
    """Raise for the store's typed refusals before any generic
    ``raise_for_status``: a plain 503 (journal degraded, draining,
    overloaded) and a 409 carrying X-Not-Owner (the shard fence). A bare
    409 (a conditional update's failed precondition) passes through."""
    if resp.status == 503:
        reason = resp.headers.get("X-Shed-Reason") or "store unavailable"
        raise StoreRefusalError(f"store refused: {reason}", status=503,
                                retry_after=resp.headers.get("Retry-After"))
    if resp.status == 409 and resp.headers.get("X-Not-Owner"):
        raise StoreRefusalError(
            "store is no longer the shard owner for this task", status=409)


class TaskManagerBase:
    """AddTask / UpdateTaskStatus / CompleteTask / FailTask /
    AddPipelineTask / GetTaskStatus — the verbs every service uses."""

    #: Whether a republished task reaches a broker that redelivers it.
    redelivers = False

    async def add_task(self, endpoint: str, body: bytes,
                       task_id: str | None = None,
                       publish: bool = False) -> dict:
        """Create a task — or, when ``task_id`` is supplied (the dispatcher
        already created it and passed the ``taskId`` header), fetch it."""
        if task_id:
            status = await self.get_task_status(task_id)
            if status is not None:
                return status
        return await self._upsert(APITask(
            task_id=task_id or "", endpoint=endpoint, body=body,
            publish=publish))

    async def update_task_status(self, task_id: str, status: str,
                                 backend_status: str | None = None) -> dict:
        return await self._update(task_id, status, backend_status)

    async def update_task_status_if(self, task_id: str,
                                    expected_status: str, status: str,
                                    backend_status: str | None = None
                                    ) -> dict | None:
        """Apply iff the task's canonical status is still
        ``expected_status`` (evaluated under the store's lock); None when
        the precondition failed."""
        raise NotImplementedError

    async def complete_task(self, task_id: str, status: str = "completed") -> dict:
        return await self._update(task_id, status, TaskStatus.COMPLETED)

    async def fail_task(self, task_id: str, status: str = "failed") -> dict:
        return await self._update(task_id, status, TaskStatus.FAILED)

    async def add_pipeline_task(self, task_id: str, next_endpoint: str,
                                body: bytes = b"") -> dict:
        """Republish the task to ``next_endpoint``; an empty body makes the
        store replay the original body. A worker hands a task it cannot
        take back to the broker this way."""
        return await self._upsert(APITask(
            task_id=task_id, endpoint=next_endpoint, body=body,
            status=TaskStatus.CREATED, backend_status=TaskStatus.CREATED,
            publish=True))

    async def get_task_status(self, task_id: str) -> dict | None:
        raise NotImplementedError

    async def append_ledger(self, task_id: str, events: list[dict]) -> int:
        """Append hop-ledger events to the task's timeline on the store
        (``observability/ledger.py``); returns the events kept. A no-op
        here, so a duck-typed task manager keeps working; callers treat
        failures as droppable."""
        return 0

    async def is_terminal(self, task_id: str) -> bool:
        """Terminal-status probe before writes that could clobber a
        completed task. A failed probe answers False and is logged."""
        try:
            record = await self.get_task_status(task_id)
        except Exception:  # noqa: BLE001 — a probe must never block its caller
            log.warning("status probe for task %s failed; proceeding as "
                        "non-terminal", task_id, exc_info=True)
            return False
        if not record:
            return False
        return TaskStatus.canonical(
            record.get("Status", "")) in TaskStatus.TERMINAL

    async def _upsert(self, task: APITask) -> dict:
        raise NotImplementedError

    async def _update(self, task_id: str, status: str,
                      backend_status: str | None = None) -> dict:
        raise NotImplementedError


class LocalTaskManager(TaskManagerBase):
    def __init__(self, store: InMemoryTaskStore):
        self.store = store

    @property
    def redelivers(self) -> bool:
        return self.store.has_publisher

    async def get_task_status(self, task_id: str) -> dict | None:
        try:
            return self.store.get(task_id).to_dict()
        except TaskNotFound:
            return None

    async def _upsert(self, task: APITask) -> dict:
        return self.store.upsert(task).to_dict()

    async def _update(self, task_id: str, status: str,
                      backend_status: str | None = None) -> dict:
        return self.store.update_status(task_id, status, backend_status).to_dict()

    async def update_task_status_if(self, task_id: str,
                                    expected_status: str, status: str,
                                    backend_status: str | None = None
                                    ) -> dict | None:
        task = self.store.update_status_if(task_id, expected_status, status,
                                           backend_status)
        return None if task is None else task.to_dict()

    async def append_ledger(self, task_id: str, events: list[dict]) -> int:
        return self.store.append_ledger(task_id, events)


# A request to a replica set gives it FAILOVER_CYCLES x FAILOVER_DELAY_S
# seconds before it fails.
FAILOVER_CYCLES = 10
FAILOVER_DELAY_S = 1.0


class _HttpStoreClient:
    """Shared plumbing for clients of the task-store HTTP surface.

    ``base_url`` may be one URL or a list, the control plane's replica set
    (primary first). On a connection failure or a 503 carrying
    ``X-Not-Primary`` the client rotates to the next replica and retries,
    sticking with whichever answered, for ``failover_cycles`` passes over
    the set ``failover_delay`` seconds apart (``FAILOVER_CYCLES`` and
    ``FAILOVER_DELAY_S`` by default). A plain 503 goes back to the
    caller. The highest ``X-Store-Epoch`` seen is echoed on every
    request. ``api_key`` rides as a default ``Ocp-Apim-Subscription-Key``
    header on every request: a control plane with subscription keys keys
    its task-store surface too (``AI4E_SERVICE_TASKSTORE_API_KEY`` on
    workers)."""

    def __init__(self, base_url: str | list[str],
                 api_key: str | None = None,
                 failover_cycles: int = FAILOVER_CYCLES,
                 failover_delay: float = FAILOVER_DELAY_S):
        urls = [base_url] if isinstance(base_url, str) else list(base_url)
        if not urls:
            raise ValueError("at least one task-store URL is required")
        self._endpoints = [u.rstrip("/") for u in urls]
        self.base_url = self._endpoints[0]
        # The replica set's patience (cycles x delay); the rig's wire
        # broker takes a shorter one, as in JAX.
        self._failover_cycles = failover_cycles
        self._failover_delay = failover_delay
        self._holder = SessionHolder(
            headers={"Ocp-Apim-Subscription-Key": api_key} if api_key
            else None)
        self.store_epoch = 0

    async def _get_session(self) -> aiohttp.ClientSession:
        return await self._holder.get()

    async def _request(self, method: str, path: str, **kwargs
                       ) -> tuple[aiohttp.ClientResponse, bytes]:
        """One store round trip with replica failover; returns
        ``(response, body)``, the body read inside the request context."""
        session = await self._get_session()
        last_exc: Exception | None = None
        single = len(self._endpoints) == 1
        cycles = 1 if single else self._failover_cycles
        for cycle in range(cycles):
            ordered = ([self.base_url]
                       + [e for e in self._endpoints if e != self.base_url])
            for base in ordered:
                try:
                    if self.store_epoch:
                        headers = dict(kwargs.pop("headers", None) or {})
                        headers.setdefault("X-Store-Epoch",
                                           str(self.store_epoch))
                        kwargs["headers"] = headers
                    async with session.request(
                            method, base + path, **kwargs) as resp:
                        body = await resp.read()
                    seen = resp.headers.get("X-Store-Epoch")
                    if seen and seen.isdigit():
                        self.store_epoch = max(self.store_epoch, int(seen))
                    if (resp.status == 503 and not single
                            and resp.headers.get("X-Not-Primary")):
                        last_exc = aiohttp.ClientResponseError(
                            resp.request_info, (), status=503,
                            message="replica not primary")
                        continue
                    self.base_url = base
                    return resp, body
                except (aiohttp.ClientConnectionError,
                        asyncio.TimeoutError, OSError) as exc:
                    last_exc = exc
                    continue
            if cycle + 1 < cycles:
                await asyncio.sleep(self._failover_delay)
        assert last_exc is not None
        raise last_exc

    async def close(self) -> None:
        await self._holder.close()


class HttpTaskManager(_HttpStoreClient, TaskManagerBase):
    """Client of the task-store HTTP surface; the control plane behind it
    publishes republished tasks to its broker."""

    redelivers = True

    async def get_task_status(self, task_id: str) -> dict | None:
        resp, body = await self._request("GET", "/v1/taskstore/task",
                                         params={"taskId": task_id})
        if resp.status != 200:
            return None
        return json.loads(body)

    async def _upsert(self, task: APITask) -> dict:
        payload = task.to_dict()
        payload["Body"] = task.body.decode("utf-8", errors="surrogateescape")
        payload["PublishToGrid"] = task.publish
        resp, body = await self._request("POST", "/v1/taskstore/upsert",
                                         data=json.dumps(payload))
        _raise_refusal(resp)
        resp.raise_for_status()
        return json.loads(body)

    async def _update(self, task_id: str, status: str,
                      backend_status: str | None = None) -> dict:
        payload = {
            "TaskId": task_id,
            "Status": status,
            "BackendStatus": backend_status or TaskStatus.canonical(status),
        }
        resp, body = await self._request("POST", "/v1/taskstore/update",
                                         data=json.dumps(payload))
        _raise_refusal(resp)
        resp.raise_for_status()
        if resp.status != 200:  # 204 = task unknown to the store
            raise KeyError(f"task not found: {task_id}")
        return json.loads(body)

    async def update_task_status_if(self, task_id: str,
                                    expected_status: str, status: str,
                                    backend_status: str | None = None
                                    ) -> dict | None:
        payload = {
            "TaskId": task_id,
            "Status": status,
            "BackendStatus": backend_status or TaskStatus.canonical(status),
            "ExpectedStatus": expected_status,
        }
        resp, body = await self._request("POST", "/v1/taskstore/update",
                                         data=json.dumps(payload))
        _raise_refusal(resp)  # the fence's 409 is not the precondition's
        if resp.status in (409, 204):
            return None
        resp.raise_for_status()
        return json.loads(body)

    async def append_ledger(self, task_id: str, events: list[dict]) -> int:
        """Ship the worker's buffered hop-ledger events to the control
        plane in one POST. Any answer but 200 (an unknown task, a refusal,
        a store without the route) counts as zero kept, never an error."""
        resp, body = await self._request(
            "POST", "/v1/taskstore/ledger",
            data=json.dumps({"TaskId": task_id, "Events": events}))
        if resp.status != 200:
            return 0
        try:
            return int(json.loads(body).get("appended", 0))
        except (json.JSONDecodeError, ValueError, AttributeError):
            return 0


class HttpResultStore(_HttpStoreClient):
    """Result writes and reads against the task-store HTTP surface: the
    ``set_result``/``get_result`` of the in-process store, as coroutines
    (the worker awaits either form)."""

    async def set_result(self, task_id: str, result: bytes,
                         content_type: str = "application/json",
                         stage: str | None = None) -> None:
        params = {"taskId": task_id}
        if stage:
            params["stage"] = stage
        resp, _body = await self._request(
            "POST", "/v1/taskstore/result", params=params,
            data=result, headers={"Content-Type": content_type})
        _raise_refusal(resp)
        if resp.status == 404:
            # The store no longer knows the task; the completion that
            # follows fails loudly too.
            log.warning("result for unknown task %s dropped by store", task_id)
            return
        resp.raise_for_status()

    async def set_result_ref(self, task_id: str,
                             content_type: str = "application/json",
                             stage: str | None = None) -> bool:
        """Register a blob already written to the shared result backend (a
        small JSON instead of the payload). False when the store no longer
        knows the task: the caller reaps the blob."""
        payload = {"TaskId": task_id, "ContentType": content_type}
        if stage:
            payload["Stage"] = stage
        resp, _body = await self._request("POST", "/v1/taskstore/result-ref",
                                          data=json.dumps(payload))
        _raise_refusal(resp)
        if resp.status == 404:
            log.warning("result ref for unknown task %s dropped by store",
                        task_id)
            return False
        resp.raise_for_status()
        return True

    async def get_result(self, task_id: str,
                         stage: str | None = None
                         ) -> tuple[bytes, str] | None:
        params = {"taskId": task_id}
        if stage:
            params["stage"] = stage
        resp, body = await self._request("GET", "/v1/taskstore/result",
                                         params=params)
        if resp.status != 200:
            return None
        return body, resp.content_type


class DirectResultStore:
    """A worker's results straight to storage: a payload of ``threshold``
    bytes or more is written to the shared result directory ``root`` under
    its key, off the event loop, and only a pointer is registered with the
    store ``inner`` (``set_result_ref``); a smaller one goes to ``inner``
    as it is. ``root`` must be the directory the control plane serves
    (``AI4E_PLATFORM_RESULT_DIR``): a worker that mounts another one gets
    a 409 at registration, never a dangling pointer. A blob whose
    registration fails, or that the store drops, is deleted again."""

    def __init__(self, root: str, inner, threshold: int = 1024 * 1024):
        from ..taskstore.results import FileResultBackend

        self.backend = FileResultBackend(root)
        self.inner = inner
        self.threshold = threshold

    async def set_result(self, task_id: str, result: bytes,
                         content_type: str = "application/json",
                         stage: str | None = None) -> None:
        if len(result) >= self.threshold:
            key = task_id if stage is None else f"{task_id}:{stage}"
            # The blob first, so the pointer never precedes it.
            await asyncio.to_thread(self.backend.put, key, result,
                                    content_type)
            try:
                res = self.inner.set_result_ref(task_id, content_type,
                                                stage=stage)
                if inspect.isawaitable(res):
                    res = await res
            except Exception:
                await asyncio.to_thread(self.backend.delete, key)
                raise
            if res is False:  # the store dropped the ref (unknown task)
                await asyncio.to_thread(self.backend.delete, key)
            return
        res = self.inner.set_result(task_id, result, content_type,
                                    stage=stage)
        if inspect.isawaitable(res):
            await res

    async def get_result(self, task_id: str, stage: str | None = None):
        res = self.inner.get_result(task_id, stage=stage)
        return await res if inspect.isawaitable(res) else res

    async def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            res = close()
            if inspect.isawaitable(res):
                await res


def next_endpoint_from(current_endpoint: str, version: str, organization: str,
                       api: str) -> str:
    """The next pipeline stage's endpoint from the current one:
    ``scheme://host/{version}/{organization}/{api}``, or the path alone
    where ``current_endpoint`` has no scheme."""
    parsed = urlparse(current_endpoint)
    base = f"{parsed.scheme}://{parsed.netloc}" if parsed.scheme else ""
    return f"{base}/{version}/{organization}/{api}"
