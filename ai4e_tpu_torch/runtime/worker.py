"""Inference worker — binds servable models to APIService endpoints.
Counterpart of ``ai4e_tpu/runtime/worker.py``.

One APIService with a sync and an async endpoint per servable, both feeding
the shared micro-batcher. Sync returns the result inline; async adopts the
task a dispatcher created (its ``taskId`` header) or creates one, drives it
running -> completed/failed and stores the result in the worker's task
store: its own, or the control plane's over HTTP. A saturated batcher
answers 503 with ``Retry-After`` before a task is adopted, so a dispatcher
redelivers it; one saturated after adoption goes back to the broker, or
fails where no broker is behind the store. The status strings are the JAX
worker's.
"""

from __future__ import annotations

import inspect
import json
import logging

import numpy as np
from aiohttp import web

from ..metrics import MetricsRegistry
from ..service import APIService
from ..service.task_manager import TaskManagerBase
from .batcher import BatcherSaturated, MicroBatcher
from .registry import ModelRuntime, ServableModel

log = logging.getLogger("ai4e_tpu_torch.worker")


class InferenceWorker:
    """Hosts one or more servables behind one service shell."""

    def __init__(self, name: str, runtime: ModelRuntime, batcher: MicroBatcher,
                 task_manager: TaskManagerBase | None = None,
                 prefix: str = "v1", metrics: MetricsRegistry | None = None,
                 store=None, executor_workers: int = 8):
        self.runtime = runtime
        self.batcher = batcher
        self.store = store
        self.service = APIService(name, prefix=prefix,
                                  task_manager=task_manager, metrics=metrics,
                                  executor_workers=executor_workers)
        self._served: dict[str, dict] = {}  # model -> endpoint listing
        self.service.app.router.add_get(self.service.prefix + "/models",
                                        self._list_models)

    async def _list_models(self, _request) -> web.Response:
        out = [{
            "name": name, "version": s.version,
            "params_version": s.params_version,
            "checkpoint": s.checkpoint_path,
            "input_shape": list(s.input_shape),
            "input_dtype": str(np.dtype(s.input_dtype)),
            "batch_buckets": list(s.batch_buckets),
            "endpoints": self._served.get(name, {}),
        } for name, s in self.runtime.models.items()]
        return web.json_response({"models": out})

    def serve_model(self, servable: ServableModel,
                    sync_path: str | None = None,
                    async_path: str | None = None,
                    maximum_concurrent_requests: int = 64) -> None:
        """Expose a servable on a sync and an async endpoint."""
        name = servable.name
        sync_path = sync_path or f"/{name}"
        async_path = async_path or f"/{name}-async"
        self._served.setdefault(name, {}).update({
            "sync": self.service.prefix + sync_path,
            "async": self.service.prefix + async_path})

        def _saturation_check():
            # Refuse before adopting a task, so a dispatcher's 503 handling
            # (delay and redeliver) engages.
            if self.batcher.pending_count >= self.batcher.max_pending:
                return 503, "Inference queue saturated; retry later.", {
                    "Retry-After": "1"}
            return None

        @self.service.api_sync_func(
            sync_path, maximum_concurrent_requests=maximum_concurrent_requests,
            admission_check=_saturation_check)
        async def _sync(body, content_type, _name=name, _servable=servable):
            example = _servable.preprocess(body, content_type)
            try:
                result = await self.batcher.submit(_name, np.asarray(example))
            except BatcherSaturated:
                return web.Response(status=503,
                                    text="Inference queue saturated; retry.",
                                    headers={"Retry-After": "1"})
            return _jsonable(result)

        @self.service.api_async_func(
            async_path, maximum_concurrent_requests=maximum_concurrent_requests,
            admission_check=_saturation_check)
        async def _async(taskId, body, content_type, _name=name,
                         _servable=servable):
            tm = self.service.task_manager
            await tm.update_task_status(taskId, f"running - {_name} inference")
            try:
                example = _servable.preprocess(body, content_type)
            except Exception as exc:  # noqa: BLE001 — recorded on the task (failed - bad input)
                await tm.fail_task(taskId, f"failed - bad input: {exc}")
                return
            try:
                result = await self.batcher.submit(_name, np.asarray(example))
            except BatcherSaturated:
                # Saturated between admission and submit: hand the task back
                # to the broker (a republish with an empty body replays the
                # original one) instead of failing it. With no broker behind
                # the store, or on a device error, the exception propagates
                # and the service shell fails the task.
                if not tm.redelivers:
                    raise
                current = await tm.get_task_status(taskId)
                endpoint = (current or {}).get("Endpoint", async_path)
                await tm.add_pipeline_task(taskId, endpoint)
                return
            await self._store_result(
                taskId, json.dumps(_jsonable(result)).encode())
            await tm.complete_task(taskId, f"completed - {_summarise(result)}")

    async def _store_result(self, task_id: str, payload: bytes) -> None:
        """Store a result in the in-process store (``set_result`` returns
        None) or on the control plane (``HttpResultStore``, a coroutine)."""
        if self.store is None:
            return
        res = self.store.set_result(task_id, payload)
        if inspect.isawaitable(res):
            await res


def _jsonable(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _summarise(result) -> str:
    if isinstance(result, dict):
        return ", ".join(f"{k}" for k in result)
    if isinstance(result, list):
        return f"{len(result)} items"
    return str(result)[:64]
