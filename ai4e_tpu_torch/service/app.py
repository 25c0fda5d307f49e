"""APIService — the in-container service shell, a copy of
``ai4e_tpu/service/app.py``.

- ``api_sync_func`` / ``api_async_func`` register endpoints with
  per-endpoint concurrency caps and content-type and max-length limits; a
  ``request_processing_function(request)`` turns the request into the
  user function's keyword arguments (by default ``body`` and
  ``content_type``; None answers 400);
- a request over the endpoint's cap gets **503** with ``Retry-After``, so a
  dispatcher backs off and redelivers;
- async endpoints create or adopt a task (reusing the ``taskId`` header
  when the dispatcher already created it), run the user function in the
  background and return the task id at once;
- any exception of a user function fails its task, unless the task is
  already terminal;
- a delivery of a task this process is running on the same endpoint under
  the same store epoch (a lost response retried, a duplicated message,
  also two delivered at once) is acknowledged without a second run, which
  would complete the task twice (ROADMAP C11; JAX's shell runs it again).
  After a failover (a higher ``X-Store-Epoch``) it runs again, as in JAX:
  the new primary may lack what the first run wrote. A delivery to another
  worker still runs it again, as in JAX;
- ``GET {prefix}/`` is the health check, ``GET {prefix}/task/{id}`` the
  task status, ``GET /metrics`` the Prometheus exposition;
- with a ``reporter`` (``metrics.ProcessingReporterClient``), each
  admitted request reports +1 to the cross-replica request reporter and
  -1 when it ends, fire-and-forget;
- every sync request runs in a span parented by its inbound B3 headers,
  every async task's background execution in one keyed by its TaskId and
  parented by the headers of the request that delivered it (the
  dispatcher's ``dispatch`` span).

Sync user functions run in a thread-pool executor; coroutine functions run
on the event loop.
"""

from __future__ import annotations

import asyncio
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable

from aiohttp import web

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from ..observability import (PARENT_HEADER, SAMPLED_HEADER, SPAN_HEADER,
                             TRACE_HEADER, Tracer)
from ..taskstore import InMemoryTaskStore, TaskStatus
from .task_manager import LocalTaskManager, TaskManagerBase

log = logging.getLogger("ai4e_tpu_torch.service")

TASK_ID_HEADER = "taskId"  # set by the dispatcher that created the task


@dataclass
class EndpointSpec:
    func: Callable
    api_path: str
    methods: tuple[str, ...]
    is_async: bool
    maximum_concurrent_requests: int = 8
    content_types: tuple[str, ...] = ()
    content_max_length: int = 0  # 0 = unlimited
    # Extra admission predicate (no awaits): return (code, message[,
    # headers]) to refuse the request, None to admit. The worker uses it to
    # 503 when the batcher is saturated, before a task is adopted.
    admission_check: Callable | None = None
    # request -> the user function's keyword arguments (may be a
    # coroutine); None: body and content_type.
    request_processing_function: Callable | None = None
    # Mutated only from the event loop with no await between check and
    # increment: that single-threadedness is the synchronization.
    in_flight: int = 0


class APIService:
    def __init__(self, name: str, prefix: str = "",
                 task_manager: TaskManagerBase | None = None,
                 metrics: MetricsRegistry | None = None,
                 executor_workers: int = 8, reporter=None):
        self.name = name
        self.prefix = ("/" + prefix.strip("/")) if prefix.strip("/") else ""
        if task_manager is None:
            task_manager = LocalTaskManager(InMemoryTaskStore())
        self.task_manager = task_manager
        self.metrics = metrics or DEFAULT_REGISTRY
        # Spans (named by endpoint path) land in this service's registry;
        # exporter and sampling follow configure_tracer live.
        self.tracer = Tracer(name, metrics=self.metrics)
        self.reporter = reporter  # ProcessingReporterClient | None
        self.is_terminating = False
        self.endpoints: dict[str, EndpointSpec] = {}
        self.executor = ThreadPoolExecutor(max_workers=executor_workers,
                                           thread_name_prefix=f"{name}-worker")
        self._background: set[asyncio.Task] = set()
        # (api_path, task_id, store epoch) of every async run in flight in
        # this process.
        self._running: set[tuple[str, str, int]] = set()

        self._inflight = self.metrics.gauge(
            "ai4e_inflight_requests", "In-flight requests per endpoint")
        self._latency = self.metrics.histogram(
            "ai4e_request_latency_seconds", "End-to-end endpoint latency")
        self._http_total = self.metrics.counter(
            "ai4e_http_requests_total", "HTTP responses by code")

        self.app = web.Application(client_max_size=1024**3)
        self.app.router.add_get(self.prefix + "/", self._health)
        if self.prefix:
            self.app.router.add_get(self.prefix, self._health)
        self.app.router.add_get(self.prefix + "/task/{task_id}",
                                self._task_status)
        self.app.router.add_get("/metrics", self._metrics_endpoint)

    # -- decorators --------------------------------------------------------

    def api_async_func(self, api_path: str, methods=("POST",), **kw):
        return self._api_func(api_path, methods, is_async=True, **kw)

    def api_sync_func(self, api_path: str, methods=("POST",), **kw):
        return self._api_func(api_path, methods, is_async=False, **kw)

    def _api_func(self, api_path: str, methods, is_async: bool,
                  maximum_concurrent_requests: int = 8,
                  content_types=(), content_max_length: int = 0,
                  admission_check=None, request_processing_function=None):
        def deco(func):
            spec = EndpointSpec(
                func=func,
                api_path=api_path if api_path.startswith("/") else "/" + api_path,
                methods=tuple(m.upper() for m in methods),
                is_async=is_async,
                maximum_concurrent_requests=maximum_concurrent_requests,
                content_types=tuple(content_types),
                content_max_length=content_max_length,
                admission_check=admission_check,
                request_processing_function=request_processing_function,
            )
            self.endpoints[spec.api_path] = spec
            for method in spec.methods:
                self.app.router.add_route(method, self.prefix + spec.api_path,
                                          self._make_handler(spec))
            return func
        return deco

    # -- request admission -------------------------------------------------

    def _admission_error(self, spec: EndpointSpec, request: web.Request):
        """A refusal is ``(code, message)`` or ``(code, message, headers)``;
        every 503 tells the caller when to retry."""
        if self.is_terminating:
            return (503, "Service is shutting down.",
                    {"Retry-After": "1", "X-Draining": "1"})
        if spec.in_flight >= spec.maximum_concurrent_requests:
            return 503, "Too many requests; try again later.", {
                "Retry-After": "1"}
        if spec.content_types:
            ctype = request.content_type or ""
            if ctype not in spec.content_types:
                return 401, f"Unsupported content type: {ctype}"
        if (spec.content_max_length
                and (request.content_length or 0) > spec.content_max_length):
            return 413, "Payload too large."
        if spec.admission_check is not None:
            return spec.admission_check()
        return None

    def _reserve(self, spec: EndpointSpec) -> None:
        spec.in_flight += 1
        self._inflight.inc(path=spec.api_path, service=self.name)
        if self.reporter is not None:
            # The cross-replica aggregated counter; fire-and-forget.
            self.reporter.report(self.prefix + spec.api_path, increment=1)

    def _release(self, spec: EndpointSpec) -> None:
        spec.in_flight -= 1
        self._inflight.dec(path=spec.api_path, service=self.name)
        if self.reporter is not None:
            self.reporter.report(self.prefix + spec.api_path, decrement=1)

    def _make_handler(self, spec: EndpointSpec):
        async def handler(request: web.Request) -> web.Response:
            # Admission check and slot reservation happen with no await in
            # between, so the per-endpoint cap holds under concurrency.
            err = self._admission_error(spec, request)
            if err:
                code, msg, *rest = err
                self._http_total.inc(code=str(code), path=spec.api_path)
                return web.Response(status=code, text=msg,
                                    headers=rest[0] if rest else None)
            self._reserve(spec)

            released_to_background = False
            try:
                if spec.request_processing_function is not None:
                    kwargs = spec.request_processing_function(request)
                    if asyncio.iscoroutine(kwargs):
                        kwargs = await kwargs
                    if kwargs is None:
                        self._http_total.inc(code="400", path=spec.api_path)
                        return web.Response(
                            status=400, text="Unable to process request data.")
                else:
                    kwargs = {"body": await request.read(),
                              "content_type": request.content_type}
                if spec.is_async:
                    resp = await self._run_async(spec, request, kwargs)
                    released_to_background = True  # _execute_async releases
                    return resp
                return await self._run_sync(spec, request, kwargs)
            finally:
                if not released_to_background:
                    self._release(spec)

        return handler

    # -- sync path ---------------------------------------------------------

    async def _run_sync(self, spec: EndpointSpec, request: web.Request,
                        kwargs: dict) -> web.Response:
        t0 = time.perf_counter()
        try:
            with self.tracer.span(spec.api_path, headers=request.headers,
                                  path=spec.api_path):
                result = await self._invoke(spec.func, **kwargs)
            resp = self._to_response(result)
            self._http_total.inc(code=str(resp.status), path=spec.api_path)
            return resp
        except Exception as exc:  # noqa: BLE001 — a failed request answers 500
            log.exception("sync endpoint %s failed", spec.api_path)
            self._http_total.inc(code="500", path=spec.api_path)
            return web.Response(status=500, text=f"Error: {exc}")
        finally:
            self._latency.observe(time.perf_counter() - t0, path=spec.api_path)

    # -- async path --------------------------------------------------------

    async def _run_async(self, spec: EndpointSpec, request: web.Request,
                         kwargs: dict) -> web.Response:
        incoming_task_id = request.headers.get(TASK_ID_HEADER, "") or None
        task = await self.task_manager.add_task(
            endpoint=str(request.url), body=b"", task_id=incoming_task_id)
        task_id = task["TaskId"]
        # Nothing awaits from this check to the run's registration below,
        # so of two deliveries read at once the second sees the first's
        # run. The epoch is read after the store read, which sees a
        # failover's new epoch first.
        epoch = self._store_epoch()
        if (spec.api_path, task_id, epoch) in self._running:
            return self._acknowledge(spec, task)
        if (incoming_task_id is not None
                and TaskStatus.canonical(task.get("Status", ""))
                in TaskStatus.TERMINAL):
            # Terminal re-check at adoption: a redelivered message for a
            # task that already finished must not run again, or its
            # running/completed writes would clobber the terminal status a
            # client may already have read. 200 acknowledges the message.
            return self._acknowledge(spec, task)

        # The reserved slot is held until the background execution ends:
        # the cap covers running tasks, not just open connections.
        parent_headers = {
            k: request.headers[k]
            for k in (TRACE_HEADER, SPAN_HEADER, PARENT_HEADER, SAMPLED_HEADER)
            if k in request.headers}
        self._running.add((spec.api_path, task_id, epoch))
        bg = asyncio.get_running_loop().create_task(
            self._execute_async(spec, task_id, kwargs, parent_headers,
                                epoch))
        self._background.add(bg)
        bg.add_done_callback(self._background.discard)

        self._http_total.inc(code="200", path=spec.api_path)
        return web.json_response({"TaskId": task_id,
                                  "Status": task.get("Status", "created")})

    async def _execute_async(self, spec: EndpointSpec, task_id: str,
                             kwargs: dict, parent_headers: dict,
                             epoch: int) -> None:
        t0 = time.perf_counter()
        try:
            # One span keyed by TaskId covers the whole background run.
            with self.tracer.span(spec.api_path, task_id=task_id,
                                  headers=parent_headers, path=spec.api_path):
                await self._invoke(spec.func, taskId=task_id, **kwargs)
        except Exception as exc:  # noqa: BLE001 — the task records the failure
            log.exception("async endpoint %s task %s failed", spec.api_path,
                          task_id)
            try:
                # Terminal re-check: a handler that completed the task and
                # then raised must not flip the completion to `failed`.
                if not await self.task_manager.is_terminal(task_id):
                    await self.task_manager.fail_task(task_id, f"failed: {exc}")
            except Exception:  # noqa: BLE001 — logged; nothing else to do
                log.exception("could not fail task %s", task_id)
        finally:
            self._running.discard((spec.api_path, task_id, epoch))
            self._release(spec)
            self._latency.observe(time.perf_counter() - t0, path=spec.api_path)

    def _store_epoch(self) -> int:
        """The highest epoch the task store has answered with (an HTTP
        store client's ``store_epoch``; 0 for a store in this process)."""
        return getattr(self.task_manager, "store_epoch", 0)

    def _acknowledge(self, spec: EndpointSpec, task: dict) -> web.Response:
        """200 for a delivery that must not run: the task already finished
        (a redelivered message), or this process is running it now under
        the same store epoch. Its slot is released; the message is
        acknowledged."""
        self._release(spec)
        self._http_total.inc(code="200", path=spec.api_path)
        return web.json_response(task)

    async def _invoke(self, func: Callable, **kwargs) -> Any:
        if asyncio.iscoroutinefunction(func):
            return await func(**kwargs)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self.executor, lambda: func(**kwargs))

    @staticmethod
    def _to_response(result: Any) -> web.Response:
        if isinstance(result, web.Response):
            return result
        if isinstance(result, (dict, list)):
            return web.json_response(result)
        if isinstance(result, bytes):
            return web.Response(body=result)
        return web.Response(text=str(result))

    # -- built-in routes ---------------------------------------------------

    async def _health(self, _: web.Request) -> web.Response:
        if self.is_terminating:
            return web.Response(status=503, text="Draining.",
                                headers={"Retry-After": "1", "X-Draining": "1"})
        return web.json_response({"service": self.name, "status": "healthy"})

    async def _task_status(self, request: web.Request) -> web.Response:
        status = await self.task_manager.get_task_status(
            request.match_info["task_id"])
        if status is None:
            return web.Response(status=404, text="Task not found.")
        return web.json_response(status)

    async def _metrics_endpoint(self, _: web.Request) -> web.Response:
        return web.Response(text=self.metrics.render_prometheus(),
                            content_type="text/plain")

    # -- lifecycle ---------------------------------------------------------

    async def drain(self, timeout: float = 30.0) -> None:
        """Refuse new work, then wait for in-flight async tasks."""
        self.is_terminating = True
        if self._background:
            await asyncio.wait(self._background, timeout=timeout)
        self.executor.shutdown(wait=False)
