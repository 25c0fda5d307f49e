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

A servable served with ``pipeline_to`` is a pipeline stage: after its
inference the handoff hands the task, under the same TaskId, to the next
API (the detector's crops to the species classifier's batch endpoint,
``handoffs.crops_handoff``). ``serve_batch`` adds a batch API: one request
carries a stack of examples, fanned into the batcher at background
priority, with per-item failure isolation. ``serve_stream`` serves an
autoregressive LM through a continuous-batching ``DecodeEngine``
(``runtime/decode.py``) on ``{prefix}/{name}-stream-async``: a prompt of
token ids in, ``{"tokens", "count"}`` out, each token handed on as it is
generated.

The operator's surface is the JAX worker's too:

- ``POST {prefix}/models/{name}/reload`` swaps a model's weights from a
  ``.npz`` checkpoint between batches (``ModelRuntime.reload_params``):
  404 unknown model, 400 no checkpoint known, a bad body, a checkpoint that
  is not a ``.npz`` (the answer names ``scripts/orbax_to_npz.py``) or one
  that fails to load, 403 a path outside ``checkpoint_root``, 409 a tree
  that does not match the served one (serving unchanged) or a worker that
  is draining, 200 with the new ``params_version``; a streaming LM's
  reload also invalidates its K/V cache, and its engine re-prefills the
  active sequences;
- ``POST {prefix}/worker/drain`` stops admitting (503 + ``Retry-After`` +
  ``X-Draining``), retires uncut requests (an async task goes back to the
  broker) and waits, at most the drain budget, for the batches on the card,
  the active decode sequences and any reload; ``GET`` reports the state
  (``decode_active`` among it) and ``POST
  {prefix}/worker/resume`` serves again.

With ``hop_ledger`` (``AI4E_OBSERVABILITY_HOP_LEDGER``) every async
request carries an ``observability.HopLedger`` through the batcher (the
batch cut and the device phases) and flushes it to the task store in one
call before its terminal transition (a pipeline stage before its handoff;
a request the drain retires with a ``retry`` event first), so the control
plane's timeline of the task is whole across the process boundary. A
batch-API stack shares one ledger across its items, which the batcher
stamps once a batch (JAX's batch API stamps nothing). A flush that fails
is dropped: a timeline is lost, never a task.

Each model's ``generation`` (``AI4E_ROLLOUT_GENERATION`` at start, or a
reload's ``generation``) labels its inference outcomes,
``ai4e_rollout_outcomes_total{generation,outcome}`` with ``ok``,
``error``, ``expired``, ``saturated`` and ``draining``, and its latency,
``ai4e_rollout_request_seconds{generation}``, on the sync and async
paths where JAX's worker counts them; the label folds into ``other``
after ``rollout.canary.GENERATION_LABEL_CAP`` values. With a ``reporter``
each request reports to the cross-replica request reporter.

Deadlines (admission, as in JAX): a request's ``X-Deadline-At`` (stamped
by the dispatcher or the sync proxy) or ``X-Deadline-Ms`` (a direct
caller) and ``X-Priority`` ride into the batcher or the decode engine. The
worker is the last hop before the card: work already expired answers 504
on the sync path and turns terminal ``expired`` on the async and stream
paths without being queued, and work that expires while queued is dropped
there (``DeadlineExceeded``) and ends the same way; each drop counts in
``ai4e_admission_expired_total{hop}``. An unlabelled direct request is
interactive, as it always was.

With ``admin_api_keys`` (``AI4E_GATEWAY_API_KEYS``, the gateway's keys)
the reload, drain (POST) and resume verbs answer 401 without
``Ocp-Apim-Subscription-Key`` or ``X-Api-Key`` naming one; ``GET
/models``, the drain status and the inference routes stay open, as in JAX.

With a ``result_cache`` (``rescache.ResultCache``, the caching gateway's
in the same process) a reload invalidates every endpoint path the model
serves (the gateway's and dispatcher's key namespace) once the swap
lands, so no answer of the old weights is served after it.
The worker answers nothing from the cache itself: the gateway in front
of it does.
"""

from __future__ import annotations

import asyncio
import inspect
import io
import json
import logging
import os
import time

import numpy as np
from aiohttp import web

from ..admission.deadline import (SHED_REASON_HEADER, DeadlineExceeded,
                                  expired, expired_status, priority_name,
                                  shed_reason, worker_admission_kwargs)
from ..checkpoint import CONVERTER_HINT, is_npz, load_params
from ..metrics import MetricsRegistry
from ..observability.ledger import CHUNK, RETRY, HopLedger
from ..pipeline.spec import split_sub_task_id
from ..rollout.canary import generation_label
from ..rollout.drain import DRAINING_HEADER, DrainingError, DrainState, \
    drain_worker
from ..service import APIService
from ..service.task_manager import TaskManagerBase
from ..taskstore import TaskStatus
from .batcher import BatcherSaturated, MicroBatcher
from .decode import DecodeSaturated
from .registry import ModelRuntime, ServableModel

log = logging.getLogger("ai4e_tpu_torch.worker")

#: A draining worker's refusal, as the JAX worker's.
DRAINING_REFUSAL = (503, "Worker draining; retry a peer.",
                    {"Retry-After": "1", DRAINING_HEADER: "1",
                     SHED_REASON_HEADER: shed_reason("worker", "draining")})


async def _request_kwargs(request) -> dict:
    """The endpoints' keyword arguments: the body, its content type and
    the request's deadline and class (``worker_admission_kwargs``)."""
    return {"body": await request.read(),
            "content_type": request.content_type,
            **worker_admission_kwargs(request.headers)}


class InferenceWorker:
    """Hosts one or more servables behind one service shell."""

    def __init__(self, name: str, runtime: ModelRuntime, batcher: MicroBatcher,
                 task_manager: TaskManagerBase | None = None,
                 prefix: str = "v1", metrics: MetricsRegistry | None = None,
                 store=None, executor_workers: int = 8,
                 checkpoint_root: str | None = None,
                 hop_ledger: bool = False,
                 drain_timeout_s: float = 30.0,
                 result_cache=None, admin_api_keys=None, reporter=None):
        self.runtime = runtime
        self.batcher = batcher
        self.store = store
        # The caching gateway's result cache, for the reload's
        # invalidation.
        self.result_cache = result_cache
        # The admin verbs' key gate: the gateway's keys; None: open.
        self._admin_keys = set(admin_api_keys) if admin_api_keys else None
        # Off: no ledger is allocated and no extra store call made.
        self.hop_ledger = hop_ledger
        # Reload confinement: checkpoints must resolve (symlinks included)
        # under this directory, else 403. None keeps reload open.
        self._checkpoint_root = (os.path.realpath(checkpoint_root)
                                 if checkpoint_root else None)
        self.service = APIService(name, prefix=prefix,
                                  task_manager=task_manager, metrics=metrics,
                                  executor_workers=executor_workers,
                                  reporter=reporter)
        self._served: dict[str, dict] = {}  # model -> endpoint listing
        # The decode engines ``serve_stream`` serves: the reload verb finds
        # LMs here (they never enter runtime.models), the drain and resume
        # verbs reach them, and ``cli.serve`` starts and stops them.
        self.decode_engines: list = []
        # Concurrent swaps would leave checkpoint_path/params_version
        # naming other weights than the ones serving.
        self._reload_lock = asyncio.Lock()
        # One drain state for the batcher, the reload verb and admission.
        self.drain_state = DrainState()
        self._drain_timeout_s = drain_timeout_s
        # Outcomes and latency by rollout generation: a canary's series
        # beside the incumbent's.
        self._rollout_outcomes = self.service.metrics.counter(
            "ai4e_rollout_outcomes_total",
            "Worker inference outcomes by rollout generation")
        self._rollout_latency = self.service.metrics.histogram(
            "ai4e_rollout_request_seconds",
            "Worker inference latency by rollout generation")
        self._drain_gauge = self.service.metrics.gauge(
            "ai4e_rollout_drain_state",
            "Worker drain state (0 active, 1 draining, 2 drained)")
        # Deadline drops at the submit hop; the batcher and the decode
        # engine count theirs in the same family.
        self._expired_total = self.service.metrics.counter(
            "ai4e_admission_expired_total",
            "Requests dropped on deadline expiry, by hop/priority")
        router, base = self.service.app.router, self.service.prefix
        router.add_get(base + "/models", self._list_models)
        router.add_post(base + "/models/{name}/reload", self._reload_model)
        router.add_post(base + "/worker/drain", self._drain_worker)
        router.add_get(base + "/worker/drain", self._drain_status)
        router.add_post(base + "/worker/resume", self._resume_worker)

    def _admin_denied(self, request) -> web.Response | None:
        """The admin verbs' key gate, with the gateway middleware's header
        contract: a 401, or None to pass."""
        if self._admin_keys is None:
            return None
        key = (request.headers.get("Ocp-Apim-Subscription-Key")
               or request.headers.get("X-Api-Key"))
        if key not in self._admin_keys:
            return web.json_response(
                {"error": "missing or invalid subscription key"},
                status=401)
        return None

    async def _drain_worker(self, request) -> web.Response:
        """POST {prefix}/worker/drain — stop admitting, retire uncut work,
        finish the batches on the card and any reload within the budget.
        Idempotent. Body (optional): ``{"timeout_ms": N}`` overrides the
        budget."""
        denied = self._admin_denied(request)
        if denied is not None:
            return denied
        timeout_s = self._drain_timeout_s
        try:
            payload = json.loads(await request.read() or b"{}")
            if isinstance(payload, dict) and "timeout_ms" in payload:
                timeout_s = max(0.0, float(payload["timeout_ms"])) / 1000.0
        except (json.JSONDecodeError, TypeError, ValueError):
            return web.json_response({"error": "invalid JSON"}, status=400)
        summary = await drain_worker(self.drain_state, batchers=[self.batcher],
                                     engines=self.decode_engines,
                                     timeout_s=timeout_s)
        self._drain_gauge.set(self.drain_state.state_code)
        log.warning("worker drained: %s", summary)
        return web.json_response(summary)

    async def _drain_status(self, _request) -> web.Response:
        return web.json_response({
            "state": self.drain_state.state,
            "reloads_in_flight": self.drain_state.reloads_in_flight,
            "batcher_pending": self.batcher.pending_count,
            "decode_active": sum(e.active_count
                                 for e in self.decode_engines)})

    async def _resume_worker(self, request) -> web.Response:
        """POST {prefix}/worker/resume — serve again after a drain."""
        denied = self._admin_denied(request)
        if denied is not None:
            return denied
        self.drain_state.resume()
        self.batcher.resume_from_drain()
        for engine in self.decode_engines:
            engine.resume_from_drain()
        self._drain_gauge.set(self.drain_state.state_code)
        log.warning("worker resumed from drain")
        return web.json_response({"state": self.drain_state.state})

    async def _reload_model(self, request) -> web.Response:
        """POST {prefix}/models/{name}/reload — swap the model's weights for
        its recorded checkpoint's, or the ``.npz`` the JSON body names
        (``{"checkpoint": path, "generation": n}``; a relative path resolves
        against the recorded checkpoint's directory), between batches."""
        denied = self._admin_denied(request)
        if denied is not None:
            return denied
        name = request.match_info["name"]
        servable = self.runtime.models.get(name)
        lm_backend = None
        if servable is None:
            # A streaming LM lives on its decode engine; the version bump
            # of its reload makes the engine clear the K/V cache and
            # re-prefill the active sequences.
            lm_backend = next(
                (e.backend for e in self.decode_engines
                 if getattr(e.backend, "name", None) == name), None)
            if lm_backend is None:
                return web.json_response({"error": "unknown model"},
                                         status=404)
            servable = lm_backend.servable
        try:
            payload = json.loads(await request.read() or b"{}")
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON"}, status=400)
        if not isinstance(payload, dict):
            return web.json_response(
                {"error": "body must be a JSON object"}, status=400)
        path = payload.get("checkpoint") or servable.checkpoint_path
        if not path:
            return web.json_response(
                {"error": "model has no checkpoint to reload; pass "
                          '{"checkpoint": ...}'}, status=400)
        if not isinstance(path, str):
            return web.json_response(
                {"error": "checkpoint must be a string path"}, status=400)
        if not os.path.isabs(path):
            if not servable.checkpoint_path:
                return web.json_response(
                    {"error": "relative checkpoint path but the model has "
                              "no recorded checkpoint directory; pass an "
                              "absolute path"}, status=400)
            path = os.path.abspath(os.path.join(
                os.path.dirname(servable.checkpoint_path), path))
        if self._checkpoint_root is not None:
            real = os.path.realpath(path)
            if not (real == self._checkpoint_root
                    or real.startswith(self._checkpoint_root + os.sep)):
                return web.json_response(
                    {"error": "checkpoint path escapes the configured "
                              "checkpoint directory"}, status=403)
            path = real
        if not is_npz(path):
            return web.json_response(
                {"error": f"checkpoint {path!r} is not a .npz: "
                          f"{CONVERTER_HINT}"}, status=400)
        generation = payload.get("generation")
        if generation is not None and not isinstance(generation, int):
            return web.json_response(
                {"error": "generation must be an integer"}, status=400)

        def load_and_swap():
            if lm_backend is not None:
                return lm_backend.reload_params(load_params(path))
            return self.runtime.reload_params(name, load_params(path))

        # Check and register in one synchronous step: a reload racing a
        # drain either lands before the drain (which waits for it) or is
        # refused here.
        if not self.drain_state.try_begin_reload():
            return web.json_response(
                {"error": "worker is draining; reload refused — the "
                          "rollout path owns this replica now"},
                status=409, headers={DRAINING_HEADER: "1"})
        try:
            async with self._reload_lock:
                try:
                    await asyncio.to_thread(load_and_swap)
                except ValueError as exc:
                    return web.json_response({"error": str(exc)}, status=409)
                except Exception as exc:  # noqa: BLE001; ai4e: noqa[AIL005] — the error is returned to the caller as the 400 body
                    return web.json_response(
                        {"error": f"reload failed: {type(exc).__name__}: "
                                  f"{exc}"}, status=400)
                servable.checkpoint_path = path
                if generation is not None:
                    servable.generation = generation
                if self.result_cache is not None:
                    # Every answer this model could have given goes: each
                    # endpoint path it serves is a family of the gateway's
                    # and dispatcher's keys.
                    for family in self._served.get(name, {}).values():
                        self.result_cache.invalidate_family(family)
                log.info("reloaded %s from %s (params_version %d)", name,
                         path, servable.params_version)
                return web.json_response(
                    {"model": name, "checkpoint": path,
                     "params_version": servable.params_version,
                     "generation": servable.generation})
        finally:
            self.drain_state.end_reload()

    async def _list_models(self, _request) -> web.Response:
        out = [{
            "name": name, "version": s.version,
            "params_version": s.params_version,
            "generation": s.generation,
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
                    maximum_concurrent_requests: int = 64,
                    pipeline_to=None) -> None:
        """Expose a servable on a sync and an async endpoint.

        ``pipeline_to`` makes the servable a pipeline stage: a callable
        ``(result) -> (next_endpoint, body_bytes) | None`` evaluated after
        inference on the async path; a two-argument callable also gets the
        stage's decoded input example (a crops handoff needs the image). A
        tuple stores the stage's result under ``?stage=<name>`` and hands
        the task, same TaskId, to the next API (``add_pipeline_task``; an
        empty body replays the original one); ``None`` means nothing to
        hand off, and the stage completes the task itself."""
        if pipeline_to is not None:
            params = [
                p for p in inspect.signature(pipeline_to).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
            handoff_wants_example = len(params) >= 2
        else:
            handoff_wants_example = False
        name = servable.name
        sync_path = sync_path or f"/{name}"
        async_path = async_path or f"/{name}-async"
        self._served.setdefault(name, {}).update({
            "sync": self.service.prefix + sync_path,
            "async": self.service.prefix + async_path})

        def _saturation_check():
            # Refuse before adopting a task, so a dispatcher's 503 handling
            # (delay and redeliver) engages; a draining worker first.
            if self.drain_state.is_draining:
                return DRAINING_REFUSAL
            if self.batcher.pending_count >= self.batcher.max_pending:
                return 503, "Inference queue saturated; retry later.", {
                    "Retry-After": "1"}
            return None

        @self.service.api_sync_func(
            sync_path, maximum_concurrent_requests=maximum_concurrent_requests,
            admission_check=_saturation_check,
            request_processing_function=_request_kwargs)
        async def _sync(body, content_type, deadline_at=0.0, priority=0,
                        _name=name, _servable=servable):
            if expired(deadline_at):
                # The budget is already spent: 504 now, no result the
                # caller stopped waiting for.
                self._note_expired(priority)
                return web.Response(
                    status=504, text="Deadline exceeded before execution.",
                    headers={SHED_REASON_HEADER:
                             shed_reason("worker", "deadline")})
            example = _servable.preprocess(body, content_type)
            gen_label = generation_label(_servable.generation)
            t0 = time.perf_counter()
            try:
                result = await self.batcher.submit(
                    _name, np.asarray(example), priority=priority,
                    deadline_at=deadline_at)
            except BatcherSaturated:
                self._rollout_outcomes.inc(generation=gen_label,
                                           outcome="saturated")
                return web.Response(status=503,
                                    text="Inference queue saturated; retry.",
                                    headers={"Retry-After": "1"})
            except DrainingError:
                # Raced the drain between admission and submit, or retired
                # by it before the cut: retryable at a peer.
                self._rollout_outcomes.inc(generation=gen_label,
                                           outcome="draining")
                return web.Response(
                    status=503, text="Worker draining; retry a peer.",
                    headers={"Retry-After": "1", DRAINING_HEADER: "1"})
            except DeadlineExceeded as exc:
                self._rollout_outcomes.inc(generation=gen_label,
                                           outcome="expired")
                return web.Response(
                    status=504, text="Deadline exceeded while queued.",
                    headers={SHED_REASON_HEADER:
                             shed_reason(exc.hop, "deadline")})
            except Exception:
                self._rollout_outcomes.inc(generation=gen_label,
                                           outcome="error")
                raise
            self._rollout_outcomes.inc(generation=gen_label, outcome="ok")
            self._rollout_latency.observe(time.perf_counter() - t0,
                                          generation=gen_label)
            return _jsonable(result)

        @self.service.api_async_func(
            async_path, maximum_concurrent_requests=maximum_concurrent_requests,
            admission_check=_saturation_check,
            request_processing_function=_request_kwargs)
        async def _async(taskId, body, content_type, deadline_at=0.0,
                         priority=0, _name=name, _servable=servable):
            tm = self.service.task_manager
            buf = HopLedger() if self.hop_ledger else None
            if expired(deadline_at):
                # Terminal ``expired``, never queued; the dispatcher takes
                # the 200 as delivered.
                self._note_expired(priority)
                await tm.update_task_status(
                    taskId, expired_status("worker"), TaskStatus.EXPIRED)
                return
            await tm.update_task_status(taskId, f"running - {_name} inference")
            try:
                example = _servable.preprocess(body, content_type)
            except Exception as exc:  # noqa: BLE001; ai4e: noqa[AIL005] — the error is recorded on the task record (failed - bad input)
                await tm.fail_task(taskId, f"failed - bad input: {exc}")
                return
            gen_label = generation_label(_servable.generation)
            t0 = time.perf_counter()
            try:
                result = await self.batcher.submit(
                    _name, np.asarray(example), priority=priority,
                    deadline_at=deadline_at, **_ledger_kw(buf))
            except DeadlineExceeded as exc:
                # Expired while queued (the batcher counted it): the
                # terminal transition only.
                self._rollout_outcomes.inc(generation=gen_label,
                                           outcome="expired")
                await self._flush_ledger(tm, taskId, buf)
                await tm.update_task_status(
                    taskId, expired_status(exc.hop), TaskStatus.EXPIRED)
                return
            except BatcherSaturated:
                # Saturated between admission and the cut: hand the task
                # back to the broker (a republish with an empty body
                # replays the original one) instead of failing it. With no
                # broker behind the store the exception propagates and the
                # service shell fails the task.
                self._rollout_outcomes.inc(generation=gen_label,
                                           outcome="saturated")
                if not tm.redelivers:
                    raise
                await _hand_back(tm, taskId, async_path)
                return
            except DrainingError:
                # Retired by a drain before the cut: the same hand-back,
                # with the retry stamped and flushed while the task is live.
                self._rollout_outcomes.inc(generation=gen_label,
                                           outcome="draining")
                if buf is not None:
                    buf.stamp(RETRY, "worker", reason="draining")
                await self._flush_ledger(tm, taskId, buf)
                if not tm.redelivers:
                    raise
                await _hand_back(tm, taskId, async_path)
                return
            except Exception:
                # The shell fails the task after this re-raise: flush first,
                # while the task is live, so a failed request keeps its
                # worker-side timeline.
                self._rollout_outcomes.inc(generation=gen_label,
                                           outcome="error")
                await self._flush_ledger(tm, taskId, buf)
                raise
            self._rollout_outcomes.inc(generation=gen_label, outcome="ok")
            self._rollout_latency.observe(time.perf_counter() - t0,
                                          generation=gen_label)
            if pipeline_to is not None:
                if handoff_wants_example:
                    # Handoffs consume the natural image; a wire-encoded
                    # servable decodes it back first.
                    img = (_servable.example_decoder(example)
                           if _servable.example_decoder is not None
                           else example)
                    handoff = pipeline_to(result, img)
                else:
                    handoff = pipeline_to(result)
                if handoff is not None:
                    next_endpoint, next_body = handoff
                    # This stage's events flush now; the next stage's
                    # worker keeps a ledger of its own under the same
                    # TaskId.
                    await self._flush_ledger(tm, taskId, buf)
                    # The stage's own result stays readable under the same
                    # TaskId while the task moves on.
                    await self._store_result(
                        taskId, json.dumps(_jsonable(result)).encode(),
                        stage=_name)
                    await tm.update_task_status(
                        taskId, f"running - {_name} handing off to "
                                f"{next_endpoint}")
                    await tm.add_pipeline_task(taskId, next_endpoint,
                                               body=next_body)
                    return
            # Before the result write and the terminal transition: the task
            # is live (retention cannot have evicted it).
            await self._flush_ledger(tm, taskId, buf)
            await self._store_result(
                taskId, json.dumps(_jsonable(result)).encode())
            await tm.complete_task(taskId, f"completed - {_summarise(result)}")

    def _note_expired(self, priority: int) -> None:
        self._expired_total.inc(hop="worker", priority=priority_name(priority))

    async def _flush_ledger(self, tm, task_id: str, buf) -> None:
        """Ship a request's buffered hop-ledger events to the store in one
        call. Drains the buffer, so a second flush is a no-op; a failure is
        dropped with a debug log, as in JAX: fail-open telemetry."""
        if buf is None:
            return
        events = buf.drain()
        if not events:
            return
        try:
            await tm.append_ledger(task_id, events)
        except Exception:  # noqa: BLE001 — a dropped flush loses a timeline, not a task
            log.debug("hop-ledger flush dropped for task %s", task_id,
                      exc_info=True)

    def serve_batch(self, servable: ServableModel,
                    sync_path: str | None = None,
                    async_path: str | None = None,
                    max_items: int = 1024,
                    submit_concurrency: int = 64,
                    progress_every: float = 2.0,
                    maximum_concurrent_requests: int = 8) -> None:
        """Expose a batch API for a servable: one request carries a stack
        of N examples, an npy array of shape ``(N, *stack_item_shape)``
        (``input_shape`` unless the servable declares another), which the
        worker fans into the micro-batcher at background priority (1) and
        gathers back in order: ``{"count", "failed", "items": [{"index",
        "result"} | {"index", "error"}]}``. A bad item gets an ``error``
        entry and never fails the stack. The async path reports progress
        (``running - {name} batch k/N``) and completes with ``completed -
        N images, M errors``."""
        name = servable.name
        sync_path = sync_path or f"/{name}-batch"
        async_path = async_path or f"/{name}-batch-async"
        self._served.setdefault(name, {}).update(
            batch_sync=self.service.prefix + sync_path,
            batch_async=self.service.prefix + async_path)
        item_shape = tuple(servable.stack_item_shape
                           or servable.input_shape)
        item_dtype = (servable.stack_item_dtype
                      if servable.stack_item_dtype is not None
                      else servable.input_dtype)

        def _decode_stack(body: bytes) -> np.ndarray:
            arr = np.load(io.BytesIO(body))
            if (arr.ndim != len(item_shape) + 1
                    or tuple(arr.shape[1:]) != item_shape):
                raise ValueError(
                    f"expected stack (N, {', '.join(map(str, item_shape))}), "
                    f"got {arr.shape}")
            if len(arr) == 0:
                raise ValueError("empty batch")
            if len(arr) > max_items:
                raise ValueError(f"batch of {len(arr)} exceeds max {max_items}")
            if servable.stack_validator is not None:
                # On the raw values, before the cast (see ServableModel).
                servable.stack_validator(arr)
            from .families import cast_image_payload
            arr = cast_image_payload(arr, item_dtype)
            if servable.stack_adapter is not None:
                arr = np.stack([servable.stack_adapter(x) for x in arr])
            return arr

        async def _run_stack(stack: np.ndarray, on_progress=None,
                             ledger=None) -> list:
            results: list = [None] * len(stack)
            done = 0
            queue: asyncio.Queue[int] = asyncio.Queue()
            for i in range(len(stack)):
                queue.put_nowait(i)

            async def _puller():
                nonlocal done
                while True:
                    try:
                        i = queue.get_nowait()
                    except asyncio.QueueEmpty:
                        return
                    while True:
                        try:
                            # Background priority: the stack shares batches
                            # with interactive requests, never ahead of them.
                            out = await self.batcher.submit(
                                name, np.asarray(stack[i]), priority=1,
                                **_ledger_kw(ledger))
                            results[i] = {"index": i, "result": _jsonable(out)}
                            break
                        except BatcherSaturated:
                            await asyncio.sleep(0.05)  # throttle, not fail
                        except Exception as exc:  # noqa: BLE001; ai4e: noqa[AIL005] — the error is reported in the batch result payload for this index
                            results[i] = {"index": i, "error": str(exc)}
                            break
                    done += 1
                    if on_progress is not None:
                        await on_progress(done, len(stack))

            pullers = min(submit_concurrency, len(stack))
            await asyncio.gather(*(_puller() for _ in range(pullers)))
            return results

        @self.service.api_sync_func(
            sync_path, maximum_concurrent_requests=maximum_concurrent_requests)
        async def _sync_batch(body, content_type):
            # Off the event loop: decoding a large stack is numpy work that
            # must not stall the interactive requests.
            stack = await asyncio.to_thread(_decode_stack, body)
            results = await _run_stack(stack)
            failed = sum(1 for r in results if "error" in r)
            return {"count": len(results), "failed": failed, "items": results}

        @self.service.api_async_func(
            async_path, maximum_concurrent_requests=maximum_concurrent_requests)
        async def _async_batch(taskId, body, content_type):
            tm = self.service.task_manager
            try:
                stack = await asyncio.to_thread(_decode_stack, body)
            except Exception as exc:  # noqa: BLE001; ai4e: noqa[AIL005] — the error is recorded on the task record (failed - bad input)
                await tm.fail_task(taskId, f"failed - bad input: {exc}")
                return
            total = len(stack)
            await tm.update_task_status(
                taskId, f"running - {name} batch 0/{total}")
            last = {"t": 0.0}

            async def on_progress(k, n):
                now = time.monotonic()
                if now - last["t"] >= progress_every or k == n:
                    last["t"] = now
                    await tm.update_task_status(
                        taskId, f"running - {name} batch {k}/{n}")

            buf = HopLedger() if self.hop_ledger else None
            results = await _run_stack(stack, on_progress, ledger=buf)
            failed = sum(1 for r in results if "error" in r)
            await self._flush_ledger(tm, taskId, buf)
            await self._store_result(taskId, json.dumps(
                {"count": total, "failed": failed, "items": results}).encode())
            # Never the word "failed" in this terminal status: canonical
            # bucketing tests for "failed" first.
            await tm.complete_task(
                taskId, f"completed - {total} images, {failed} errors")

    def serve_stream(self, engine, async_path: str | None = None,
                     maximum_concurrent_requests: int = 64,
                     event_hub=None) -> None:
        """Expose a streaming autoregressive endpoint over a
        ``DecodeEngine``: the request joins the running decode batch
        between steps, and each generated token goes to ``event_hub``
        (any object with ``track(task_id)`` and ``publish(task_id, event,
        data)``) as a ``chunk`` event under the request's TaskId, the
        moment it exists; a pipeline stage's sub-task publishes under its root
        TaskId, the one stream a client watches, labelled with the stage.
        With ``event_hub=None``, as the CLI runs it, the tokens are only
        stored at the end.

        Request body (JSON): ``{"prompt": [token ids], "max_new_tokens":
        N}`` (``"tokens"`` in place of ``"prompt"`` takes an upstream
        stage's stored result); a bad body, an id outside the vocabulary
        or a prompt that leaves no room under the cache length fails the
        task as ``failed - bad input``. The stored result is ``{"tokens":
        [...], "count": N}`` and the status ``completed - N tokens``. A
        draining worker or a full pending queue answers 503 before a task
        is adopted; an engine saturated or drained after adoption hands
        the task back to the broker (a standalone worker fails it)."""
        name = engine.backend.name
        async_path = async_path or f"/{name}-stream-async"
        self._served.setdefault(name, {}).update(
            stream_async=self.service.prefix + async_path)
        self.decode_engines.append(engine)
        servable = getattr(engine.backend, "servable", None)
        vocab = getattr(servable, "vocab_size", None)
        max_len = engine.backend.max_len

        def _saturation_check():
            if self.drain_state.is_draining:
                return DRAINING_REFUSAL
            if engine.pending_count >= engine.max_pending:
                return 503, "Decode queue saturated; retry later.", {
                    "Retry-After": "1"}
            return None

        def _parse(body: bytes) -> tuple[list[int], int]:
            payload = json.loads(body)
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            prompt = payload.get("prompt", payload.get("tokens"))
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) for t in prompt)):
                raise ValueError('"prompt" must be a non-empty list of '
                                 'token ids')
            if vocab is not None and any(not 0 <= t < vocab for t in prompt):
                raise ValueError(f"token ids must be in [0, {vocab})")
            if len(prompt) >= max_len:
                raise ValueError(
                    f"prompt of {len(prompt)} tokens leaves no room to "
                    f"generate under the KV-cache length {max_len}")
            max_new = payload.get("max_new_tokens", 64)
            if not isinstance(max_new, int) or max_new < 1:
                raise ValueError('"max_new_tokens" must be a positive int')
            return prompt, max_new

        @self.service.api_async_func(
            async_path, maximum_concurrent_requests=maximum_concurrent_requests,
            admission_check=_saturation_check,
            request_processing_function=_request_kwargs)
        async def _stream(taskId, body, content_type, deadline_at=0.0,
                          priority=0, _name=name):
            tm = self.service.task_manager
            buf = HopLedger() if self.hop_ledger else None
            if expired(deadline_at):
                self._note_expired(priority)
                await tm.update_task_status(
                    taskId, expired_status("worker"), TaskStatus.EXPIRED)
                return
            try:
                prompt, max_new = _parse(body)
            except (ValueError, json.JSONDecodeError) as exc:
                await tm.fail_task(taskId, f"failed - bad input: {exc}")
                return
            publish_id = taskId
            if event_hub is not None:
                root = split_sub_task_id(taskId)
                if root is not None:
                    publish_id = root[0]
                # Chunks are kept before any subscriber attaches, so one
                # that connects mid-stream replays the tokens so far.
                event_hub.track(publish_id)
            await tm.update_task_status(taskId, f"running - {_name} decode")

            def on_token(index: int, token: int) -> None:
                if event_hub is not None:
                    event_hub.publish(publish_id, CHUNK,
                                      {"stage": _name, "index": index,
                                       "data": {"token": token}})

            try:
                tokens = await engine.submit(prompt, max_new,
                                             on_token=on_token,
                                             priority=priority,
                                             deadline_at=deadline_at,
                                             ledger=buf)
            except DeadlineExceeded as exc:
                # Retired by the engine's sweep (which counted it).
                await self._flush_ledger(tm, taskId, buf)
                await tm.update_task_status(
                    taskId, expired_status(exc.hop), TaskStatus.EXPIRED)
                return
            except DecodeSaturated:
                # Saturated between admission and submit: hand the task
                # back to the broker; a peer decodes it again from the
                # prompt.
                if not tm.redelivers:
                    raise
                await _hand_back(tm, taskId, async_path)
                return
            except DrainingError:
                # Retired by a drain: the same hand-back, the retry stamped
                # and flushed first.
                if buf is not None:
                    buf.stamp(RETRY, "worker", reason="draining")
                await self._flush_ledger(tm, taskId, buf)
                if not tm.redelivers:
                    raise
                await _hand_back(tm, taskId, async_path)
                return
            except Exception:
                await self._flush_ledger(tm, taskId, buf)
                raise
            await self._flush_ledger(tm, taskId, buf)
            await self._store_result(taskId, json.dumps(
                {"tokens": tokens, "count": len(tokens)}).encode())
            await tm.complete_task(taskId,
                                   f"completed - {len(tokens)} tokens")

    async def _store_result(self, task_id: str, payload: bytes,
                            stage: str | None = None) -> None:
        """Store a result (``stage``: a pipeline stage's own, under
        ``?stage=``) in the in-process store (``set_result`` returns None)
        or on the control plane (``HttpResultStore``, a coroutine)."""
        if self.store is None:
            return
        res = self.store.set_result(task_id, payload, stage=stage)
        if inspect.isawaitable(res):
            await res


async def _hand_back(tm, task_id: str, async_path: str) -> None:
    """Republish a task to its own endpoint with an empty body (the store
    replays the original one), so the broker redelivers it to a peer."""
    current = await tm.get_task_status(task_id)
    endpoint = (current or {}).get("Endpoint", async_path)
    await tm.add_pipeline_task(task_id, endpoint)


def _ledger_kw(ledger) -> dict:
    """``submit``'s ``ledger`` keyword, passed only with a ledger: with the
    hop ledger off the batcher is called exactly as before."""
    return {} if ledger is None else {"ledger": ledger}


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
