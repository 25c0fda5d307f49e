"""Control-plane assembly — store + broker + dispatchers + gateway in one
event loop; ``PlatformConfig`` and ``LocalPlatform`` of
``ai4e_tpu/platform_assembly.py``, with the in-memory store (with
``result_dir``, large results offloaded to files) or the native C++ store
(``native_store``), the in-memory broker (transport ``"queue"``) or the
native one (``native_broker``), the reaper's terminal retention and, with
``reaper_running_timeout``, its stuck-task rescue, the
autoscaler on a route's one dispatcher (``scaling.AutoscaleController``),
the queue-depth gauges (``observability.DepthLogger``, always on, as in
JAX) and, with ``observability``, the hop ledger and flight recorder
(``observability.RequestObservability``, shared by the gateway and the
dispatchers), the SLO burn-rate engine on ``slo_objectives`` and, with
``admission``, the admission controller (``admission.AdmissionController``:
deadlines and priority shedding at the gateway, the sync proxy's adaptive
cap, each dispatcher's fan-out on its own limiter unless an autoscaler
owns it, the drain rate and goodput from the store's change feed) and,
with ``result_cache``, the inference result cache
(``rescache.ResultCache``: the gateway answers repeat requests without
dispatching and coalesces identical ones onto one execution, the
dispatchers complete redeliveries from it, the store's change feed fills
it; a worker in the same process takes it as ``result_cache``, so that
its reloads invalidate it).
The sharded store and orchestration, under which the JAX package scales a
route's shards or on a predictive signal, are refused by
``config.check_ported`` (ROADMAP A18.2, A18.9). As in JAX, the native store
refuses ``result_dir``, an explicit ``reaper_terminal_retention`` and
observability, and either native core refuses admission, each with JAX's
text.

``PlatformConfig`` holds the fields ``LocalPlatform`` reads, with the JAX
package's defaults; ``PlatformSection.to_platform_config`` fills it, after
``config.check_ported`` has refused every knob this port does not serve.
Imports neither torch nor JAX: the control-plane process never touches the
card.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass

from .broker import DispatcherPool, InMemoryBroker
from .gateway import Gateway
from .metrics import DEFAULT_REGISTRY, MetricsRegistry
from .observability import (DepthLogger, FlightRecorder,
                            RequestObservability, SloEngine,
                            parse_objectives)
from .service import LocalTaskManager
from .taskstore import InMemoryTaskStore, TaskStatus, endpoint_path
from .taskstore.reaper import TaskReaper

log = logging.getLogger("ai4e_tpu_torch.platform")

# Terminal retention when ``reaper_terminal_retention`` is None, as in the
# JAX package's Python store.
DEFAULT_TERMINAL_RETENTION_S = 900.0


@dataclass
class PlatformConfig:
    retry_delay: float = 60.0       # dispatcher backoff on 429/503
    max_delivery_count: int = 1440  # broker patience
    dispatcher_concurrency: int = 1
    lease_seconds: float = 300.0
    native_broker: bool = False     # C++ broker core (native/broker_core.cpp)
    native_store: bool = False      # C++ task-store core (native/taskstore_core.cpp)
    # Seconds a task may sit in running before the reaper republishes it;
    # None: no rescue.
    reaper_running_timeout: float | None = None
    reaper_interval: float = 30.0
    reaper_max_requeues: int = 3
    # Seconds a completed/failed task is kept: None = 900 on the Python
    # store and forever on the native one (it has no eviction), < 0 =
    # forever.
    reaper_terminal_retention: float | None = None
    # Result offload: results of result_offload_threshold bytes or more are
    # written under result_dir (a directory every process mounts) and the
    # store keeps a pointer. Python store only.
    result_dir: str | None = None
    result_offload_threshold: int = 1024 * 1024
    queue_depth_interval: float = 30.0
    process_depth_interval: float = 300.0
    # Request observability: the hop ledger, the flight recorder and the
    # per-route e2e telemetry; with objectives, the SLO burn-rate engine.
    observability: bool = False
    flight_capacity: int = 512
    flight_sample: float = 0.05
    flight_slow_ms: float = 1000.0
    slo_objectives: str | None = None
    slo_tick_s: float = 5.0
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    # Admission control: deadlines (X-Deadline-Ms / X-Priority /
    # X-Shed-Reason), priority shedding with a drain-rate Retry-After, and
    # an adaptive concurrency limit for the sync proxy and each
    # dispatcher's fan-out. Off by default: on, the platform may refuse or
    # expire work (terminal `expired`) instead of carrying every request
    # to completion however late.
    admission: bool = False
    admission_min_limit: int = 1
    admission_max_limit: int = 256
    admission_initial_limit: int = 8
    # The async edge's backlog capacity the shedder's fractions divide
    # (created tasks per route; background sheds first, at 60%).
    admission_max_backlog: int = 1024
    # Inference result cache and single-flight coalescing. Off by default:
    # on, identical payloads may share results (per-request opt-out:
    # X-Cache-Bypass).
    result_cache: bool = False
    cache_max_entries: int = 4096
    cache_max_bytes: int = 256 * 1024 * 1024
    # Entry lifetime: the staleness bound for a cache that a remote
    # worker's reload cannot reach. None = no TTL.
    cache_ttl_seconds: float | None = 300.0


class LocalPlatform:
    """Everything the async path needs, in one event loop: the task store
    (whose HTTP surface ``taskstore.http.make_app`` adds to the gateway
    app), the broker, one dispatcher per async route and the gateway."""

    def __init__(self, config: PlatformConfig | None = None,
                 metrics: MetricsRegistry | None = None):
        self.config = config or PlatformConfig()
        self.metrics = metrics or DEFAULT_REGISTRY
        self.store = self._build_store()
        self.task_manager = LocalTaskManager(self.store)
        self.result_cache = None
        if self.config.result_cache:
            from .rescache import ResultCache, attach_store

            self.result_cache = ResultCache(
                max_entries=self.config.cache_max_entries,
                max_bytes=self.config.cache_max_bytes,
                ttl_s=self.config.cache_ttl_seconds,
                metrics=self.metrics)
            # The async path's fill point: terminal transitions copy
            # results in and release single-flight leaders.
            attach_store(self.store, self.result_cache)
        self.observability = None
        self.slo = None
        if self.config.observability:
            if self.config.native_store:
                # The C store has no ledger slot.
                raise ValueError(
                    "observability=True requires the Python store "
                    "(the native core carries no hop-ledger state)")
            self.observability = RequestObservability(
                self.store, metrics=self.metrics,
                flight=FlightRecorder(
                    capacity=self.config.flight_capacity,
                    sample=self.config.flight_sample,
                    slow_ms=self.config.flight_slow_ms,
                    metrics=self.metrics))
        if self.config.slo_objectives:
            if self.observability is None:
                raise ValueError(
                    "slo_objectives requires observability=True — the SLO "
                    "engine reads the e2e histograms the observability "
                    "layer maintains")
            self.slo = SloEngine(
                parse_objectives(self.config.slo_objectives),
                metrics=self.metrics,
                fast_window_s=self.config.slo_fast_window_s,
                slow_window_s=self.config.slo_slow_window_s,
                tick_s=self.config.slo_tick_s)
        self.admission = None
        if self.config.admission:
            if self.config.native_store or self.config.native_broker:
                # The C cores have no deadline or priority slots and no
                # expired bucket: admission there would drop the very
                # state it enforces.
                raise ValueError(
                    "admission control requires the Python store and "
                    "broker (the native cores carry no deadline/priority "
                    "state)")
            from .admission import AdmissionController

            self.admission = AdmissionController(
                metrics=self.metrics,
                min_limit=self.config.admission_min_limit,
                max_limit=self.config.admission_max_limit,
                initial_limit=self.config.admission_initial_limit,
                max_backlog=self.config.admission_max_backlog)
            # Terminal transitions feed the drain rate (every shed's
            # Retry-After) and score goodput.
            self.admission.attach_store(self.store)
        if self.config.native_broker:
            from .broker.native import NativeBroker

            self.broker = NativeBroker(
                max_delivery_count=self.config.max_delivery_count,
                lease_seconds=self.config.lease_seconds)
        else:
            self.broker = InMemoryBroker(
                max_delivery_count=self.config.max_delivery_count,
                lease_seconds=self.config.lease_seconds,
                metrics=self.metrics)
        self.store.set_publisher(self.broker.publish)
        self.dispatchers = DispatcherPool(
            self.broker, self.task_manager,
            retry_delay=self.config.retry_delay,
            concurrency=self.config.dispatcher_concurrency,
            observability=self.observability, admission=self.admission,
            metrics=self.metrics, result_cache=self.result_cache,
            result_store=(self.store if self.result_cache is not None
                          else None))
        self.gateway = Gateway(self.store, metrics=self.metrics)
        if self.result_cache is not None:
            self.gateway.set_result_cache(self.result_cache)
        if self.observability is not None:
            self.gateway.set_observability(self.observability)
        if self.admission is not None:
            self.gateway.set_admission(self.admission)
        # None = AUTO: 15 minutes on the Python store, no eviction on the
        # native one (it has none); negative opts out.
        retention = self.config.reaper_terminal_retention
        if retention is None and not self.config.native_store:
            retention = DEFAULT_TERMINAL_RETENTION_S
        if retention is not None and retention < 0:
            retention = None
        self.reaper = None
        if (self.config.reaper_running_timeout is not None
                or retention is not None):
            self.reaper = TaskReaper(
                self.store,
                running_timeout=self.config.reaper_running_timeout,
                interval=self.config.reaper_interval,
                max_requeues=self.config.reaper_max_requeues,
                terminal_retention=retention,
                metrics=self.metrics)
        self.depth_logger = DepthLogger(
            self.store, metrics=self.metrics,
            queue_interval=self.config.queue_depth_interval,
            process_interval=self.config.process_depth_interval)
        self.autoscalers: list = []
        self._started = False
        # Strong refs to fire-and-forget terminal transitions: the event
        # loop holds tasks weakly.
        self._bg_tasks: set[asyncio.Task] = set()

    def _build_store(self):
        """The Python store, with the result backend when ``result_dir`` is
        set, or the native one, which refuses the options it cannot
        honour."""
        if not self.config.native_store:
            backend = None
            if self.config.result_dir:
                from .taskstore.results import FileResultBackend

                backend = FileResultBackend(self.config.result_dir)
            return InMemoryTaskStore(
                result_backend=backend,
                result_offload_threshold=(
                    self.config.result_offload_threshold if backend else None))
        if self.config.result_dir:
            raise ValueError(
                "result_dir offload requires the Python store "
                "(the native store keeps results in its own memory)")
        ret = self.config.reaper_terminal_retention
        if ret is not None and ret >= 0:
            # An explicit retention that never evicts would be the very
            # growth it exists to bound.
            raise ValueError(
                "reaper_terminal_retention requires the Python store "
                "(the native store has no eviction)")
        from .taskstore.native import NativeTaskStore

        return NativeTaskStore()

    def publish_async_api(self, public_prefix: str, backend_uri: str,
                          retry_delay: float | None = None,
                          concurrency: int | None = None,
                          autoscale=None,
                          autoscale_interval: float = 5.0,
                          max_body_bytes: int | None = None) -> None:
        """Register an async API end to end: gateway route + a dispatcher
        for its queue. An ``AutoscalePolicy`` as ``autoscale`` attaches the
        HPA-style control loop to the dispatcher's delivery fan-out."""
        self.gateway.add_async_route(public_prefix, backend_uri,
                                     max_body_bytes=max_body_bytes)
        self.register_internal_route(backend_uri, retry_delay=retry_delay,
                                     concurrency=concurrency,
                                     autoscale=autoscale,
                                     autoscale_interval=autoscale_interval)

    def register_internal_route(self, backend_uri: str,
                                retry_delay: float | None = None,
                                concurrency: int | None = None,
                                autoscale=None,
                                autoscale_interval: float = 5.0) -> None:
        """A transport consumer for a backend without a public route,
        reached only by republished tasks."""
        queue_name = endpoint_path(backend_uri)
        self.broker.register_queue(queue_name)
        dispatcher = self.dispatchers.register(queue_name, backend_uri,
                                               retry_delay=retry_delay,
                                               concurrency=concurrency)
        if autoscale is not None:
            self._attach_autoscaler(queue_name, dispatcher, autoscale,
                                    autoscale_interval)
        elif self.admission is not None:
            # The queue's limiter (delivery RTTs, backpressure backoffs)
            # owns the fan-out. An autoscale policy wins: two control
            # loops on one actuator would fight.
            self.admission.add_target("dispatch:" + queue_name,
                                      dispatcher.set_concurrency)

    def _attach_autoscaler(self, queue_name: str, dispatcher, policy,
                           interval: float) -> None:
        """HPA-style scaling of one route's dispatcher on its queue
        pressure (``created`` + ``running`` in the task store)."""
        from .scaling import AutoscaleController, DispatcherScaleTarget

        self.autoscalers.append(AutoscaleController(
            self.store, queue_name, DispatcherScaleTarget(dispatcher),
            policy=policy, interval=interval, metrics=self.metrics))

    def publish_sync_api(self, public_prefix: str, backend_uri: str,
                         max_body_bytes: int | None = None) -> None:
        self.gateway.add_sync_route(public_prefix, backend_uri,
                                    max_body_bytes=max_body_bytes)

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self.broker.bind_loop(loop)

        def on_dead_letter(msg) -> None:
            # Fail the task so it never sits non-terminal once its message
            # is gone.
            task = loop.create_task(self._fail_dead_letter(msg.task_id))
            self._bg_tasks.add(task)
            task.add_done_callback(self._bg_tasks.discard)

        self.broker.set_dead_letter_handler(on_dead_letter)
        await self.dispatchers.start()
        await self.depth_logger.start()
        if self.reaper is not None:
            await self.reaper.start()
        if self.slo is not None:
            await self.slo.start()
        for scaler in self.autoscalers:
            await scaler.start()
        self._started = True

    async def _fail_dead_letter(self, task_id: str) -> None:
        try:
            task = self.store.get(task_id)
            if task.canonical_status not in TaskStatus.TERMINAL:
                await self.task_manager.fail_task(task_id,
                                                  TaskStatus.DEAD_LETTER)
        except Exception:  # noqa: BLE001 — best-effort terminal transition
            log.exception("could not fail dead-lettered task %s", task_id)

    async def stop(self) -> None:
        if self._started:
            for scaler in self.autoscalers:
                await scaler.stop()
            if self.reaper is not None:
                await self.reaper.stop()
            if self.slo is not None:
                await self.slo.stop()
            await self.depth_logger.stop()
            await self.dispatchers.stop()
            self._started = False
        if hasattr(self.broker, "close"):
            self.broker.close()
