"""Control-plane assembly — store + broker + dispatchers + gateway in one
event loop; ``PlatformConfig`` and ``LocalPlatform`` of
``ai4e_tpu/platform_assembly.py``, with the in-memory store (with
``result_dir``, large results offloaded to files) or the native C++ store
(``native_store``), the in-memory broker (transport ``"queue"``) or the
native one (``native_broker``) or the push transport (transport
``"push"``, ``broker/push.py``: a ``PushTopic`` delivering to a
``WebhookDispatcher`` served on a port of its own, subscribed through the
validation handshake at start, where a failed handshake raises
``SubscriptionError``), the reaper's terminal retention and, with
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

With ``journal_path`` the store is journaled (``taskstore/store.py``,
fsync policy ``AI4E_TASKSTORE_FSYNC``): a restart replays it and publishes
the replayed unfinished tasks again. It is a born-primary
``FollowerTaskStore``, so a promoted standby can depose it. With
``replicate_from`` as well, the platform is the HA pair's standby: it
tails the primary's journal (``replication.JournalReplicator``), serves
reads, refuses writes, starts no transport and no reaper, and its
``FailoverWatchdog`` promotes it after ``failover_down_after`` failed
probes ``failover_interval`` apart, once it has synced. Promoted
(``_on_promoted``), it starts the transport, publishes every unfinished
task and runs a ``FencingProber`` against the old primary. A demoted
primary (``demote_now``, ``POST /v1/taskstore/demote``) stops its
transport (on push it closes topic and webhook, cancelling the deliveries
in flight, and a later promotion builds them anew) and, given the new
primary's URL, rejoins it as a standby.
``advertise_url`` marks an HA pair: only then may an ``X-Store-Epoch``
header demote a primary, and the prober offers it for the rejoin.

With ``task_shards`` > 1 the store is the sharded facade
(``taskstore/sharding.py``): ``task_shards`` shards over a ring of
``task_shard_slots`` hash slots, each with ``task_shard_replicas`` passive
replicas tailing its journal every ``shard_tail_interval`` s when
``journal_path`` is set (``{journal_path}.shard{i}``), and a change feed
keeping ``shard_feed_recent`` terminal records for the long polls. The
broker puts each task on its shard's sub-queue (``{path}#s{i}``), and
every route gets a dispatcher for each sub-queue, each with its own
admission limiter. The replica tails start and stop with the platform; a
restart re-seeds the unfinished tasks every shard's journal restored. As
in JAX, the sharded store refuses the native cores, ``replicate_from`` and,
without orchestration, an ``autoscale`` route. As in JAX, the native store
refuses ``result_dir``, an explicit ``reaper_terminal_retention`` and
observability, and either native core refuses admission, each with JAX's
text.

With ``resilience`` one ``BackendHealth`` (breakers, retries with
failover, drain ejection; ``resilience/``) serves the gateway's sync
proxy and every dispatcher. With ``orchestration`` (which needs admission
and resilience, JAX's refusal) one ``Orchestrator`` places their
deliveries, its degradation ladder is admission's (``set_ladder``), with
``slo_ladder`` (which needs SLO objectives and orchestration) the SLO
engine feeds it, and an ``autoscale`` route scales on the predictive
signal: on a sharded store through one ``ShardedAutoscaleController``
reading each shard's store at every tick.

With ``tenancy`` (``tenancy/``) subscription keys resolve to declared
tenants at the gateway, whose work-creating requests spend a bucket a
tenant; every broker queue, each shard's sub-queue included, serves its
tenants' lanes by deficit round-robin; under orchestration each delivery
charges its tenant the backend's cost; and the store's feed labels the
per-tenant outcomes. With ``pipeline`` (``pipeline/``) ``register_pipeline``
publishes a declared DAG whose root tasks a ``PipelineCoordinator``
consumes from its entry queue (one a shard on a sharded store) and runs
as stage sub-tasks through the ordinary dispatchers, and a
``TaskEventHub`` on the store's feed serves the gateway's SSE route. The
coordinator runs beside the transport only, so only a primary drives
runs; a restarted or promoted one resumes them from its re-seed. Both
refuse the push transport and the native cores, with JAX's texts.

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
from .broker.push import PushTopic, WebhookDispatcher
from .broker.queue import shard_queue_name
from .gateway import Gateway
from .metrics import DEFAULT_REGISTRY, MetricsRegistry
from .observability import (DepthLogger, FlightRecorder,
                            RequestObservability, SloEngine,
                            parse_objectives)
from .service import APIService, LocalTaskManager
from .taskstore import InMemoryTaskStore, TaskStatus, endpoint_path
from .taskstore.reaper import TaskReaper
from .utils.backends import normalize_backends

log = logging.getLogger("ai4e_tpu_torch.platform")

# Terminal retention when ``reaper_terminal_retention`` is None, as in the
# JAX package's Python store.
DEFAULT_TERMINAL_RETENTION_S = 900.0


@dataclass
class PlatformConfig:
    transport: str = "queue"        # "queue" | "push"
    retry_delay: float = 60.0       # dispatcher backoff on 429/503
    max_delivery_count: int = 1440  # broker patience
    dispatcher_concurrency: int = 1
    lease_seconds: float = 300.0
    native_broker: bool = False     # C++ broker core (native/broker_core.cpp)
    native_store: bool = False      # C++ task-store core (native/taskstore_core.cpp)
    # The push transport's delivery policy (an Event Grid subscription's).
    push_ttl_seconds: float = 300.0
    push_max_attempts: int = 3
    push_window: int = 256          # concurrent in-flight deliveries
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
    # The journaled store and its HA pair. None: the in-memory store.
    journal_path: str | None = None
    # The primary's URL, on the standby (needs journal_path).
    replicate_from: str | None = None
    failover_interval: float = 2.0
    failover_down_after: int = 3
    # Subscription key for the standby's calls to a keyed primary.
    replicate_api_key: str | None = None
    # This control plane's own URL: the HA-pair marker, offered to a
    # deposed primary for its rejoin.
    advertise_url: str | None = None
    # None: AI4E_TASKSTORE_FSYNC (never | always | group:<ms>).
    taskstore_fsync: str | None = None
    # The sharded task store: shards over a ring of hash slots (>= shards),
    # passive replicas a shard (with journal_path), their journal-tail
    # period, and each shard feed's replay window.
    task_shards: int = 1
    task_shard_slots: int = 64
    task_shard_replicas: int = 1
    shard_tail_interval: float = 0.25
    shard_feed_recent: int = 4096
    # Resilient routing: a breaker a backend shared by the sync proxy and
    # every dispatcher, in-delivery retries with failover on a retry
    # budget, 5xx as transient and duplicate suppression. Off by default:
    # on, a 5xx is retried and redelivered instead of failing the task.
    resilience: bool = False
    resilience_failure_threshold: int = 5   # consecutive failures to trip
    resilience_window: int = 16             # rolling error-rate window
    resilience_error_rate: float = 0.5      # window fraction that trips
    resilience_recovery_seconds: float = 30.0  # open -> half-open cooldown
    resilience_max_attempts: int = 3        # POST attempts a delivery
    resilience_retry_base_s: float = 0.05   # first in-delivery retry delay
    resilience_retry_budget_ratio: float = 0.2  # retries a request, steady
    # Deadline-aware orchestration: placement on predicted completion
    # within the deadline and on backend cost, the degradation ladder and
    # predictive scaling. Off by default: on, backends are unequal and
    # sustained predicted-miss pressure may brown the platform out class
    # by class. Needs admission and resilience.
    orchestration: bool = False
    orchestration_confidence: float = 0.75   # p_within bar a backend clears
    orchestration_window: int = 256          # RTT samples a backend
    orchestration_horizon_s: float = 60.0    # sample decay horizon (s)
    # "substring=cost,..." relative backend cost (first match wins,
    # unmatched = 1.0).
    orchestration_costs: str | None = None
    orchestration_ladder_up: float = 0.3     # pressure that steps up
    orchestration_ladder_down: float = 0.1   # pressure that steps down
    orchestration_ladder_hold_s: float = 5.0  # sustain a step (hysteresis)
    orchestration_scale_horizon_s: float = 10.0  # predictive projection
    # SLO breaches as ladder evidence (needs slo_objectives and
    # orchestration).
    slo_ladder: bool = False
    # Declared pipeline DAGs run under one TaskId, and the SSE event
    # surface. Queue transport and the Python store and broker only.
    pipeline: bool = False
    # Events a late stream still replays, a stream's longest life (s), and
    # the trailing chunk events kept before a `truncated` marker.
    pipeline_event_replay: int = 256
    pipeline_stream_max_s: float = 300.0
    pipeline_chunk_replay: int = 128
    # Multi-tenancy: keys resolve to tenants at the edge, a token bucket a
    # tenant, weighted-fair lanes in every broker queue, the placement cost
    # charged a tenant and per-tenant series under a bounded label. Queue
    # transport and the Python store and broker only.
    tenancy: bool = False
    # "name=key1|key2[:weight[:rps[:burst]]]", comma-separated.
    tenancy_tenants: str | None = None
    # Defaults for omitted fields, and the default tenant's policy (rps 0 =
    # unlimited).
    tenancy_default_weight: float = 1.0
    tenancy_default_rps: float = 0.0
    tenancy_default_burst: float = 0.0
    # The first N declared tenants keep their id as label, the rest "other".
    tenancy_label_top_n: int = 8
    tenancy_goodput_target: float = 0.99
    # Floor on a lane's deficit-round-robin credit a ring visit.
    tenancy_min_quantum: float = 0.05
    # How long a backend that answered X-Draining stays out of placement
    # (AI4E_ROLLOUT_DRAIN_EJECT_TTL_S).
    rollout_drain_eject_ttl_s: float = 30.0


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
        self.resilience = None
        if self.config.resilience:
            # One health model: the sync proxy and every dispatcher record
            # into and route around the same breakers.
            from .resilience import BackendHealth, ResiliencePolicy

            self.resilience = BackendHealth(
                policy=ResiliencePolicy(
                    failure_threshold=self.config.resilience_failure_threshold,
                    window=self.config.resilience_window,
                    error_rate=self.config.resilience_error_rate,
                    recovery_seconds=self.config.resilience_recovery_seconds,
                    max_attempts=self.config.resilience_max_attempts,
                    retry_base_s=self.config.resilience_retry_base_s,
                    retry_budget_ratio=(
                        self.config.resilience_retry_budget_ratio),
                    drain_eject_ttl_s=(
                        self.config.rollout_drain_eject_ttl_s)),
                metrics=self.metrics)
        self.orchestration = None
        if self.config.orchestration:
            if self.admission is None or self.resilience is None:
                raise ValueError(
                    "orchestration=True requires admission=True and "
                    "resilience=True (it composes their signals — "
                    "docs/orchestration.md)")
            from .orchestration import (Orchestrator, OrchestrationPolicy,
                                        parse_costs)

            self.orchestration = Orchestrator(
                self.resilience,
                policy=OrchestrationPolicy(
                    confidence=self.config.orchestration_confidence,
                    window=self.config.orchestration_window,
                    horizon_s=self.config.orchestration_horizon_s,
                    costs=parse_costs(self.config.orchestration_costs),
                    ladder_up=self.config.orchestration_ladder_up,
                    ladder_down=self.config.orchestration_ladder_down,
                    ladder_hold_s=self.config.orchestration_ladder_hold_s,
                    scale_horizon_s=(
                        self.config.orchestration_scale_horizon_s)),
                metrics=self.metrics)
            # Admission consults the ladder on every decision, and its
            # store listener feeds the ladder the late and expired tasks.
            self.admission.set_ladder(self.orchestration.ladder)
        if self.config.slo_ladder:
            if self.slo is None or self.orchestration is None:
                raise ValueError(
                    "slo_ladder=True requires slo_objectives AND "
                    "orchestration=True — it feeds SLO breaches to the "
                    "degradation ladder (docs/observability.md)")
            self.slo.attach_ladder(self.orchestration.ladder)
        self.tenancy = None
        if self.config.tenancy:
            if self.config.transport != "queue":
                raise ValueError(
                    "tenancy=True requires the queue transport — the "
                    "weighted-fair lanes live inside the broker's queues "
                    "(docs/tenancy.md)")
            if self.config.native_store or self.config.native_broker:
                # The C structs have no tenant slot.
                raise ValueError(
                    "tenancy=True requires the Python store and broker "
                    "(the native cores carry no tenant state)")
            from .tenancy import Tenancy

            self.tenancy = Tenancy.from_spec(
                self.config.tenancy_tenants,
                metrics=self.metrics,
                default_weight=self.config.tenancy_default_weight,
                default_rps=self.config.tenancy_default_rps,
                default_burst=self.config.tenancy_default_burst,
                label_top_n=self.config.tenancy_label_top_n,
                goodput_target=self.config.tenancy_goodput_target,
                min_quantum=self.config.tenancy_min_quantum)
            # Terminal transitions label the per-tenant outcome and burn
            # series, with or without the observability layer.
            self.tenancy.attach_store(self.store)
        self.broker = None
        self.dispatchers = None
        self.topic = None
        self.webhook = None
        self._webhook_runner = None
        if self.config.transport == "push":
            # The routes are kept, so a demoted-then-promoted node can build
            # the push transport anew (demote_now closes it).
            self._push_routes: list[tuple[str, list]] = []
            self._build_push()
        elif self.config.transport == "queue":
            self._build_queue()
        else:
            raise ValueError(
                f"unknown transport {self.config.transport!r}; "
                "expected 'queue' or 'push'")
        self.pipeline = None
        self.task_events = None
        if self.config.pipeline:
            self._build_pipeline()
        self.gateway = Gateway(self.store, metrics=self.metrics)
        if self.result_cache is not None:
            self.gateway.set_result_cache(self.result_cache)
        if self.observability is not None:
            self.gateway.set_observability(self.observability)
        if self.admission is not None:
            self.gateway.set_admission(self.admission)
        if self.resilience is not None:
            self.gateway.set_resilience(self.resilience)
        if self.orchestration is not None:
            self.gateway.set_orchestration(self.orchestration)
        if self.tenancy is not None:
            self.gateway.set_tenancy(self.tenancy)
        if self.task_events is not None:
            self.gateway.set_event_stream(
                self.task_events,
                max_stream_s=self.config.pipeline_stream_max_s)
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
        self.services: list[APIService] = []
        self._started = False
        self._transport_running = False
        # The HA machinery: the standby's replicator and watchdog, the
        # promoted standby's prober.
        self.replicator = None
        self.watchdog = None
        self.prober = None
        # Strong refs to fire-and-forget terminal transitions: the event
        # loop holds tasks weakly.
        self._bg_tasks: set[asyncio.Task] = set()

    def _build_queue(self) -> None:
        """The queue transport: the broker (native or in-memory, by shard
        sub-queue on a sharded store) as the store's publisher, and the
        dispatcher pool that drains it."""
        if self.config.native_broker:
            from .broker.native import NativeBroker

            self.broker = NativeBroker(
                max_delivery_count=self.config.max_delivery_count,
                lease_seconds=self.config.lease_seconds)
        else:
            self.broker = InMemoryBroker(
                max_delivery_count=self.config.max_delivery_count,
                lease_seconds=self.config.lease_seconds,
                metrics=self.metrics,
                # A sharded store: per-shard sub-queues, each drained by
                # its own dispatchers.
                shard_router=(self.store.shard_for
                              if self.config.task_shards > 1 else None),
                # Tenancy: deficit-round-robin lanes in every queue.
                fair=(self.tenancy.lanes
                      if self.tenancy is not None else None))
        self.store.set_publisher(self.broker.publish)
        self.dispatchers = DispatcherPool(
            self.broker, self.task_manager,
            retry_delay=self.config.retry_delay,
            concurrency=self.config.dispatcher_concurrency,
            observability=self.observability, admission=self.admission,
            metrics=self.metrics, result_cache=self.result_cache,
            result_store=(self.store if self.result_cache is not None
                          else None),
            resilience=self.resilience, orchestration=self.orchestration,
            tenancy=self.tenancy)

    def _build_pipeline(self) -> None:
        """The event hub on the store's feed and the coordinator, which
        consumes each pipeline's entry queue (one a shard's sub-queue on
        a sharded store)."""
        if self.config.transport != "queue":
            raise ValueError(
                "pipeline=True requires the queue transport — the "
                "coordinator consumes pipeline entry queues "
                "(docs/pipelines.md)")
        if self.config.native_store or self.config.native_broker:
            raise ValueError(
                "pipeline=True requires the Python store and broker "
                "(the coordinator rides the store change feed and "
                "stage sub-records)")
        from .pipeline import PipelineCoordinator, TaskEventHub

        self.task_events = TaskEventHub(
            replay=self.config.pipeline_event_replay,
            chunk_replay=self.config.pipeline_chunk_replay,
            metrics=self.metrics)
        # Every transition of a tracked task is a `status` event; a
        # terminal one closes its streams.
        self.task_events.attach_store(self.store)
        queue_names = None
        if self.config.task_shards > 1:
            n = self.config.task_shards

            def queue_names(path, _n=n):
                return [shard_queue_name(path, i) for i in range(_n)]

        self.pipeline = PipelineCoordinator(
            self.store, self.broker, hub=self.task_events,
            result_cache=self.result_cache, admission=self.admission,
            observability=self.observability, metrics=self.metrics,
            queue_names=queue_names)

    def _build_push(self) -> None:
        """(Re)build the push transport: topic, webhook and the recorded
        routes, with the topic as the store's publisher (the sharded
        facade's too). Called at assembly and again after a demotion closed
        the previous topic, since ``PushTopic.aclose`` is terminal."""
        self.topic = PushTopic(
            ttl_seconds=self.config.push_ttl_seconds,
            max_attempts=self.config.push_max_attempts,
            retry_delay=self.config.retry_delay,
            window=self.config.push_window,
            metrics=self.metrics)
        self.webhook = WebhookDispatcher(self.task_manager,
                                         metrics=self.metrics)
        for queue_name, backends in self._push_routes:
            self.webhook.add_route(queue_name, backends)
        self.store.set_publisher(self.topic.publish)

    @property
    def _publish(self):
        """The transport's publish hook: the topic's or the broker's."""
        return (self.topic.publish if self.config.transport == "push"
                else self.broker.publish)

    def _build_store(self):
        """The sharded facade (``task_shards`` > 1), the Python store
        (journaled with ``journal_path``, a standby with ``replicate_from``
        too), with the result backend when ``result_dir`` is set, or the
        native one; each refuses the options it cannot honour, with JAX's
        text."""
        config = self.config
        if config.task_shards > 1:
            if config.native_store or config.native_broker:
                raise ValueError(
                    "task_shards > 1 requires the Python store and broker "
                    "(the native cores hold no ring/fence state)")
            if config.replicate_from:
                raise ValueError(
                    "task_shards > 1 is exclusive with replicate_from: "
                    "per-shard replicas are the sharded availability "
                    "story (docs/sharding.md)")
            from .taskstore.sharding import ShardedTaskStore

            return ShardedTaskStore(
                config.task_shards, slots=config.task_shard_slots,
                journal_path=config.journal_path,
                replicas=(config.task_shard_replicas
                          if config.journal_path else 0),
                tail_interval=config.shard_tail_interval,
                feed_recent=config.shard_feed_recent,
                fsync=config.taskstore_fsync, metrics=self.metrics,
                **self._result_kwargs())
        if config.replicate_from and not config.journal_path:
            raise ValueError(
                "replicate_from (standby mode) requires journal_path — "
                "the follower journals the absorbed stream")
        if config.journal_path and config.native_store:
            if config.replicate_from:
                raise ValueError("standby mode requires the Python store")
            raise ValueError(
                "native_store has no journal; use journal_path with the "
                "Python store or native_store without durability")
        if not config.native_store:
            result_kwargs = self._result_kwargs()
            if not config.journal_path:
                return InMemoryTaskStore(**result_kwargs)
            from .taskstore.store import FollowerTaskStore

            # The journal's metrics land in this platform's registry. A
            # journaled primary is a born-primary follower store, which a
            # promoted standby can depose.
            return FollowerTaskStore(
                config.journal_path,
                start_as_primary=not config.replicate_from,
                fsync=config.taskstore_fsync, metrics=self.metrics,
                **result_kwargs)
        if config.result_dir:
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

    def _result_kwargs(self) -> dict:
        """The Python store's result backend and offload threshold."""
        backend = None
        if self.config.result_dir:
            from .taskstore.results import FileResultBackend

            backend = FileResultBackend(self.config.result_dir)
        return dict(result_backend=backend,
                    result_offload_threshold=(
                        self.config.result_offload_threshold
                        if backend else None))

    def make_service(self, name: str, prefix: str = "") -> APIService:
        """A service shell on this platform's store (an in-process worker,
        as JAX's pipeline tests build their stages)."""
        svc = APIService(name, prefix=prefix,
                         task_manager=self.task_manager, metrics=self.metrics)
        self.services.append(svc)
        return svc

    def publish_async_api(self, public_prefix: str, backend_uri,
                          retry_delay: float | None = None,
                          concurrency: int | None = None,
                          autoscale=None,
                          autoscale_interval: float = 5.0,
                          max_body_bytes: int | None = None) -> None:
        """Register an async API end to end: gateway route + a transport
        consumer for its queue. An ``AutoscalePolicy`` as ``autoscale``
        attaches the HPA-style control loop to the dispatcher's delivery
        fan-out. ``backend_uri`` may be a weighted backend list (a canary):
        the recorded task endpoint is its first backend's, deliveries split
        by the weights, and the route is not cacheable."""
        backends = normalize_backends(backend_uri)
        self.gateway.add_async_route(public_prefix, backends,
                                     max_body_bytes=max_body_bytes)
        self.register_internal_route(backends, retry_delay=retry_delay,
                                     concurrency=concurrency,
                                     autoscale=autoscale,
                                     autoscale_interval=autoscale_interval)

    def register_internal_route(self, backend_uri,
                                retry_delay: float | None = None,
                                concurrency: int | None = None,
                                autoscale=None,
                                autoscale_interval: float = 5.0) -> None:
        """A transport consumer for a backend without a public route,
        reached only by republished tasks (a weighted list is a canary); on
        the push transport a webhook route, on a sharded store one
        dispatcher for each shard's sub-queue."""
        backend_uri = normalize_backends(backend_uri)
        queue_name = endpoint_path(backend_uri[0][0])
        if self.config.transport == "push":
            if (autoscale is not None or retry_delay is not None
                    or concurrency is not None):
                raise ValueError(
                    "autoscale/retry_delay/concurrency are queue-transport "
                    "knobs; push retry policy is topic-wide "
                    "(PlatformConfig.retry_delay/push_max_attempts)")
            self._push_routes.append((queue_name, backend_uri))
            self.webhook.add_route(queue_name, backend_uri)
            return
        self.broker.register_queue(queue_name)
        if self.config.task_shards > 1:
            if autoscale is not None and self.orchestration is None:
                # Orchestration's sharded scaler routes per-shard decisions
                # through one actuator; without it, one autoscaler a
                # sub-queue would be two control loops on one route.
                raise ValueError(
                    "autoscale policies are per-dispatcher; with "
                    "task_shards > 1 use admission's adaptive control "
                    "(one limiter per shard sub-queue) instead — or "
                    "enable orchestration, whose predictive scaler "
                    "routes per-shard decisions through one actuator "
                    "(docs/orchestration.md)")
            queue_names = [shard_queue_name(queue_name, i)
                           for i in range(self.config.task_shards)]
        else:
            queue_names = [queue_name]
        dispatchers = [self.dispatchers.register(qn, backend_uri,
                                                 retry_delay=retry_delay,
                                                 concurrency=concurrency)
                       for qn in queue_names]
        if autoscale is not None:
            self._attach_autoscaler(queue_names, dispatchers, autoscale,
                                    autoscale_interval)
        elif self.admission is not None:
            # Each queue's limiter (delivery RTTs, backpressure backoffs)
            # owns its fan-out. An autoscale policy wins: two control
            # loops on one actuator would fight.
            for qn, dispatcher in zip(queue_names, dispatchers):
                self.admission.add_target("dispatch:" + qn,
                                          dispatcher.set_concurrency)

    def _attach_autoscaler(self, queue_names: list, dispatchers: list,
                           policy, interval: float) -> None:
        """HPA-style scaling of a route's dispatchers on its queue pressure
        (``created`` + ``running`` in the task store). Under orchestration
        the signal is predictive (``scaling.predictive_signal``, from this
        route's arrival and drain rates), and a sharded route gets one
        ``ShardedAutoscaleController``: a decision for each shard, one
        actuator."""
        from .scaling import (AutoscaleController, DispatcherScaleTarget,
                              ShardedAutoscaleController, ShardScaleTarget,
                              predictive_signal)

        base_path = dispatchers[0].route_path
        if len(dispatchers) > 1:
            # Sharded (only under orchestration): each shard's own depth,
            # the route's arrival and drain imbalance split evenly (the
            # ring spreads task ids uniformly).
            horizon = self.orchestration.policy.scale_horizon_s
            n = len(dispatchers)

            def shard_depth(i, p=base_path):
                def depth() -> float:
                    # Read at every tick: a shard failover swaps a promoted
                    # replica in, and a captured store would be the dead
                    # primary's.
                    s = self.store.shard_stores()[i]
                    return (s.set_len(p, "created")
                            + s.set_len(p, "running"))
                return depth

            shards = [(qn, predictive_signal(
                shard_depth(i),
                lambda p=base_path, n=n: (
                    self.admission.arrival_rate(route=p) / n),
                lambda p=base_path, n=n: (
                    self.admission.route_drain_rate(p) / n),
                horizon)) for i, qn in enumerate(queue_names)]
            self.autoscalers.append(ShardedAutoscaleController(
                shards, ShardScaleTarget(dispatchers), policy=policy,
                interval=interval, metrics=self.metrics))
            return
        signal = None
        if self.orchestration is not None:
            store = self.store
            signal = predictive_signal(
                lambda: (store.set_len(base_path, "created")
                         + store.set_len(base_path, "running")),
                lambda p=base_path: self.admission.arrival_rate(route=p),
                lambda p=base_path: self.admission.route_drain_rate(p),
                self.orchestration.policy.scale_horizon_s)
        self.autoscalers.append(AutoscaleController(
            self.store, queue_names[0], DispatcherScaleTarget(dispatchers[0]),
            policy=policy, interval=interval, signal=signal,
            metrics=self.metrics))

    def register_pipeline(self, spec, max_body_bytes: int | None = None
                          ) -> None:
        """Publish a declared pipeline DAG (``pipeline.PipelineSpec``): a
        gateway async route at ``spec.prefix`` whose tasks the coordinator
        consumes. Each stage's endpoint still needs its transport consumer
        (``register_internal_route`` or ``publish_async_api``)."""
        if self.pipeline is None:
            raise ValueError(
                "register_pipeline requires PlatformConfig(pipeline=True)")
        self.gateway.add_async_route(spec.prefix, spec.entry_path,
                                     max_body_bytes=max_body_bytes)
        self.pipeline.register(spec)

    def publish_sync_api(self, public_prefix: str, backend_uri,
                         max_body_bytes: int | None = None) -> None:
        self.gateway.add_sync_route(public_prefix, backend_uri,
                                    max_body_bytes=max_body_bytes)

    async def start(self) -> None:
        if self.config.replicate_from:
            # The standby: tail the primary, serve reads, refuse writes.
            # The transport starts only at promotion, so a standby never
            # delivers tasks the primary delivers.
            self._start_standby(self.config.replicate_from)
            await self.depth_logger.start()
            self._started = True
            return
        if hasattr(self.store, "passive_fencing"):
            # Without an HA peer a forged or stale X-Store-Epoch header
            # would only take the sole primary out of service.
            self.store.passive_fencing = bool(self.config.advertise_url)
        if hasattr(self.store, "start_replication"):
            # The sharded store's replica journal tails, on this loop.
            await self.store.start_replication()
        await self._start_transport()
        await self.depth_logger.start()
        await self._start_primary_loops()
        self._reseed_unfinished()
        self._started = True

    def _start_standby(self, primary_url: str) -> None:
        from .taskstore.replication import FailoverWatchdog, JournalReplicator

        self.replicator = JournalReplicator(
            self.store, primary_url, api_key=self.config.replicate_api_key,
            metrics=self.metrics)
        self.replicator.start()
        self.watchdog = FailoverWatchdog(
            self.replicator, interval=self.config.failover_interval,
            down_after=self.config.failover_down_after,
            on_promote=self._on_promoted)
        self.watchdog.start()

    async def _start_transport(self) -> None:
        loop = asyncio.get_running_loop()
        self._transport_running = True
        if self.config.transport == "push":
            if self.topic is None:
                # A demotion closed the previous topic and webhook; a
                # promotion builds them anew.
                self._build_push()
            await self._start_push(loop)
            return
        self.broker.bind_loop(loop)

        def on_dead_letter(msg) -> None:
            # Fail the task so it never sits non-terminal once its message
            # is gone.
            self._spawn_bg(loop, self._fail_dead_letter(msg.task_id))

        self.broker.set_dead_letter_handler(on_dead_letter)
        await self.dispatchers.start()
        if self.pipeline is not None:
            # With the transport only, never on a standby; its entry-queue
            # loops run before the re-seed, which is the resume path.
            await self.pipeline.start()

    async def _start_push(self, loop: asyncio.AbstractEventLoop) -> None:
        """Serve the webhook on a port of its own (the topic -> webhook leg
        is a real HTTP hop), then subscribe the topic to it through the
        validation handshake."""
        from aiohttp import web

        self.topic.bind_loop(loop)

        def on_dead_letter(event) -> None:
            self._spawn_bg(loop, self._fail_dead_letter(event.id))

        self.topic.set_dead_letter_handler(on_dead_letter)
        runner = web.AppRunner(self.webhook.app)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", 0).start()
        self._webhook_runner = runner
        port = runner.addresses[0][1]
        await self.topic.subscribe(
            "backend-webhook", f"http://127.0.0.1:{port}/api/events")

    def _spawn_bg(self, loop: asyncio.AbstractEventLoop, coro) -> None:
        """Background work held by a strong reference until done: the loop
        holds tasks weakly, and a collected one would drop its terminal
        transition."""
        task = loop.create_task(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    async def _start_primary_loops(self) -> None:
        """The loops only a primary runs beside its transport."""
        if self.reaper is not None:
            await self.reaper.start()
        if self.slo is not None:
            await self.slo.start()
        for scaler in self.autoscalers:
            await scaler.start()

    def _reseed_unfinished(self) -> None:
        """Publish the unfinished tasks a journal replay restored: their
        broker messages died with the previous process. Tasks created in
        this process already have theirs."""
        restored = getattr(self.store, "replayed_task_ids", None)
        if not restored:
            return
        reseeded = 0
        publish = self._publish
        for task in self.store.unfinished_tasks():
            if task.task_id in restored:
                publish(task)
                reseeded += 1
        log.info("journal replayed %d tasks; re-seeded %d unfinished",
                 len(restored), reseeded)

    async def _on_promoted(self) -> None:
        """This standby is the primary now: start the transport and the
        primary's loops, publish every unfinished task (replicated, so none
        has a broker message here) and fence the old primary."""
        log.warning("promoted to primary; starting transport and "
                    "re-seeding %d unfinished tasks",
                    len(self.store.unfinished_tasks()))
        # Cleared, not only stopped: demote_now rejoins only without one,
        # and /role reports "replicating" from it.
        if self.replicator is not None:
            await self.replicator.aclose()
            self.replicator = None
        await self._start_transport()
        await self._start_primary_loops()
        publish = self._publish
        for task in self.store.unfinished_tasks():
            publish(task)
        if self.config.replicate_from:
            from .taskstore.replication import FencingProber

            self.prober = FencingProber(
                self.store, self.config.replicate_from,
                advertise_url=self.config.advertise_url,
                api_key=self.config.replicate_api_key,
                interval=self.config.failover_interval)
            self.prober.start()

    async def promote_now(self) -> None:
        """Manual failover (``POST /v1/taskstore/promote``): the watchdog's
        sequence, replication torn down before the flip, so a racing poll
        can never resync-wipe the new primary."""
        if self.watchdog is not None:
            await self.watchdog.stop()
            self.watchdog = None
        if self.replicator is not None:
            await self.replicator.aclose()
            self.replicator = None
        if getattr(self.store, "role", "primary") == "primary":
            return
        self.store.promote()
        await self._on_promoted()

    async def demote_now(self, epoch: int,
                         primary_url: str | None = None) -> None:
        """Fence this node out of the primary role (``POST
        /v1/taskstore/demote``): the store flips first, so writes refuse
        before this returns (``StaleEpochError`` when ``epoch`` is not
        newer). Then the primary's machinery stops, and with
        ``primary_url`` the node rejoins the new primary as its standby,
        watchdog armed."""
        self.store.demote(epoch)
        # Keyed on the transport, not the role: a passive demotion (a
        # client's epoch header) flipped the bare store and left it running.
        if self._transport_running:
            log.warning("demoted at epoch %d (new primary: %s); stopping "
                        "transport", epoch, primary_url or "unknown")
            self._transport_running = False
            if self.prober is not None:
                await self.prober.aclose()
                self.prober = None
            for scaler in self.autoscalers:
                await scaler.stop()
            if self.reaper is not None:
                await self.reaper.stop()
            if self.slo is not None:
                await self.slo.stop()
            if self.pipeline is not None:
                # Live runs are abandoned; the new primary's re-seed resumes
                # them.
                await self.pipeline.stop()
            if self.dispatchers is not None:
                await self.dispatchers.stop()
            if self.topic is not None:
                # In-flight deliveries are cancelled: their tasks' writes
                # would meet the store's fence, and the new primary's
                # re-seed owns redelivery. aclose is terminal, so topic and
                # webhook go: a promotion builds them anew
                # (_start_transport -> _build_push).
                await self.topic.aclose()
                self.topic = None
                self.webhook = None
                self.store.set_publisher(None)
                await self._close_webhook()
        if primary_url and self.replicator is None:
            self.config.replicate_from = primary_url
            self._start_standby(primary_url)

    async def _fail_dead_letter(self, task_id: str) -> None:
        try:
            task = self.store.get(task_id)
            if task.canonical_status not in TaskStatus.TERMINAL:
                await self.task_manager.fail_task(task_id,
                                                  TaskStatus.DEAD_LETTER)
        except Exception:  # noqa: BLE001 — best-effort terminal transition
            log.exception("could not fail dead-lettered task %s", task_id)

    async def stop(self) -> None:
        if self.watchdog is not None:
            await self.watchdog.stop()
            self.watchdog = None
        if self.replicator is not None:
            await self.replicator.aclose()
            self.replicator = None
        if self.prober is not None:
            await self.prober.aclose()
            self.prober = None
        if self._started:
            for scaler in self.autoscalers:
                await scaler.stop()
            if self.reaper is not None:
                await self.reaper.stop()
            if self.slo is not None:
                await self.slo.stop()
            await self.depth_logger.stop()
            if self.pipeline is not None:
                await self.pipeline.stop()
            if self.dispatchers is not None:
                await self.dispatchers.stop()
            if hasattr(self.store, "stop_replication"):
                await self.store.stop_replication()
            self._transport_running = False
            self._started = False
        # Push cleanup runs also when start() failed mid-way (a handshake
        # error after the webhook's site was bound).
        if self.topic is not None:
            await self.topic.aclose()
        await self._close_webhook()
        if hasattr(self.broker, "close"):
            self.broker.close()

    async def _close_webhook(self) -> None:
        if self._webhook_runner is not None:
            await self._webhook_runner.cleanup()
            self._webhook_runner = None
