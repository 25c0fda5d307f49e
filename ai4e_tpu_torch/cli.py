"""Command line: ``python -m ai4e_tpu_torch
control-plane|worker|reporter|redrive|trace|top|timeline``.

Counterpart of ``ai4e_tpu/cli.py``; both read the same spec files and the
same ``AI4E_*`` variables (``config.FrameworkConfig.from_env``):

- ``control-plane --routes routes.json [--port P]`` — gateway, task store
  (its HTTP surface on the same port), broker and dispatchers in one
  process. It imports neither torch nor JAX. routes.json is
  ``{"apis": [{"prefix", "backend", "mode": "async"|"sync",
  "concurrency", "retry_delay", "max_body_bytes", "internal",
  "autoscale"}], "definitions": [...]}``, ``autoscale`` being
  ``scaling.AutoscalePolicy``'s fields; a route's ``"backends": [{"uri",
  "weight"}, ...]`` in place of ``backend`` is a weighted canary set
  (``utils/backends.py``), and ``definitions`` are typed API definitions
  (``gateway/registration.ApiDefinition``'s fields), published before the
  ``apis``. ``AI4E_PLATFORM_TRANSPORT=push`` delivers through the push
  topic and webhook instead of the queue (``_PUSH_TTL_SECONDS``,
  ``_PUSH_MAX_ATTEMPTS``, ``_PUSH_WINDOW``), and refuses a route's
  ``autoscale``, ``retry_delay`` and ``concurrency``; the startup line
  names the transport.
- ``worker --models models.json [--port P] [--device cuda|cpu]`` — model
  runtime, micro-batcher and service shell, on the card unless
  ``--device cpu``. models.json has ``service_name``, ``prefix``,
  ``models`` (``family`` plus the family's keyword arguments,
  ``sync_path``, ``async_path``, ``maximum_concurrent_requests``,
  ``checkpoint``, ``pipeline_to`` (a pipeline stage's handoff, see
  ``_declarative_handoff``) and ``batch`` (``true``, or ``serve_batch``'s
  keyword arguments: the model's batch API)) and optionally ``taskstore``:
  the control plane's URL (a comma-separated value is its replica set),
  whose task store then holds the worker's tasks and results. A
  ``seqformer-lm`` model is served on ``{prefix}/{name}-stream-async`` by
  a continuous-batching decode engine when ``AI4E_RUNTIME_DECODE_ENABLE``
  is on (``AI4E_RUNTIME_KV_SLOTS``, ``_KV_MAX_LEN``,
  ``_DECODE_PROMPT_BUCKETS``, ``_DECODE_MAX_PENDING``), and skipped with a
  warning when it is off. ``AI4E_ROLLOUT_GENERATION`` (0: keep the
  default) sets every model's rollout generation, and
  ``AI4E_SERVICE_REPORTER_URI`` (with ``_CLUSTER``) reports each request
  to a request reporter. With ``WORLD_SIZE`` > 1 (and ``RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``) the worker is one rank of a mesh:
  rank 0 serves and every other rank mirrors its batches
  (``parallel/multihost.py``) until rank 0 stops; the mesh is
  ``AI4E_RUNTIME_MESH_SPEC`` (``dp=2``, ``sp=2``, ``dp=2,tp=2``: the
  serving plane's grammar, served through a ``MeshEndpoint``, health
  threshold ``AI4E_RUNTIME_MESH_UNHEALTHY_AFTER``) or the axis sizes
  ``AI4E_RUNTIME_DP``/``_FSDP``/``_TP``/``_SP``/``_EP``, never both, and by
  default every rank on dp.
- ``reporter [--port P]`` — the cross-replica in-flight request counter
  (``metrics/reporter.py``; port 8085 by default). It imports neither
  torch nor JAX.
- ``redrive --store CONTROL_PLANE [--task-id ID | --contains TEXT]
  [--api-key KEY]`` — republish failed tasks with their original bodies
  (``POST /v1/taskstore/redrive``): one task, or every failed task whose
  status contains TEXT (default: the dead-letter prose; ``''``: all).
  It imports neither torch nor JAX.
- ``trace --task-id ID --url CONTROL_PLANE`` — the task's hop ledger,
  fetched live (``GET /v1/taskmanagement/task/{id}?ledger=1``) and rendered
  with per-hop deltas; ``trace [--task-id ID | --trace-id ID] [--list]
  [--export LOG]`` — span trees from the JSONL span log (default:
  ``AI4E_OBSERVABILITY_TRACE_EXPORT_PATH``). Neither imports torch.
- ``top --targets name=url,... | --collector URL [--interval S]
  [--once]`` — the fleet dashboard (``observability/top.py``): per
  process req/s, goodput, SLO burn, loop lag, RSS. ``--once`` prints one
  frame, its rates from two snapshots ``interval`` apart.
- ``timeline --rig-dir DIR [--out PATH]`` — one Chrome-trace JSON of a
  run (``observability/timeline.build_from_rig_dir``: ``ledgers.json``,
  ``vitals.json``, ``rig.json``'s chaos times), written to
  ``DIR/timeline.json`` by default. Neither builds a platform.

Both services install ``AI4E_OBSERVABILITY_*``'s tracer settings at start
(every span an INFO log line unless an export path or OTLP endpoint is
set, as in JAX) and, with ``AI4E_OBSERVABILITY_VITALS``, sample their own
vitals into their ``/metrics``.

``AI4E_GATEWAY_API_KEYS`` keys the control plane (its task-store surface
included; set but empty, it raises) and the worker's admin verbs;
``AI4E_GATEWAY_RATE_LIMIT_RPS``/``_BURST``, ``_RATE_LIMITS``, ``_QUOTA``
and ``_QUOTAS`` throttle it; a worker reaches a keyed control plane with
``AI4E_SERVICE_TASKSTORE_API_KEY``; ``AI4E_PLATFORM_RESULT_CACHE`` turns
on the result cache (``_CACHE_MAX_ENTRIES``, ``_CACHE_MAX_BYTES``,
``_CACHE_TTL_SECONDS``). ``AI4E_PLATFORM_RESULT_DIR`` offloads results of
``_RESULT_OFFLOAD_THRESHOLD`` bytes or more to files there, and a worker
with ``AI4E_SERVICE_RESULT_DIR`` on the same directory writes them itself
and registers a pointer; ``AI4E_PLATFORM_NATIVE_STORE`` and
``_NATIVE_BROKER`` run the C++ cores; ``AI4E_PLATFORM_REAPER_RUNNING_TIMEOUT``
turns on the reaper's rescue of tasks stuck in running
(``_REAPER_MAX_REQUEUES`` rescues, then failed).
``AI4E_PLATFORM_JOURNAL_PATH`` journals the control plane's task store
(``AI4E_TASKSTORE_FSYNC``: ``never``, ``always`` or ``group:<ms>``), so a
restart keeps every task and publishes the unfinished ones again; with
``AI4E_PLATFORM_REPLICATE_FROM`` (the primary's URL) as well the control
plane is the HA pair's standby (``_FAILOVER_INTERVAL``,
``_FAILOVER_DOWN_AFTER``, ``_REPLICATE_API_KEY``; ``_ADVERTISE_URL`` on
both). Workers list the pair as ``"taskstore": "primary,standby"``.

A spec key, route key or ``AI4E_*`` knob the JAX package would honour and
this port does not serve yet raises and names its ROADMAP item.
"""

from __future__ import annotations

import argparse
import asyncio
import inspect
import json
import logging
import os
import signal
import threading

from .config import ConfigError, FrameworkConfig
from .taskstore.task import TaskStatus

log = logging.getLogger("ai4e_tpu_torch.cli")

def load_spec(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _key_list(value: str | None) -> list[str]:
    """A comma-separated key list's non-empty keys, in order."""
    return [k.strip() for k in (value or "").split(",") if k.strip()]


def gateway_api_keys(config: FrameworkConfig) -> set[str] | None:
    """``AI4E_GATEWAY_API_KEYS`` as a set: the control plane's subscription
    keys and the worker's admin keys. None when unset (open); set but
    empty raises, on both sides: the operator wanted auth, so fail
    closed."""
    if config.gateway.api_keys is None:
        return None
    keys = set(_key_list(config.gateway.api_keys))
    if not keys:
        raise ConfigError("AI4E_GATEWAY_API_KEYS is set but contains no keys")
    return keys


# -- control plane -----------------------------------------------------------


def build_control_plane(config: FrameworkConfig, routes: dict):
    """Assemble the control-plane process; returns the wired platform, whose
    gateway app also carries the task store's HTTP surface."""
    from .platform_assembly import LocalPlatform
    from .scaling import AutoscalePolicy
    from .taskstore.http import make_app as make_taskstore_app

    keys = gateway_api_keys(config)
    platform = LocalPlatform(config.to_platform_config())
    if keys is not None:
        # The APIM front door: published APIs need a subscription key.
        platform.gateway.set_api_keys(keys)
    platform.gateway.max_body_bytes = config.gateway.max_body_bytes
    if config.gateway.rate_limit_rps or config.gateway.rate_limits:
        from .gateway.ratelimit import (RateLimit, RateLimiter,
                                        parse_rate_limits)
        per_key = parse_rate_limits(config.gateway.rate_limits or "")
        if config.gateway.rate_limit_rps:
            default = RateLimit(rps=config.gateway.rate_limit_rps,
                                burst=config.gateway.rate_limit_burst)
        else:
            # Per-key limits alone: keys without one stay unlimited.
            default = RateLimit(rps=1e9)
        platform.gateway.set_rate_limiter(RateLimiter(default,
                                                      per_key=per_key))
    if config.gateway.quota or config.gateway.quotas:
        from .gateway.ratelimit import (QuotaTracker, parse_quota,
                                        parse_quotas)
        per_key_q = parse_quotas(config.gateway.quotas or "")
        # None: keys without a per-key quota are unlimited and untracked.
        default_q = (parse_quota(config.gateway.quota)
                     if config.gateway.quota else None)
        platform.gateway.set_quota_tracker(QuotaTracker(default_q,
                                                        per_key=per_key_q))
    # Role flips over HTTP run the platform's whole sequence, not a bare
    # store flip.
    make_taskstore_app(platform.store, app=platform.gateway.app,
                       max_body_bytes=config.gateway.max_body_bytes,
                       max_result_bytes=config.gateway.max_result_bytes,
                       lifecycle=platform)
    if routes.get("definitions"):
        # Typed API definitions publish through the registration
        # customizer; both spec styles may share one routes.json.
        from .gateway.registration import (ApiDefinition,
                                           register_definitions)
        register_definitions(platform, [ApiDefinition.from_dict(r)
                                        for r in routes["definitions"]])
    for api in routes.get("apis", []):
        mode = api.get("mode", "async")
        autoscale = api.get("autoscale")
        autoscale = AutoscalePolicy(**autoscale) if autoscale else None
        # A presence check, not truthiness: an empty "backends" must reach
        # normalize_backends' error, not fall back to "backend".
        backend = api["backends"] if "backends" in api else api["backend"]
        if mode == "sync":
            platform.publish_sync_api(api["prefix"], backend,
                                      max_body_bytes=api.get("max_body_bytes"))
        elif mode != "async":
            raise ValueError(f"route mode {mode!r}: expected async or sync")
        elif api.get("internal"):
            platform.register_internal_route(
                backend, retry_delay=api.get("retry_delay"),
                concurrency=api.get("concurrency"), autoscale=autoscale)
        else:
            platform.publish_async_api(
                api["prefix"], backend,
                retry_delay=api.get("retry_delay"),
                concurrency=api.get("concurrency"), autoscale=autoscale,
                max_body_bytes=api.get("max_body_bytes"))
    return platform


async def start_vitals(config: FrameworkConfig, metrics):
    """A started ``VitalsSampler`` into ``metrics`` when
    ``AI4E_OBSERVABILITY_VITALS`` is set, else None."""
    if not config.observability.vitals:
        return None
    from .observability.vitals import VitalsSampler

    vitals = VitalsSampler(metrics,
                           interval_s=config.observability.vitals_interval)
    await vitals.start()
    return vitals


async def run_control_plane(config: FrameworkConfig, routes: dict) -> None:
    from aiohttp import web

    from .taskstore.journal import crc32c_impl

    platform = build_control_plane(config, routes)
    runner = web.AppRunner(platform.gateway.app)
    await runner.setup()
    await web.TCPSite(runner, config.gateway.host, config.gateway.port).start()
    await platform.start()
    vitals = await start_vitals(config, platform.metrics)
    # Operators grep the startup line for posture: admission changes the
    # public contract (sheds, expiry, computed Retry-After); resilience
    # the failure semantics (breakers, retries, 5xx as transient);
    # orchestration placement and overload (deadline- and cost-aware
    # picks, the brownout ladder, predictive scaling); tenancy the
    # contract a caller gets (its bucket, lane and series); sharding the
    # durability and availability topology (per-shard journals and
    # failover); the journal's fsync policy what an acknowledgment means
    # against a machine crash, and its checksum what a replay costs.
    stats = getattr(platform.store, "journal_stats", None)
    journal = stats() if stats is not None else {}
    posture = "".join([
        f", transport {platform.config.transport}",
        ", admission control ON" if platform.admission is not None else "",
        ", resilience ON" if platform.resilience is not None else "",
        (", orchestration ON"
         if platform.orchestration is not None else ""),
        (f", tenancy ON ({len(platform.tenancy.registry.tenant_ids())}"
         f" tenants)" if platform.tenancy is not None else ""),
        ", observability ON" if platform.observability is not None else "",
        (f", SLO engine ON ({len(platform.slo.objectives)} objectives)"
         if platform.slo is not None else ""),
        ", vitals ON" if vitals is not None else "",
        (f", task store sharded x{platform.config.task_shards}"
         if platform.config.task_shards > 1 else ""),
        (f", journal {config.platform.journal_path} "
         f"fsync={journal['fsync_policy']} crc32c={crc32c_impl()}"
         if journal else ""),
        (f", standby of {config.platform.replicate_from}"
         if config.platform.replicate_from else "")])
    log.info("control plane on %s:%s (%d routes%s)", config.gateway.host,
             config.gateway.port, len(platform.gateway.routes), posture)
    try:
        await _wait_for_termination()
    finally:
        if vitals is not None:
            await vitals.stop()
        await platform.stop()
        await runner.cleanup()
        if journal:
            log.info("journal stats %s", json.dumps(stats()))
            # A clean stop owes the disk nothing: the group policy's
            # pending fsync runs here.
            platform.store.close()


# -- worker ------------------------------------------------------------------


def restore_checkpoint(servable, path: str,
                       checkpoint_dir: str | None = None,
                       state_dict_from_flax=None) -> None:
    """Load a flax params tree saved flat with ``convert.save_npz`` into
    ``servable.module``, converted by ``state_dict_from_flax`` (default:
    the servable's own converter); a relative path resolves under
    ``checkpoint_dir`` (``AI4E_RUNTIME_CHECKPOINT_DIR``) or the working
    directory, and a bare name to ``<name>.npz`` there when that file
    exists. Any other path raises, naming ``scripts/orbax_to_npz.py``,
    which converts an orbax checkpoint where JAX is installed."""
    from .checkpoint import load_params, resolve_npz

    convert = state_dict_from_flax or servable.state_dict_from_flax
    if convert is None:
        raise ValueError(f"model {servable.name!r} has no weights to restore")
    if not os.path.isabs(path):
        path = os.path.abspath(os.path.join(checkpoint_dir or ".", path))
    path = resolve_npz(path)
    servable.module.load_state_dict(convert(load_params(path)))
    servable.checkpoint_path = path
    log.info("restored %s params from %s", servable.name, path)


def _declarative_handoff(spec: dict | None):
    """A model spec's ``pipeline_to`` as a handoff callable: composite APIs
    as deployment data.

    ``{"endpoint": "/v1/models/classify-async", "when_nonempty":
    "detections"}`` hands the task on with an empty body, which makes the
    store replay the task's ORIGINAL payload to the next stage; when the
    gate field of the result is empty or absent the stage completes the
    task itself.

    ``{"endpoint": ".../classify-species-batch-async", "payload": "crops",
    "crop_size": 224, "max_crops": 16}`` ships the detector's crops to the
    next stage's batch endpoint instead (``runtime.handoffs.crops_handoff``,
    tuned with ``crop_size``, ``max_crops`` and ``min_score``)."""
    if not spec:
        return None
    endpoint = spec["endpoint"]
    if spec.get("payload") == "crops":
        from .runtime.handoffs import crops_handoff
        return crops_handoff(endpoint, crop_size=spec.get("crop_size", 224),
                             max_crops=spec.get("max_crops", 16),
                             min_score=spec.get("min_score"))
    gate = spec.get("when_nonempty")

    def pipeline_to(result):
        if gate is not None:
            value = result.get(gate) if isinstance(result, dict) else None
            if not value:
                return None  # nothing to hand off: the stage completes it
        return endpoint, b""  # an empty body replays the original one

    return pipeline_to


def _stores(models: dict, config: FrameworkConfig):
    """``(task_manager, result_store)``: on the control plane's task store
    when the spec (or ``AI4E_GATEWAY_TASKSTORE_GET_URI``) names it, with
    the first non-empty key of ``AI4E_SERVICE_TASKSTORE_API_KEY`` (a keyed
    control plane keys its store surface too), else a store of the
    worker's own. ``AI4E_SERVICE_RESULT_DIR`` offloads results of
    ``AI4E_SERVICE_RESULT_OFFLOAD_THRESHOLD`` bytes or more to files."""
    from .service.task_manager import (DirectResultStore, HttpResultStore,
                                       HttpTaskManager, LocalTaskManager)
    from .taskstore import InMemoryTaskStore

    service = config.service
    base = models.get("taskstore") or config.gateway.taskstore_get_uri
    if not base:
        # A standalone worker: ``AI4E_SERVICE_RESULT_DIR`` becomes its own
        # store's offload backend (there is no control plane to register
        # pointers with).
        backend = None
        if service.result_dir:
            from .taskstore.results import FileResultBackend

            backend = FileResultBackend(service.result_dir)
        store = InMemoryTaskStore(
            result_backend=backend,
            result_offload_threshold=(service.result_offload_threshold
                                      if backend else None))
        return LocalTaskManager(store), store
    # The gateway's comma-separated key list may be mounted as it is: a
    # leading comma must not leave the worker keyless.
    key = next(iter(_key_list(service.taskstore_api_key)), None)
    if isinstance(base, str) and "," in base:
        # The control plane's replica set, primary first.
        base = [u.strip() for u in base.split(",") if u.strip()]
    results = HttpResultStore(base, api_key=key)
    if service.result_dir:
        # Large results go to the result directory the control plane
        # serves (AI4E_PLATFORM_RESULT_DIR); only a pointer crosses HTTP.
        results = DirectResultStore(service.result_dir, results,
                                    threshold=service.result_offload_threshold)
    return HttpTaskManager(base, api_key=key), results


def _mesh_from_config(rt, device_type: str):
    """The serving mesh from the runtime section, one of two sources:

    - ``AI4E_RUNTIME_MESH_SPEC``, the serving-mesh grammar (``dp=8``,
      ``dp=2,tp=2``; ``runtime/mesh/spec.py``), checked against the ranks
      present (``MeshSpecError`` where it needs more or fewer);
    - the axis sizes ``AI4E_RUNTIME_DP/FSDP/TP/SP/EP`` (dp 0: whatever the
      others leave of the ranks).

    Both set raises. Neither: every rank on dp, or None for one process."""
    from .parallel.sharding import MeshSpec, make_mesh, process_count
    from .runtime.mesh.spec import parse_mesh_spec

    layout = parse_mesh_spec(rt.mesh_spec)
    axes = dict(fsdp=rt.fsdp, tp=rt.tp, sp=rt.sp, ep=rt.ep)
    axes_set = rt.dp > 0 or any(v > 1 for v in axes.values())
    if layout is not None:
        if axes_set:
            raise ValueError(
                "AI4E_RUNTIME_MESH_SPEC and the AI4E_RUNTIME_DP/FSDP/TP/"
                "SP/EP axis knobs are mutually exclusive — the spec IS "
                "the serving mesh; unset the axis knobs")
        from .runtime.mesh.placement import mesh_for_layout
        return mesh_for_layout(layout, device_type)
    ranks = process_count()
    if not axes_set:
        return make_mesh(device_type=device_type) if ranks > 1 else None
    denom = max(1, rt.fsdp) * max(1, rt.tp) * max(1, rt.sp) * max(1, rt.ep)
    if rt.dp <= 0:
        if ranks % denom:
            raise ValueError(
                f"{ranks} ranks not divisible by fsdp*tp*sp*ep={denom} "
                f"(AI4E_RUNTIME_* axis sizes)")
        dp = ranks // denom
    else:
        dp = rt.dp
    spec = MeshSpec(dp=dp, **{k: max(1, v) for k, v in axes.items()})
    if spec.size == 1 and ranks == 1:
        return None
    return make_mesh(spec, device_type=device_type)


def build_worker(models: dict, device=None, max_wait_ms: float | None = None,
                 max_pending: int | None = None,
                 config: FrameworkConfig | None = None,
                 measure_phases: bool | None = None):
    """Assemble a worker from a models spec; returns ``(worker, batcher,
    task_manager)``. ``device`` defaults to ``cuda``; ``config`` (default:
    every section at its defaults) supplies the batcher's window and
    capacity unless ``max_wait_ms``/``max_pending`` are given, its pipeline
    depth and double buffer, the ladder deriver's knobs, the reload's
    checkpoint root, the admin verbs' keys (``AI4E_GATEWAY_API_KEYS``), the
    task-store key and the drain budget. In the JAX package's order: every
    model is registered, the persisted ladders are restored, every bucket
    is warmed (on the card: run and captured as a CUDA graph), then the
    batcher is built. ``AI4E_OBSERVABILITY_HOP_LEDGER`` makes the worker
    flush each request's hop ledger and turns on the batcher's
    device-phase, overlap and pad metrics, as in the JAX package;
    ``measure_phases`` set to True or False overrides the config for the
    metrics alone. ``seqformer-lm`` specs are collected apart and, with
    ``AI4E_RUNTIME_DECODE_ENABLE``, each gets a ``PagedDecodeRuntime`` on
    the model runtime's device, lock, stream and graph pool, warmed (its
    graphs captured) at boot, and a ``DecodeEngine`` behind
    ``worker.serve_stream``.

    With ``WORLD_SIZE`` > 1 this process first joins the process group
    (``init_distributed``; a card a rank where there are enough, else the
    rank's share of one), builds the mesh (``_mesh_from_config``), gives
    it to every family, and wraps the runtime in a ``MultihostRuntime``
    (rank 0 serves, the others call ``follower_loop``); with
    ``AI4E_RUNTIME_MESH_SPEC`` the outermost wrapper is a ``MeshEndpoint``
    whose coordinator watches the ranks' poison reports. Every rank builds
    the same models and warms the same buckets in the same order."""
    from .metrics import MetricsRegistry
    from .parallel.sharding import (init_distributed, process_count,
                                    process_index, rank_device)
    from .runtime.batcher import MicroBatcher
    from .runtime.families import build_servable
    from .runtime.ladder import LadderManager
    from .runtime.registry import ModelRuntime
    from .runtime.worker import InferenceWorker

    config = config or FrameworkConfig()
    # The admin verbs are an operator's: the front door's keys gate them.
    admin_keys = gateway_api_keys(config)
    rt = config.runtime
    init_distributed(device if device is not None else "cuda")
    device = rank_device(device)
    runtime = ModelRuntime(device=device,
                           mesh=_mesh_from_config(rt, device.type))
    ranks = process_count()
    to_serve = []
    lm_specs = []
    for spec in models.get("models", []):
        spec = dict(spec)
        family = spec.pop("family")
        if family == "seqformer-lm":
            # Served by the decode engine, not the batcher: wired once the
            # worker exists.
            lm_specs.append(spec)
            continue
        sync_path = spec.pop("sync_path", None)
        async_path = spec.pop("async_path", None)
        cap = spec.pop("maximum_concurrent_requests", 64)
        batch = spec.pop("batch", None)  # true | {serve_batch kwargs}
        checkpoint = spec.pop("checkpoint", None)
        pipeline_spec = spec.pop("pipeline_to", None)
        # Families with mesh-aware compute (sp, ep, tp) take the mesh; the
        # rest ignore it.
        spec.setdefault("mesh", runtime.mesh)
        servable = build_servable(family, **spec)
        if checkpoint:
            restore_checkpoint(servable, checkpoint, rt.checkpoint_dir)
        runtime.register(servable)
        to_serve.append((servable, sync_path, async_path, cap,
                         _declarative_handoff(pipeline_spec), batch))

    task_manager, store = _stores(models, config)
    reporter = None
    if config.service.reporter_uri:
        # The cross-replica in-flight counter; fire-and-forget deltas.
        from .metrics import ProcessingReporterClient
        reporter = ProcessingReporterClient(config.service.reporter_uri,
                                            cluster=config.service.cluster)
    metrics = MetricsRegistry()
    ladders = None
    if rt.ladder_derive and ranks > 1 and process_index():
        # Followers mirror the primary's batches, new buckets included: a
        # deriver of their own would desync the broadcast order.
        log.info("ladder derivation: follower %d defers to the mesh "
                 "primary's derived ladder", process_index())
    elif rt.ladder_derive:
        ladders = LadderManager(
            runtime, window_s=rt.ladder_window_s,
            max_programs=rt.ladder_max_programs, period_s=rt.ladder_period_s,
            dwell_s=rt.ladder_dwell_s, metrics=metrics,
            persist_path=(rt.ladder_path or os.path.join(
                rt.compile_cache_dir, "ladders.json")))
        # A restored ladder would warm buckets the followers do not: over
        # more than one rank the primary derives afresh.
        restored = ladders.restore() if ranks == 1 else None
        if restored:
            log.info("restored derived ladders for %s", sorted(restored))
    runtime.warmup()
    batcher = MicroBatcher(
        runtime,
        max_wait_ms=rt.batch_max_wait_ms if max_wait_ms is None else max_wait_ms,
        max_pending=rt.batch_max_pending if max_pending is None else max_pending,
        metrics=metrics, pipeline_depth=rt.batch_pipeline_depth,
        interactive_reserve=rt.batch_interactive_reserve,
        priority_aging_s=rt.batch_priority_aging_s,
        measure_phases=(config.observability.hop_ledger
                        if measure_phases is None else measure_phases),
        ladder_manager=ladders,
        double_buffer=rt.batch_double_buffer)
    worker = InferenceWorker(models.get("service_name", "gpu-worker"), runtime,
                             batcher, task_manager=task_manager,
                             prefix=models.get("prefix", "v1"),
                             metrics=metrics, store=store,
                             executor_workers=config.service.executor_workers,
                             checkpoint_root=rt.checkpoint_dir,
                             hop_ledger=config.observability.hop_ledger,
                             drain_timeout_s=(config.rollout.drain_timeout_ms
                                              / 1000.0),
                             admin_api_keys=admin_keys, reporter=reporter)
    for servable, sync_path, async_path, cap, handoff, batch in to_serve:
        if config.rollout.generation:
            # The deploy generation this process serves; 0 keeps the
            # registry's default.
            servable.generation = config.rollout.generation
        worker.serve_model(servable, sync_path=sync_path,
                           async_path=async_path,
                           maximum_concurrent_requests=cap,
                           pipeline_to=handoff)
        if batch:
            worker.serve_batch(servable,
                               **(batch if isinstance(batch, dict) else {}))
    if ranks > 1:
        # Rank 0's batcher runs every batch through the broadcast, so each
        # rank enters the same model calls.
        from .parallel.multihost import MultihostRuntime
        mh = MultihostRuntime(runtime)
        worker.runtime = batcher.runtime = mh
        if ladders is not None:
            ladders.runtime = mh
        if lm_specs:
            raise ValueError("seqformer-lm streaming decode serves on one "
                             "device; it does not run over a mesh of "
                             f"{ranks} ranks")
    from .runtime.mesh import parse_mesh_spec
    layout = parse_mesh_spec(rt.mesh_spec)
    if layout is not None:
        # The serving plane's endpoint: the layout checked against the live
        # mesh, poison accounting into the coordinator's follower-health
        # state machine, per-rank phases into hop ledgers. Outermost: it
        # must see the multihost runtime's poison gathers.
        from .runtime.mesh import EndpointHealth, MeshCoordinator, MeshEndpoint
        health = EndpointHealth()
        coordinator = MeshCoordinator(
            layout, health=health, process_count=ranks,
            process_index=process_index(),
            unhealthy_after=rt.mesh_unhealthy_after)
        inner = worker.runtime
        if hasattr(inner, "poison_listener"):
            coordinator.attach(inner)
        endpoint = MeshEndpoint(inner, layout, health=health,
                                coordinator=coordinator)
        worker.runtime = batcher.runtime = endpoint
        log.info("mesh serving plane ON: %s (tier %s, %d ranks, rank %d)",
                 layout.describe()["spec"], layout.tier_label, layout.size,
                 process_index())
    if lm_specs and not rt.decode_enable:
        log.warning("models spec names %d seqformer-lm servable(s) but "
                    "AI4E_RUNTIME_DECODE_ENABLE is off — not serving them",
                    len(lm_specs))
    elif lm_specs:
        _serve_lms(worker, runtime, lm_specs, rt, metrics)
    return worker, batcher, task_manager


def _serve_lms(worker, runtime, lm_specs: list[dict], rt, metrics) -> None:
    """One warmed ``PagedDecodeRuntime`` and ``DecodeEngine`` per
    ``seqformer-lm`` spec, served on the worker; ``kv_max_len`` is the
    default ``max_len``."""
    from .convert import seqformer_lm_state_dict_from_flax
    from .runtime.decode import DecodeEngine
    from .runtime.kvcache import PagedDecodeRuntime, build_lm_servable

    for spec in lm_specs:
        async_path = spec.pop("async_path", None)
        cap = spec.pop("maximum_concurrent_requests", 64)
        checkpoint = spec.pop("checkpoint", None)
        spec.setdefault("max_len", rt.kv_max_len)
        lm = build_lm_servable(**spec)
        if checkpoint:
            restore_checkpoint(lm, checkpoint, rt.checkpoint_dir,
                               seqformer_lm_state_dict_from_flax)
        backend = PagedDecodeRuntime(
            lm, runtime, slots=rt.kv_slots,
            prompt_buckets=rt.decode_prompt_buckets or None)
        backend.warm()
        engine = DecodeEngine(backend, max_pending=rt.decode_max_pending,
                              metrics=metrics)
        worker.serve_stream(engine, async_path=async_path,
                            maximum_concurrent_requests=cap)
        log.info("decode engine %s: %d slots, max_len %d, prompt buckets "
                 "%s, cache %.1f MB", lm.name, backend.slots,
                 backend.max_len, backend.prompt_buckets,
                 backend.cache_nbytes() / 1e6)


def kernel_launches() -> dict[str, int]:
    """Each serving kernel's launch count in this process, graph replays
    included."""
    from .ops import launch_counts

    counts = launch_counts()
    return {k: counts[k] for k in ("normalize_image", "fused_seg_postprocess",
                                   "flash_attention")}


def _launches_by_model(runtime, before: dict | None = None) -> dict:
    """Each model's kernel launches through its graphs' replays, less
    ``before`` (an earlier result of this function)."""
    before = before or {}
    return {model: {k: n - before.get(model, {}).get(k, 0)
                    for k, n in counts.items()}
            for model, counts in runtime.model_launches.items()}


async def serve(worker, batcher, host: str, port: int,
                stop: asyncio.Event, drain_timeout: float = 30.0,
                config: FrameworkConfig | None = None) -> None:
    """Serve ``worker`` on ``host:port`` until ``stop`` is set, then drain
    in-flight async tasks, stop the batcher and the decode engines, close
    the store clients and log each kernel's launches while serving (warmup
    excluded). ``config`` (default: every section at its defaults) may
    start the vitals sampler. In the main thread, SIGUSR1 logs the
    launches so far, the same two lines with ``so far`` for ``while
    serving``, so a process that will be killed can still be counted."""
    from aiohttp import web

    await batcher.start()
    for engine in worker.decode_engines:
        await engine.start()
    runner = web.AppRunner(worker.service.app)
    await runner.setup()
    before = kernel_launches()
    before_by_model = _launches_by_model(worker.runtime)

    def log_launches(when: str) -> None:
        log.info("kernel launches %s %s", when, json.dumps(
            {k: n - before[k] for k, n in kernel_launches().items()}))
        log.info("kernel launches by model %s %s", when, json.dumps(
            _launches_by_model(worker.runtime, before_by_model)))

    loop = asyncio.get_running_loop()
    report = threading.current_thread() is threading.main_thread()
    if report:
        loop.add_signal_handler(signal.SIGUSR1, log_launches, "so far")
    vitals = None
    try:
        await web.TCPSite(runner, host, port).start()
        vitals = await start_vitals(config or FrameworkConfig(),
                                    worker.service.metrics)
        log.info("worker on %s:%s serving %s on %s%s%s%s", host, port,
                 list(worker.runtime.models), worker.runtime.device,
                 ", vitals ON" if vitals is not None else "",
                 ", hop ledger ON" if worker.hop_ledger else "",
                 (", streaming decode ON (%s)" % ", ".join(
                     e.backend.name for e in worker.decode_engines)
                  if worker.decode_engines else ""))
        await stop.wait()
    finally:
        if vitals is not None:
            await vitals.stop()
        await worker.service.drain(timeout=drain_timeout)
        await batcher.stop()
        for engine in worker.decode_engines:
            await engine.stop()
        for client in (worker.service.reporter, worker.service.task_manager,
                       worker.store):
            # The HTTP clients close a session; a standalone worker's own
            # store closes synchronously.
            close = getattr(client, "close", None)
            if close is not None and inspect.isawaitable(done := close()):
                await done
        await runner.cleanup()
        if report:
            loop.remove_signal_handler(signal.SIGUSR1)
        log_launches("while serving")


async def run_worker(config: FrameworkConfig, models: dict,
                     device=None) -> None:
    from .parallel.sharding import process_count, process_index

    worker, batcher, _ = build_worker(models, device=device, config=config)
    if process_count() > 1 and process_index():
        # A follower rank: no HTTP surface; mirror the primary's batches
        # until its shutdown sentinel.
        log.info("follower %d/%d: entering mirror loop", process_index(),
                 process_count())
        await asyncio.to_thread(worker.runtime.follower_loop)
        _leave_process_group()
        return
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    try:
        await serve(worker, batcher, config.service.host, config.service.port,
                    stop, drain_timeout=config.service.drain_timeout,
                    config=config)
    finally:
        if process_count() > 1:
            worker.runtime.shutdown_followers()
            _leave_process_group()


def _leave_process_group() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


async def run_reporter(config: FrameworkConfig, port: int | None) -> None:
    """The ``reporter`` verb: a standalone request reporter."""
    from aiohttp import web

    from .metrics import RequestReporterService

    svc = RequestReporterService()
    runner = web.AppRunner(svc.app)
    await runner.setup()
    await web.TCPSite(runner, config.service.host, port or 8085).start()
    log.info("request reporter on %s:%s", config.service.host, port or 8085)
    try:
        await _wait_for_termination()
    finally:
        await runner.cleanup()


def run_redrive(args) -> None:
    """The ``redrive`` verb: an HTTP client of the control plane's
    ``POST /v1/taskstore/redrive``, no assembly."""
    import sys
    import urllib.error
    import urllib.request

    if args.task_id:
        payload: dict = {"TaskId": args.task_id}
    else:
        payload = {"Contains": args.contains}
    req = urllib.request.Request(
        args.store.rstrip("/") + "/v1/taskstore/redrive",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json",
                 **({"Ocp-Apim-Subscription-Key": args.api_key}
                    if args.api_key else {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            print(resp.read().decode())
    except urllib.error.HTTPError as exc:
        detail = exc.read().decode()
        if exc.code == 409:
            # The store refused: the task is not failed.
            print("redrive refused (409): task is not in a "
                  "redrivable status", file=sys.stderr)
        elif exc.code == 503:
            after = exc.headers.get("Retry-After") if exc.headers else None
            print("store refused the redrive (503"
                  + (f", retry after {after}s" if after else "")
                  + ") — standby or degraded; retry against the "
                  "primary", file=sys.stderr)
        print(detail)
        raise SystemExit(1)
    except OSError as exc:  # URLError and TimeoutError are OSErrors
        raise SystemExit(f"cannot reach {args.store}: {exc}")


def run_trace(args) -> None:
    """The ``trace`` verb: an HTTP client or a log reader, no assembly."""
    if args.url:
        if not args.task_id:
            raise SystemExit("--url mode requires --task-id")
        import urllib.error
        import urllib.request

        from .observability.ledger import render_ledger
        req = urllib.request.Request(
            args.url.rstrip("/")
            + f"/v1/taskmanagement/task/{args.task_id}?ledger=1",
            headers=({"Ocp-Apim-Subscription-Key": args.api_key}
                     if args.api_key else {}))
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                record = json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            raise SystemExit(
                f"task fetch failed: HTTP {exc.code} "
                f"{exc.read().decode(errors='replace')[:200]}")
        except OSError as exc:
            raise SystemExit(f"cannot reach {args.url}: {exc}")
        print(render_ledger(args.task_id, record.get("Ledger") or [],
                            status=record.get("Status")))
        return
    from .observability.traceview import (load_spans, render_list,
                                          render_trace, select_traces)
    path = args.export
    if path is None:
        path = FrameworkConfig.from_env().observability.trace_export_path
    if not path:
        raise SystemExit(
            "no span log: pass --export or set "
            "AI4E_OBSERVABILITY_TRACE_EXPORT_PATH on the services")
    try:
        spans = load_spans(path)
    except OSError as exc:
        raise SystemExit(f"cannot read span log {path}: {exc}")
    selected = select_traces(spans, task_id=args.task_id,
                             trace_id=args.trace_id)
    if not selected and (args.task_id or args.trace_id):
        raise SystemExit("no matching spans")
    if args.list_traces:
        print(render_list(selected, limit=args.limit))
        return
    if not selected:
        raise SystemExit("no matching spans")
    print(render_trace(selected))


def run_timeline(args) -> None:
    """The ``timeline`` verb: a run's directory to one trace file."""
    from .observability.timeline import build_from_rig_dir

    if not os.path.isdir(args.rig_dir):
        raise SystemExit(f"timeline: {args.rig_dir} is not a directory "
                         "(pass the run's artifact directory)")
    if not any(os.path.exists(os.path.join(args.rig_dir, f))
               for f in ("rig.json", "ledgers.json")):
        raise SystemExit(f"timeline: {args.rig_dir} has neither rig.json "
                         "nor ledgers.json: not a run's artifact directory")
    doc = build_from_rig_dir(args.rig_dir)
    out_path = args.out or os.path.join(args.rig_dir, "timeline.json")
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    meta = doc["otherData"]
    print(f"wrote {out_path}: {len(doc['traceEvents'])} events, "
          f"{meta['tasks']} tasks, hops {meta['hops']}, "
          f"{len(meta['procs'])} procs; load it at https://ui.perfetto.dev")


async def _wait_for_termination() -> None:
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    log.info("termination signal; draining")


def main(argv=None) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    parser = argparse.ArgumentParser(prog="ai4e_tpu_torch")
    sub = parser.add_subparsers(dest="component", required=True)
    cp = sub.add_parser("control-plane",
                        help="gateway + task store + broker + dispatchers")
    cp.add_argument("--routes", required=True, help="routes.json path")
    cp.add_argument("--port", type=int, default=None)
    wk = sub.add_parser("worker", help="GPU inference worker")
    wk.add_argument("--models", required=True, help="models.json path")
    wk.add_argument("--host", default=None)
    wk.add_argument("--port", type=int, default=None)
    wk.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    rp = sub.add_parser("reporter",
                        help="cross-replica in-flight request reporter")
    rp.add_argument("--port", type=int, default=None)
    rd = sub.add_parser(
        "redrive",
        help="republish dead-lettered (or otherwise failed) tasks with "
             "their original bodies")
    rd.add_argument("--store", default="http://127.0.0.1:8080",
                    help="control-plane URL (the task-store surface)")
    rd.add_argument("--task-id", default=None,
                    help="redrive ONE task (any failed state)")
    rd.add_argument("--contains", default=TaskStatus.DEAD_LETTER_PROSE,
                    help="sweep filter on the failed Status prose; '' "
                         "redrives every failed task")
    rd.add_argument("--api-key", default=None,
                    help="subscription key when the control plane runs "
                         "with gateway keys")
    tr = sub.add_parser(
        "trace",
        help="a task's hop ledger fetched live from the control plane "
             "(--url), or span trees from the JSONL span log")
    tr.add_argument("--export", default=None,
                    help="span log path (default: the configured "
                         "AI4E_OBSERVABILITY_TRACE_EXPORT_PATH)")
    tr.add_argument("--url", default=None,
                    help="control-plane base URL: fetch the task's hop "
                         "ledger (GET /v1/taskmanagement/task/{id}"
                         "?ledger=1) instead of reading a span log; "
                         "requires --task-id")
    tr.add_argument("--api-key", default=None,
                    help="subscription key, for a control plane that "
                         "checks one (--url mode)")
    tr_sel = tr.add_mutually_exclusive_group()
    tr_sel.add_argument("--task-id", default=None,
                        help="render every trace this task traversed")
    tr_sel.add_argument("--trace-id", default=None, help="render one trace")
    tr.add_argument("--list", action="store_true", dest="list_traces",
                    help="summarise recent traces instead of rendering")
    tr.add_argument("--limit", type=int, default=20,
                    help="--list: how many recent traces")
    tp = sub.add_parser(
        "top",
        help="live fleet dashboard: per-process req/s, goodput, SLO burn, "
             "event-loop lag, RSS from the federation snapshot")
    tp.add_argument("--collector", default=None,
                    help="poll a collector's /v1/debug/fleet")
    tp.add_argument("--spec", default=None,
                    help="scrape a rig topology.json's roles directly")
    tp.add_argument("--targets", default=None,
                    help="ad-hoc name=url,name=url target list")
    tp.add_argument("--interval", type=float, default=2.0)
    tp.add_argument("--once", action="store_true",
                    help="print one frame and exit (scriptable)")
    tl = sub.add_parser(
        "timeline",
        help="export a run as one Chrome-trace/Perfetto JSON: hop "
             "ledgers, device phases, chaos verbs, vitals curves")
    tl.add_argument("--rig-dir", required=True,
                    help="the run's directory (rig.json and the "
                         "ledgers/vitals files beside it)")
    tl.add_argument("--out", default=None,
                    help="output path (default <rig-dir>/timeline.json)")
    args = parser.parse_args(argv)
    if args.component == "top":
        from .observability.top import run_top
        raise SystemExit(asyncio.run(run_top(
            collector=args.collector, spec=args.spec,
            targets=args.targets, interval=args.interval,
            once=args.once)))
    if args.component == "timeline":
        run_timeline(args)
        return
    if args.component == "trace":
        run_trace(args)
        return
    if args.component == "redrive":
        run_redrive(args)
        return
    try:
        config = FrameworkConfig.from_env()
    except ConfigError as exc:
        raise SystemExit(f"ai4e_tpu_torch: {exc}")
    config.observability.apply()
    if args.component == "control-plane":
        if args.port is not None:
            config.gateway.port = args.port
        asyncio.run(run_control_plane(config, load_spec(args.routes)))
    elif args.component == "worker":
        if args.host is not None:
            config.service.host = args.host
        if args.port is not None:
            config.service.port = args.port
        asyncio.run(run_worker(config, load_spec(args.models),
                               device=args.device))
    elif args.component == "reporter":
        asyncio.run(run_reporter(config, args.port))


if __name__ == "__main__":
    main()
