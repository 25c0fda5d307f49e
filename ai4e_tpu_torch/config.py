"""Typed configuration with environment-variable overrides — a copy of
``ai4e_tpu/config.py``.

Every section and field of the JAX package is here under the same name,
type and default, so every documented ``AI4E_<SECTION>_<FIELD>`` variable
parses exactly as it does there, and a misspelled one fails the same way.
What this port does not serve yet is listed in ``UNPORTED``: a field there
raises ``ConfigError`` naming its variable and its ROADMAP item when it is
set away from its default, so no knob is silently ignored. Fields the JAX
package itself never reads (``RuntimeSection.buckets``,
``GatewaySection.taskstore_upsert_uri``) are accepted and stay inert, as
they do there.

Usage::

    cfg = FrameworkConfig.from_env()      # defaults + AI4E_* overrides
    platform = LocalPlatform(cfg.to_platform_config())
"""

from __future__ import annotations

import dataclasses
import os
import typing
from dataclasses import dataclass, field, fields

_TRUE = frozenset({"1", "true", "yes", "on"})
_FALSE = frozenset({"0", "false", "no", "off", ""})

# Out-of-band AI4E_* namespaces that the JAX package reads directly and that
# FrameworkConfig.from_env therefore exempts from its unknown-variable check.
OUT_OF_BAND_ENV_PREFIXES = ("AI4E_FAULT_", "AI4E_CHAOS_", "AI4E_FEED_",
                            "AI4E_TASKSTORE_", "AI4E_RIG_")

_ROLLOUT = ("the rollout controller, which only the rig drives "
            "(ROADMAP A19)")
_DONATE = "batch donation, an XLA buffer option (ROADMAP A4)"

#: ``(env prefix, field) -> what it turns on (its ROADMAP item)``.
UNPORTED: dict[tuple[str, str], str] = {
    ("AI4E_RUNTIME_", "platform"):
        "JAX's platform pin (the port's device is the --device flag)",
    ("AI4E_RUNTIME_", "donate_batch"): _DONATE,
    **{("AI4E_ROLLOUT_", f): _ROLLOUT for f in (
        "canary_steps", "step_hold_s", "guard_tick_s", "burn_fast_max",
        "burn_slow_max")},
}


class ConfigError(ValueError):
    pass


def check_ported(obj, prefix: str) -> None:
    """Raise ``ConfigError`` for the first field of the section ``obj``
    listed in ``UNPORTED`` under ``prefix`` whose value differs from its
    default."""
    for f in fields(obj):
        what = UNPORTED.get((prefix, f.name))
        if what is not None and getattr(obj, f.name) != f.default:
            raise ConfigError(
                f"{prefix}{f.name.upper()}={getattr(obj, f.name)!r}: "
                f"{what} is not ported yet")


def _parse(raw: str, typ, name: str):
    """Parse an env string per the declared field type."""
    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[X] — "" means None
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if raw == "":
            return None
        return _parse(raw, args[0], name)
    if typ is bool:
        low = raw.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ConfigError(f"{name}: {raw!r} is not a boolean")
    if typ is int:
        try:
            return int(raw)
        except ValueError as e:
            raise ConfigError(f"{name}: {raw!r} is not an int") from e
    if typ is float:
        try:
            return float(raw)
        except ValueError as e:
            raise ConfigError(f"{name}: {raw!r} is not a float") from e
    if origin in (tuple, list):
        item_t = (typing.get_args(typ) or (str,))[0]
        if item_t is Ellipsis:
            item_t = str
        items = [s.strip() for s in raw.split(",") if s.strip()]
        parsed = [_parse(s, item_t, name) for s in items]
        return tuple(parsed) if origin is tuple else parsed
    return raw


def section_from_env(cls, env: typing.Mapping[str, str] | None = None,
                     prefix: str = "AI4E_"):
    """Build a config dataclass from defaults + ``{prefix}{FIELD}`` env vars."""
    env = os.environ if env is None else env
    kwargs = {}
    hints = typing.get_type_hints(cls)
    known = {prefix + f.name.upper(): f.name for f in fields(cls)}
    for key, name in known.items():
        if key in env:
            kwargs[name] = _parse(env[key], hints[name], key)
    # A prefixed-but-unknown variable is a misspelled field: fail loudly.
    unknown = [k for k in env if k.startswith(prefix) and k not in known]
    if unknown:
        raise ConfigError(
            f"unknown config variable(s) {sorted(unknown)}; "
            f"valid: {sorted(known)}")
    return cls(**kwargs)


def _env_section(prefix: str):
    """Class decorator: attach ``from_env`` with the section's prefix, and a
    ``__post_init__`` that refuses unported fields set away from their
    defaults."""
    def deco(cls):
        cls.__post_init__ = lambda self: check_ported(self, prefix)
        cls = dataclass(cls)
        cls._env_prefix = prefix

        def from_env(inner_cls, env=None):
            return section_from_env(inner_cls, env=env, prefix=prefix)

        cls.from_env = classmethod(from_env)
        return cls
    return deco


@_env_section("AI4E_PLATFORM_")
class PlatformSection:
    """Transport/task-fabric knobs."""
    transport: str = "queue"         # queue | push
    retry_delay: float = 60.0        # dispatcher backoff on 429/503 (s)
    max_delivery_count: int = 1440   # broker patience
    dispatcher_concurrency: int = 1  # serial per queue
    journal_path: typing.Optional[str] = None
    lease_seconds: float = 300.0
    native_broker: bool = False
    native_store: bool = False
    push_ttl_seconds: float = 300.0
    push_max_attempts: int = 3
    push_window: int = 256
    reaper_running_timeout: typing.Optional[float] = None
    reaper_interval: float = 30.0
    reaper_max_requeues: int = 3
    reaper_terminal_retention: typing.Optional[float] = None
    result_dir: typing.Optional[str] = None
    result_offload_threshold: int = 1048576
    replicate_from: typing.Optional[str] = None
    failover_interval: float = 2.0
    failover_down_after: int = 3
    replicate_api_key: typing.Optional[str] = None
    advertise_url: typing.Optional[str] = None
    result_cache: bool = False
    cache_max_entries: int = 4096
    cache_max_bytes: int = 268435456
    cache_ttl_seconds: typing.Optional[float] = 300.0
    admission: bool = False
    admission_min_limit: int = 1
    admission_max_limit: int = 256
    admission_initial_limit: int = 8
    admission_max_backlog: int = 1024
    resilience: bool = False
    resilience_failure_threshold: int = 5
    resilience_window: int = 16
    resilience_error_rate: float = 0.5
    resilience_recovery_seconds: float = 30.0
    resilience_max_attempts: int = 3
    resilience_retry_base_s: float = 0.05
    resilience_retry_budget_ratio: float = 0.2
    orchestration: bool = False
    orchestration_confidence: float = 0.75
    orchestration_window: int = 256
    orchestration_horizon_s: float = 60.0
    orchestration_costs: typing.Optional[str] = None
    orchestration_ladder_up: float = 0.3
    orchestration_ladder_down: float = 0.1
    orchestration_ladder_hold_s: float = 5.0
    orchestration_scale_horizon_s: float = 10.0
    task_shards: int = 1
    task_shard_slots: int = 64
    task_shard_replicas: int = 1
    shard_tail_interval: float = 0.25
    shard_feed_recent: int = 4096
    observability: bool = False
    flight_capacity: int = 512
    flight_sample: float = 0.05
    flight_slow_ms: float = 1000.0
    slo_objectives: typing.Optional[str] = None
    slo_tick_s: float = 5.0
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    slo_ladder: bool = False
    pipeline: bool = False
    pipeline_event_replay: int = 256
    pipeline_stream_max_s: float = 300.0
    pipeline_chunk_replay: int = 128

    def to_platform_config(self):
        """The fields of this section that ``LocalPlatform`` reads;
        ``replicate_api_key`` as its first non-empty comma-separated key,
        as in JAX."""
        from .platform_assembly import PlatformConfig
        pc_fields = {f.name for f in fields(PlatformConfig)}
        values = {f.name: getattr(self, f.name) for f in fields(self)
                  if f.name in pc_fields}
        values["replicate_api_key"] = next(
            (k.strip() for k in (self.replicate_api_key or "").split(",")
             if k.strip()), None)
        return PlatformConfig(**values)


@_env_section("AI4E_SERVICE_")
class ServiceSection:
    """In-container service shell knobs."""
    host: str = "0.0.0.0"
    port: int = 8081
    executor_workers: int = 8
    drain_timeout: float = 30.0
    reporter_uri: typing.Optional[str] = None
    cluster: str = "local"
    taskstore_api_key: typing.Optional[str] = None
    result_dir: typing.Optional[str] = None
    result_offload_threshold: int = 1048576


@_env_section("AI4E_RUNTIME_")
class RuntimeSection:
    """Runtime knobs."""
    platform: typing.Optional[str] = None
    batch_max_wait_ms: float = 5.0
    batch_max_pending: int = 256
    batch_pipeline_depth: int = 2
    batch_interactive_reserve: float = 0.25
    batch_priority_aging_s: float = 2.0
    batch_double_buffer: bool = False
    ladder_derive: bool = False
    ladder_window_s: float = 300.0
    ladder_max_programs: int = 16
    ladder_period_s: float = 60.0
    ladder_dwell_s: float = 120.0
    ladder_path: typing.Optional[str] = None
    buckets: typing.Tuple[int, ...] = (1, 8, 32, 64)
    decode_enable: bool = False
    decode_max_pending: int = 64
    decode_prompt_buckets: typing.Tuple[int, ...] = ()
    kv_slots: int = 8
    kv_max_len: int = 256
    compile_cache_dir: str = "/tmp/ai4e_tpu_xla_cache"
    checkpoint_dir: typing.Optional[str] = None
    donate_batch: bool = False
    dp: int = 0
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    mesh_spec: str = ""
    mesh_unhealthy_after: int = 3


@_env_section("AI4E_GATEWAY_")
class GatewaySection:
    """Edge router knobs."""
    host: str = "0.0.0.0"
    port: int = 8080
    taskstore_upsert_uri: typing.Optional[str] = None
    taskstore_get_uri: typing.Optional[str] = None
    api_keys: typing.Optional[str] = None
    max_body_bytes: int = 134217728
    max_result_bytes: int = 1073741824
    rate_limit_rps: float = 0.0
    rate_limit_burst: float = 0.0
    rate_limits: typing.Optional[str] = None
    quota: typing.Optional[str] = None
    quotas: typing.Optional[str] = None


@_env_section("AI4E_OBSERVABILITY_")
class ObservabilitySection:
    """Tracing/metrics knobs: tracing is on at rate 1.0 with every span an
    INFO log line unless an export path or OTLP endpoint is set; the depth
    intervals feed the control plane's ``DepthLogger``; ``vitals`` starts
    the ``VitalsSampler`` in both launchers; ``hop_ledger`` makes the
    worker measure device phases and flush each request's timeline."""
    trace_enabled: bool = True
    trace_sample_rate: float = 1.0
    trace_export_path: typing.Optional[str] = None
    trace_otlp_endpoint: typing.Optional[str] = None
    queue_depth_interval: float = 30.0
    process_depth_interval: float = 300.0
    vitals: bool = False
    vitals_interval: float = 1.0
    hop_ledger: bool = False

    def apply(self) -> None:
        """Install these settings on the process tracer (components without
        explicit tracer settings follow it live)."""
        from .observability import (FanoutExporter, JsonlExporter,
                                    configure_tracer)
        rate = self.trace_sample_rate if self.trace_enabled else 0.0
        exporters = []
        if self.trace_export_path:
            exporters.append(JsonlExporter(self.trace_export_path))
        if self.trace_otlp_endpoint:
            from .observability.otlp import OtlpHttpExporter
            exporters.append(OtlpHttpExporter(self.trace_otlp_endpoint))
        exporter = None
        if len(exporters) == 1:
            exporter = exporters[0]
        elif exporters:
            exporter = FanoutExporter(exporters)
        if exporter is not None:
            # Flush buffered spans at exit (the OTLP exporter holds up to
            # its flush interval of them).
            import atexit
            atexit.register(exporter.close)
        configure_tracer(exporter=exporter, sample_rate=rate)


@_env_section("AI4E_TENANCY_")
class TenancySection:
    """Multi-tenancy knobs."""
    enabled: bool = False
    tenants: typing.Optional[str] = None
    default_weight: float = 1.0
    default_rps: float = 0.0
    default_burst: float = 0.0
    label_top_n: int = 8
    goodput_target: float = 0.99
    min_quantum: float = 0.05


@_env_section("AI4E_ROLLOUT_")
class RolloutSection:
    """Zero-downtime rollout knobs."""
    drain_timeout_ms: float = 30000.0
    canary_steps: str = "25,50,100"
    step_hold_s: float = 10.0
    guard_tick_s: float = 1.0
    burn_fast_max: float = 1.0
    burn_slow_max: float = 1.0
    drain_eject_ttl_s: float = 30.0
    generation: int = 0


@dataclass
class FrameworkConfig:
    """The whole platform's config tree."""
    platform: PlatformSection = field(default_factory=PlatformSection)
    service: ServiceSection = field(default_factory=ServiceSection)
    runtime: RuntimeSection = field(default_factory=RuntimeSection)
    gateway: GatewaySection = field(default_factory=GatewaySection)
    observability: ObservabilitySection = field(
        default_factory=ObservabilitySection)
    tenancy: TenancySection = field(default_factory=TenancySection)
    rollout: RolloutSection = field(default_factory=RolloutSection)

    @classmethod
    def from_env(cls, env: typing.Mapping[str, str] | None = None
                 ) -> "FrameworkConfig":
        hints = typing.get_type_hints(cls)
        sections = {f.name: hints[f.name] for f in fields(cls)}
        # A misspelled *section* matches no section prefix: catch it here.
        env_map = os.environ if env is None else env
        prefixes = tuple(s._env_prefix for s in sections.values())
        unknown = [k for k in env_map
                   if k.startswith("AI4E_") and not k.startswith(prefixes)
                   and not k.startswith(OUT_OF_BAND_ENV_PREFIXES)]
        if unknown:
            raise ConfigError(
                f"unknown config section in variable(s) {sorted(unknown)}; "
                f"valid section prefixes: {sorted(prefixes)}")
        return cls(**{name: sec.from_env(env)
                      for name, sec in sections.items()})

    def to_platform_config(self):
        """The ``PlatformConfig`` the control plane assembles from: the
        platform section's fields, the depth logger's intervals from the
        observability section, the tenancy section's fields and the drain
        ejection's TTL from the rollout section."""
        pc = self.platform.to_platform_config()
        pc.queue_depth_interval = self.observability.queue_depth_interval
        pc.process_depth_interval = self.observability.process_depth_interval
        pc.tenancy = self.tenancy.enabled
        pc.tenancy_tenants = self.tenancy.tenants
        pc.tenancy_default_weight = self.tenancy.default_weight
        pc.tenancy_default_rps = self.tenancy.default_rps
        pc.tenancy_default_burst = self.tenancy.default_burst
        pc.tenancy_label_top_n = self.tenancy.label_top_n
        pc.tenancy_goodput_target = self.tenancy.goodput_target
        pc.tenancy_min_quantum = self.tenancy.min_quantum
        pc.rollout_drain_eject_ttl_s = self.rollout.drain_eject_ttl_s
        return pc

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
