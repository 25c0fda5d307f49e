"""The port's ``FrameworkConfig.from_env`` against the JAX package's on the
same environment dicts: the same section values, the same ``ConfigError``
for a misspelled or malformed ``AI4E_*`` variable, and, for every knob
whose feature the port does not serve yet, a ``ConfigError`` that names the
variable and its ROADMAP item (the JAX package accepts the same value)."""

import dataclasses
import typing

import pytest

from ai4e_tpu import config as jax_config
from ai4e_tpu_torch import config as port_config
from ai4e_tpu_torch.platform_assembly import PlatformConfig

SAME = [
    {},
    {"AI4E_PLATFORM_RETRY_DELAY": "0.05",
     "AI4E_PLATFORM_MAX_DELIVERY_COUNT": "3",
     "AI4E_PLATFORM_DISPATCHER_CONCURRENCY": "4",
     "AI4E_PLATFORM_LEASE_SECONDS": "30"},
    {"AI4E_SERVICE_HOST": "127.0.0.1", "AI4E_SERVICE_PORT": "9000",
     "AI4E_SERVICE_EXECUTOR_WORKERS": "2", "AI4E_SERVICE_DRAIN_TIMEOUT": "5"},
    {"AI4E_RUNTIME_BATCH_MAX_WAIT_MS": "2.5",
     "AI4E_RUNTIME_BATCH_MAX_PENDING": "64",
     "AI4E_RUNTIME_CHECKPOINT_DIR": "/ckpts",
     "AI4E_RUNTIME_BUCKETS": "1, 16,64"},
    {"AI4E_GATEWAY_HOST": "127.0.0.1", "AI4E_GATEWAY_PORT": "18080",
     "AI4E_GATEWAY_MAX_BODY_BYTES": "0",
     "AI4E_GATEWAY_MAX_RESULT_BYTES": "1024",
     "AI4E_GATEWAY_TASKSTORE_GET_URI": "http://cp:8080,http://standby:8080",
     "AI4E_GATEWAY_TASKSTORE_UPSERT_URI": "http://cp:8080"},
    {"AI4E_FAULT_FETCH_FAIL_NTHS": "3", "AI4E_TASKSTORE_FSYNC": "always",
     "OTHER": "1"},
    {"AI4E_PLATFORM_REAPER_INTERVAL": "5",
     "AI4E_PLATFORM_REAPER_TERMINAL_RETENTION": "60"},
]
ERRORS = [
    {"AI4E_PLATFORM_RETRY_DELEY": "1"},
    {"AI4E_OBSERVABILTY_TRACE_ENABLED": "0"},
    {"AI4E_PLATFORM_RETRY_DELAY": "soon"},
    {"AI4E_SERVICE_PORT": "80.5"},
    {"AI4E_RUNTIME_BATCH_MAX_WAIT_MS": ""},
    {"AI4E_RUNTIME_BUCKETS": "1,x"},
]


def off_default(field: dataclasses.Field, hint) -> str:
    """An env value that parses to something other than the default."""
    default = field.default
    base = typing.get_args(hint)[0] if typing.get_origin(hint) is typing.Union \
        else hint
    if base is bool:
        return "0" if default else "1"
    if base is int:
        return str(default + 1)
    if base is float:
        return str((default or 0.0) + 1.5)
    if typing.get_origin(base) is tuple:
        return "3,5"
    return "x"


#: The runtime's pipeline, double-buffer, priority-class, ladder and drain
#: knobs: the port serves them, so each set away from its default parses as
#: JAX's does.
SERVED_RUNTIME_KNOBS = [
    ("AI4E_RUNTIME_", f) for f in (
        "batch_pipeline_depth", "batch_double_buffer",
        "batch_interactive_reserve", "batch_priority_aging_s", "ladder_derive",
        "ladder_window_s", "ladder_max_programs", "ladder_period_s",
        "ladder_dwell_s", "ladder_path", "compile_cache_dir")] + [
    ("AI4E_ROLLOUT_", "drain_timeout_ms")]

#: The parallel plane's knobs (ROADMAP A15): the mesh spec, the five axis
#: sizes and the mesh endpoint's health threshold parse as JAX's do.
SERVED_MESH_KNOBS = [
    ("AI4E_RUNTIME_", f) for f in (
        "dp", "fsdp", "tp", "sp", "ep", "mesh_spec", "mesh_unhealthy_after")]


#: The observability knobs (ROADMAP A18.11): the port serves them, so each
#: set away from its default parses as JAX's does. ``slo_ladder`` came with
#: orchestration (A18.9, ``SERVED_RESILIENCE_KNOBS``).
SERVED_OBSERVABILITY_KNOBS = [
    ("AI4E_OBSERVABILITY_", f) for f in (
        "trace_enabled", "trace_sample_rate", "trace_export_path",
        "trace_otlp_endpoint", "queue_depth_interval",
        "process_depth_interval", "vitals", "vitals_interval",
        "hop_ledger")] + [
    ("AI4E_PLATFORM_", f) for f in (
        "observability", "flight_capacity", "flight_sample",
        "flight_slow_ms", "slo_objectives", "slo_tick_s",
        "slo_fast_window_s", "slo_slow_window_s")]


#: The streaming decode knobs (ROADMAP A13): the port serves them, so each
#: set away from its default parses as JAX's does.
SERVED_DECODE_KNOBS = [
    ("AI4E_RUNTIME_", f) for f in (
        "decode_enable", "decode_max_pending", "decode_prompt_buckets",
        "kv_slots", "kv_max_len")]


#: Admission control's knobs (ROADMAP A18.5): the port serves them, so
#: each set away from its default parses as JAX's does.
SERVED_ADMISSION_KNOBS = [
    ("AI4E_PLATFORM_", f) for f in (
        "admission", "admission_min_limit", "admission_max_limit",
        "admission_initial_limit", "admission_max_backlog")]


#: Subscription keys, rate limits and quotas (ROADMAP A18.4) and the result
#: cache (A18.6): the port serves them, so each set away from its default
#: parses as JAX's does.
SERVED_AUTH_CACHE_KNOBS = [
    ("AI4E_GATEWAY_", f) for f in (
        "api_keys", "rate_limit_rps", "rate_limit_burst", "rate_limits",
        "quota", "quotas")] + [
    ("AI4E_SERVICE_", "taskstore_api_key")] + [
    ("AI4E_PLATFORM_", f) for f in (
        "result_cache", "cache_max_entries", "cache_max_bytes",
        "cache_ttl_seconds")]


#: Result offload, the native cores (ROADMAP A18.13) and the reaper's
#: stuck-task rescue (A18.7): the port serves them, so each set away from
#: its default parses as JAX's does.
SERVED_NATIVE_REAPER_KNOBS = [
    ("AI4E_PLATFORM_", f) for f in (
        "native_broker", "native_store", "result_dir",
        "result_offload_threshold", "reaper_running_timeout",
        "reaper_max_requeues")] + [
    ("AI4E_SERVICE_", f) for f in ("result_dir", "result_offload_threshold")]


#: The journaled store and its HA pair (ROADMAP A18.1): the port serves
#: them, so each set away from its default parses as JAX's does.
SERVED_HA_KNOBS = [
    ("AI4E_PLATFORM_", f) for f in (
        "journal_path", "replicate_from", "failover_interval",
        "failover_down_after", "replicate_api_key", "advertise_url")]


#: The sharded task store (ROADMAP A18.2): the port serves it, so each set
#: away from its default parses as JAX's does.
SERVED_SHARD_KNOBS = [
    ("AI4E_PLATFORM_", f) for f in (
        "task_shards", "task_shard_slots", "task_shard_replicas",
        "shard_tail_interval", "shard_feed_recent")]


#: The push transport (ROADMAP A18.3), the request reporter (A18.14) and
#: the worker's rollout generation (A6.3): the port serves them, so each
#: set away from its default parses as JAX's does.
SERVED_PUSH_REPORTER_KNOBS = [
    ("AI4E_PLATFORM_", f) for f in (
        "transport", "push_ttl_seconds", "push_max_attempts",
        "push_window")] + [
    ("AI4E_SERVICE_", f) for f in ("reporter_uri", "cluster")] + [
    ("AI4E_ROLLOUT_", "generation")]

#: Resilience and orchestration (ROADMAP A18.9): the port serves them, so
#: each set away from its default parses as JAX's does.
SERVED_RESILIENCE_KNOBS = [
    ("AI4E_PLATFORM_", f) for f in (
        "resilience", "resilience_failure_threshold", "resilience_window",
        "resilience_error_rate", "resilience_recovery_seconds",
        "resilience_max_attempts", "resilience_retry_base_s",
        "resilience_retry_budget_ratio", "orchestration",
        "orchestration_confidence", "orchestration_window",
        "orchestration_horizon_s", "orchestration_costs",
        "orchestration_ladder_up", "orchestration_ladder_down",
        "orchestration_ladder_hold_s", "orchestration_scale_horizon_s",
        "slo_ladder")] + [
    ("AI4E_ROLLOUT_", "drain_eject_ttl_s")]

#: Tenancy (ROADMAP A18.10) and pipeline DAGs (A18.12): served, so each
#: set away from its default parses as JAX's does.
SERVED_TENANCY_PIPELINE_KNOBS = [
    ("AI4E_TENANCY_", f) for f in (
        "enabled", "tenants", "default_weight", "default_rps",
        "default_burst", "label_top_n", "goodput_target",
        "min_quantum")] + [
    ("AI4E_PLATFORM_", f) for f in (
        "pipeline", "pipeline_event_replay", "pipeline_stream_max_s",
        "pipeline_chunk_replay")]

#: The rollout controller's knobs, still refused under its item.
CONTROLLER_KNOBS = [
    ("AI4E_ROLLOUT_", f) for f in (
        "canary_steps", "step_hold_s", "guard_tick_s", "burn_fast_max",
        "burn_slow_max")]


def off_default_cases(keys, kind: str):
    """A ``kind`` case for each field in ``keys`` (``(env prefix,
    field)``), set away from its default, id'd by its variable; an
    unported field's case carries its ROADMAP item."""
    for section in typing.get_type_hints(port_config.FrameworkConfig).values():
        hints = typing.get_type_hints(section)
        for f in dataclasses.fields(section):
            key = (section._env_prefix, f.name)
            if key in keys:
                var = key[0] + f.name.upper()
                yield pytest.param(
                    kind, {var: off_default(f, hints[f.name])},
                    port_config.UNPORTED.get(key), id=var)


CASES = ([pytest.param("same", env, None, id=f"same-{i}")
          for i, env in enumerate(SAME)]
         + [pytest.param("error", env, None, id=next(iter(env)))
            for env in ERRORS]
         + list(off_default_cases(port_config.UNPORTED, "unported"))
         + list(off_default_cases(SERVED_RUNTIME_KNOBS, "same"))
         + list(off_default_cases(SERVED_OBSERVABILITY_KNOBS, "same"))
         + list(off_default_cases(SERVED_DECODE_KNOBS, "same"))
         + list(off_default_cases(SERVED_ADMISSION_KNOBS, "same"))
         + list(off_default_cases(SERVED_AUTH_CACHE_KNOBS, "same"))
         + list(off_default_cases(SERVED_NATIVE_REAPER_KNOBS, "same"))
         + list(off_default_cases(SERVED_HA_KNOBS, "same"))
         + list(off_default_cases(SERVED_SHARD_KNOBS, "same"))
         + list(off_default_cases(SERVED_PUSH_REPORTER_KNOBS, "same"))
         + list(off_default_cases(SERVED_RESILIENCE_KNOBS, "same"))
         + list(off_default_cases(SERVED_TENANCY_PIPELINE_KNOBS, "same"))
         + list(off_default_cases(SERVED_MESH_KNOBS, "same")))


@pytest.mark.parametrize("kind,env,item", CASES)
def test_from_env_matches_jax(kind, env, item):
    if kind == "error":
        with pytest.raises(jax_config.ConfigError) as want:
            jax_config.FrameworkConfig.from_env(env)
        with pytest.raises(port_config.ConfigError) as got:
            port_config.FrameworkConfig.from_env(env)
        assert str(got.value) == str(want.value)
        return
    want = jax_config.FrameworkConfig.from_env(env).to_dict()
    if kind == "same":
        assert port_config.FrameworkConfig.from_env(env).to_dict() == want
        return
    # An unported knob: JAX takes the value; the port refuses it, naming
    # the variable and its ROADMAP item.
    (var, raw), = env.items()
    section = next(s for s in want if var.startswith(
        f"AI4E_{s.upper()}_"))
    field = var[len(f"AI4E_{section.upper()}_"):].lower()
    default = getattr(jax_config.FrameworkConfig(), section)
    assert want[section][field] != getattr(default, field)
    assert "ROADMAP" in item or "--device" in item
    with pytest.raises(port_config.ConfigError) as got:
        port_config.FrameworkConfig.from_env(env)
    assert str(got.value).startswith(f"{var}=")
    assert f"{item} is not ported yet" in str(got.value)


@pytest.mark.parametrize("env", [
    {},
    {"AI4E_PLATFORM_RETRY_DELAY": "0.05"},
    {"AI4E_PLATFORM_MAX_DELIVERY_COUNT": "3"},
    {"AI4E_PLATFORM_DISPATCHER_CONCURRENCY": "4"},
    {"AI4E_PLATFORM_LEASE_SECONDS": "30"},
    {"AI4E_PLATFORM_REAPER_INTERVAL": "0.5"},
    {"AI4E_PLATFORM_REAPER_TERMINAL_RETENTION": "0"},
    {"AI4E_PLATFORM_REAPER_TERMINAL_RETENTION": "-1"},
    {"AI4E_PLATFORM_TRANSPORT": "queue"},
    {"AI4E_PLATFORM_OBSERVABILITY": "1"},
    {"AI4E_PLATFORM_FLIGHT_CAPACITY": "8"},
    {"AI4E_PLATFORM_SLO_OBJECTIVES": "/v1/a=250:99,/v1/a=goodput:99.9"},
    {"AI4E_OBSERVABILITY_QUEUE_DEPTH_INTERVAL": "0.5"},
    {"AI4E_OBSERVABILITY_PROCESS_DEPTH_INTERVAL": "2"},
    {"AI4E_PLATFORM_ADMISSION": "1"},
    {"AI4E_PLATFORM_ADMISSION_INITIAL_LIMIT": "4"},
    {"AI4E_PLATFORM_ADMISSION_MAX_BACKLOG": "64"},
    {"AI4E_PLATFORM_RESULT_CACHE": "1"},
    {"AI4E_PLATFORM_CACHE_MAX_ENTRIES": "7"},
    {"AI4E_PLATFORM_CACHE_MAX_BYTES": "1024"},
    {"AI4E_PLATFORM_CACHE_TTL_SECONDS": ""},
    {"AI4E_PLATFORM_NATIVE_STORE": "1"},
    {"AI4E_PLATFORM_NATIVE_BROKER": "1"},
    {"AI4E_PLATFORM_RESULT_DIR": "/results"},
    {"AI4E_PLATFORM_RESULT_OFFLOAD_THRESHOLD": "4096"},
    {"AI4E_PLATFORM_REAPER_RUNNING_TIMEOUT": "5"},
    {"AI4E_PLATFORM_REAPER_MAX_REQUEUES": "1"},
    {"AI4E_PLATFORM_JOURNAL_PATH": "/j/store.jsonl"},
    {"AI4E_PLATFORM_REPLICATE_FROM": "http://primary:8080"},
    {"AI4E_PLATFORM_FAILOVER_INTERVAL": "0.5"},
    {"AI4E_PLATFORM_FAILOVER_DOWN_AFTER": "5"},
    {"AI4E_PLATFORM_REPLICATE_API_KEY": " ,k1, k2"},
    {"AI4E_PLATFORM_ADVERTISE_URL": "http://standby:8080"},
    {"AI4E_PLATFORM_TASK_SHARDS": "4"},
    {"AI4E_PLATFORM_TASK_SHARD_SLOTS": "128"},
    {"AI4E_PLATFORM_TASK_SHARD_REPLICAS": "2"},
    {"AI4E_PLATFORM_SHARD_TAIL_INTERVAL": "0.05"},
    {"AI4E_PLATFORM_SHARD_FEED_RECENT": "512"},
    {"AI4E_PLATFORM_TRANSPORT": "push"},
    {"AI4E_PLATFORM_PUSH_TTL_SECONDS": "30"},
    {"AI4E_PLATFORM_PUSH_MAX_ATTEMPTS": "7"},
    {"AI4E_PLATFORM_PUSH_WINDOW": "16"},
    {"AI4E_PLATFORM_RESILIENCE": "1"},
    {"AI4E_PLATFORM_RESILIENCE_RECOVERY_SECONDS": "2"},
    {"AI4E_PLATFORM_RESILIENCE_MAX_ATTEMPTS": "5"},
    {"AI4E_PLATFORM_ORCHESTRATION": "1"},
    {"AI4E_PLATFORM_ORCHESTRATION_COSTS": "a=1,b=3"},
    {"AI4E_PLATFORM_ORCHESTRATION_LADDER_HOLD_S": "0.5"},
    {"AI4E_PLATFORM_SLO_LADDER": "1"},
    {"AI4E_ROLLOUT_DRAIN_EJECT_TTL_S": "4"},
    {"AI4E_TENANCY_ENABLED": "1"},
    {"AI4E_TENANCY_TENANTS": "alpha=k1|k2:4:50:100,beta=k3:1:5"},
    {"AI4E_TENANCY_DEFAULT_RPS": "3"},
    {"AI4E_TENANCY_LABEL_TOP_N": "2"},
    {"AI4E_TENANCY_MIN_QUANTUM": "0.5"},
    {"AI4E_PLATFORM_PIPELINE": "1"},
    {"AI4E_PLATFORM_PIPELINE_CHUNK_REPLAY": "4"},
    {"AI4E_PLATFORM_PIPELINE_STREAM_MAX_S": "2"},
], ids=lambda env: next(iter(env), "defaults"))
def test_platform_config_is_jax_s(env):
    """``to_platform_config`` gives ``LocalPlatform`` the values the JAX
    package's gives its own, for every field the port's reads."""
    port = port_config.FrameworkConfig.from_env(env).to_platform_config()
    want = jax_config.FrameworkConfig.from_env(env).to_platform_config()
    assert isinstance(port, PlatformConfig)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(want, f.name), f.name


def test_seventeen_observability_knobs_left_the_unported_set():
    """The served knobs are out of ``UNPORTED``, the SLO ladder, the other
    eighteen of resilience and orchestration, tenancy's eight and the
    pipelines' four, and the parallel plane's seven among them; 7 remain,
    each naming its item."""
    assert not set(SERVED_OBSERVABILITY_KNOBS) & set(port_config.UNPORTED)
    assert not set(SERVED_DECODE_KNOBS) & set(port_config.UNPORTED)
    assert not set(SERVED_ADMISSION_KNOBS) & set(port_config.UNPORTED)
    assert not set(SERVED_AUTH_CACHE_KNOBS) & set(port_config.UNPORTED)
    assert not set(SERVED_NATIVE_REAPER_KNOBS) & set(port_config.UNPORTED)
    assert not set(SERVED_HA_KNOBS) & set(port_config.UNPORTED)
    assert not set(SERVED_SHARD_KNOBS) & set(port_config.UNPORTED)
    assert not set(SERVED_PUSH_REPORTER_KNOBS) & set(port_config.UNPORTED)
    assert not set(SERVED_RESILIENCE_KNOBS) & set(port_config.UNPORTED)
    assert not set(SERVED_TENANCY_PIPELINE_KNOBS) & set(port_config.UNPORTED)
    assert not set(SERVED_MESH_KNOBS) & set(port_config.UNPORTED)
    assert len(SERVED_OBSERVABILITY_KNOBS) == 17
    assert len(SERVED_RESILIENCE_KNOBS) == 19
    assert len(SERVED_AUTH_CACHE_KNOBS) == 11
    assert len(SERVED_NATIVE_REAPER_KNOBS) == 8
    assert len(SERVED_PUSH_REPORTER_KNOBS) == 7
    assert len(SERVED_TENANCY_PIPELINE_KNOBS) == 12
    assert len(SERVED_MESH_KNOBS) == 7
    assert len(port_config.UNPORTED) == 7
    assert not any(item in what for what in port_config.UNPORTED.values()
                   for item in ("A18.9", "A18.10", "A18.12", "A15"))
    assert (port_config.FrameworkConfig.from_env(
        {"AI4E_PLATFORM_SLO_LADDER": "1"}).to_platform_config().slo_ladder
        is True)


def test_sections_and_fields_are_the_jax_package_s():
    jax_sections = typing.get_type_hints(jax_config.FrameworkConfig)
    port_sections = typing.get_type_hints(port_config.FrameworkConfig)
    assert list(port_sections) == list(jax_sections)
    for name, section in port_sections.items():
        want = jax_sections[name]
        assert section._env_prefix == want._env_prefix
        assert ([(f.name, str(f.type), f.default)
                 for f in dataclasses.fields(section)]
                == [(f.name, str(f.type), f.default)
                    for f in dataclasses.fields(want)])
    assert (port_config.OUT_OF_BAND_ENV_PREFIXES
            == jax_config.OUT_OF_BAND_ENV_PREFIXES)


@pytest.mark.parametrize("key", CONTROLLER_KNOBS,
                         ids=lambda k: k[0] + k[1].upper())
def test_controller_knobs_refuse_under_their_new_item(key):
    """The rollout controller's five knobs stay refused, each naming the
    rig's item, A19: nothing but the rig drives the controller."""
    assert port_config.UNPORTED[key] == (
        "the rollout controller, which only the rig drives (ROADMAP A19)")


def test_push_reporter_and_generation_reach_their_consumers():
    """Each of the seven served knobs reaches what reads it: the platform's
    transport and topic policy, the worker's reporter client and every
    servable's generation."""
    import asyncio

    from ai4e_tpu_torch.cli import build_control_plane, build_worker

    env = {"AI4E_PLATFORM_TRANSPORT": "push",
           "AI4E_PLATFORM_PUSH_TTL_SECONDS": "30",
           "AI4E_PLATFORM_PUSH_MAX_ATTEMPTS": "7",
           "AI4E_PLATFORM_PUSH_WINDOW": "16",
           "AI4E_PLATFORM_RETRY_DELAY": "0.5"}
    platform = build_control_plane(port_config.FrameworkConfig.from_env(env),
                                   {"apis": []})
    topic = platform.topic
    assert (platform.config.transport, platform.broker) == ("push", None)
    assert (topic.ttl_seconds, topic.max_attempts, topic.retry_delay,
            topic._window._value) == (30.0, 7, 0.5, 16)
    spec = {"models": [{"family": "echo", "name": "echo"}]}
    worker, _, _ = build_worker(spec, device="cpu",
                                config=port_config.FrameworkConfig.from_env({
                                    "AI4E_SERVICE_REPORTER_URI":
                                        "http://rep:9000/",
                                    "AI4E_SERVICE_CLUSTER": "h100",
                                    "AI4E_ROLLOUT_GENERATION": "3"}))
    reporter = worker.service.reporter
    assert (reporter.reporter_uri, reporter.cluster) == ("http://rep:9000",
                                                         "h100")
    assert worker.runtime.models["echo"].generation == 3
    asyncio.run(reporter.close())
