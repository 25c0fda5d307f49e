"""Topology spec — the one document every rig process derives itself
from; a copy of ``ai4e_tpu/rig/topology.py``.

The driver resolves counts + the port layout once, writes the spec to
``<workdir>/topology.json``, and launches every child as
``python -m ai4e_tpu_torch.rig <role> --spec <file> --shard i --index j``. A
child never guesses a peer's address: gateways compute the shard store
URL lists (primary first, then replicas — the rotation order every wire
client uses), dispatchers compute their shard's worker URLs, the
balancer computes the gateway URLs. Deterministic ports also make the
teardown verifiable: the supervisor can prove nothing it owns still
listens.

Port layout (``base_port`` from ``--base-port`` or ``AI4E_RIG_BASE_PORT``,
default 18800; all on ``host``):

- balancer:          base
- gateway g:         base + 1 + g      (g bounded by the collector slot)
- collector:         base + 19         (fleet telemetry, docs/deployment.md)
- shard s primary:   base + 20 + s
- shard s replica r: base + 40 + s * replicas_max + r
- dispatcher d of s: base + 60 + s * dispatchers_max + d  (health/metrics)
- worker w of s:     base + 80 + s * workers_max + w
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field

ECHO_ROUTE = "/v1/echo/run-async"

# Sub-range strides: bounded so layouts stay stable as counts vary.
_REPLICAS_MAX = 4
_DISPATCHERS_MAX = 4
_WORKERS_MAX = 4


@dataclass
class Topology:
    gateways: int = 3
    shards: int = 2
    replicas: int = 1          # per shard
    dispatchers: int = 1       # per shard (separate OS processes)
    workers: int = 1           # per shard (CPU echo processes)
    loadgens: int = 2
    slots: int = 16            # hash-slot table size (stable_hash % slots)
    rate: float = 10000.0      # offered req/s, total across loadgens
    duration: float = 30.0     # measured window per loadgen (s)
    ramp: float = 3.0
    max_inflight: int = 512    # per loadgen process
    task_timeout: float = 60.0
    poll_wait: float = 20.0
    dispatcher_concurrency: int = 8
    lease_seconds: float = 5.0   # short: a killed dispatcher's leases must
                                 # redeliver within the run, not in 5 min
    retry_delay: float = 0.2
    work_ms: float = 0.0       # artificial per-request worker time
    chaos: bool = True
    observability: bool = True  # hop-ledger stamps + flight rings per role
    collector: bool = True     # fleet-telemetry collector process
    scrape_interval: float = 2.0   # collector scrape period (s)
    vitals_interval: float = 1.0   # per-role vitals sample period (s)
    seed: int = 20260803
    host: str = "127.0.0.1"
    base_port: int = 18800
    workdir: str = "/tmp/ai4e-rig"
    route: str = ECHO_ROUTE
    payload_bytes: int = 64
    # Multi-tenancy (tenancy/, docs/tenancy.md). ``tenants`` is the
    # registry spec ("name=key:weight:rps:burst,..."): non-empty puts the
    # tenant resolver + token-bucket quota on EVERY gateway replica (each
    # enforces the contracted rps locally, so the fleet ceiling is
    # gateways × rps — the per-instance rate-limit semantic, stated in
    # docs/tenancy.md) and weighted-fair lanes on every shard broker.
    # ``loadgen_tenants[i]`` pins loadgen i to one tenant:
    # {"name": ..., "key": ..., "rate": rps} — rate overrides the even
    # rate/loadgens split, which is how the noisy-neighbor scenario
    # drives one tenant at 10× while the victims hold rated.
    tenants: str = ""
    loadgen_tenants: list = field(default_factory=list)
    # Mesh serving plane (runtime/mesh/, docs/mesh_serving.md). ``mesh``
    # is the declarative layout spec ("dp=8", "dp=2,tp=2"): non-empty
    # boots every worker as a MESH endpoint — the JAX-free half of the
    # production MeshEndpoint (same spec grammar, same EndpointHealth/
    # MeshCoordinator state machine), with the layout's cost-tier label
    # riding the route so every backend URI carries the substring the
    # orchestration cost map keys on. ``mesh_poison_nths`` injects
    # degradation: comma-separated 1-based delivery ordinals each worker
    # poisons (the rig analogue of AI4E_FAULT_MESH_POISON_NTHS — those
    # deliveries answer 503 result-invalidated and redeliver per task).
    # ``mesh_recovery_s`` is how long a flipped-unhealthy worker stays
    # dark (answering 500, ejected by dispatcher breakers) before its
    # "follower restart" probe delivery is allowed to heal it.
    mesh: str = ""
    mesh_poison_nths: str = ""
    mesh_recovery_s: float = 2.0
    # Zero-downtime rollout (rollout/, docs/deployment.md#rollouts).
    # ``rollout`` is the scenario: "" (off), "clean" (every generation
    # healthy — the upgrade must lose nothing and surface zero
    # client-visible 5xx from drained workers) or "bad-canary"
    # (``rollout_error_rate`` of deliveries fail with 500 at generations
    # >= ``rollout_bad_generation`` — the guard must auto-rollback before
    # the canary's traffic share passes 50%). The driver (rig/rollout.py)
    # starts after ``ramp``, drains + respawns workers one at a time with
    # a bumped AI4E_ROLLOUT_GENERATION, and steps canary weight through
    # ``rollout_steps`` holding ``rollout_hold_s`` per step.
    rollout: str = ""
    rollout_error_rate: float = 0.0
    rollout_bad_generation: int = 2
    rollout_steps: str = "25,50,100"
    rollout_hold_s: float = 3.0
    rollout_drain_timeout_ms: float = 5000.0
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.mesh:
            from ..runtime.mesh import parse_mesh_spec
            layout = parse_mesh_spec(self.mesh)  # raises MeshSpecError early
            if layout is not None and self.route == ECHO_ROUTE:
                # Tier-labelled route: reloading a saved spec keeps the
                # already-derived route (it no longer equals ECHO_ROUTE).
                self.route = f"/v1/echo-{layout.tier_label}/run-async"
        if self.gateways < 1 or self.shards < 1:
            raise ValueError("topology needs >= 1 gateway and >= 1 shard")
        if self.gateways > 18:
            # Gateway g lives at base+1+g; g=17 (the 18th gateway) takes
            # base+18, the last slot before the collector's base+19.
            raise ValueError("gateways must be <= 18 (port layout)")
        if not (1 <= self.replicas <= _REPLICAS_MAX):
            raise ValueError(f"replicas must be 1..{_REPLICAS_MAX}")
        if not (1 <= self.dispatchers <= _DISPATCHERS_MAX):
            raise ValueError(f"dispatchers must be 1..{_DISPATCHERS_MAX}")
        if not (1 <= self.workers <= _WORKERS_MAX):
            raise ValueError(f"workers must be 1..{_WORKERS_MAX}")
        if self.slots < self.shards:
            raise ValueError("slots must be >= shards")
        if self.rollout not in ("", "clean", "bad-canary"):
            raise ValueError("rollout must be '', 'clean' or 'bad-canary'")
        if self.rollout == "bad-canary" and self.rollout_error_rate <= 0:
            # The scenario's whole point is a visibly bad generation.
            self.rollout_error_rate = 0.25

    # -- ports/urls ---------------------------------------------------------

    def balancer_port(self) -> int:
        return self.base_port

    def gateway_port(self, g: int) -> int:
        return self.base_port + 1 + g

    def collector_port(self) -> int:
        return self.base_port + 19

    def shard_port(self, s: int) -> int:
        return self.base_port + 20 + s

    def replica_port(self, s: int, r: int) -> int:
        return self.base_port + 40 + s * _REPLICAS_MAX + r

    def dispatcher_port(self, s: int, d: int) -> int:
        return self.base_port + 60 + s * _DISPATCHERS_MAX + d

    def worker_port(self, s: int, w: int) -> int:
        return self.base_port + 80 + s * _WORKERS_MAX + w

    def _url(self, port: int) -> str:
        return f"http://{self.host}:{port}"

    def balancer_url(self) -> str:
        return self._url(self.balancer_port())

    def gateway_urls(self) -> list[str]:
        return [self._url(self.gateway_port(g)) for g in range(self.gateways)]

    def shard_urls(self, s: int) -> list[str]:
        """Store URL list for shard ``s`` — primary FIRST, then replicas:
        the rotation order every wire client (gateway, dispatcher, worker,
        feed tail) walks on connect errors / 503-not-primary, which is
        what re-homes the whole fleet onto a promoted replica."""
        return [self._url(self.shard_port(s))] + [
            self._url(self.replica_port(s, r)) for r in range(self.replicas)]

    def all_shard_urls(self) -> list[list[str]]:
        return [self.shard_urls(s) for s in range(self.shards)]

    def worker_urls(self, s: int) -> list[str]:
        return [self._url(self.worker_port(s, w)) + self.route
                for w in range(self.workers)]

    def journal_path(self, s: int) -> str:
        return os.path.join(self.workdir, f"shard{s}.jsonl")

    def replica_journal_path(self, s: int, r: int) -> str:
        return os.path.join(self.workdir, f"shard{s}.replica{r}.jsonl")

    def collector_url(self) -> str:
        return self._url(self.collector_port())

    def metrics_urls(self) -> dict[str, str]:
        """Every scrapeable node, by proc name — the rig verdict's
        post-hoc merge and the live collector's target set share this
        one map (the collector excludes itself)."""
        urls = {"balancer": self.balancer_url()}
        for g in range(self.gateways):
            urls[f"gateway{g}"] = self.gateway_urls()[g]
        for s in range(self.shards):
            urls[f"store{s}"] = self.shard_urls(s)[0]
            for r in range(self.replicas):
                urls[f"store{s}r{r}"] = self.shard_urls(s)[1 + r]
            for d in range(self.dispatchers):
                urls[f"dispatcher{s}.{d}"] = \
                    self._url(self.dispatcher_port(s, d))
            for w in range(self.workers):
                urls[f"worker{s}.{w}"] = self._url(self.worker_port(s, w))
        if self.collector:
            urls["collector"] = self.collector_url()
        return urls

    def all_ports(self) -> list[int]:
        ports = [self.balancer_port()]
        if self.collector:
            ports.append(self.collector_port())
        ports += [self.gateway_port(g) for g in range(self.gateways)]
        for s in range(self.shards):
            ports.append(self.shard_port(s))
            ports += [self.replica_port(s, r) for r in range(self.replicas)]
            ports += [self.dispatcher_port(s, d)
                      for d in range(self.dispatchers)]
            ports += [self.worker_port(s, w) for w in range(self.workers)]
        return ports

    # -- (de)serialization --------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Topology":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_dict(), fh, indent=1)

    @classmethod
    def load(cls, path: str) -> "Topology":
        with open(path, encoding="utf-8") as fh:
            return cls.from_dict(json.load(fh))

    def spec_path(self) -> str:
        return os.path.join(self.workdir, "topology.json")
