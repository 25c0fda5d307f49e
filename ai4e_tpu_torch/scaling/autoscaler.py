"""Autoscaler — a copy of ``ai4e_tpu/scaling/autoscaler.py`` for one
dispatcher per route: the HPA feedback loop, in the control plane.

The signal is the task store's per-endpoint depth, tasks ``created`` plus
tasks ``running``; the decision rule is the k8s HPA's (proportional, with
a tolerance dead-band and a scale-down stabilisation window); the actuator
is a ``ScaleTarget``, here the dispatcher's delivery-loop fan-out. Under
orchestration the signal is predictive (``predictive_signal``: the backlog
projected from admission's arrival and drain rates), and a sharded route
gets one ``ShardedAutoscaleController``: a decision for each shard's
sub-queue, all applied through one actuator (``ShardScaleTarget``).
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
from dataclasses import dataclass
from typing import Callable, Protocol

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry

log = logging.getLogger("ai4e_tpu_torch.autoscaler")


@dataclass
class AutoscalePolicy:
    """HPA-shaped policy: replicas within [min, max], a per-replica target
    of the signal, a tolerance dead-band and a scale-down window."""

    min_replicas: int = 1
    max_replicas: int = 10
    target_per_replica: float = 1.0   # targetAverageValue
    tolerance: float = 0.1            # k8s HPA default dead-band (10%)
    stabilization_seconds: float = 30.0  # scale-down damping window


class HPADecider:
    """The k8s HPA decision rule: ``desired = ceil(current * metric /
    (replicas * target))`` with a tolerance dead-band, clamped to
    [min, max]; scale-down takes the *maximum* recommendation over the
    stabilisation window, so a transient dip never kills replicas."""

    def __init__(self, policy: AutoscalePolicy,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy
        self._clock = clock
        self._recommendations: list[tuple[float, int]] = []

    def desired(self, current_replicas: int, metric_value: float) -> int:
        p = self.policy
        current_replicas = max(current_replicas, 1)
        ratio = metric_value / (current_replicas * p.target_per_replica)
        if abs(ratio - 1.0) <= p.tolerance:
            raw = current_replicas
        else:
            raw = math.ceil(current_replicas * ratio)
        raw = min(max(raw, p.min_replicas), p.max_replicas)

        now = self._clock()
        self._recommendations.append((now, raw))
        horizon = now - p.stabilization_seconds
        self._recommendations = [(t, r) for t, r in self._recommendations
                                 if t >= horizon]
        if raw < current_replicas:
            # Scale-down stabilisation: act on the window's max.
            raw = min(max(r for _, r in self._recommendations),
                      current_replicas)
        return raw


def predictive_signal(depth_fn: Callable[[], float],
                      arrival_rate_fn: Callable[[], float],
                      drain_rate_fn: Callable[[], float],
                      horizon_s: float = 10.0) -> Callable[[], float]:
    """The backlog projected ``horizon_s`` ahead: ``depth + max(0, arrival
    - drain) x horizon``. When arrivals outrun the drain the projection
    grows before the depth does, so the HPA rule scales up ahead of the
    queue wait that causes the first deadline miss. A draining queue
    projects its depth only: scale-down damping is the decider's
    stabilisation window. The rates are the admission controller's."""
    def signal() -> float:
        growth = max(0.0, float(arrival_rate_fn()) - float(drain_rate_fn()))
        return float(depth_fn()) + growth * horizon_s
    return signal


class ScaleTarget(Protocol):
    """An actuator the controller drives."""

    @property
    def replicas(self) -> int: ...

    def scale_to(self, n: int) -> None: ...


class DispatcherScaleTarget:
    """A dispatcher's delivery-loop count, the single-host stand-in for pod
    replicas: more loops put more tasks in flight to the worker's
    micro-batcher, so its batches grow."""

    def __init__(self, dispatcher):
        self.dispatcher = dispatcher

    @property
    def replicas(self) -> int:
        return self.dispatcher.concurrency

    def scale_to(self, n: int) -> None:
        self.dispatcher.set_concurrency(n)


class _ControlLoop:
    """The ``ai4e_autoscale_*`` instruments, the decide -> log -> count ->
    actuate step and the periodic task's lifecycle."""

    interval: float = 5.0
    _loop_name: str = "autoscale"

    def _make_instruments(self, metrics: MetricsRegistry | None) -> None:
        self.metrics = metrics or DEFAULT_REGISTRY
        self._replica_gauge = self.metrics.gauge(
            "ai4e_autoscale_replicas", "Actuated replica count per endpoint")
        self._signal_gauge = self.metrics.gauge(
            "ai4e_autoscale_signal", "Scaling signal value per endpoint")
        self._decisions = self.metrics.counter(
            "ai4e_autoscale_decisions_total",
            "Actuated scaling decisions by endpoint and direction")
        self._task: asyncio.Task | None = None

    def _apply_decision(self, name: str, decider: HPADecider, value: float,
                        current: int, scale_fn) -> int:
        desired = decider.desired(current, value)
        self._signal_gauge.set(value, endpoint=name)
        if desired != current:
            log.info("autoscale %s: signal=%.1f replicas %d -> %d",
                     name, value, current, desired)
            self._decisions.inc(endpoint=name,
                                direction="up" if desired > current
                                else "down")
            scale_fn(desired)
        return desired

    def tick(self):
        raise NotImplementedError

    async def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the control loop must survive
                log.exception("autoscale tick failed for %s",
                              self._loop_name)


class AutoscaleController(_ControlLoop):
    """Periodic control loop: signal -> HPA decision -> actuator.

    ``signal`` defaults to the endpoint's queue pressure: tasks waiting in
    the ``created`` set plus tasks being processed (``running``)."""

    def __init__(self, store, endpoint_path: str, target: ScaleTarget,
                 policy: AutoscalePolicy | None = None,
                 interval: float = 5.0,
                 signal: Callable[[], float] | None = None,
                 metrics: MetricsRegistry | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.store = store
        self.endpoint_path = endpoint_path
        self._loop_name = endpoint_path
        self.target = target
        self.policy = policy or AutoscalePolicy()
        self.interval = interval
        self.signal = signal or self._default_signal
        self.decider = HPADecider(self.policy, clock=clock)
        self._make_instruments(metrics)

    def _default_signal(self) -> float:
        return (self.store.set_len(self.endpoint_path, "created")
                + self.store.set_len(self.endpoint_path, "running"))

    def tick(self) -> int:
        """One control step (sync; also called by the async loop)."""
        desired = self._apply_decision(
            self.endpoint_path, self.decider, float(self.signal()),
            self.target.replicas, self.target.scale_to)
        self._replica_gauge.set(self.target.replicas,
                                endpoint=self.endpoint_path)
        return desired


class ShardScaleTarget:
    """One actuator over a sharded route's per-shard dispatchers: the
    sharded controller's decisions for each shard go through it, so each
    dispatcher's concurrency has one writer. It is also a plain
    ``ScaleTarget``: ``replicas`` and ``scale_to`` treat the shards as one
    pool, split evenly with the remainder on the lowest shards."""

    def __init__(self, dispatchers: list):
        if not dispatchers:
            raise ValueError("ShardScaleTarget needs at least one dispatcher")
        self.dispatchers = list(dispatchers)

    @property
    def replicas(self) -> int:
        return sum(d.concurrency for d in self.dispatchers)

    def scale_to(self, n: int) -> None:
        base, rem = divmod(max(0, n), len(self.dispatchers))
        for i, d in enumerate(self.dispatchers):
            d.set_concurrency(base + (1 if i < rem else 0))

    def shard_replicas(self, i: int) -> int:
        return self.dispatchers[i].concurrency

    def scale_shard(self, i: int, n: int) -> None:
        self.dispatchers[i].set_concurrency(max(0, n))


class ShardedAutoscaleController(_ControlLoop):
    """Per-shard scaling decisions through one actuator (a sharded
    ``autoscale`` route, which the assembly accepts only under
    orchestration). One control loop; for each sub-queue its own signal
    and its own ``HPADecider`` (one hot shard must not pin a cold one's
    loops up); the sub-queue is the endpoint label."""

    def __init__(self, shards: list, target: ShardScaleTarget,
                 policy: AutoscalePolicy | None = None,
                 interval: float = 5.0,
                 metrics: MetricsRegistry | None = None,
                 clock: Callable[[], float] = time.monotonic):
        # shards: [(sub_queue_name, signal_fn)], aligned with the target's
        # dispatchers.
        if len(shards) != len(target.dispatchers):
            raise ValueError(
                f"{len(shards)} shard signals for "
                f"{len(target.dispatchers)} dispatchers")
        self.shards = list(shards)
        self._loop_name = (shards[0][0] if shards else "sharded")
        self.target = target
        self.policy = policy or AutoscalePolicy()
        self.interval = interval
        self.deciders = [HPADecider(self.policy, clock=clock)
                         for _ in self.shards]
        self._make_instruments(metrics)

    def tick(self) -> None:
        for i, (name, signal) in enumerate(self.shards):
            self._apply_decision(
                name, self.deciders[i], float(signal()),
                self.target.shard_replicas(i),
                lambda n, i=i: self.target.scale_shard(i, n))
            self._replica_gauge.set(self.target.shard_replicas(i),
                                    endpoint=name)
