"""Deterministic, seeded fault injection for the platform's two transport
surfaces, the HTTP hop (dispatcher deliveries, the gateway's sync proxy)
and the queue publish surface; a copy of ``ai4e_tpu/chaos/injector.py``.

The injector wraps the ``SessionHolder`` each component owns, so with no
injector installed the production path is unchanged. Faults:

- ``error``          — the backend "answers" the injected status; the
  real request is not sent;
- ``connect_error``  — ``aiohttp.ClientConnectorError`` before any bytes
  move (a crashed pod, a refused connection);
- ``drop``           — the real request is sent and the backend executes,
  but the response is lost (``asyncio.TimeoutError``): the at-least-once
  hazard;
- ``latency``        — an added sleep before the hop proceeds, composable
  with any of the above;
- ``duplicate``      — queue surface: the publish fires twice, two broker
  messages for one task.

One seeded ``random.Random`` drives every draw, so a scenario replays the
same decisions as the JAX package's injector under the same seed and call
order. Rules match backends by URL substring (``"*"`` = every hop) and can
be bounded (``times=N``).
"""

from __future__ import annotations

import asyncio
import random
from collections import Counter
from dataclasses import dataclass, field

import aiohttp


@dataclass
class FaultRule:
    backend: str = "*"            # substring match on the target URL
    error_rate: float = 0.0
    error_status: int = 500
    connect_error_rate: float = 0.0
    drop_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.0
    duplicate_rate: float = 0.0   # queue surface (wrap_publish)
    times: int | None = None      # max faults this rule injects; None = ∞
    _injected: int = field(default=0, repr=False)

    def matches(self, url: str) -> bool:
        return self.backend == "*" or self.backend in url

    def exhausted(self) -> bool:
        return self.times is not None and self._injected >= self.times


@dataclass
class Decision:
    fault: str | None = None      # "error" | "connect_error" | "drop" | None
    status: int = 500
    latency_s: float = 0.0


class FaultInjector:
    """Seeded fault source shared by every wrapped surface."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.rules: list[FaultRule] = []
        self.injected: Counter = Counter()

    def add_rule(self, backend: str = "*", **spec) -> FaultRule:
        rule = FaultRule(backend=backend, **spec)
        self.rules.append(rule)
        return rule

    def blackout(self, backend: str) -> FaultRule:
        """Total darkness for matching backends — every hop refuses the
        connection until ``lift``. Inserted at the FRONT of the rule list
        so an existing background-noise rule can't shadow it (``decide``
        takes the first matching rule). The dark-fleet scenario lever:
        30% of a tier dark is ``blackout`` on 1 of its 3 backends."""
        rule = FaultRule(backend=backend, connect_error_rate=1.0)
        self.rules.insert(0, rule)
        return rule

    def lift(self, rule: FaultRule) -> None:
        """End a ``blackout`` (idempotent)."""
        if rule in self.rules:
            self.rules.remove(rule)

    def counts(self) -> dict:
        return dict(self.injected)

    def _rule_for(self, url: str) -> FaultRule | None:
        for rule in self.rules:
            if rule.matches(url) and not rule.exhausted():
                return rule
        return None

    def decide(self, url: str) -> Decision:
        """One HTTP-hop draw. Faults are mutually exclusive (stacked
        probability bands over a single uniform draw); latency is an
        independent draw so a slow backend can also fail."""
        rule = self._rule_for(url)
        if rule is None:
            return Decision()
        d = Decision(status=rule.error_status)
        if rule.latency_rate > 0 and self.rng.random() < rule.latency_rate:
            d.latency_s = rule.latency_s
            self.injected["latency"] += 1
        r = self.rng.random()
        edge = rule.connect_error_rate
        if r < edge:
            d.fault = "connect_error"
        elif r < (edge := edge + rule.drop_rate):
            d.fault = "drop"
        elif r < edge + rule.error_rate:
            d.fault = "error"
        if d.fault is not None:
            rule._injected += 1
            self.injected[d.fault] += 1
        return d

    def duplicate(self, queue_name: str) -> bool:
        """Queue-surface draw: should this publish fire twice?"""
        rule = self._rule_for(queue_name)
        if rule is None or rule.duplicate_rate <= 0:
            return False
        if self.rng.random() < rule.duplicate_rate:
            rule._injected += 1
            self.injected["duplicate"] += 1
            return True
        return False


# -- HTTP hop wrapping -------------------------------------------------------


class _FakeResponse:
    """The minimal response surface the dispatcher and sync proxy read."""

    def __init__(self, status: int,
                 body: bytes = b"chaos: injected backend error"):
        self.status = status
        self.headers: dict = {}
        self.content_type = "text/plain"
        self._body = body

    async def read(self) -> bytes:
        return self._body

    async def text(self) -> str:
        return self._body.decode()


class _ChaosRequestCtx:
    """Async context manager standing in for ``session.post(...)`` /
    ``session.request(...)``: applies the injector's decision, delegating
    to the real request only when the fault model says bytes move."""

    def __init__(self, injector: FaultInjector, url: str, factory):
        self._injector = injector
        self._url = url
        self._factory = factory
        self._inner = None

    async def __aenter__(self):
        d = self._injector.decide(self._url)
        if d.latency_s > 0:
            await asyncio.sleep(d.latency_s)
        if d.fault == "connect_error":
            # ClientConnectorError specifically (not the ClientConnectionError
            # base): that is what a real refused connection raises, and it is
            # the class the resilience retry gates key on to know the request
            # never reached the backend (gateway/router.py) — the base class
            # would make injected refusals behave unlike real ones.
            import types
            from urllib.parse import urlparse
            p = urlparse(self._url)
            key = types.SimpleNamespace(host=p.hostname or "", port=p.port,
                                        ssl=None, is_ssl=False)
            raise aiohttp.ClientConnectorError(
                key, OSError("chaos: connection refused"))
        if d.fault == "error":
            return _FakeResponse(d.status)
        self._inner = self._factory()
        resp = await self._inner.__aenter__()
        if d.fault == "drop":
            # The backend executed; the response is lost in transit. Drain
            # it first so the server side finishes cleanly, then present
            # the timeout the sender would have seen.
            await resp.read()
            await self._inner.__aexit__(None, None, None)
            self._inner = None
            raise asyncio.TimeoutError("chaos: response dropped")
        return resp

    async def __aexit__(self, *exc):
        if self._inner is not None:
            inner, self._inner = self._inner, None
            return await inner.__aexit__(*exc)
        return False


class ChaosSession:
    """Wraps a real ``aiohttp.ClientSession``, injecting faults on
    ``post``/``request``/``get``."""

    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self._injector = injector

    @property
    def closed(self) -> bool:
        return self._inner.closed

    def post(self, url, **kw):
        return _ChaosRequestCtx(self._injector, str(url),
                                lambda: self._inner.post(url, **kw))

    def get(self, url, **kw):
        return _ChaosRequestCtx(self._injector, str(url),
                                lambda: self._inner.get(url, **kw))

    def request(self, method, url, **kw):
        return _ChaosRequestCtx(
            self._injector, str(url),
            lambda: self._inner.request(method, url, **kw))

    async def close(self) -> None:
        await self._inner.close()


class ChaosSessionHolder:
    """Drop-in for ``utils.http.SessionHolder`` whose ``get()`` answers a
    fault-injecting session view over the real holder's session."""

    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self._injector = injector

    async def get(self) -> ChaosSession:
        return ChaosSession(await self._inner.get(), self._injector)

    async def close(self) -> None:
        await self._inner.close()


def wrap_platform_http(platform, injector: FaultInjector) -> None:
    """Install the injector on every HTTP hop the platform currently owns:
    each registered dispatcher's delivery session and the gateway's sync
    proxy session. Call AFTER routes are registered — dispatchers created
    later are not wrapped."""
    if getattr(platform, "dispatchers", None) is not None:
        for d in platform.dispatchers.dispatchers.values():
            d._sessions = ChaosSessionHolder(d._sessions, injector)
    platform.gateway._sessions = ChaosSessionHolder(
        platform.gateway._sessions, injector)


def wrap_publish_duplicates(platform, injector: FaultInjector) -> None:
    """Queue-surface duplicate injection: the store's publisher hook fires
    twice per ``duplicate`` draw, minting two broker messages for one task
    — the redelivery hazard lease expiry creates in production, on demand."""
    broker = platform.broker
    orig = broker.publish

    def publish(task) -> None:
        orig(task)
        if injector.duplicate(task.endpoint):
            orig(task)

    platform.store.set_publisher(publish)
