"""The degradation ladder: declared brownout modes; a copy of
``ai4e_tpu/orchestration/ladder.py``.

Levels (``LEVELS``; each includes everything above it):

0. ``normal`` — nothing degraded.
1. ``reroute_background`` — background placements are restricted to the
   cheapest live tier (``Orchestrator.place`` consults
   ``restrict_background``); nothing is refused.
2. ``shed_background`` — background requests are refused at admission
   (``X-Shed-Reason: brownout at <hop>``, a drain-derived Retry-After).
3. ``shed_default`` — the default class too; the gateway consults the
   result cache before the brownout check, so cached answers still flow.
4. ``shed_interactive`` — interactive as well; cache hits are the only
   service.

Pressure is the decayed fraction of miss evidence among deadline events:
predicted misses from placement (no backend cleared the confidence bar)
and actual ones from the store's terminal transitions (``late``
completions, ``expired`` tasks). A ``min_rate`` guard keeps one early miss
on an idle platform from reading as full pressure, and makes an idle
platform step back down.

Hysteresis: pressure must hold above ``up`` for ``hold_s`` before a step
up, below ``down`` for ``hold_s`` before a step down, one level a hold
(``up > down`` is required). Each transition is logged and counted
(``ai4e_orchestration_ladder_*``).

Thread safety: ``note`` arrives from the event loop (placements) and from
whichever thread wrote the store (terminal transitions); transitions run
under one lock. ``level`` and ``restrict_background`` are lock-free reads;
``refuse`` takes the lock (its evaluate is what steps a full brownout
down), so never call it holding a lock ordered after this one.
"""

from __future__ import annotations

import logging
import threading
import time

from ..admission.controller import DecayingRate
from ..admission.deadline import BACKGROUND, DEFAULT, priority_name
from ..metrics import DEFAULT_REGISTRY, MetricsRegistry

log = logging.getLogger("ai4e_tpu_torch.orchestration")

LEVELS = ("normal", "reroute_background", "shed_background",
          "shed_default", "shed_interactive")


class DegradationLadder:
    def __init__(self, up: float = 0.3, down: float = 0.1,
                 hold_s: float = 5.0, min_rate: float = 1.0,
                 tau_s: float = 10.0,
                 metrics: MetricsRegistry | None = None,
                 clock=time.monotonic):
        if not (0.0 <= down < up <= 1.0):
            raise ValueError(
                f"ladder thresholds need 0 <= down < up <= 1, got "
                f"down={down} up={up}")
        self.up = up
        self.down = down
        self.hold_s = hold_s
        self.min_rate = min_rate
        self.metrics = metrics or DEFAULT_REGISTRY
        self._clock = clock
        self._miss = DecayingRate(tau_s=tau_s)
        self._total = DecayingRate(tau_s=tau_s)
        self.level = 0
        self._lock = threading.Lock()
        self._above_since: float | None = None
        self._below_since: float | None = None
        self._level_gauge = self.metrics.gauge(
            "ai4e_orchestration_ladder_level",
            "Degradation-ladder level: 0 normal .. 4 shed_interactive")
        self._level_gauge.set(0)
        self._transitions = self.metrics.counter(
            "ai4e_orchestration_ladder_transitions_total",
            "Ladder steps by direction and the mode entered")
        self._refusals = self.metrics.counter(
            "ai4e_orchestration_brownout_refusals_total",
            "Admissions refused by the ladder, by priority and mode")

    @property
    def mode(self) -> str:
        return LEVELS[self.level]

    # -- pressure feed ------------------------------------------------------

    def note(self, miss: bool, now: float | None = None,
             n: float = 1.0) -> None:
        """``n`` units of deadline evidence: a placement decision (miss =
        nobody cleared the confidence bar), a terminal outcome (miss =
        late/expired), or — batched via ``n`` — an SLO engine tick's
        worth of requests (one note per multi-second tick would decay
        below the ``min_rate`` evidence floor and never move the
        ladder; the engine passes the window's event count instead).
        Evaluates transitions inline — the ladder needs no background
        task."""
        now = self._clock() if now is None else now
        self._total.on_event(n, now=now)
        if miss:
            self._miss.on_event(n, now=now)
        self.evaluate(now)

    def pressure(self, now: float | None = None) -> float:
        now = self._clock() if now is None else now
        total = self._total.rate(now)
        if total < self.min_rate:
            # Too little deadline traffic to judge — and the decay of an
            # idle platform's rates lands here, which is what steps a
            # stale brownout back down.
            return 0.0
        return min(1.0, self._miss.rate(now) / total)

    # -- transitions --------------------------------------------------------

    def evaluate(self, now: float | None = None) -> int:
        """Apply the hysteresis rule; returns the (possibly new) level."""
        now = self._clock() if now is None else now
        p = self.pressure(now)
        with self._lock:
            if p >= self.up and self.level < len(LEVELS) - 1:
                self._below_since = None
                if self._above_since is None:
                    self._above_since = now
                elif now - self._above_since >= self.hold_s:
                    self._step(+1, p, now)
                    # Re-arm: the NEXT step up needs a fresh hold window.
                    self._above_since = now
            elif p <= self.down and self.level > 0:
                self._above_since = None
                if self._below_since is None:
                    self._below_since = now
                elif now - self._below_since >= self.hold_s:
                    self._step(-1, p, now)
                    self._below_since = now
            else:
                # Dead band (or already at an end stop): both hold timers
                # reset — a step requires SUSTAINED evidence, not
                # accumulated flickers.
                self._above_since = None
                self._below_since = None
            return self.level

    def _step(self, direction: int, pressure: float, now: float) -> None:
        self.level += direction
        mode = LEVELS[self.level]
        self._level_gauge.set(self.level)
        self._transitions.inc(direction="up" if direction > 0 else "down",
                              mode=mode)
        log.warning("degradation ladder %s -> %s (predicted-miss pressure "
                    "%.2f)", LEVELS[self.level - direction], mode, pressure)

    # -- policy queries -----------------------------------------------------

    def restrict_background(self) -> bool:
        """Level >= 1: background placements go to the cheapest live
        tier only (best-effort reroute ahead of any shedding)."""
        return self.level >= 1

    def refuse(self, priority: int) -> str | None:
        """The mode name when the ladder refuses this class right now,
        else None. Counting happens here because every non-None answer
        IS a refusal at the calling hop (admission 429/503).

        Transitions are re-evaluated FIRST: at ``shed_interactive``
        every admission is refused, so no placements and (once the
        backlog drains) no terminal outcomes ever call ``note`` again —
        without this consult-time evaluate, the ladder would wedge at
        full brownout forever even after pressure decayed to nothing.
        Clients keep knocking (they were told Retry-After), and each
        knock is the clock tick that steps a stale brownout down."""
        self.evaluate()
        level = self.level
        refused = (level >= 4
                   or (level >= 3 and priority >= DEFAULT)
                   or (level >= 2 and priority >= BACKGROUND))
        if not refused:
            return None
        mode = LEVELS[level]
        self._refusals.inc(priority=priority_name(priority), mode=mode)
        return mode
