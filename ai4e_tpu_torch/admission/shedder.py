"""Priority load shedder — the lowest class refused first, with a computed
Retry-After; a copy of ``ai4e_tpu/admission/shedder.py``.

- each priority class may occupy only a FRACTION of the capacity —
  interactive traffic can fill it, default stops at 85%, background at
  60% — so as occupancy climbs the classes shed strictly lowest first, and
  a background flood never refuses interactive traffic out of its
  headroom;
- a refusal's Retry-After is the time the EXCESS above the class's
  threshold should take to drain at the observed drain rate.
"""

from __future__ import annotations

from .deadline import BACKGROUND, DEFAULT, INTERACTIVE, drain_retry_after


class PriorityShedder:
    #: Fraction of capacity each class may occupy before it sheds.
    DEFAULT_FRACTIONS = {INTERACTIVE: 1.0, DEFAULT: 0.85, BACKGROUND: 0.6}

    def __init__(self, fractions: dict[int, float] | None = None):
        self.fractions = dict(fractions or self.DEFAULT_FRACTIONS)

    def threshold(self, priority: int, capacity: int) -> float:
        """Occupancy above which ``priority`` sheds. Classes beyond the map
        clamp to the nearest configured one."""
        if priority in self.fractions:
            frac = self.fractions[priority]
        elif priority <= min(self.fractions):
            frac = self.fractions[min(self.fractions)]
        else:
            frac = self.fractions[max(self.fractions)]
        # Every class, however low, may use at least one slot: a pure
        # background workload on an idle platform must still run.
        return max(1.0, frac * capacity)

    def check(self, priority: int, occupancy: int, capacity: int,
              drain_rate: float = 0.0) -> float | None:
        """None to admit; else the Retry-After (seconds) of the refusal.
        ``occupancy``/``capacity``: in flight against the adaptive limit on
        the sync proxy, the created backlog against ``max_backlog`` at the
        async edge."""
        threshold = self.threshold(priority, capacity)
        if occupancy < threshold:
            return None
        return drain_retry_after(occupancy - threshold + 1.0, drain_rate)
