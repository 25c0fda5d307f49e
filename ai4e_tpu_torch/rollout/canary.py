"""Generation-keyed canary routing; a copy of ``ai4e_tpu/rollout/canary.py``.

- ``generation_label`` is the bounded mapper for the ``generation``
  dimension of the worker's ``ai4e_rollout_outcomes_total`` and
  ``ai4e_rollout_request_seconds``: a long-lived worker that reloads
  weekly would otherwise mint one series per generation number forever;
- ``CanaryWeights`` splits traffic between generations by rescaling the
  weighted backend set every placement already consumes: the canary
  generation's backends hold ``share`` of the pool's total weight as a
  group, whatever the replica counts on each side. ``BackendHealth``
  carries one (``attach_canary``), so the health-aware pick and the
  orchestrator's in-tier pick both apply it.
"""

from __future__ import annotations

#: Distinct generation values one process may label before folding the
#: rest into ``other``: a worker sees its own generation plus a handful of
#: rollouts in its lifetime.
GENERATION_LABEL_CAP = 8
_seen_generations: list[str] = []


def generation_label(generation) -> str:
    """The first ``GENERATION_LABEL_CAP`` distinct values this process sees
    keep their own series; every later one folds into ``other``."""
    value = str(generation)
    if value in _seen_generations:
        return value
    if len(_seen_generations) < GENERATION_LABEL_CAP:
        _seen_generations.append(value)
        return value
    return "other"


class CanaryWeights:
    """Generation -> traffic-share policy applied to a weighted backend set.
    ``apply`` leaves the pool it is given alone."""

    def __init__(self):
        self._generations: dict[str, int] = {}
        self._canary_generation: int | None = None
        self._canary_share: float = 0.0

    def set_generation(self, uri: str, generation: int) -> None:
        self._generations[str(uri)] = int(generation)

    def generation_of(self, uri: str) -> int | None:
        return self._generations.get(str(uri))

    def set_split(self, canary_generation: int, share: float) -> None:
        """Route ``share`` (0..1) of the pool's traffic to backends of
        ``canary_generation``; the rest serves the other generations."""
        self._canary_generation = int(canary_generation)
        self._canary_share = min(1.0, max(0.0, float(share)))

    def clear_split(self) -> None:
        self._canary_generation = None
        self._canary_share = 0.0

    @property
    def split(self) -> tuple[int | None, float]:
        return self._canary_generation, self._canary_share

    def apply(self, pool):
        """Rescale ``[(uri, weight), ...]`` so the canary generation's
        backends hold the configured share of the total weight. A pool
        passes through unchanged with no split configured, with no canary
        backend in it, or with nothing but canary backends."""
        if self._canary_generation is None or not pool:
            return pool
        canary_total = other_total = 0.0
        for uri, weight in pool:
            if self._generations.get(uri) == self._canary_generation:
                canary_total += weight
            else:
                other_total += weight
        if canary_total <= 0 or other_total <= 0:
            return pool
        total = canary_total + other_total
        share = self._canary_share
        out = []
        for uri, weight in pool:
            if self._generations.get(uri) == self._canary_generation:
                out.append((uri, weight * share * total / canary_total))
            else:
                out.append((uri, weight * (1.0 - share) * total
                            / other_total))
        if all(w <= 0 for _, w in out):
            return pool
        return out
