"""The rollout generation's metric label. A copy of the first part of
``ai4e_tpu/rollout/canary.py``: ``generation_label``, the bounded mapper
for the ``generation`` dimension of the worker's
``ai4e_rollout_outcomes_total`` and ``ai4e_rollout_request_seconds``.
A long-lived worker that reloads weekly would otherwise mint one series
per generation number forever.

``CanaryWeights`` (the generation -> traffic-share policy) is not ported:
only the rollout controller drives it (ROADMAP A18.9, A19).
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
