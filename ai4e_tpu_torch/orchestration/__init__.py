"""Deadline-aware orchestration over unequal backends; the counterpart of
``ai4e_tpu/orchestration``:

- ``CompletionEstimator`` (estimator.py) — decayed RTT sketches a backend,
  crossed with breaker state and queue pressure: P(finishes within the
  remaining deadline budget);
- ``DegradationLadder`` (ladder.py) — brownout modes stepped through
  hysteretically under sustained predicted-miss pressure, consulted by
  admission;
- ``Orchestrator`` (core.py) — the cheapest backend that clears the bar,
  in place of the health-weighted random pick in the dispatcher and the
  sync proxy.

On with ``PlatformConfig(orchestration=True)`` /
``AI4E_PLATFORM_ORCHESTRATION=1``, which needs admission and resilience.
"""

from .core import Orchestrator, OrchestrationPolicy, parse_costs
from .estimator import CompletionEstimator, DecayedQuantiles, backend_label
from .ladder import LEVELS, DegradationLadder

__all__ = [
    "Orchestrator",
    "OrchestrationPolicy",
    "parse_costs",
    "CompletionEstimator",
    "DecayedQuantiles",
    "backend_label",
    "DegradationLadder",
    "LEVELS",
]
