"""Rollout: the worker's drain, the generation label of its rollout
series, the canary split and the rollout controller (counterpart of
``ai4e_tpu/rollout``). The rig drives the controller
(``rig/rollout.py``); ``RolloutPolicy.from_config`` reads its
``AI4E_ROLLOUT_*`` knobs."""

from .canary import CanaryWeights, generation_label
from .controller import (RolloutController, RolloutPolicy, RolloutResult,
                         parse_steps)
from .drain import (DRAINING_HEADER, DrainingError, DrainState,
                    drain_worker, retire_pending)

__all__ = [
    "CanaryWeights",
    "generation_label",
    "RolloutController",
    "RolloutPolicy",
    "RolloutResult",
    "parse_steps",
    "DRAINING_HEADER",
    "DrainingError",
    "DrainState",
    "drain_worker",
    "retire_pending",
]
