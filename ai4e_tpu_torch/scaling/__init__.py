from .autoscaler import (AutoscaleController, AutoscalePolicy,
                         DispatcherScaleTarget, HPADecider, ScaleTarget,
                         ShardedAutoscaleController, ShardScaleTarget,
                         predictive_signal)

__all__ = ["AutoscaleController", "AutoscalePolicy", "DispatcherScaleTarget",
           "HPADecider", "ScaleTarget", "ShardScaleTarget",
           "ShardedAutoscaleController", "predictive_signal"]
