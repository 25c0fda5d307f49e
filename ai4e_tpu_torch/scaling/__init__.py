from .autoscaler import (AutoscaleController, AutoscalePolicy,
                         DispatcherScaleTarget, HPADecider, ScaleTarget)

__all__ = ["AutoscaleController", "AutoscalePolicy", "DispatcherScaleTarget",
           "HPADecider", "ScaleTarget"]
