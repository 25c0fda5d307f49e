"""First-class pipeline DAGs (docs/pipelines.md).
(A copy of ``ai4e_tpu/pipeline/__init__.py``.)

``PipelineSpec`` declares a DAG of named stages (edges, fan-out/fan-in
joins with a failure quorum, per-stage deadline fractions);
``PipelineCoordinator`` executes it under one client-visible TaskId
through the existing store/broker/dispatcher fabric, reusing the result
cache per stage; ``TaskEventHub`` feeds the gateway's streaming surface
(``GET /v1/taskmanagement/task/{id}/events``) with stage-by-stage
partial results.
"""

from .coordinator import PipelineCoordinator
from .events import TaskEventHub, TaskEventStream, sse_encode
from .spec import (PipelineSpec, PipelineSpecError, StageSpec,
                   split_sub_task_id, stage_deadline, sub_task_id)

__all__ = [
    "PipelineCoordinator",
    "PipelineSpec",
    "PipelineSpecError",
    "StageSpec",
    "TaskEventHub",
    "TaskEventStream",
    "split_sub_task_id",
    "sse_encode",
    "stage_deadline",
    "sub_task_id",
]
