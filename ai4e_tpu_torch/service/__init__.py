from .app import TASK_ID_HEADER, APIService, EndpointSpec
from .task_manager import LocalTaskManager, TaskManagerBase

__all__ = ["APIService", "EndpointSpec", "TASK_ID_HEADER",
           "LocalTaskManager", "TaskManagerBase"]
