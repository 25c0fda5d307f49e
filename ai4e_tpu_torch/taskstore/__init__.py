from .store import InMemoryTaskStore, TaskNotFound
from .task import APITask, TaskStatus, endpoint_path, new_task_id

__all__ = ["APITask", "InMemoryTaskStore", "TaskNotFound", "TaskStatus",
           "endpoint_path", "new_task_id"]
