from .store import InMemoryTaskStore, TaskNotFound
from .task import APITask, TaskStatus, new_task_id

__all__ = ["APITask", "InMemoryTaskStore", "TaskNotFound", "TaskStatus",
           "new_task_id"]
