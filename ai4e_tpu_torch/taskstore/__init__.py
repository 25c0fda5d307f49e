from .journal import JournalCorruptError
from .store import (FollowerTaskStore, InMemoryTaskStore,
                    JournalDegradedError, JournaledTaskStore,
                    NotPrimaryError, StaleEpochError, StoreClosedError,
                    TaskNotFound)
from .task import APITask, TaskStatus, endpoint_path, new_task_id

__all__ = ["APITask", "FollowerTaskStore", "InMemoryTaskStore",
           "JournalCorruptError", "JournalDegradedError",
           "JournaledTaskStore", "NotPrimaryError", "StaleEpochError",
           "StoreClosedError", "TaskNotFound", "TaskStatus", "endpoint_path",
           "new_task_id"]
