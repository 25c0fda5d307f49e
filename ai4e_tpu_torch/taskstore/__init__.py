from .journal import JournalCorruptError
from .results import FileResultBackend, ResultBackend
from .store import (FollowerTaskStore, InMemoryTaskStore,
                    JournalDegradedError, JournaledTaskStore, NotOwnerError,
                    NotPrimaryError, StaleEpochError, StoreClosedError,
                    TaskNotFound)
from .task import APITask, TaskStatus, endpoint_path, new_task_id

__all__ = ["APITask", "FileResultBackend", "FollowerTaskStore",
           "InMemoryTaskStore", "JournalCorruptError",
           "JournalDegradedError", "JournaledTaskStore", "NotOwnerError",
           "NotPrimaryError", "ResultBackend", "StaleEpochError",
           "StoreClosedError", "TaskNotFound", "TaskStatus", "endpoint_path",
           "new_task_id"]
