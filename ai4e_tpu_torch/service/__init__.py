from .app import TASK_ID_HEADER, APIService, EndpointSpec
from .sync_client import SyncTaskManager
from .task_manager import (HttpResultStore, HttpTaskManager,
                           LocalTaskManager, StoreRefusalError,
                           TaskManagerBase)

__all__ = ["APIService", "EndpointSpec", "TASK_ID_HEADER",
           "HttpResultStore", "HttpTaskManager", "LocalTaskManager",
           "StoreRefusalError", "SyncTaskManager", "TaskManagerBase"]
