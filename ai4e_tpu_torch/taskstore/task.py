"""Task record and status model — a copy of ``ai4e_tpu/taskstore/task.py``
with the fields this port uses (no cache, deadline or tenant state)."""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field, replace


class TaskStatus:
    """Canonical lifecycle states."""

    CREATED = "created"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    EXPIRED = "expired"

    ALL = (CREATED, RUNNING, COMPLETED, FAILED, EXPIRED)
    TERMINAL = (COMPLETED, FAILED, EXPIRED)

    @staticmethod
    def canonical(status: str) -> str:
        """Map a free-form status string ("completed - class_histogram")
        onto its lifecycle bucket by substring, failed first."""
        s = (status or "").lower()
        for canon in (TaskStatus.FAILED, TaskStatus.COMPLETED,
                      TaskStatus.EXPIRED, TaskStatus.RUNNING):
            if canon in s:
                return canon
        return TaskStatus.CREATED


def new_task_id() -> str:
    """GUID task ids."""
    return str(uuid.uuid4())


@dataclass
class APITask:
    """A single unit of asynchronous work."""

    task_id: str = field(default_factory=new_task_id)
    timestamp: float = field(default_factory=time.time)
    status: str = TaskStatus.CREATED
    backend_status: str = TaskStatus.CREATED
    endpoint: str = ""
    body: bytes = b""
    content_type: str = "application/json"

    @property
    def canonical_status(self) -> str:
        return TaskStatus.canonical(self.status)

    def to_dict(self) -> dict:
        """Wire shape returned to clients polling ``GET /task/{taskId}``."""
        return {
            "TaskId": self.task_id,
            "Timestamp": self.timestamp,
            "Status": self.status,
            "BackendStatus": self.backend_status,
            "Endpoint": self.endpoint,
            "ContentType": self.content_type,
        }

    def with_status(self, status: str, backend_status: str | None = None) -> "APITask":
        return replace(
            self,
            status=status,
            backend_status=backend_status if backend_status is not None else status,
            timestamp=time.time(),
        )
