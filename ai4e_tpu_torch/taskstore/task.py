"""Task record and status model — a copy of ``ai4e_tpu/taskstore/task.py``.

The record's wire shape (``to_dict``/``from_dict``) and the status
canonicalisation are the JAX package's exactly, so a port worker and a JAX
control plane (or the other way round) read each other's records. The
admission, cache and tenant fields are carried on the record and the wire
unchanged; the port acts on the admission fields and the cache key, not yet
on the tenant (ROADMAP A18.10).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field, replace
from urllib.parse import urlparse


class TaskStatus:
    """Canonical lifecycle states."""

    CREATED = "created"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    EXPIRED = "expired"

    ALL = (CREATED, RUNNING, COMPLETED, FAILED, EXPIRED)
    TERMINAL = (COMPLETED, FAILED, EXPIRED)

    # The exact prose written when a task's transport message exhausts its
    # delivery budget.
    DEAD_LETTER_PROSE = "delivery attempts exhausted"
    DEAD_LETTER = FAILED + " - " + DEAD_LETTER_PROSE

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


# Separator between a pipeline root TaskId and a stage name in stage
# sub-task ids; the store's HTTP surface refuses to create such ids.
SUB_TASK_SEP = "~"


def endpoint_path(endpoint: str) -> str:
    """Derived endpoint path, e.g. ``http://host/v1/landcover/classify`` ->
    ``/v1/landcover/classify``, without query or fragment."""
    if not endpoint:
        return ""
    if "://" in endpoint:
        return urlparse(endpoint).path or "/"
    path = endpoint if endpoint.startswith("/") else "/" + endpoint
    return path.split("?", 1)[0].split("#", 1)[0] or "/"


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
    publish: bool = False  # enqueue onto the transport on upsert
    cache_key: str = ""
    deadline_at: float = 0.0
    priority: int = 1
    tenant: str = ""
    # False for a record whose loss on restart is acceptable: a cache hit's,
    # whose terminal record was already in the submit answer. Process-local
    # like ``publish``, never on the wire. The store's result offload skips
    # such a record, as a journal (ROADMAP A18.1) will, so a high duplicate
    # rate cannot turn "served from cache" into payload-sized writes.
    durable: bool = True

    @property
    def endpoint_path(self) -> str:
        return endpoint_path(self.endpoint)

    @property
    def canonical_status(self) -> str:
        return TaskStatus.canonical(self.status)

    def to_dict(self) -> dict:
        """Wire shape returned to clients polling ``GET /task/{taskId}``;
        the optional fields appear only when set."""
        d = {
            "TaskId": self.task_id,
            "Timestamp": self.timestamp,
            "Status": self.status,
            "BackendStatus": self.backend_status,
            "Endpoint": self.endpoint,
            "ContentType": self.content_type,
        }
        if self.cache_key:
            d["CacheKey"] = self.cache_key
        if self.deadline_at:
            d["DeadlineAt"] = self.deadline_at
        if self.priority != 1:
            d["Priority"] = self.priority
        if self.tenant:
            d["Tenant"] = self.tenant
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "APITask":
        body = d.get("Body", b"")
        if isinstance(body, str):
            # Inverse of the client's surrogateescape decode: binary bodies
            # survive the JSON round trip.
            body = body.encode("utf-8", errors="surrogateescape")
        return cls(
            task_id=d.get("TaskId") or d.get("Uuid") or new_task_id(),
            timestamp=float(d.get("Timestamp") or time.time()),
            status=d.get("Status", TaskStatus.CREATED),
            backend_status=d.get("BackendStatus", TaskStatus.CREATED),
            endpoint=d.get("Endpoint", ""),
            body=body,
            content_type=d.get("ContentType", "application/json"),
            publish=bool(d.get("PublishToGrid", False)),
            cache_key=d.get("CacheKey", ""),
            deadline_at=float(d.get("DeadlineAt") or 0.0),
            priority=int(d.get("Priority") or 1),
            tenant=d.get("Tenant", ""),
        )

    def with_status(self, status: str, backend_status: str | None = None) -> "APITask":
        return replace(
            self,
            status=status,
            backend_status=backend_status if backend_status is not None else status,
            timestamp=time.time(),
        )
