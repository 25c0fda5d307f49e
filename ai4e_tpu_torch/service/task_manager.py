"""Task-manager facade used inside API services — the in-process half of
``ai4e_tpu/service/task_manager.py``. The HTTP backend (a worker behind the
control plane's task store) is not ported yet."""

from __future__ import annotations

import logging

from ..taskstore import APITask, InMemoryTaskStore, TaskNotFound, TaskStatus

log = logging.getLogger("ai4e_tpu_torch.task_manager")


class TaskManagerBase:
    """AddTask / UpdateTaskStatus / CompleteTask / FailTask / GetTaskStatus —
    the verbs every service uses."""

    async def add_task(self, endpoint: str, body: bytes,
                       task_id: str | None = None) -> dict:
        """Create a task — or, when ``task_id`` is supplied (the dispatcher
        already created it and passed the ``taskId`` header), fetch it."""
        if task_id:
            status = await self.get_task_status(task_id)
            if status is not None:
                return status
        return await self._upsert(APITask(
            task_id=task_id or "", endpoint=endpoint, body=body))

    async def update_task_status(self, task_id: str, status: str,
                                 backend_status: str | None = None) -> dict:
        return await self._update(task_id, status, backend_status)

    async def complete_task(self, task_id: str, status: str = "completed") -> dict:
        return await self._update(task_id, status, TaskStatus.COMPLETED)

    async def fail_task(self, task_id: str, status: str = "failed") -> dict:
        return await self._update(task_id, status, TaskStatus.FAILED)

    async def get_task_status(self, task_id: str) -> dict | None:
        raise NotImplementedError

    async def is_terminal(self, task_id: str) -> bool:
        """Terminal-status probe before writes that could clobber a
        completed task. A failed probe answers False and is logged."""
        try:
            record = await self.get_task_status(task_id)
        except Exception:  # noqa: BLE001 — a probe must never block its caller
            log.warning("status probe for task %s failed; proceeding as "
                        "non-terminal", task_id, exc_info=True)
            return False
        if not record:
            return False
        return TaskStatus.canonical(
            record.get("Status", "")) in TaskStatus.TERMINAL

    async def _upsert(self, task: APITask) -> dict:
        raise NotImplementedError

    async def _update(self, task_id: str, status: str,
                      backend_status: str | None = None) -> dict:
        raise NotImplementedError


class LocalTaskManager(TaskManagerBase):
    def __init__(self, store: InMemoryTaskStore):
        self.store = store

    async def get_task_status(self, task_id: str) -> dict | None:
        try:
            return self.store.get(task_id).to_dict()
        except TaskNotFound:
            return None

    async def _upsert(self, task: APITask) -> dict:
        return self.store.upsert(task).to_dict()

    async def _update(self, task_id: str, status: str,
                      backend_status: str | None = None) -> dict:
        return self.store.update_status(task_id, status, backend_status).to_dict()
