"""Result backends — a copy of ``ai4e_tpu/taskstore/results.py``: the
object-storage slot the task store routes large results through instead
of holding them in memory.

- ``ResultBackend`` is the interface: ``put``, ``get``, ``delete`` and a
  streaming ``open``;
- ``FileResultBackend`` keeps each result as two files under a root
  directory (a local directory, or a volume every process mounts):
  ``{name}.bin`` (the payload) and ``{name}.meta`` (its content type).

Keys are ``{task_id}`` or ``{task_id}:{stage}``; the backend maps them to
file names itself, injectively.
"""

from __future__ import annotations

import io
import os
from urllib.parse import quote


class ResultBackend:
    """Interface: durable blob storage for task results."""

    def put(self, key: str, data: bytes, content_type: str) -> None:
        raise NotImplementedError

    def get(self, key: str) -> tuple[bytes, str] | None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def open(self, key: str):
        """Streaming read: ``(file_like, content_type, size)`` or None. The
        default adapts ``get``; a file backend returns a real handle so a
        multi-MB result never buffers whole."""
        found = self.get(key)
        if found is None:
            return None
        data, content_type = found
        return io.BytesIO(data), content_type, len(data)


class FileResultBackend(ResultBackend):
    """Results as files under ``root``, each written to a temporary name,
    fsynced and renamed into place, so a crashed write never leaves half a
    result readable."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _name(self, key: str) -> str:
        # Injective: the stage suffix is free-form ("/", ":", ...), and a
        # lossy substitution would let two stages share one file.
        return quote(key, safe="")

    def put(self, key: str, data: bytes, content_type: str) -> None:
        name = self._name(key)
        for suffix, payload in ((".bin", data),
                                (".meta", content_type.encode())):
            tmp = os.path.join(self.root, name + suffix + ".tmp")
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.root, name + suffix))

    def get(self, key: str) -> tuple[bytes, str] | None:
        name = self._name(key)
        try:
            with open(os.path.join(self.root, name + ".bin"), "rb") as f:
                data = f.read()
            with open(os.path.join(self.root, name + ".meta"), "rb") as f:
                content_type = f.read().decode()
        except FileNotFoundError:
            return None
        return data, content_type

    def delete(self, key: str) -> None:
        name = self._name(key)
        for suffix in (".bin", ".meta"):
            try:
                os.unlink(os.path.join(self.root, name + suffix))
            except FileNotFoundError:
                pass

    def open(self, key: str):
        name = self._name(key)
        try:
            with open(os.path.join(self.root, name + ".meta"), "rb") as f:
                content_type = f.read().decode()
            fh = open(os.path.join(self.root, name + ".bin"), "rb")  # noqa: SIM115 — the caller closes the handle
        except FileNotFoundError:
            return None
        size = os.fstat(fh.fileno()).st_size
        return fh, content_type, size
