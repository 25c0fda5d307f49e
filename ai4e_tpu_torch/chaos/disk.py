"""Seeded filesystem fault injection on the journal's write path; a copy
of ``ai4e_tpu/chaos/disk.py``.

- ``DiskFaultInjector`` — the seeded rule engine deciding per write,
  flush and fsync;
- ``FaultyFile``        — wraps the store's journal handle, applying the
  decisions (the store's ``_fsync_journal`` prefers a handle-level
  ``fsync()``, so EIO on fsync injects without patching ``os.fsync``);
- ``attach_journal_faults`` — installs the wrapper on a live
  ``JournaledTaskStore``;
- ``lose_page_cache``   — the ``fsync=never`` crash model: truncate a
  journal file to the prefix that reached the disk.
"""

from __future__ import annotations

import errno as errno_mod
import random
from dataclasses import dataclass, field


@dataclass
class DiskFaultRule:
    """One fault schedule. ``op`` is ``"write"``, ``"flush"`` (fails the
    kernel handoff while the Python-side buffer RETAINS the bytes), or
    ``"fsync"``;
    ``after_ops`` skips that many matching operations first (a fault
    "mid-run", deterministically); ``rate`` draws seeded randomness
    instead (0 = fire every time once armed); ``times`` bounds how often
    the rule fires; ``torn_bytes`` makes a failing WRITE first persist
    that many bytes of the buffer — the short/torn-write shape (None =
    nothing persists)."""
    op: str = "write"
    errno: int = errno_mod.ENOSPC
    after_ops: int = 0
    rate: float = 0.0
    times: int | None = 1
    torn_bytes: int | None = None
    _seen: int = field(default=0, repr=False)
    _fired: int = field(default=0, repr=False)

    def exhausted(self) -> bool:
        return self.times is not None and self._fired >= self.times


class DiskFaultInjector:
    """Seeded decision source shared by every wrapped handle."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.rules: list[DiskFaultRule] = []
        self.injected: dict[str, int] = {}

    def add_rule(self, **spec) -> DiskFaultRule:
        rule = DiskFaultRule(**spec)
        self.rules.append(rule)
        return rule

    def clear(self) -> None:
        """Lift every fault (the recovery half of a scenario)."""
        self.rules = []

    def counts(self) -> dict:
        return dict(self.injected)

    def decide(self, op: str) -> DiskFaultRule | None:
        """First matching armed rule for this operation, or None."""
        for rule in self.rules:
            if rule.op != op or rule.exhausted():
                continue
            rule._seen += 1
            if rule._seen <= rule.after_ops:
                continue
            if rule.rate > 0 and self.rng.random() >= rule.rate:
                continue
            rule._fired += 1
            name = errno_mod.errorcode.get(rule.errno, "OSError")
            key = f"{op}:{name}"
            self.injected[key] = self.injected.get(key, 0) + 1
            return rule
        return None


class FaultyFile:
    """Wraps a real text-mode journal handle; ``JournaledTaskStore``
    writes/flushes/fsyncs through it unchanged until a rule fires."""

    def __init__(self, inner, injector: DiskFaultInjector):
        self._inner = inner
        self._injector = injector

    def write(self, data: str) -> int:
        rule = self._injector.decide("write")
        if rule is None:
            return self._inner.write(data)
        if rule.torn_bytes:
            # Torn write: a PREFIX of the buffer reaches the file before
            # the fault — the exact shape that leaves a partial line for
            # boot-salvage to truncate. Flush it through so the bytes are
            # really in the file, not just the wrapper's fiction.
            self._inner.write(data[:rule.torn_bytes])
            self._inner.flush()
        raise OSError(rule.errno, "chaos: injected disk fault on write")

    def flush(self) -> None:
        # op="flush" models the nastiest real-world shape: write()
        # buffered cleanly, the flush to the kernel fails, and the
        # BUFFER RETAINS the bytes — a later ordinary close() would
        # re-flush them behind the store's back (the resurrection the
        # store's discard-close exists to prevent).
        rule = self._injector.decide("flush")
        if rule is not None:
            raise OSError(rule.errno, "chaos: injected disk fault on flush")
        self._inner.flush()

    def fsync(self) -> None:
        # The store's _fsync_journal prefers this method when present —
        # the injection point for EIO-on-fsync.
        rule = self._injector.decide("fsync")
        if rule is not None:
            raise OSError(rule.errno, "chaos: injected disk fault on fsync")
        import os
        os.fsync(self._inner.fileno())

    def fileno(self) -> int:
        return self._inner.fileno()

    def close(self) -> None:
        self._inner.close()

    @property
    def closed(self) -> bool:
        return self._inner.closed

    def seek(self, *a):
        return self._inner.seek(*a)

    def tell(self):
        return self._inner.tell()


def attach_journal_faults(store, injector: DiskFaultInjector) -> None:
    """Install the injector on a live journaled store's append handle.
    Wraps the CURRENT handle — a compaction rewrite swaps in a fresh,
    unwrapped one (compaction under injected faults is its own scenario;
    re-attach after forcing one). Safe on a ``FollowerTaskStore`` in
    either role."""
    with store._lock:
        if store._journal is not None:
            store._journal = FaultyFile(store._journal, injector)
        raw = getattr(store, "_raw", None)
        if raw is not None and store._journal is not raw:
            store._raw = FaultyFile(raw, injector)


def lose_page_cache(journal_path: str, keep_bytes: int) -> int:
    """Machine-crash emulation for ``fsync=never``: the process died AND
    the kernel never wrote the tail — only ``keep_bytes`` of the journal
    survive. Returns the bytes dropped. The crash-point sweep drives this
    across every record boundary and seeded mid-record offsets
    (``crashpoint.py``)."""
    import os
    size = os.path.getsize(journal_path)
    keep = max(0, min(keep_bytes, size))
    with open(journal_path, "rb+") as fh:
        fh.truncate(keep)
    return size - keep
