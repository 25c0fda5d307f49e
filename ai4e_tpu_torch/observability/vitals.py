"""Per-process runtime vitals — event-loop lag, GC pauses, /proc stats; a
copy of ``ai4e_tpu/observability/vitals.py``.

The sampler exports ``ai4e_process_*`` series into the registry the
process already serves at ``/metrics`` (the control plane's assembly
registry, the worker's service registry). Both launchers start it when
``AI4E_OBSERVABILITY_VITALS`` is set. Stdlib only:

- event-loop lag (``ai4e_process_loop_lag_seconds``): a timed callback
  measures how late the loop woke it; any blocking call, GC pause or CPU
  starvation on the loop thread shows up here;
- GC pauses (``ai4e_process_gc_pause_seconds``): ``gc.callbacks``
  brackets every collection;
- /proc reads (RSS, CPU seconds, open fds, host CPU steal), one small
  read each per interval.

``recent()`` keeps a bounded history ring for ``timeline``'s counter
tracks.
"""

from __future__ import annotations

import asyncio
import gc
import os
import threading
import time
from collections import deque

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry

PROC_ROOT = "/proc"

# Loop-lag histogram buckets: lag below ~1 ms is scheduler noise; the
# interesting range is 10 ms (a heavy callback) through seconds (a
# blocking call on the loop — the bug class AIL001 exists for).
LOOP_LAG_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, float("inf"))
GC_PAUSE_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                    float("inf"))

# The loop-lag max gauge tracks the worst lag over this many recent
# samples — a live dashboard wants "how bad lately", not an
# all-time-high that one startup hiccup pins forever.
_LAG_WINDOW = 30


# -- /proc helpers ------------------------------------------------------------


def read_rss_bytes(pid: int | None = None,
                   proc_root: str = PROC_ROOT) -> float:
    """Resident set size in bytes from ``/proc/<pid>/status`` (VmRSS),
    -1.0 when the process is gone or the file is unreadable."""
    who = "self" if pid is None else str(pid)
    try:
        with open(f"{proc_root}/{who}/status", encoding="ascii") as fh:
            kb = fh.read().split("VmRSS:")[1].split()[0]
        return float(int(kb) * 1024)
    except (OSError, IndexError, ValueError, TypeError):
        return -1.0


def read_rss_mb(pid: int | None = None,
                proc_root: str = PROC_ROOT) -> float:
    """RSS in MiB (one decimal) — the soak engine's historical unit;
    -1.0 = process died (its loop keys on the sign)."""
    rss = read_rss_bytes(pid, proc_root=proc_root)
    return -1.0 if rss < 0 else round(rss / (1024.0 * 1024.0), 1)


def read_cpu_seconds(pid: int | None = None,
                     proc_root: str = PROC_ROOT) -> float:
    """utime+stime of the process in seconds (``/proc/<pid>/stat``
    fields 14/15), -1.0 on failure. The comm field may contain spaces
    and parentheses — parse from the LAST ')' like every correct
    /proc/stat reader."""
    who = "self" if pid is None else str(pid)
    try:
        with open(f"{proc_root}/{who}/stat", encoding="ascii") as fh:
            raw = fh.read()
        fields = raw[raw.rindex(")") + 2:].split()
        # fields[0] is state (field 3); utime/stime are fields 14/15.
        ticks = int(fields[11]) + int(fields[12])
        return ticks / float(os.sysconf("SC_CLK_TCK"))
    except (OSError, IndexError, ValueError, TypeError):
        return -1.0


def read_fd_count(pid: int | None = None,
                  proc_root: str = PROC_ROOT) -> int:
    """Open file descriptors of the process, -1 on failure."""
    who = "self" if pid is None else str(pid)
    try:
        return len(os.listdir(f"{proc_root}/{who}/fd"))
    except OSError:
        return -1


def proc_fd_links(pid: int | str,
                  proc_root: str = PROC_ROOT) -> list[tuple[str, str]]:
    """``(fd, readlink target)`` pairs for one process — the primitive
    the supervisor's socket-inode forensics walks (a target like
    ``socket:[12345]`` identifies a listener). Unreadable fds are
    skipped; an unreadable process yields an empty list."""
    fd_dir = f"{proc_root}/{pid}/fd"
    out: list[tuple[str, str]] = []
    try:
        fds = os.listdir(fd_dir)
    except OSError:
        return out
    for fd in fds:
        try:
            out.append((fd, os.readlink(os.path.join(fd_dir, fd))))
        except OSError:
            continue
    return out


def read_host_cpu_ticks(proc_root: str = PROC_ROOT) -> dict | None:
    """The aggregate ``cpu`` line of ``/proc/stat`` as named tick
    counts (user/nice/system/idle/iowait/irq/softirq/steal), or None
    when unreadable. Steal is the hypervisor running someone else on
    our core."""
    names = ("user", "nice", "system", "idle", "iowait", "irq",
             "softirq", "steal")
    try:
        with open(f"{proc_root}/stat", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("cpu "):
                    parts = line.split()[1:]
                    return {n: int(parts[i]) if i < len(parts) else 0
                            for i, n in enumerate(names)}
    except (OSError, ValueError):
        return None
    return None


class VitalsSampler:
    """Samples this process's runtime vitals every ``interval_s`` into
    ``ai4e_process_*`` metrics plus a bounded history ring.

    ``start()`` must run on the event loop being measured (the lag
    measurement IS that loop's scheduling delay). ``sample_once`` is
    callable without a loop for tests and for synchronous contexts that
    only want the /proc gauges.
    """

    def __init__(self, metrics: MetricsRegistry | None = None,
                 interval_s: float = 1.0, history: int = 600,
                 proc_root: str = PROC_ROOT):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = interval_s
        self.proc_root = proc_root
        self.metrics = metrics or DEFAULT_REGISTRY
        self._history: deque[dict] = deque(maxlen=history)
        self._hist_lock = threading.Lock()
        self._task: asyncio.Task | None = None
        self._gc_installed = False
        self._gc_t0 = 0.0
        # GC pause seconds accumulated since the last sample tick (the
        # callback fires on whatever thread triggered collection).
        self._gc_accum = 0.0
        self._gc_lock = threading.Lock()
        self._recent_lags: deque[float] = deque(maxlen=_LAG_WINDOW)
        self._last_cpu = -1.0
        self._last_host = read_host_cpu_ticks(proc_root)
        self._m_lag = self.metrics.histogram(
            "ai4e_process_loop_lag_seconds",
            "Event-loop scheduling lag per sampler tick (blocking "
            "calls, GC, CPU starvation on the loop thread)",
            buckets=LOOP_LAG_BUCKETS)
        self._m_lag_max = self.metrics.gauge(
            "ai4e_process_loop_lag_max_seconds",
            f"Worst loop lag over the last {_LAG_WINDOW} samples")
        self._m_gc_pause = self.metrics.histogram(
            "ai4e_process_gc_pause_seconds",
            "Stop-the-world GC pause durations (gc.callbacks)",
            buckets=GC_PAUSE_BUCKETS)
        self._m_gc_total = self.metrics.counter(
            "ai4e_process_gc_collections_total",
            "GC collections by generation")
        self._m_rss = self.metrics.gauge(
            "ai4e_process_rss_bytes", "Resident set size")
        self._m_fds = self.metrics.gauge(
            "ai4e_process_open_fds", "Open file descriptors")
        self._m_cpu = self.metrics.counter(
            "ai4e_process_cpu_seconds_total",
            "Process CPU time consumed (utime+stime)")
        self._m_steal = self.metrics.gauge(
            "ai4e_process_cpu_steal_ratio",
            "Host CPU steal fraction over the last sample interval "
            "(shared-container contention)")

    # -- GC bracketing -------------------------------------------------------

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
            return
        pause = time.perf_counter() - self._gc_t0
        if pause < 0:
            return
        self._m_gc_pause.observe(pause)
        self._m_gc_total.inc(generation=str(info.get("generation", "?")))  # ai4e: noqa[AIL013] — CPython GC generations are 0/1/2 (plus "?"), inherently bounded; not a rollout generation
        with self._gc_lock:
            self._gc_accum += pause

    def install_gc_hook(self) -> None:
        if not self._gc_installed:
            gc.callbacks.append(self._on_gc)
            self._gc_installed = True

    def remove_gc_hook(self) -> None:
        if self._gc_installed:
            try:
                gc.callbacks.remove(self._on_gc)
            except ValueError:
                pass
            self._gc_installed = False

    # -- sampling ------------------------------------------------------------

    def sample_once(self, lag_s: float | None = None) -> dict:
        """One vitals sample: read /proc, update the gauges, append to
        the history ring. ``lag_s`` is supplied by the loop tick (None
        for loop-less callers)."""
        rss = read_rss_bytes(proc_root=self.proc_root)
        fds = read_fd_count(proc_root=self.proc_root)
        cpu = read_cpu_seconds(proc_root=self.proc_root)
        if rss >= 0:
            self._m_rss.set(rss)
        if fds >= 0:
            self._m_fds.set(fds)
        if cpu >= 0:
            if self._last_cpu >= 0 and cpu > self._last_cpu:
                self._m_cpu.inc(cpu - self._last_cpu)
            self._last_cpu = cpu
        steal = None
        host = read_host_cpu_ticks(self.proc_root)
        if host is not None and self._last_host is not None:
            total = sum(host.values()) - sum(self._last_host.values())
            if total > 0:
                steal = (host["steal"] - self._last_host["steal"]) / total
                self._m_steal.set(max(0.0, steal))
        self._last_host = host
        with self._gc_lock:
            gc_pause, self._gc_accum = self._gc_accum, 0.0
        if lag_s is not None:
            self._m_lag.observe(lag_s)
            self._recent_lags.append(lag_s)
            self._m_lag_max.set(max(self._recent_lags))
        sample = {"t": round(time.time(), 3),
                  "rss_bytes": rss, "fds": fds, "cpu_s": round(cpu, 3),
                  "gc_pause_s": round(gc_pause, 6)}
        if lag_s is not None:
            sample["lag_s"] = round(lag_s, 6)
        if steal is not None:
            sample["steal"] = round(max(0.0, steal), 4)
        with self._hist_lock:
            self._history.append(sample)
        return sample

    def recent(self) -> list[dict]:
        """The history ring, oldest first — ``timeline``'s counter-track
        source."""
        with self._hist_lock:
            return list(self._history)

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        """Install the GC hook and start the tick loop on the RUNNING
        loop (whose scheduling lag is the thing measured)."""
        if self._task is not None:
            return
        self.install_gc_hook()
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self.remove_gc_hook()
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            due = loop.time() + self.interval_s
            await asyncio.sleep(self.interval_s)
            # The loop woke LATE by exactly its scheduling lag: every
            # blocking call / GC pause / starved-core interval that
            # elapsed while this coroutine was due shows up here.
            lag = max(0.0, loop.time() - due)
            self.sample_once(lag_s=lag)
