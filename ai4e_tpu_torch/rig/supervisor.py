"""Process supervision as a robustness surface (docs/deployment.md); a
copy of ``ai4e_tpu/rig/supervisor.py``.

``scripts/soak.sh`` learned these lessons by hand and encoded them in
bash: a previous run's control plane can outlive its SIGTERM by minutes
(the signal lands when the event loop breathes), so you must wait for the
ports and then escalate to SIGKILL on whatever still holds them; children
must die with the parent or they leak; a child that dies at boot must
fail the run loudly, not hang it. This module is that knowledge as code,
shared by the rig driver and the (now thin) soak script:

- **port eviction** (``ensure_port_free``): wait for a listener to drain,
  then SIGKILL the holder found via ``/proc/net/tcp`` — no ``ss``/psutil
  dependency;
- **health-gated spawn**: a child is not "up" until its health URL
  answers (or its port accepts), bounded by a deadline; a child that
  EXITS while we wait fails immediately with its log tail;
- **crash-loop detection**: the monitor restarts an unexpectedly-dead
  child at most ``max_restarts`` times, and only counts an uptime under
  ``min_uptime_s`` as a crash-loop strike — a child the chaos timeline
  killed on purpose is marked expected and never restarted;
- **hard teardown** (``shutdown``): SIGTERM the process GROUPS (children
  are spawned with ``start_new_session=True``, so grandchildren die
  too), bounded grace, SIGKILL the stragglers, reap, then verify the
  rig's ports are actually free — registered via ``atexit`` and usable
  as a context manager, so no exit path leaks processes.

Everything here is deliberately synchronous: supervision must keep
working when the event loop it would ride is the thing that wedged.
"""

from __future__ import annotations

import atexit
import glob
import logging
import os
import signal
import socket
import subprocess
import sys
import time

log = logging.getLogger("ai4e_tpu_torch.rig.supervisor")


class RigError(RuntimeError):
    """A supervision failure the run must surface loudly."""


# -- port forensics (the soak.sh port-wait/SIGKILL ladder, in-process) ------


def port_is_free(host: str, port: int) -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, port))
            return True
        except OSError:
            return False


def _listen_inodes(port: int) -> set[str]:
    """Socket inodes LISTENing on ``port`` (state 0A), from
    /proc/net/tcp{,6} — hex-encoded local_address:port per line."""
    inodes: set[str] = set()
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(path, encoding="ascii") as fh:
                lines = fh.readlines()[1:]
        except OSError:
            continue
        for line in lines:
            parts = line.split()
            if len(parts) < 10 or parts[3] != "0A":
                continue
            try:
                if int(parts[1].rsplit(":", 1)[1], 16) == port:
                    inodes.add(parts[9])
            except (ValueError, IndexError):
                continue
    return inodes


def pids_listening_on(port: int) -> list[int]:
    """PIDs holding a LISTEN socket on ``port`` — inode → /proc/*/fd scan
    (fd readlinks via the shared vitals helper)."""
    from ..observability.vitals import proc_fd_links

    inodes = _listen_inodes(port)
    if not inodes:
        return []
    wanted = {f"socket:[{ino}]" for ino in inodes}
    pids = []
    for fd_dir in glob.glob("/proc/[0-9]*/fd"):
        pid = fd_dir.split("/")[2]
        if any(target in wanted for _fd, target in proc_fd_links(pid)):
            pids.append(int(pid))
    return pids


def ensure_port_free(host: str, port: int, wait_s: float = 10.0,
                     kill: bool = True) -> None:
    """Wait up to ``wait_s`` for ``port`` to drain; then (``kill``)
    SIGKILL whatever still holds it — a previous run's wedged process —
    and wait again. Raises ``RigError`` if the port cannot be freed."""
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        if port_is_free(host, port):
            return
        time.sleep(0.25)
    if not kill:
        raise RigError(f"port {port} still held after {wait_s}s")
    holders = pids_listening_on(port)
    for pid in holders:
        if pid == os.getpid():
            raise RigError(f"port {port} is held by THIS process")
        log.warning("port %d still held by pid %d after %.0fs; SIGKILL "
                    "(the soak.sh escalation ladder)", port, pid, wait_s)
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if port_is_free(host, port):
            return
        time.sleep(0.1)
    raise RigError(f"port {port} could not be freed (holders: {holders})")


# -- children ---------------------------------------------------------------


class Child:
    def __init__(self, name: str, argv: list[str], env: dict,
                 log_path: str, port: int | None = None,
                 health_url: str | None = None,
                 drain_url: str | None = None):
        self.name = name
        self.argv = argv
        self.env = env
        self.log_path = log_path
        self.port = port
        self.health_url = health_url
        # Graceful-drain verb (rollout/, docs/deployment.md#drain): set
        # for children that serve one (workers) — teardown POSTs it
        # best-effort before the SIGTERM so in-flight work redelivers
        # instead of dying with the process.
        self.drain_url = drain_url
        self.proc: subprocess.Popen | None = None
        self.started_at = 0.0
        self.restarts = 0
        self.expected_death = False

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def log_tail(self, n: int = 20) -> str:
        try:
            with open(self.log_path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                fh.seek(max(0, fh.tell() - 8192))
                return "\n".join(
                    fh.read().decode("utf-8", "replace").splitlines()[-n:])
        except OSError:
            return "<no log>"


class Supervisor:
    """Owns every rig child process from spawn to verified teardown."""

    def __init__(self, host: str = "127.0.0.1",
                 max_restarts: int = 2, min_uptime_s: float = 5.0):
        self.host = host
        self.max_restarts = max_restarts
        self.min_uptime_s = min_uptime_s
        self.children: dict[str, Child] = {}
        self._down = False
        atexit.register(self.shutdown)

    # -- spawn --------------------------------------------------------------

    def spawn(self, name: str, argv: list[str], env: dict | None = None,
              log_path: str | None = None, port: int | None = None,
              health_url: str | None = None,
              drain_url: str | None = None) -> Child:
        if name in self.children and self.children[name].alive():
            raise RigError(f"child {name!r} already running")
        if port is not None:
            # Port-conflict eviction BEFORE the child boots: a stale
            # holder fails the bind seconds later with a far worse error.
            ensure_port_free(self.host, port)
        child = self.children.get(name) or Child(
            name, argv, dict(env or os.environ),
            log_path or f"/tmp/rig-{name}.log", port=port,
            health_url=health_url, drain_url=drain_url)
        child.argv, child.env = argv, dict(env or os.environ)
        self.children[name] = child
        self._start(child)
        return child

    def _start(self, child: Child) -> None:
        log_fh = open(child.log_path, "ab")
        try:
            # start_new_session: the child leads its own process group, so
            # teardown can kill the GROUP (grandchildren included) and an
            # interactive ^C on the driver doesn't pre-empt our ordered
            # shutdown.
            child.proc = subprocess.Popen(
                child.argv, env=child.env, stdout=log_fh, stderr=log_fh,
                start_new_session=True)
        finally:
            log_fh.close()
        child.started_at = time.monotonic()
        child.expected_death = False
        log.info("spawned %s (pid %d): %s", child.name, child.proc.pid,
                 " ".join(child.argv[:6]))

    # -- health gating ------------------------------------------------------

    def wait_healthy(self, name: str, timeout: float = 60.0) -> None:
        """Block until the child's health URL answers 200 (or, with only a
        port, until TCP accepts). A child that EXITS while we wait fails
        the run immediately with its log tail — a silent boot crash must
        not burn the whole timeout."""
        import urllib.error
        import urllib.request

        child = self.children[name]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not child.alive():
                raise RigError(
                    f"{name} died at boot (exit "
                    f"{child.proc.returncode}):\n{child.log_tail()}")
            try:
                if child.health_url:
                    with urllib.request.urlopen(child.health_url,
                                                timeout=2.0) as resp:
                        if resp.status == 200:
                            return
                elif child.port is not None:
                    with socket.create_connection(
                            (self.host, child.port), timeout=2.0):
                        return
                else:
                    return  # nothing to gate on
            except (urllib.error.URLError, OSError, ValueError):
                pass
            time.sleep(0.2)
        raise RigError(f"{name} did not become healthy within {timeout}s:"
                       f"\n{child.log_tail()}")

    # -- chaos hooks --------------------------------------------------------

    def expect_death(self, name: str) -> None:
        """Mark a child the chaos timeline is about to kill: the monitor
        must neither restart it nor count it as a crash."""
        self.children[name].expected_death = True

    def kill(self, name: str, sig: int = signal.SIGKILL) -> int:
        """SIGKILL (default) a child's process group — the chaos verbs'
        process-death primitive. Returns the pid killed."""
        child = self.children[name]
        if not child.alive():
            raise RigError(f"cannot kill {name}: not running")
        child.expected_death = True
        pid = child.proc.pid
        try:
            os.killpg(os.getpgid(pid), sig)
        except OSError:
            os.kill(pid, sig)
        return pid

    def respawn(self, name: str, env_overrides: dict | None = None) -> Child:
        """Relaunch a (dead) child with its original argv/env — the chaos
        timeline's dispatcher-restart verb, and what a crash-loop restart
        does one step at a time. ``env_overrides`` merge into the child's
        env (and STICK for later respawns) — the rolling-upgrade driver's
        generation bump (``AI4E_ROLLOUT_GENERATION``)."""
        child = self.children[name]
        if child.alive():
            raise RigError(f"cannot respawn {name}: still running")
        if env_overrides:
            child.env = {**child.env,
                         **{k: str(v) for k, v in env_overrides.items()}}
        if child.port is not None:
            ensure_port_free(self.host, child.port)
        self._start(child)
        return child

    # -- crash-loop monitor -------------------------------------------------

    def check(self) -> list[str]:
        """One monitor pass: restart unexpectedly-dead children (bounded),
        raise on a crash-looping one. Returns names restarted."""
        restarted = []
        for child in list(self.children.values()):
            if child.alive() or child.proc is None:
                continue
            if child.expected_death:
                continue  # the chaos timeline owns this corpse
            uptime = time.monotonic() - child.started_at
            if uptime >= self.min_uptime_s:
                # A long-lived child dying is a crash, not a crash LOOP —
                # it restarts with a fresh strike budget (the documented
                # contract: only short uptimes count as loop strikes).
                child.restarts = 0
            child.restarts += 1
            if child.restarts > self.max_restarts:
                raise RigError(
                    f"{child.name} is crash-looping (attempt "
                    f"{child.restarts}, uptime {uptime:.1f}s, exit "
                    f"{child.proc.returncode}):\n{child.log_tail()}")
            log.warning("%s died unexpectedly (exit %s, uptime %.1fs); "
                        "restarting (%d/%d)", child.name,
                        child.proc.returncode, uptime, child.restarts,
                        self.max_restarts)
            if child.port is not None:
                ensure_port_free(self.host, child.port)
            self._start(child)
            restarted.append(child.name)
        return restarted

    # -- teardown -----------------------------------------------------------

    @staticmethod
    def _teardown_wave(child: Child) -> int:
        """Drain-first teardown ordering (docs/deployment.md#teardown):
        workers go first (their drain verb redelivers in-flight work),
        then dispatchers (they stop popping a queue whose workers are
        gone), then everything else, stores LAST — every earlier wave may
        still be flushing task state into them."""
        if child.name.startswith("worker"):
            return 0
        if child.name.startswith("dispatcher"):
            return 1
        if child.name.startswith("store"):
            return 3
        return 2

    def _post_drain(self, child: Child, timeout_s: float = 2.0) -> None:
        """Best-effort drain POST before a worker's SIGTERM: bounded,
        fail-open — a worker that cannot answer still dies on the signal
        path below; the drain just lets in-flight work redeliver first."""
        import urllib.error
        import urllib.request

        try:
            req = urllib.request.Request(
                child.drain_url, data=b'{"timeout_ms": 1500}',
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                log.info("drained %s before teardown (HTTP %d)",
                         child.name, resp.status)
        except (urllib.error.URLError, OSError, ValueError) as exc:
            log.debug("teardown drain of %s skipped: %s", child.name, exc)

    def shutdown(self, grace_s: float = 5.0) -> None:
        """Hard teardown that cannot leak: drain-first ordered SIGTERM
        waves (workers → dispatchers → the rest → stores), bounded grace,
        SIGKILL stragglers, reap, then verify our ports are free
        (evicting any holder as the last resort). Idempotent — atexit and
        explicit callers can both run it."""
        if self._down:
            return
        self._down = True
        waves: dict[int, list[Child]] = {}
        for child in self.children.values():
            waves.setdefault(self._teardown_wave(child), []).append(child)
        # Per-wave slice of the grace budget; the global grace loop below
        # stays the fallback bound, so total teardown time is unchanged.
        wave_grace = grace_s / max(1, len(waves)) if waves else grace_s
        for _, members in sorted(waves.items()):
            for child in members:
                if child.drain_url and child.alive():
                    self._post_drain(child)
            for child in members:
                if child.alive():
                    try:
                        os.killpg(os.getpgid(child.proc.pid),
                                  signal.SIGTERM)
                    except OSError:
                        pass
            wave_deadline = time.monotonic() + wave_grace
            while time.monotonic() < wave_deadline:
                if not any(c.alive() for c in members):
                    break
                time.sleep(0.05)
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            if not any(c.alive() for c in self.children.values()):
                break
            time.sleep(0.1)
        for child in self.children.values():
            if child.alive():
                log.warning("%s survived SIGTERM grace; SIGKILL",
                            child.name)
                try:
                    os.killpg(os.getpgid(child.proc.pid), signal.SIGKILL)
                except OSError:
                    try:
                        child.proc.kill()
                    except OSError:
                        pass
        for child in self.children.values():
            if child.proc is not None:
                try:
                    child.proc.wait(timeout=5.0)
                except (subprocess.TimeoutExpired, OSError):
                    log.error("%s (pid %s) could not be reaped",
                              child.name, child.pid)
        # The proof the teardown contract demands: nothing of ours still
        # listens. Evict-and-verify rather than trust.
        for child in self.children.values():
            if child.port is not None and not port_is_free(self.host,
                                                           child.port):
                try:
                    ensure_port_free(self.host, child.port, wait_s=2.0)
                except RigError:
                    log.error("port %d still held after teardown",
                              child.port)

    def __enter__(self) -> "Supervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def python_argv(module: str, *args: str) -> list[str]:
    """Child argv running ``python -m <module>`` with this interpreter."""
    return [sys.executable, "-m", module, *args]


async def serve_until_signal(app, host: str, port: int) -> None:
    """Run one rig role's aiohttp app until SIGTERM/SIGINT — the shared
    child-process main loop (every role exits cleanly on the supervisor's
    group SIGTERM so teardown needs no SIGKILL escalation on the happy
    path)."""
    import asyncio

    from aiohttp import web

    # Short shutdown grace: rig nodes hold long-lived streams (feed
    # tails, long-polls) that would otherwise pin cleanup for aiohttp's
    # default 60 s and force the supervisor's SIGKILL escalation.
    runner = web.AppRunner(app, shutdown_timeout=2.0)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    log.info("serving on %s:%d", host, port)
    try:
        await stop.wait()
    finally:
        await runner.cleanup()
