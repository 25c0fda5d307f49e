"""Kill and restart helpers for chaos scenarios; a copy of
``ai4e_tpu/chaos/harness.py``: a worker that is gone (its port refuses
connections) and comes back on the same port, a dispatcher stopped
mid-delivery and restarted, a shard primary killed, a slot moved.
"""

from __future__ import annotations

from aiohttp import web


class RestartableBackend:
    """An aiohttp app on a stable host:port with kill()/restart()."""

    def __init__(self, app: web.Application, host: str = "127.0.0.1",
                 port: int = 0):
        self.app = app
        self.host = host
        self.port = port
        self._runner: web.AppRunner | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def start(self) -> "RestartableBackend":
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        if not self.port:
            self.port = self._runner.addresses[0][1]
        return self

    async def kill(self) -> None:
        """Stop serving: the port answers connection-refused until
        ``restart``. In-flight requests are aborted, like a real crash."""
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    async def restart(self) -> None:
        if self._runner is not None:
            return  # already serving
        await self.start()

    @property
    def alive(self) -> bool:
        return self._runner is not None


async def kill_dispatcher(platform, queue_name: str):
    """Stop one dispatcher's delivery loops (in-flight deliveries are
    cancelled and their messages abandoned back to the broker — the crash
    path ``Dispatcher._run`` already implements). Returns the dispatcher
    so the caller can ``restart_dispatcher`` it."""
    d = platform.dispatchers.dispatchers[queue_name]
    await d.stop()
    return d


async def restart_dispatcher(platform, queue_name: str):
    """Bring a killed dispatcher back; its queue's backlog (including
    everything abandoned at kill time) drains normally."""
    d = platform.dispatchers.dispatchers[queue_name]
    await d.start()
    return d


async def kill_worker(backend: RestartableBackend) -> None:
    await backend.kill()


async def restart_worker(backend: RestartableBackend) -> None:
    await backend.restart()


def kill_shard_primary(platform, shard: int) -> None:
    """SIGKILL one shard primary of a sharded platform
    (``PlatformConfig(task_shards=N)``): its journal handle closes and
    every mutation refuses from this instant — no half-applied writes,
    exactly the window a process kill leaves. The next write routed to
    the shard performs the failover promotion inline (final journal
    drain → replica ``promote()`` minting the fencing epoch)."""
    platform.store.kill_shard_primary(shard)


def rebalance_slot(platform, slot: int, dest_shard: int) -> int:
    """Live rebalance under load: move one hash slot's keyspace range to
    ``dest_shard`` (``ShardedTaskStore.move_slot`` — bulk copy, then an
    atomic delta + ring flip under the old owner's lock). Returns tasks
    moved."""
    return platform.store.move_slot(slot, dest_shard)
