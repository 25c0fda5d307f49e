"""C12: a task 16a read as terminal without a result, held on both packages.

``chip_smoke.py``'s phase 16a SIGKILLs a journaled control plane (fsync
``always``) mid-burst and restarts it on its journal, one URL. These tests
replay that sequence in one process on the JAX package and on the port: a
journaled control plane, an echo worker built by each package's
``build_worker`` behind it, one task, and the control plane killed just
before the worker's ``kill_at``-th store request and back before its
``back_at``-th. Requests in between are refused.

A worker whose result write is refused fails the task from its service
shell (``is_terminal`` probe, then ``fail_task``). A single-URL store client
gives up at once, so when the control plane comes back between the refusal
and that probe, the task ends ``failed: Cannot connect to host ...`` with
no result: its re-seeded delivery then finds it terminal and acknowledges
it. Both packages do this (JAX's design; the port keeps it). The journal
itself never holds a completion without its result: every record boundary
and seeded mid-record cut of a served burst's journal reboots without one.
"""

from __future__ import annotations

import asyncio
import io
import random
import socket
import time
import types

import numpy as np
import pytest
from aiohttp.test_utils import TestServer

import ai4e_tpu.chaos.crashpoint as jax_crash
import ai4e_tpu.cli as jax_cli
import ai4e_tpu.platform_assembly as jax_pa
import ai4e_tpu.service.task_manager as jax_tm
import ai4e_tpu.taskstore.http as jax_http
import ai4e_tpu.taskstore.store as jax_store
import ai4e_tpu_torch.chaos.crashpoint as port_crash
import ai4e_tpu_torch.cli as port_cli
import ai4e_tpu_torch.platform_assembly as port_pa
import ai4e_tpu_torch.service.task_manager as port_tm
import ai4e_tpu_torch.taskstore.http as port_http
import ai4e_tpu_torch.taskstore.store as port_store
from ai4e_tpu.config import FrameworkConfig as JaxConfig
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry

NS = {
    "jax": types.SimpleNamespace(
        pa=jax_pa, http=jax_http, tm=jax_tm, crash=jax_crash, store=jax_store,
        Registry=JaxRegistry,
        build=lambda spec: jax_cli.build_worker(JaxConfig(), spec)),
    "port": types.SimpleNamespace(
        pa=port_pa, http=port_http, tm=port_tm, crash=port_crash,
        store=port_store,
        Registry=PortRegistry,
        build=lambda spec: port_cli.build_worker(spec, device="cpu")),
}
ROUTE = "/v1/echo/echo-async"
# The worker's store requests for one task, in order: the adoption read,
# ``running``, the result, the completion.
RESULT_CALL = 2
COMPLETION_CALL = 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def npy(values: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, values.astype(np.float32))
    return buf.getvalue()


class JournaledControlPlane:
    """One package's journaled control plane on a fixed port, its store
    surface on the gateway's app; ``kill`` closes the listener and the
    store, and a new one on the same journal is the restart."""

    def __init__(self, ns, journal: str, backend: str, port: int):
        self.platform = ns.pa.LocalPlatform(
            ns.pa.PlatformConfig(journal_path=journal,
                                 taskstore_fsync="always", retry_delay=0.05),
            metrics=ns.Registry())
        self.platform.publish_async_api(ROUTE, backend)
        ns.http.make_app(self.platform.store, app=self.platform.gateway.app,
                         lifecycle=self.platform)
        self.server = TestServer(self.platform.gateway.app, port=port)

    async def start(self):
        await self.server.start_server()
        await self.platform.start()
        return self

    async def kill(self):
        await self.server.close()
        await self.platform.stop()
        self.platform.store.close()


async def until(cond, what: str, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


async def restart_replay(pkg: str, tmp_path, monkeypatch, n_tasks: int = 1,
                         kill_at: int | None = None,
                         back_at: int | None = None) -> dict:
    """16a's sequence on one package: ``n_tasks`` echo tasks through a
    journaled control plane, killed before the worker's ``kill_at``-th
    store request and restarted on its journal before its ``back_at``-th
    (``back_at`` None: once the killed run has ended; no kill with
    ``kill_at`` None). Returns each task's final status,
    whether its result reads back, the worker's store requests by path
    and the journal's bytes."""
    import aiohttp

    ns = NS[pkg]
    port = free_port()
    journal = str(tmp_path / f"{pkg}_restart.jsonl")
    worker, batcher, tm = ns.build(
        {"models": [{"family": "echo", "name": "echo"}],
         "taskstore": f"http://127.0.0.1:{port}"})
    await batcher.start()
    ws = TestServer(worker.service.app)
    await ws.start_server()
    backend = str(ws.make_url("/v1/echo-async"))
    state = {"cp": await JournaledControlPlane(ns, journal, backend,
                                               port).start(),
             "calls": []}
    request = ns.tm._HttpStoreClient._request

    async def counted(self, method, path, **kw):
        at = len(state["calls"])
        state["calls"].append(path.rsplit("/", 1)[-1])
        if at == kill_at:
            await state["cp"].kill()
            state["cp"] = None
        if at == back_at:
            state["cp"] = await JournaledControlPlane(ns, journal, backend,
                                                      port).start()
        return await request(self, method, path, **kw)

    monkeypatch.setattr(ns.tm._HttpStoreClient, "_request", counted)
    try:
        async with aiohttp.ClientSession() as http:
            ids = []
            for i in range(n_tasks):
                async with http.post(
                        f"http://127.0.0.1:{port}{ROUTE}",
                        data=npy(np.full(16, i)),
                        headers={"Content-Type":
                                 "application/octet-stream"}) as r:
                    ids.append((await r.json())["TaskId"])

            def settled() -> bool:
                cp = state["cp"]
                if cp is None or worker.service._background:
                    return False
                return all(cp.platform.store.get(t).canonical_status
                           in ("completed", "failed") for t in ids)

            if kill_at is not None and back_at is None:
                # Back once the killed run has ended with every request
                # refused.
                await until(lambda: len(state["calls"]) > kill_at
                            and not worker.service._background,
                            "the refused run's end")
                state["cp"] = await JournaledControlPlane(
                    ns, journal, backend, port).start()
            await until(settled, "every task terminal, every run ended")
            store = state["cp"].platform.store
            out = {"status": [store.get(t).status for t in ids],
                   "result": [store.get_result(t) is not None for t in ids],
                   "calls": state["calls"]}
        await state["cp"].kill()
        state["cp"] = None
        with open(journal, "rb") as f:
            out["journal"] = f.read()
        out["ids"] = ids
        return out
    finally:
        if state["cp"] is not None:
            await state["cp"].kill()
        await ws.close()
        await batcher.stop()
        await tm.close()


def refused(status: str) -> bool:
    return status.startswith("failed: Cannot connect to host 127.0.0.1:")


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("kill_at,back_at,want", [
    # The result write refused, the control plane back for the probe: the
    # task fails with no result (16a's 204).
    (RESULT_CALL, RESULT_CALL + 1, "failed without result"),
    # The completion refused after the result was acknowledged: failed,
    # its result kept.
    (COMPLETION_CALL, COMPLETION_CALL + 1, "failed with result"),
    # Back only after the shell's probe and its fail_task were refused
    # too: the task stays running, its re-seeded delivery runs it again.
    (RESULT_CALL, None, "completed"),
], ids=["result-refused", "completion-refused", "back-after-the-probe"])
def test_c12_a_refused_store_write_fails_the_task(pkg, kill_at, back_at,
                                                  want, tmp_path,
                                                  monkeypatch):
    out = asyncio.run(restart_replay(pkg, tmp_path, monkeypatch,
                                     kill_at=kill_at, back_at=back_at))
    (status,), (has_result,) = out["status"], out["result"]
    if want == "completed":
        assert status == "completed - echo" and has_result
        # The first run's result, probe and fail_task refused; the
        # re-seeded delivery's run wrote both again.
        assert out["calls"][kill_at:] == ["result", "task", "update", "task",
                                          "update", "result", "update"]
    else:
        assert refused(status), status
        assert has_result == (want == "failed with result")
        # After the refused write: the shell's terminal probe and its
        # fail_task, both answered by the restarted control plane, and the
        # re-seeded delivery's adoption read, in either order; that
        # delivery runs nothing.
        assert sorted(out["calls"][kill_at + 1:]) == ["task", "task",
                                                      "update"]


def test_c12_same_path_on_both_packages(tmp_path, monkeypatch):
    """The result-refused replay gives the same statuses, results and
    store requests on both packages, up to the port number."""
    got = {}
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        out = asyncio.run(restart_replay(pkg, tmp_path / pkg, monkeypatch,
                                         kill_at=RESULT_CALL,
                                         back_at=RESULT_CALL + 1))
        got[pkg] = ([s.split(" host ")[0] for s in out["status"]],
                    out["result"], out["calls"])
    assert got["port"] == got["jax"]
    assert got["port"][1] == [False]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_c12_no_journal_cut_holds_a_completion_without_its_result(
        pkg, tmp_path, monkeypatch):
    """A served burst's journal, cut at every record boundary and at seeded
    mid-record offsets: each reboot that reads a task completed also reads
    its result (it is appended first)."""
    (tmp_path / pkg).mkdir()
    out = asyncio.run(restart_replay(pkg, tmp_path / pkg, monkeypatch,
                                     n_tasks=4))
    assert out["status"] == ["completed - echo"] * 4
    assert out["result"] == [True] * 4
    ns = NS[pkg]
    trace = ns.crash.WorkloadTrace(journal_path="", fsync="always", seed=12,
                                   journal_bytes=out["journal"])
    cuts = ns.crash.crash_offsets(trace, random.Random(12))
    assert len(cuts) > 4 * 4
    completed_at = []
    for cut in cuts:
        path = tmp_path / pkg / f"cut{cut}.jsonl"
        path.write_bytes(out["journal"][:cut])
        store = ns.store.FollowerTaskStore(str(path), start_as_primary=True,
                                        metrics=ns.Registry())
        try:
            for tid in out["ids"]:
                try:
                    task = store.get(tid)
                except KeyError:
                    continue
                if task.canonical_status == "completed":
                    assert store.get_result(tid) is not None, (cut, tid)
                    completed_at.append(cut)
        finally:
            store.close()
    assert completed_at, "no cut held a completion"
