"""The port's blocking task client (``ai4e_tpu_torch/service/
sync_client.py``) held against the JAX package's.

``tests/test_sync_client.py`` runs whole on the port (``port_suite``).
Then one script of every verb (create, fetch, adopt by id, status
updates, complete, fail, pipeline handoff, results by stage, unknown ids)
runs in all four pairings of client and store app (JAX's client on the
port's store, the port's on JAX's, and each on its own): the same
answers, record for record, but for ids and times.
"""

from __future__ import annotations

import asyncio

import pytest
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.service as jax_service
import ai4e_tpu.taskstore as jax_taskstore
import ai4e_tpu.taskstore.http as jax_http
import ai4e_tpu_torch.service as port_service
import ai4e_tpu_torch.taskstore as port_taskstore
import ai4e_tpu_torch.taskstore.http as port_http
from tests.test_torch_tenancy import port_suite

globals().update(port_suite("test_sync_client"))

CLIENTS = {"jax": jax_service, "port": port_service}
STORES = {"jax": (jax_taskstore, jax_http), "port": (port_taskstore,
                                                     port_http)}
VOLATILE = {"Timestamp", "TaskId", "Uuid", "CreatedAt", "UpdatedAt"}


def script(tm) -> list:
    """Every verb once or more; a dict answer keeps its stable fields."""
    def keep(x):
        if isinstance(x, dict):
            return {k: v for k, v in sorted(x.items()) if k not in VOLATILE}
        return x

    out = []
    a = tm.add_task("/v1/org/api", b"PAYLOAD")
    out.append(keep(a))
    tid = a["TaskId"]
    out.append(keep(tm.add_task("/v1/org/api", b"ignored", task_id=tid)))
    out.append(keep(tm.update_task_status(tid, "running - step 1")))
    out.append(keep(tm.get_task_status(tid)))
    tm.set_result(tid, b'{"stage": 1}', stage="first")
    out.append(tm.get_result(tid, stage="first"))
    out.append(keep(tm.add_pipeline_task(tid, "/v1/org/next")))
    out.append(keep(tm.complete_task(tid, "completed - done")))
    tm.set_result(tid, b'{"final": true}')
    out.append(tm.get_result(tid))
    out.append(tm.get_result(tid, stage="missing"))
    b = tm.add_task("/v1/org/other", "é ✓".encode(), publish=True)
    out.append(keep(b))
    out.append(keep(tm.fail_task(b["TaskId"], "failed - bad input")))
    out.append(tm.get_task_status("no-such-task"))
    try:
        tm.update_task_status("no-such-task", "running")
    except KeyError as exc:
        out.append(f"KeyError {exc}")
    tm.set_result("no-such-task", b"x")  # dropped by the store, logged
    out.append(tm.get_result("no-such-task"))
    return out


async def run_pairing(client_pkg: str, store_pkg: str) -> list:
    ts, http = STORES[store_pkg]
    server = TestClient(TestServer(http.make_app(ts.InMemoryTaskStore())))
    await server.start_server()
    try:
        tm = CLIENTS[client_pkg].SyncTaskManager(str(server.make_url("/")))
        return await asyncio.get_running_loop().run_in_executor(
            None, script, tm)
    finally:
        await server.close()


@pytest.mark.parametrize("client_pkg,store_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_verbs_answer_as_jax_on_jax(client_pkg, store_pkg):
    want = asyncio.run(run_pairing("jax", "jax"))
    got = asyncio.run(run_pairing(client_pkg, store_pkg))
    assert got == want
    assert want[1]["Status"].startswith("running") is False
    assert want[-3] is None and want[-1] is None
