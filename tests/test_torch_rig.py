"""The port's multi-process rig (``ai4e_tpu_torch/rig/``, ROADMAP A19) held
against the JAX package's on the CPU.

``tests/test_rig.py`` runs whole on the port: its source with every
``ai4e_tpu`` import pointed at ``ai4e_tpu_torch`` but the interleaving
explorer's (``ai4e_tpu.analysis``, a JAX-free tool the port has no copy
of), its fixed rig base port moved to a block of 100 free ports and its
shared scratch directory to one of its own, so it never contends with
JAX's file in another worker. Then both packages on the same inputs: the
port layout and spec JSON of the same ``Topology`` arguments, the chaos
timeline of the same seed, the verdict over journals either package's
store node wrote, and the mesh worker's poison -> unhealthy -> probe ->
healthy walk. Last, what only the port can show: one small ``python -m
ai4e_tpu_torch.rig up`` with chaos on ends with the verdict ``ok``, and
no module string the port spawns names the JAX package.
"""

from __future__ import annotations

import ast
import asyncio
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).parent
ROOT = TESTS.parent
HOST = "127.0.0.1"


def free_base_port(span: int = 100, low: int = 20000,
                   high: int = 32000) -> int:
    """A base port whose whole block of ``span`` ports is free now, below
    the kernel's ephemeral range, so no client socket takes one later:
    the rig's supervisor SIGKILLs whatever holds a topology port, and a
    block chosen this way holds nothing of another test's. JAX's
    ``tests/test_rig.py`` takes 28800's block, which another worker may
    be running."""
    import random

    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(low, high - span) // span * span
        if base == 28800:
            continue
        held = False
        for port in range(base, base + span):
            with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
                try:
                    s.bind((HOST, port))
                except OSError:
                    held = True
                    break
        if not held:
            return base
    raise RuntimeError("no free block of ports")


def port_rig_module() -> types.ModuleType:
    """``tests/test_rig.py`` on the port, run as a module of its own."""
    path = TESTS / "test_rig.py"
    src = re.sub(r"\bai4e_tpu\b(?!_torch|\.analysis)", "ai4e_tpu_torch",
                 path.read_text())
    src = src.replace("base_port=28800", f"base_port={free_base_port()}")
    src = src.replace('"/tmp/ai4e-rig-idt"',
                      repr(tempfile.mkdtemp(prefix="ai4e-torch-rig-")))
    mod = types.ModuleType("_port_test_rig")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


_suite = port_rig_module()
globals().update({key: value for key, value in vars(_suite).items()
                  if key.startswith(("test_", "Test"))})


# -- both packages on the same inputs ------------------------------------------

import ai4e_tpu.rig.chaos as jax_chaos  # noqa: E402
import ai4e_tpu.rig.storenode as jax_storenode  # noqa: E402
import ai4e_tpu.rig.topology as jax_topology  # noqa: E402
import ai4e_tpu.rig.verdict as jax_verdict  # noqa: E402
import ai4e_tpu.rig.workernode as jax_workernode  # noqa: E402
import ai4e_tpu_torch.rig.chaos as port_chaos  # noqa: E402
import ai4e_tpu_torch.rig.storenode as port_storenode  # noqa: E402
import ai4e_tpu_torch.rig.topology as port_topology  # noqa: E402
import ai4e_tpu_torch.rig.verdict as port_verdict  # noqa: E402
import ai4e_tpu_torch.rig.workernode as port_workernode  # noqa: E402

RIG = {
    "jax": types.SimpleNamespace(topology=jax_topology, chaos=jax_chaos,
                                 storenode=jax_storenode,
                                 verdict=jax_verdict,
                                 workernode=jax_workernode),
    "port": types.SimpleNamespace(topology=port_topology, chaos=port_chaos,
                                  storenode=port_storenode,
                                  verdict=port_verdict,
                                  workernode=port_workernode),
}
TOPOLOGIES = [
    {},
    dict(gateways=2, shards=2, replicas=1, dispatchers=1, workers=1,
         loadgens=1, rate=1500.0, duration=8.0, base_port=24000),
    dict(gateways=3, shards=4, replicas=2, dispatchers=2, workers=3,
         loadgens=2, slots=64, seed=7, chaos=False, collector=False),
    dict(gateways=2, shards=1, replicas=1, dispatchers=1, workers=2,
         loadgens=2, rate=300.0, rollout="bad-canary",
         rollout_steps="25,50,100", rollout_hold_s=3.0, seed=20260803),
    dict(shards=2, workers=2, mesh="dp=2", mesh_poison_nths="2,3",
         tenants="a=ka:2:50:100,b=kb"),
]


def layout(topo) -> dict:
    ports = {"balancer": topo.balancer_port(),
             "gateways": [topo.gateway_port(g) for g in range(topo.gateways)]}
    for s in range(topo.shards):
        ports[f"shard{s}"] = {
            "primary": topo.shard_port(s),
            "replicas": [topo.replica_port(s, r)
                         for r in range(topo.replicas)],
            "workers": [topo.worker_port(s, w) for w in range(topo.workers)],
            "dispatchers": [topo.dispatcher_port(s, d)
                            for d in range(topo.dispatchers)],
            "urls": topo.shard_urls(s)}
    return {"ports": ports, "metrics": topo.metrics_urls()}


@pytest.mark.parametrize("kwargs", TOPOLOGIES,
                         ids=lambda k: ",".join(sorted(k)) or "defaults")
def test_topology_layout_and_spec_json_equal_jax(kwargs, tmp_path):
    got = {}
    for pkg, ns in RIG.items():
        topo = ns.topology.Topology(workdir=str(tmp_path), **kwargs)
        path = tmp_path / f"{pkg}.json"
        topo.save(str(path))
        got[pkg] = (layout(topo), path.read_bytes(),
                    layout(ns.topology.Topology.load(str(path))))
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("kwargs", TOPOLOGIES + [
    dict(shards=1, replicas=1, duration=30.0, seed=3),
    dict(shards=3, replicas=1, dispatchers=4, gateways=5, seed=11,
         duration=4.0)], ids=lambda k: ",".join(sorted(k)) or "defaults")
def test_build_timeline_equals_jax(kwargs, tmp_path):
    got = {pkg: ns.chaos.build_timeline(ns.topology.Topology(
        workdir=str(tmp_path), **kwargs)) for pkg, ns in RIG.items()}
    assert got["port"] == got["jax"]
    assert all(e["at"] >= 0 for e in got["port"])


def _shard_tasks(topo, shard: int, n: int, tag: str) -> list[str]:
    from ai4e_tpu_torch.taskstore.sharding import stable_hash

    out = []
    for i in range(100_000):
        tid = f"{tag}-{shard}-{i}"
        if (stable_hash(tid) % topo.slots) % topo.shards == shard:
            out.append(tid)
            if len(out) == n:
                return out
    raise AssertionError("no task id hashed onto the shard")


def _write_fleet_journals(ns, workdir: str) -> None:
    """Two shards' journals written by ``ns``'s store node, and one
    loadgen's promises: completions, a failure, a duplicate completion, a
    task accepted but never finished, and a client-seen completion the
    journals never acknowledged."""
    from ai4e_tpu_torch.taskstore import TaskStatus

    topo = ns.topology.Topology(gateways=1, shards=2, replicas=1,
                                dispatchers=1, workers=1, loadgens=1,
                                workdir=workdir, collector=False)
    os.makedirs(workdir, exist_ok=True)
    task_mod = sys.modules[ns.storenode.__name__.replace(
        ".rig.storenode", ".taskstore.task")]
    accepted, terminal = [], {}
    for shard in range(topo.shards):
        node = ns.storenode.StoreNode(topo, shard=shard, index=-1)
        try:
            ids = _shard_tasks(topo, shard, 6, "v")
            for tid in ids:
                node.store.upsert(task_mod.APITask(
                    task_id=tid, endpoint=topo.route, body=b"{}",
                    status=TaskStatus.CREATED,
                    backend_status=TaskStatus.CREATED, publish=False))
                accepted.append(tid)
            for tid in ids[:4]:
                node.store.update_status(tid, "completed - v",
                                         TaskStatus.COMPLETED)
                terminal[tid] = "completed - v"
            node.store.update_status(ids[4], "failed - v",
                                     TaskStatus.FAILED)
            terminal[ids[4]] = "failed - v"
            if shard == 1:
                node.store.update_status(ids[0], "completed - again",
                                         TaskStatus.COMPLETED)
        finally:
            node.store.close()
    terminal["never-journaled"] = "completed - v"
    with open(os.path.join(workdir, "loadgen-0.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"loadgen": 0, "accepted": accepted,
                   "terminal": terminal, "window": {"offered": 12}}, fh)


def test_compute_verdict_equal_on_either_package_s_journals(tmp_path):
    verdicts = {}
    for writer, ns in RIG.items():
        workdir = str(tmp_path / writer)
        _write_fleet_journals(ns, workdir)
        for reader, rns in RIG.items():
            topo = rns.topology.Topology(gateways=1, shards=2, replicas=1,
                                         dispatchers=1, workers=1,
                                         loadgens=1, workdir=workdir,
                                         collector=False)
            v = rns.verdict.compute_verdict(topo)
            for meta in v["per_shard"].values():
                meta["lineage"] = os.path.basename(meta["lineage"])
            verdicts[(writer, reader)] = v
    first = verdicts[("jax", "jax")]
    assert all(v == first for v in verdicts.values())
    assert not first["ok"]
    assert (first["accepted"], first["duplicates"]) == (12, 1)
    assert first["phantom_client_completions"] == ["never-journaled"]
    assert first["violation_count"] >= 2


class _NoStore:
    """The mesh worker's ring client for an in-process drive: results and
    completions land nowhere (the walk under test is the health one)."""

    async def set_result(self, *args, **kwargs) -> None:
        return None

    async def update_task_status_if(self, task_id, *args, **kwargs):
        return {"TaskId": task_id}

    async def append_ledger(self, *args, **kwargs) -> int:
        return 0

    async def aclose(self) -> None:
        return None


async def _mesh_walk(ns, workdir: str) -> list:
    from aiohttp.test_utils import TestClient, TestServer

    topo = ns.topology.Topology(shards=1, workers=1, mesh="dp=2",
                                mesh_poison_nths="2,3,4,9",
                                mesh_recovery_s=0.3, observability=False,
                                workdir=workdir)
    worker = ns.workernode.MeshEchoWorker(topo, shard=0)
    await worker.ring.aclose()
    worker.ring = _NoStore()
    steps = []
    async with TestClient(TestServer(worker.app)) as client:
        for i in range(12):
            if i == 7:
                await asyncio.sleep(topo.mesh_recovery_s + 0.1)
            async with client.post(topo.route, data=b"{}",
                                   headers={"taskId": f"t{i}"}) as r:
                body = await r.json()
            async with client.get("/healthz") as h:
                health = await h.json()
            steps.append((r.status, body.get("ok"),
                          (body.get("reason") or "")[:40],
                          health["mesh_healthy"]))
    return steps


def test_mesh_worker_poison_unhealthy_probe_healthy_equals_jax(tmp_path):
    got = {pkg: asyncio.run(_mesh_walk(ns, str(tmp_path)))
           for pkg, ns in RIG.items()}
    assert got["port"] == got["jax"]
    statuses = [s[0] for s in got["port"]]
    # Poisoned deliveries 503, the flipped endpoint 500s until its
    # recovery window ends, then the probe heals it.
    assert 503 in statuses and 500 in statuses
    assert got["port"][-1][3] is True
    assert any(not s[3] for s in got["port"])


# -- the vitals helpers and the wire refusal (JAX's cases, on the port) ---------


def test_soak_rss_rides_the_shared_helper():
    from ai4e_tpu_torch.observability.vitals import read_rss_mb
    from ai4e_tpu_torch.rig import soak

    assert soak.read_rss_mb is read_rss_mb
    assert soak._rss_mb(None) == -1.0
    if os.path.isdir("/proc/self"):
        assert soak._rss_mb(os.getpid()) == read_rss_mb(os.getpid())


def test_vitals_helpers_equal_jax(tmp_path):
    from ai4e_tpu.observability import vitals as jax_vitals
    from ai4e_tpu_torch.observability import vitals as port_vitals

    proc = tmp_path / "proc"
    (proc / "42" / "fd").mkdir(parents=True)
    (proc / "42" / "status").write_text("Name:\tx\nVmRSS:\t  20480 kB\n")
    os.symlink("socket:[777]", proc / "42" / "fd" / "3")
    os.symlink("/dev/null", proc / "42" / "fd" / "0")
    for pid in (42, 43):
        assert (port_vitals.read_rss_mb(pid, proc_root=str(proc))
                == jax_vitals.read_rss_mb(pid, proc_root=str(proc)))
        assert (sorted(port_vitals.proc_fd_links(pid, proc_root=str(proc)))
                == sorted(jax_vitals.proc_fd_links(pid,
                                                   proc_root=str(proc))))
    assert port_vitals.read_rss_mb(42, proc_root=str(proc)) == 20.0
    assert ("3", "socket:[777]") in port_vitals.proc_fd_links(
        42, proc_root=str(proc))


@pytest.mark.skipif(not os.path.isdir("/proc/self"),
                    reason="needs a Linux /proc")
def test_supervisor_fd_scan_rides_proc_fd_links():
    from ai4e_tpu_torch.rig.supervisor import pids_listening_on

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((HOST, 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        assert os.getpid() in pids_listening_on(port)
    assert os.getpid() not in pids_listening_on(port)


class _FakeResp:
    def __init__(self, status: int, headers: dict | None = None):
        self.status = status
        self.headers = headers or {}


def test_rig_wire_refusal_helper_equals_jax():
    from ai4e_tpu.rig.wire import _raise_refusal as jax_refusal
    from ai4e_tpu_torch.rig.wire import _raise_refusal
    from ai4e_tpu_torch.taskstore import NotPrimaryError

    def outcome(fn, resp):
        try:
            fn(resp)
        except Exception as exc:  # noqa: BLE001 — the raised type and words are compared
            return type(exc).__name__, str(exc)
        return None

    cases = [_FakeResp(503, {"Retry-After": "2"}), _FakeResp(503),
             _FakeResp(503, {"X-Not-Primary": "1"}),
             _FakeResp(409, {"X-Not-Owner": "1"}), _FakeResp(409),
             _FakeResp(200), _FakeResp(404)]
    for resp in cases:
        assert outcome(_raise_refusal, resp) == outcome(jax_refusal, resp)
    with pytest.raises(NotPrimaryError) as ei:
        _raise_refusal(_FakeResp(503, {"Retry-After": "2"}))
    assert "retry after 2s" in str(ei.value)
    with pytest.raises(NotPrimaryError):
        _raise_refusal(_FakeResp(409, {"X-Not-Owner": "1"}))


# -- the whole rig, from the port, on the CPU ----------------------------------


def test_rig_up_with_chaos_ends_with_the_verdict_ok(tmp_path):
    """``python -m ai4e_tpu_torch.rig up``: two gateways, two shards with a
    replica each, one dispatcher, worker and loadgen, the four faults of
    the seeded timeline, 8 s of load; its process group is bounded by a
    timeout and killed past it."""
    base = free_base_port()
    out = tmp_path / "artifact"
    argv = [sys.executable, "-m", "ai4e_tpu_torch.rig", "up",
            "--gateways", "2", "--shards", "2", "--replicas", "1",
            "--dispatchers", "1", "--workers", "1", "--loadgens", "1",
            "--rate", "200", "--duration", "8", "--ramp", "2",
            "--task-timeout", "30", "--seed", "20260803",
            "--base-port", str(base), "--workdir", str(tmp_path / "work"),
            "--out", str(out)]
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        stdout, _ = proc.communicate(timeout=150)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
        # The supervisor's children lead sessions of their own; a run cut
        # short leaves them to this sweep.
        for port in range(base, base + 100):
            from ai4e_tpu_torch.rig.supervisor import pids_listening_on
            for pid in pids_listening_on(port):
                os.kill(pid, 9)
    assert proc.returncode == 0, stdout[-4000:]
    result = json.loads((out / "rig.json").read_text())
    assert result["ok"] and result["verdict"]["ok"], stdout[-4000:]
    assert result["verdict"]["violation_count"] == 0
    assert result["verdict"]["accepted"] > 0
    assert ([(e["verb"], e.get("ok")) for e in result["chaos"]]
            == [("kill_gateway", True), ("kill_dispatcher", True),
                ("move_slot", True), ("kill_shard_primary", True)])
    assert (out / "ledgers.json").exists() and (out / "timeline.json").exists()


# -- every spawned child runs the port -----------------------------------------


def _spawned_module_strings(path: Path) -> list[tuple[int, str]]:
    """String literals that name a module a child runs: the first argument
    of ``python_argv(...)`` and the element after ``"-m"`` in a list or
    tuple literal."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if (isinstance(node, ast.Call) and node.args
                and getattr(node.func, "id",
                            getattr(node.func, "attr", None))
                == "python_argv"
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            found.append((node.lineno, node.args[0].value))
        if isinstance(node, (ast.List, ast.Tuple)):
            elts = node.elts
            for a, b in zip(elts, elts[1:]):
                if (isinstance(a, ast.Constant) and a.value == "-m"
                        and isinstance(b, ast.Constant)
                        and isinstance(b.value, str)):
                    found.append((b.lineno, b.value))
    return found


def test_no_spawned_module_names_the_jax_package():
    sources = sorted((ROOT / "ai4e_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    seen, bad = [], []
    for path in sources:
        for line, module in _spawned_module_strings(path):
            seen.append((path.name, module))
            if module.startswith("ai4e_tpu") and not module.startswith(
                    "ai4e_tpu_torch"):
                bad.append((str(path.relative_to(ROOT)), line, module))
    assert bad == []
    # The walk does find the rig's spawns.
    assert ("run.py", "ai4e_tpu_torch.rig") in seen
    assert ("soak.py", "ai4e_tpu_torch") in seen
