"""Result offload on the port (``taskstore/results.py``, the store's
threshold, ``POST /v1/taskstore/result-ref``, ``DirectResultStore``)
against the JAX package's: the backends and the stores under one op
script give the same answers and leave the same files on disk; the
route answers with JAX's codes; a worker's ``DirectResultStore`` writes
straight to the result directory behind the port's and JAX's control
planes alike."""

import asyncio
import io
import json
import os
import socket
from urllib.parse import quote

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu.service.task_manager import DirectResultStore as JaxDirect
from ai4e_tpu.service.task_manager import HttpResultStore as JaxHttpResults
from ai4e_tpu.taskstore import APITask as JaxTask
from ai4e_tpu.taskstore import InMemoryTaskStore as JaxStore
from ai4e_tpu.taskstore.http import make_app as jax_make_app
from ai4e_tpu.taskstore.results import FileResultBackend as JaxBackend
from ai4e_tpu_torch.cli import _stores, build_control_plane, build_worker
from ai4e_tpu_torch.config import FrameworkConfig
from ai4e_tpu_torch.service.task_manager import (DirectResultStore,
                                                 HttpResultStore)
from ai4e_tpu_torch.taskstore import APITask, InMemoryTaskStore, TaskNotFound
from ai4e_tpu_torch.taskstore.http import make_app
from ai4e_tpu_torch.taskstore.results import FileResultBackend

THRESHOLD = 16
BIG = bytes(range(256)) * 4     # 1024 bytes: offloaded
SMALL = b'{"n": 1}'             # inline


def run(coro):
    return asyncio.run(coro)


def files(root) -> dict:
    """Every file under ``root`` with its bytes."""
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


PACKAGES = {
    "jax": (JaxBackend, JaxStore, JaxTask),
    "port": (FileResultBackend, InMemoryTaskStore, APITask),
}


def backend_script(backend_cls, root) -> list:
    backend = backend_cls(str(root))
    seen = []
    for key in ("t1", "t1:det", "t1:a/b", "t1:a%2Fb"):
        backend.put(key, BIG + key.encode(), "application/x-npy")
    seen.append(files(root))
    seen.append(backend.get("t1:a/b"))
    fh, ctype, size = backend.open("t1:det")
    with fh:
        seen.append((fh.read(), ctype, size))
    backend.put("t1", SMALL, "application/json")  # overwrite in place
    seen.append(backend.get("t1"))
    backend.delete("t1:det")
    backend.delete("never")
    seen.append((backend.get("t1:det"), backend.open("t1:det")))
    seen.append(files(root))
    return seen


def test_file_backends_write_the_same_files(tmp_path):
    want = backend_script(JaxBackend, tmp_path / "jax")
    got = backend_script(FileResultBackend, tmp_path / "port")
    assert got == want
    # Two stages that a lossy naming would merge stay two files.
    assert {"t1%3Aa%2Fb.bin", "t1%3Aa%252Fb.bin"} <= set(want[0])


def store_script(package: str, root) -> list:
    backend_cls, store_cls, task_cls = PACKAGES[package]
    backend = backend_cls(str(root))
    store = store_cls(result_backend=backend,
                      result_offload_threshold=THRESHOLD)
    seen = []
    for tid in ("a", "b", "c"):
        store.upsert(task_cls(task_id=tid, endpoint="/v1/x", body=b"x"))
    store.set_result("a", SMALL)                      # under: inline
    store.set_result("a", BIG, "application/x-npy", stage="det")  # over
    store.set_result("b", BIG)                        # exactly over
    store.set_result("b", BIG[:THRESHOLD], stage="edge")  # at: offloaded
    seen.append(files(root))
    seen.append(store.get_result("a"))
    seen.append(store.get_result("a", stage="det"))
    seen.append(store._results["a:det"][0])           # a pointer
    for tid, stage in (("a", None), ("a", "det"), ("b", "edge"),
                       ("zz", None)):
        found = store.open_result(tid, stage=stage)
        if found is None:
            seen.append(None)
            continue
        fh, ctype, size = found
        with fh:
            seen.append((fh.read(), ctype, size))
    # The pointer before its blob: refused, nothing becomes visible.
    with pytest.raises(FileNotFoundError):
        store.set_result_ref("c", "image/png", stage="ref")
    seen.append(store.get_result("c", stage="ref"))
    backend.put("c:ref", BIG, "image/png")
    store.set_result_ref("c", "image/png", stage="ref")
    seen.append(store.get_result("c", stage="ref"))
    with pytest.raises(FileNotFoundError):  # the blob is checked first
        store.set_result_ref("zz", "image/png")
    backend.put("zz", BIG, "image/png")
    with pytest.raises(KeyError):
        store.set_result_ref("zz", "image/png")
    backend.delete("zz")
    # An inline value supersedes a pointer: its blob goes.
    store.set_result("b", SMALL)
    seen.append(files(root))
    # An unknown task's blob is reaped after the refusal.
    with pytest.raises(KeyError):
        store.set_result("zz", BIG)
    seen.append(sorted(files(root)))
    # A memory-only record (a cache hit) keeps even a large result inline.
    hit = task_cls(task_id="h", endpoint="/v1/x", body=b"x")
    hit.durable = False
    store.upsert(hit)
    store.set_result("h", BIG)
    seen.append(store._results["h"][0] == BIG)
    # Eviction forgets the records and deletes their blobs.
    for tid in ("a", "b", "c", "h"):
        store.update_status(tid, "completed")
    seen.append(store.evict_terminal_older_than(-1))
    seen.append(files(root))
    return seen


def test_stores_offload_alike(tmp_path):
    want = store_script("jax", tmp_path / "jax")
    got = store_script("port", tmp_path / "port")
    assert got == want
    assert sorted(want[0]) == sorted(
        f"{k}.{s}" for k in ("a%3Adet", "b", "b%3Aedge") for s in
        ("bin", "meta"))
    assert want[-1] == {}


def test_store_without_a_backend_refuses_a_ref():
    store = InMemoryTaskStore()
    store.upsert(APITask(task_id="a", endpoint="/v1/x"))
    with pytest.raises(RuntimeError, match="no result backend"):
        store.set_result_ref("a")
    store.set_result("a", BIG)
    assert store.get_result("a") == (BIG, "application/json")


# -- the HTTP surface ---------------------------------------------------------


async def serve(app):
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


REF_CASES = [
    pytest.param(b"{}", None, 400, id="no-task-id"),
    pytest.param(b"{not json", None, 400, id="invalid-json"),
    pytest.param(json.dumps({"TaskId": "zz"}).encode(), "zz", 404,
                 id="unknown"),
    pytest.param(json.dumps({"TaskId": "a", "Stage": "s"}).encode(), None,
                 409, id="blob-missing"),
    pytest.param(json.dumps({"TaskId": "a", "Stage": "w",
                             "ContentType": "image/png"}).encode(), "a:w",
                 200, id="registered"),
    pytest.param(json.dumps({"TaskId": "a"}).encode(), "no-backend", 400,
                 id="no-backend"),
]


@pytest.mark.parametrize("body,blob,code", REF_CASES)
def test_result_ref_answers_jax_s_codes(body, blob, code, tmp_path):
    async def answer(package):
        backend_cls, store_cls, task_cls = PACKAGES[package]
        app_maker = jax_make_app if package == "jax" else make_app
        root = tmp_path / package
        if blob == "no-backend":
            store = store_cls()
        else:
            backend = backend_cls(str(root))
            store = store_cls(result_backend=backend,
                              result_offload_threshold=THRESHOLD)
            if blob:
                backend.put(blob, BIG, "image/png")
        store.upsert(task_cls(task_id="a", endpoint="/v1/x"))
        client = await serve(app_maker(store))
        try:
            resp = await client.post("/v1/taskstore/result-ref", data=body)
            out = (resp.status, await resp.json())
            got = await client.get("/v1/taskstore/result",
                                   params={"taskId": "a", "stage": "w"})
            out += (got.status, await got.read(),
                    got.headers.get("Content-Type"))
        finally:
            await client.close()
        return out

    want = run(answer("jax"))
    assert run(answer("port")) == want
    assert want[0] == code
    assert (want[2], want[3]) == ((200, BIG) if code == 200 else (204, b""))


def test_result_ref_codes_are_the_expected_ones(tmp_path):
    """The same cases, each code spelled out for the port."""
    async def main():
        backend = FileResultBackend(str(tmp_path))
        store = InMemoryTaskStore(result_backend=backend,
                                  result_offload_threshold=THRESHOLD)
        store.upsert(APITask(task_id="a", endpoint="/v1/x"))
        backend.put("a:w", BIG, "image/png")
        backend.put("zz", BIG, "image/png")
        client = await serve(make_app(store))
        try:
            codes = []
            for payload in ({}, {"TaskId": "zz"},
                            {"TaskId": "a", "Stage": "s"},
                            {"TaskId": "a", "Stage": "w",
                             "ContentType": "image/png"}):
                resp = await client.post("/v1/taskstore/result-ref",
                                         json=payload)
                codes.append(resp.status)
            resp = await client.get("/v1/taskstore/result",
                                    params={"taskId": "a", "stage": "w"})
            assert (resp.status, await resp.read(),
                    resp.headers["Content-Length"]) == (200, BIG,
                                                        str(len(BIG)))
            assert codes == [400, 404, 409, 200]
        finally:
            await client.close()

    run(main())


def test_get_result_streams_an_offloaded_result_in_chunks(tmp_path):
    big = os.urandom(3 * 256 * 1024 + 5)

    async def main():
        store = InMemoryTaskStore(
            result_backend=FileResultBackend(str(tmp_path)),
            result_offload_threshold=THRESHOLD)
        store.upsert(APITask(task_id="a", endpoint="/v1/x"))
        store.set_result("a", big, "application/x-npy", stage="crops")
        client = await serve(make_app(store))
        try:
            resp = await client.get("/v1/taskstore/result",
                                    params={"taskId": "a", "stage": "crops"})
            assert resp.headers["Content-Type"] == "application/x-npy"
            assert await resp.read() == big
            resp = await client.get("/v1/taskstore/result",
                                    params={"taskId": "a"})
            assert resp.status == 204
        finally:
            await client.close()

    run(main())


# -- DirectResultStore against both control planes ----------------------------


DIRECTIONS = [
    pytest.param("port", "port", id="port-worker-port-store"),
    pytest.param("port", "jax", id="port-worker-jax-store"),
    pytest.param("jax", "port", id="jax-worker-port-store"),
]


@pytest.mark.parametrize("worker,plane", DIRECTIONS)
def test_direct_results_reach_the_store_as_pointers(worker, plane, tmp_path):
    async def main():
        backend_cls, store_cls, task_cls = PACKAGES[plane]
        app_maker = jax_make_app if plane == "jax" else make_app
        root = str(tmp_path / "results")
        store = store_cls(result_backend=backend_cls(root),
                          result_offload_threshold=THRESHOLD)
        for tid in ("a", "b"):
            store.upsert(task_cls(task_id=tid, endpoint="/v1/x"))
        client = await serve(app_maker(store))
        url = str(client.make_url("")).rstrip("/")
        direct_cls, http_cls = ((DirectResultStore, HttpResultStore)
                                if worker == "port"
                                else (JaxDirect, JaxHttpResults))
        direct = direct_cls(root, http_cls(url), threshold=THRESHOLD)
        try:
            await direct.set_result("a", BIG, "application/x-npy",
                                    stage="det")
            await direct.set_result("a", SMALL)
            assert sorted(os.listdir(root)) == ["a%3Adet.bin",
                                                "a%3Adet.meta"]
            assert store._results["a:det"] == (None, "application/x-npy")
            assert store.get_result("a") == (SMALL, "application/json")
            assert await direct.get_result("a", stage="det") == (
                BIG, "application/x-npy")
            # The store does not know the task: the blob is reaped.
            await direct.set_result("zz", BIG)
            assert sorted(os.listdir(root)) == ["a%3Adet.bin",
                                                "a%3Adet.meta"]
            # A worker on another directory: 409 raises, its blob goes.
            other = str(tmp_path / "elsewhere")
            stray = direct_cls(other, http_cls(url), threshold=THRESHOLD)
            with pytest.raises(Exception):
                await stray.set_result("b", BIG)
            assert os.listdir(other) == []
            assert store.get_result("b") is None
            await stray.close()
        finally:
            await direct.close()
            await client.close()

    run(main())


def test_worker_stores_follow_the_service_result_dir(tmp_path):
    env = {"AI4E_SERVICE_RESULT_DIR": str(tmp_path),
           "AI4E_SERVICE_RESULT_OFFLOAD_THRESHOLD": "32"}
    config = FrameworkConfig.from_env(env)
    _, results = _stores({"taskstore": "http://127.0.0.1:1"}, config)
    assert isinstance(results, DirectResultStore)
    assert (results.backend.root, results.threshold) == (str(tmp_path), 32)
    assert isinstance(results.inner, HttpResultStore)
    # A standalone worker's own store offloads itself.
    manager, store = _stores({}, config)
    assert manager.store is store
    store.upsert(APITask(task_id="a", endpoint="/v1/x"))
    store.set_result("a", BIG)
    assert store._results["a"][0] is None
    assert os.path.exists(os.path.join(str(tmp_path), "a.bin"))
    _, plain = _stores({"taskstore": "http://127.0.0.1:1"},
                       FrameworkConfig.from_env({}))
    assert isinstance(plain, HttpResultStore)


# -- the deploy spec's results against the threshold ---------------------------

#: The deploy spec's camera trap with its 16 crops of 224 px (a 2,408,576
#: byte npy stack, the species stage's task body), at a small detector and
#: a one-stage species ResNet; land cover at a small tile.
TRAP = [
    {"family": "detector", "name": "det", "image_size": 64,
     "widths": [8, 8, 8], "score_threshold": 0.0, "max_detections": 16,
     "buckets": [1], "async_path": "/detect-async",
     "pipeline_to": {"endpoint": "/v1/trap/cls-batch-async",
                     "payload": "crops", "crop_size": 224, "max_crops": 16}},
    {"family": "resnet", "name": "cls", "image_size": 224,
     "stage_sizes": [1], "width": 8, "num_classes": 4, "buckets": [16],
     "batch": {"async_path": "/cls-batch-async", "max_items": 16}},
    {"family": "unet", "name": "lc", "tile": 32, "widths": [8, 16],
     "num_classes": 4, "buckets": [1], "async_path": "/lc-async"}]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


async def drive_trap(root, threshold) -> tuple:
    """Two scenes through detect and two tiles through land cover behind
    the port's control plane, worker and control plane on one result
    directory; ``(results by store key, the species stage's task bodies,
    the files in the directory)``."""
    cp_port, wk_port = free_port(), free_port()
    worker_url = f"http://127.0.0.1:{wk_port}/v1/trap"
    env = {"AI4E_PLATFORM_RETRY_DELAY": "0.05",
           "AI4E_PLATFORM_RESULT_DIR": str(root),
           "AI4E_SERVICE_RESULT_DIR": str(root)}
    if threshold is not None:
        env["AI4E_PLATFORM_RESULT_OFFLOAD_THRESHOLD"] = str(threshold)
        env["AI4E_SERVICE_RESULT_OFFLOAD_THRESHOLD"] = str(threshold)
    config = FrameworkConfig.from_env(env)
    platform = build_control_plane(config, {"apis": [
        {"prefix": "/v1/public/detect", "mode": "async",
         "backend": worker_url + "/detect-async"},
        {"prefix": "/v1/public/lc", "mode": "async",
         "backend": worker_url + "/lc-async"},
        {"backend": worker_url + "/cls-batch-async", "mode": "async",
         "internal": True}]})
    worker, batcher, _ = build_worker(
        {"service_name": "trap", "prefix": "v1/trap",
         "taskstore": f"http://127.0.0.1:{cp_port}", "models": TRAP},
        device="cpu", config=config)
    gw = TestClient(TestServer(platform.gateway.app, port=cp_port))
    await gw.start_server()
    await platform.start()
    await batcher.start()
    svc = TestServer(worker.service.app, port=wk_port)
    await svc.start_server()
    results, bodies = {}, []
    try:
        for i in range(2):
            rng = np.random.default_rng(i)
            for route, size in (("detect", 64), ("lc", 32)):
                img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
                resp = await gw.post(f"/v1/public/{route}", data=npy(img))
                assert resp.status == 200, await resp.text()
                tid = (await resp.json())["TaskId"]
                resp = await gw.get(f"/v1/taskmanagement/task/{tid}",
                                    params={"wait": "30"})
                status = (await resp.json())["Status"]
                assert status.startswith("completed"), status
                for stage in ((None, "det") if route == "detect"
                              else (None,)):
                    params = {"taskId": tid,
                              **({"stage": stage} if stage else {})}
                    resp = await gw.get("/v1/taskstore/result",
                                        params=params)
                    assert resp.status == 200, (tid, stage, resp.status)
                    key = f"{tid}:{stage}" if stage else tid
                    results[key] = await resp.read()
                if route == "detect":
                    bodies.append(platform.store.get(tid).body)
    finally:
        await platform.stop()
        await batcher.stop()
        for client in (worker.service.task_manager, worker.store):
            await client.close()
        await svc.close()
        await gw.close()
    return results, bodies, files(root)


@pytest.mark.parametrize("threshold", [None, 96], ids=["default-1MiB", "96B"])
def test_deploy_spec_results_reach_the_directory_by_size(threshold,
                                                         tmp_path):
    """At the default 1 MiB no file is written: the 2.4 MB crops stack is
    the species stage's task body, and every result is a small JSON. At
    96 B each result of 96 B or more is one ``.bin`` of the bytes the
    store serves, and no other result has a file."""
    root = tmp_path / "results"
    root.mkdir()
    results, bodies, on_disk = run(drive_trap(root, threshold))
    assert len(results) == 6
    assert all(len(body) >= 16 * 224 * 224 * 3 > 1024 * 1024
               for body in bodies)
    assert max(len(r) for r in results.values()) < 1024 * 1024
    want = {quote(key, safe="") + ".bin": body
            for key, body in results.items()
            if threshold is not None and len(body) >= threshold}
    assert {n: b for n, b in on_disk.items() if n.endswith(".bin")} == want
    if threshold is not None:
        assert want and len(want) < len(results)


def test_unknown_task_result_is_refused_without_offload_too():
    store = InMemoryTaskStore()
    with pytest.raises(TaskNotFound):
        store.set_result("zz", BIG)


def test_platform_serves_offloaded_results(tmp_path):
    from ai4e_tpu_torch.metrics import MetricsRegistry
    from ai4e_tpu_torch.platform_assembly import (LocalPlatform,
                                                  PlatformConfig)

    platform = LocalPlatform(PlatformConfig(
        result_dir=str(tmp_path), result_offload_threshold=THRESHOLD),
        metrics=MetricsRegistry())
    platform.store.upsert(APITask(task_id="a", endpoint="/v1/x"))
    platform.store.set_result("a", BIG)
    assert sorted(os.listdir(tmp_path)) == ["a.bin", "a.meta"]
    assert platform.store.get_result("a") == (BIG, "application/json")


def test_result_backend_default_open_adapts_get():
    from ai4e_tpu_torch.taskstore.results import ResultBackend

    class Memory(ResultBackend):
        def get(self, key):
            return (b"xyz", "text/plain") if key == "k" else None

    fh, ctype, size = Memory().open("k")
    assert (fh.read(), ctype, size) == (b"xyz", "text/plain", 3)
    assert Memory().open("nope") is None


def test_make_app_route_table_has_the_new_routes():
    app = make_app(InMemoryTaskStore(), app=web.Application())
    routes = {(r.method, r.resource.canonical) for r in app.router.routes()}
    assert {("POST", "/v1/taskstore/result-ref"),
            ("POST", "/v1/taskstore/redrive")} <= routes
