"""The port's land-cover worker (``ai4e_tpu_torch.cli.build_worker``) served
behind aiohttp's test server on the CPU, against the JAX package's
``build_unet`` servable on the same weights, plus the port's isolation from
JAX and from the JAX package.

Widths are cut to (8, 16) and the tile to 32 so that a forward pass takes
milliseconds; the deployed widths are held against JAX in
``test_torch_unet.py``."""

import ast
import asyncio
import base64
import contextlib
import copy
import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu.runtime.families import build_unet as jax_build_unet
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.cli import build_control_plane, build_worker
from ai4e_tpu_torch.config import FrameworkConfig
from ai4e_tpu_torch.models import create_unet
from ai4e_tpu_torch.runtime.registry import ModelRuntime

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TILE = 32
WIDTHS = (8, 16)
PIXELS = TILE * TILE
PREFIX = "/v1/models"
NPY = {"Content-Type": "application/octet-stream"}
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "ai4e_tpu"}


def landcover_spec(**model_overrides) -> dict:
    """deploy/specs/models.json's land-cover entry at a small width."""
    model = {"family": "unet", "name": "landcover", "tile": TILE,
             "widths": list(WIDTHS), "num_classes": 4, "buckets": [1, 8],
             "sync_path": "/classify", "async_path": "/classify-async"}
    model.update(model_overrides)
    return {"service_name": "gpu-worker", "prefix": "v1/models",
            "models": [model]}


def npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def tiles(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, TILE, TILE, 3),
                                                np.uint8)


@pytest.fixture(scope="module")
def jax_landcover():
    """The JAX package's land-cover servable at the test width."""
    return jax_build_unet(tile=TILE, widths=WIDTHS, num_classes=4,
                          buckets=(1, 8))


@pytest.fixture(scope="module")
def checkpoint(jax_landcover, tmp_path_factory):
    """The JAX servable's params, saved flat for the port to restore."""
    path = tmp_path_factory.mktemp("ckpt") / "landcover.npz"
    convert.save_npz(jax.tree.map(np.asarray, jax_landcover.params),
                     str(path))
    return str(path)


def jax_answer(servable, image: np.ndarray) -> dict:
    """The JAX worker's JSON for one tile: apply_fn at bucket 1, then
    postprocess, through a JSON round trip as the wire does."""
    out = servable.apply_fn(servable.params, jnp.asarray(image[None]))
    result = servable.postprocess({k: np.asarray(v)[0] for k, v in out.items()})
    return json.loads(json.dumps(result))


@contextlib.asynccontextmanager
async def serving(worker, batcher):
    await batcher.start()
    client = TestClient(TestServer(worker.service.app))
    await client.start_server()
    try:
        yield client
    finally:
        await client.close()
        await batcher.stop()


async def poll(client, task_id: str, tries: int = 500) -> dict:
    for _ in range(tries):
        resp = await client.get(f"{PREFIX}/task/{task_id}")
        body = await resp.json()
        if body["Status"].startswith(("completed", "failed")):
            return body
        await asyncio.sleep(0.01)
    raise AssertionError(f"task {task_id} never finished: {body}")


def histogram(result: dict) -> np.ndarray:
    counts = np.zeros(4, np.int64)
    for cls, n in result["class_histogram"].items():
        counts[int(cls)] = n
    return counts


class TestServing:
    def test_sync_matches_jax_servable(self, jax_landcover, checkpoint):
        """Same weights, same tile: the JSON schema is JAX's, zero classes
        are left out, the counts sum to H*W and agree per class within 1%
        of the pixels (bfloat16 rounds at other places in the two
        frameworks, see test_torch_unet)."""
        worker, batcher, _ = build_worker(
            landcover_spec(checkpoint=checkpoint), device="cpu")
        images = tiles(3)

        async def main():
            async with serving(worker, batcher) as client:
                out = []
                for image in images:
                    resp = await client.post(f"{PREFIX}/classify",
                                             data=npy(image), headers=NPY)
                    assert resp.status == 200, await resp.text()
                    out.append(await resp.json())
                return out

        for image, got in zip(images, asyncio.run(main())):
            want = jax_answer(jax_landcover, image)
            assert set(got) == set(want) == {"class_histogram"}
            assert 0 not in got["class_histogram"].values()
            assert sum(got["class_histogram"].values()) == PIXELS
            diff = np.abs(histogram(got) - histogram(want)).max()
            assert diff <= 0.01 * PIXELS, (got, want)
        assert worker.runtime.models["landcover"].checkpoint_path == checkpoint

    def test_async_lifecycle_and_stored_result(self, checkpoint):
        worker, batcher, _ = build_worker(
            landcover_spec(checkpoint=checkpoint), device="cpu")
        statuses = []
        store = worker.store
        update = store.update_status

        def spy(task_id, status, backend_status=None):
            statuses.append(status)
            return update(task_id, status, backend_status)

        store.update_status = spy
        image = tiles(1, seed=1)[0]

        async def main():
            async with serving(worker, batcher) as client:
                resp = await client.post(f"{PREFIX}/classify-async",
                                         data=npy(image), headers=NPY)
                assert resp.status == 200
                created = await resp.json()
                assert set(created) == {"TaskId", "Status"}
                assert created["Status"] == "created"
                final = await poll(client, created["TaskId"])
                resp = await client.post(f"{PREFIX}/classify",
                                         data=npy(image), headers=NPY)
                return created["TaskId"], final, await resp.json()

        task_id, final, sync_answer = asyncio.run(main())
        assert final["Status"] == "completed - class_histogram"
        assert statuses == ["running - landcover inference",
                            "completed - class_histogram"]
        payload, content_type = store.get_result(task_id)
        assert content_type == "application/json"
        assert json.loads(payload) == sync_answer

    def test_bad_payload_fails_the_task(self):
        worker, batcher, _ = build_worker(landcover_spec(), device="cpu")

        async def main():
            async with serving(worker, batcher) as client:
                resp = await client.post(
                    f"{PREFIX}/classify-async",
                    data=npy(np.zeros((TILE, TILE + 1, 3), np.uint8)),
                    headers=NPY)
                return await poll(client, (await resp.json())["TaskId"])

        final = asyncio.run(main())
        assert final["Status"].startswith("failed - bad input")

    def test_concurrent_requests_share_one_bucket(self):
        """Eight requests inside one max_wait window ride one batch of the
        bucket-8 shape."""
        worker, batcher, _ = build_worker(landcover_spec(), device="cpu",
                                          max_wait_ms=200)
        runtime = worker.runtime
        run = runtime.run_batch_phases
        sizes = []

        def spy(name, batch):
            sizes.append(batch.shape[0])
            return run(name, batch)

        runtime.run_batch_phases = spy
        images = tiles(8, seed=2)

        async def main():
            async with serving(worker, batcher) as client:
                async def one(image):
                    resp = await client.post(f"{PREFIX}/classify",
                                             data=npy(image), headers=NPY)
                    return resp.status, await resp.json()
                return await asyncio.gather(*(one(i) for i in images))

        results = asyncio.run(main())
        assert sizes == [8]
        assert all(status == 200 for status, _ in results)
        assert all(sum(r["class_histogram"].values()) == PIXELS
                   for _, r in results)

    def test_over_the_cap_gets_503(self):
        """maximum_concurrent_requests=1: while the first request waits in
        the batcher, a second one is refused with Retry-After."""
        worker, batcher, _ = build_worker(
            landcover_spec(maximum_concurrent_requests=1), device="cpu",
            max_wait_ms=300)
        body = npy(tiles(1, seed=3)[0])

        async def main():
            async with serving(worker, batcher) as client:
                first = asyncio.ensure_future(client.post(
                    f"{PREFIX}/classify", data=body, headers=NPY))
                await asyncio.sleep(0.05)
                second = await client.post(f"{PREFIX}/classify", data=body,
                                           headers=NPY)
                return (await first).status, second.status, second.headers

        first, second, headers = asyncio.run(main())
        assert (first, second) == (200, 503)
        assert headers["Retry-After"] == "1"

    def test_health_models_metrics_and_classmap(self):
        worker, batcher, _ = build_worker(
            landcover_spec(return_classmap=True), device="cpu")
        image = tiles(1, seed=4)[0]

        async def main():
            async with serving(worker, batcher) as client:
                health = await (await client.get(f"{PREFIX}/")).json()
                listing = await (await client.get(f"{PREFIX}/models")).json()
                resp = await client.post(f"{PREFIX}/classify",
                                         data=npy(image), headers=NPY)
                result = await resp.json()
                metrics = await (await client.get("/metrics")).text()
                return health, listing, result, metrics

        health, listing, result, metrics = asyncio.run(main())
        assert health == {"service": "gpu-worker", "status": "healthy"}
        (model,) = listing["models"]
        assert model["name"] == "landcover"
        assert model["input_shape"] == [TILE, TILE, 3]
        assert model["input_dtype"] == "uint8"
        assert model["batch_buckets"] == [1, 8]
        assert model["endpoints"] == {"sync": f"{PREFIX}/classify",
                                      "async": f"{PREFIX}/classify-async"}
        from PIL import Image
        classmap = np.asarray(Image.open(io.BytesIO(
            base64.b64decode(result["classmap_png"]))))
        assert classmap.shape == (TILE, TILE)
        assert {str(c): int(n) for c, n in zip(*np.unique(
            classmap, return_counts=True))} == result["class_histogram"]
        assert 'ai4e_batch_size_count{model="landcover"} 1' in metrics
        # Off by default, as in the JAX package's worker.
        assert "ai4e_device_phase_seconds" not in metrics


#: Metric families of the JAX worker whose features the port lacks: none
#: since the per-generation rollout series (A6.3) are ported.
UNPORTED_METRICS: set = set()
ECHO_SPEC = {"service_name": "w", "prefix": "v1/models", "models": [
    {"family": "echo", "name": "echo", "sync_path": "/e",
     "async_path": "/e-async"}]}

#: JAX's ``build_worker`` of ``ECHO_SPEC`` in a fresh interpreter (its
#: registry is the process-wide one, which other tests fill), with
#: ``AI4E_OBSERVABILITY_HOP_LEDGER`` off and then on; prints the metric
#: families registered after each.
JAX_WORKER_METRICS = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from ai4e_tpu.cli import build_worker
from ai4e_tpu.config import FrameworkConfig
families = {}
for on in ("0", "1"):
    _, batcher, _ = build_worker(FrameworkConfig.from_env({
        "AI4E_OBSERVABILITY_HOP_LEDGER": on,
        "AI4E_RUNTIME_COMPILE_CACHE_DIR": sys.argv[2]}),
        json.loads(sys.argv[1]))
    families[on] = sorted(batcher.metrics._metrics)
print(json.dumps(families))
"""


@pytest.fixture(scope="module")
def jax_worker_metrics(tmp_path_factory) -> dict[str, set[str]]:
    out = subprocess.run(
        [sys.executable, "-c", JAX_WORKER_METRICS, json.dumps(ECHO_SPEC),
         str(tmp_path_factory.mktemp("xla_cache"))],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return {k: set(v) for k, v in
            json.loads(out.stdout.strip().splitlines()[-1]).items()}


class TestMetricSet:
    @pytest.mark.parametrize("phases", [False, True])
    def test_build_worker_registers_jax_s_families(self, phases,
                                                   jax_worker_metrics):
        """The worker ``build_worker`` assembles registers the JAX worker's
        metric families, but for unported features: by default, and with
        the device phases measured (JAX: ``AI4E_OBSERVABILITY_HOP_LEDGER``;
        the port: ``measure_phases``)."""
        _, batcher, _ = build_worker(copy.deepcopy(ECHO_SPEC), device="cpu",
                                     measure_phases=phases)
        assert batcher.measure_phases is phases
        assert set(batcher.metrics._metrics) == \
            jax_worker_metrics[str(int(phases))] - UNPORTED_METRICS

    @pytest.mark.parametrize("on", ["0", "1"])
    def test_hop_ledger_switch_registers_jax_s_families(
            self, on, jax_worker_metrics):
        """The same through JAX's own switch,
        ``AI4E_OBSERVABILITY_HOP_LEDGER``, which also makes the worker
        flush each request's hop ledger."""
        worker, batcher, _ = worker_of(
            ECHO_SPEC, AI4E_OBSERVABILITY_HOP_LEDGER=on)()
        assert batcher.measure_phases is (on == "1")
        assert worker.hop_ledger is (on == "1")
        assert set(batcher.metrics._metrics) == \
            jax_worker_metrics[on] - UNPORTED_METRICS


def worker_of(spec: dict, **env):
    """A builder of the port's worker from ``spec`` under the ``AI4E_*``
    variables ``env``."""
    return lambda: build_worker(copy.deepcopy(spec), device="cpu",
                                config=FrameworkConfig.from_env(env))


def control_plane_of(api: dict, **env):
    """A builder of the port's control plane serving one route ``api``
    under the ``AI4E_*`` variables ``env``."""
    route = {"prefix": "/v1/pub/x", "backend": "http://w/v1/models/x", **api}
    return lambda: build_control_plane(FrameworkConfig.from_env(env),
                                       {"apis": [route]})


class TestUnported:
    @pytest.mark.parametrize("build,match", [
        # The compressed wires serve (ROADMAP A9); a tile they cannot
        # encode raises at build time, naming the wire.
        (worker_of(landcover_spec(wire="yuv420", tile=33)),
         r"wire='yuv420' needs even dims, got 33x33"),
        (worker_of(landcover_spec(wire="dct", tile=40)),
         r"wire='dct' needs dims divisible by 16, got 40x40"),
        (worker_of(landcover_spec(checkpoint="landcover")),
         r"is not a \.npz: .*scripts/orbax_to_npz\.py SRC DST\.npz"),
        # Weighted backends serve (ROADMAP A18.8); an empty set reaches
        # normalize_backends' error (a presence check, as in JAX).
        (control_plane_of({"backends": []}),
         r"backend list is empty"),
        # The push transport serves (ROADMAP A18.3); a queue-transport knob
        # on its route is refused with JAX's text.
        (control_plane_of({"concurrency": 2}, AI4E_PLATFORM_TRANSPORT="push"),
         r"autoscale/retry_delay/concurrency are queue-transport knobs; "
         r"push retry policy is topic-wide"),
        # The journal serves (ROADMAP A18.1); the native store, which
        # has none, refuses it with JAX's text.
        (control_plane_of({}, AI4E_PLATFORM_JOURNAL_PATH="/j.jsonl",
                          AI4E_PLATFORM_NATIVE_STORE="1"),
         r"native_store has no journal; use journal_path with the Python "
         r"store or native_store without durability"),
        (worker_of(landcover_spec(), AI4E_RUNTIME_DONATE_BATCH="1"),
         r"AI4E_RUNTIME_DONATE_BATCH=True: batch donation, an XLA buffer "
         r"option \(ROADMAP A4"),
    ], ids=["yuv420", "dct", "orbax",
            "backends", "push", "journal", "donate"])
    def test_raises_and_names_itself(self, build, match):
        with pytest.raises(ValueError, match=match):
            build()


class TestServedKeys:
    """The ``pipeline_to`` and ``batch`` model keys, which earlier slices
    refused, served as the JAX worker serves them."""

    @pytest.mark.parametrize("gate,handed_off", [
        ("class_histogram", True), ("classmap_png", False)],
        ids=["gate-open", "gate-closed"])
    def test_pipeline_to_hands_off_or_completes(self, gate, handed_off):
        """An open ``when_nonempty`` gate stores the stage's result under
        ``?stage=landcover`` and republishes the task, same TaskId, to the
        next endpoint; a closed one completes it at this stage."""
        worker, batcher, _ = build_worker(landcover_spec(pipeline_to={
            "endpoint": "/v1/next-async", "when_nonempty": gate}),
            device="cpu")
        statuses = []
        store = worker.store
        update = store.update_status

        def spy(task_id, status, backend_status=None):
            statuses.append(status)
            return update(task_id, status, backend_status)

        store.update_status = spy
        image = tiles(1, seed=5)[0]

        async def main():
            async with serving(worker, batcher) as client:
                resp = await client.post(f"{PREFIX}/classify-async",
                                         data=npy(image), headers=NPY)
                task_id = (await resp.json())["TaskId"]
                for _ in range(500):
                    record = store.get(task_id).to_dict()
                    if record["Endpoint"] == "/v1/next-async" or \
                            record["Status"].startswith("completed"):
                        break
                    await asyncio.sleep(0.01)
                answer = await (await client.post(
                    f"{PREFIX}/classify", data=npy(image),
                    headers=NPY)).json()
                return task_id, record, answer

        task_id, record, answer = asyncio.run(main())
        staged = store.get_result(task_id, stage="landcover")
        if handed_off:
            assert record["Endpoint"] == "/v1/next-async"
            assert record["Status"] == "created"
            assert statuses[:2] == [
                "running - landcover inference",
                "running - landcover handing off to /v1/next-async"]
            assert json.loads(staged[0]) == answer
            assert store.get_result(task_id) is None
        else:
            assert record["Status"] == "completed - class_histogram"
            assert staged is None
            assert json.loads(store.get_result(task_id)[0]) == answer

    def test_batch_key_serves_the_batch_api(self):
        """``"batch": {"max_items": 8}``: a stack of tiles answered in
        order, each item the sync answer to the served limit; a stack over
        ``max_items`` refused."""
        worker, batcher, _ = build_worker(
            landcover_spec(batch={"max_items": 8}), device="cpu")
        stack = tiles(3, seed=6)

        async def main():
            async with serving(worker, batcher) as client:
                resp = await client.post(f"{PREFIX}/landcover-batch",
                                         data=npy(stack), headers=NPY)
                batch = await resp.json()
                singles = [await (await client.post(
                    f"{PREFIX}/classify", data=npy(x), headers=NPY)).json()
                    for x in stack]
                over = await client.post(f"{PREFIX}/landcover-batch",
                                         data=npy(tiles(9)), headers=NPY)
                listing = await (await client.get(f"{PREFIX}/models")).json()
                return batch, singles, over.status, await over.text(), listing

        batch, singles, status, text, listing = asyncio.run(main())
        assert batch["count"] == 3 and batch["failed"] == 0
        # Other bucket shapes than the single requests' (bfloat16 convs
        # round by batch shape): test_sync_matches_jax_servable's 1%.
        for item, single in zip(batch["items"], singles):
            diff = np.abs(histogram(item["result"]) - histogram(single)).max()
            assert diff <= 0.01 * PIXELS, (item, single)
        assert status == 500 and "exceeds max 8" in text
        endpoints = listing["models"][0]["endpoints"]
        assert endpoints["batch_sync"] == f"{PREFIX}/landcover-batch"
        assert endpoints["batch_async"] == f"{PREFIX}/landcover-batch-async"

    def test_camera_trap_entries_of_the_deploy_spec_build(self):
        """deploy/specs/models.json's ``megadetector`` (with
        ``pipeline_to`` and ``batch``) and ``species`` (with ``batch``)
        entries, less ``checkpoint``, build at the deployed widths."""
        spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
        models = [dict(m) for m in spec["models"]
                  if m["name"] in ("megadetector", "species")]
        for model in models:
            model.pop("checkpoint")
        worker, _, _ = build_worker({"service_name": "w",
                                     "prefix": spec["prefix"],
                                     "models": models}, device="cpu")
        served = worker._served
        assert served["megadetector"]["async"] == "/v1/models/detect-async"
        assert served["species"]["async"] == \
            "/v1/models/classify-species-async"
        assert served["species"]["batch_async"] == \
            "/v1/models/classify-species-batch-async"
        runtime = worker.runtime
        assert runtime.models["megadetector"].batch_buckets == (1, 8)
        assert runtime.models["species"].input_shape == (224, 224, 3)
        assert runtime.models["species"].input_dtype == np.uint8


def port_sources() -> list[Path]:
    return sorted((ROOT / "ai4e_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


class TestIsolation:
    def test_no_module_imports_jax_or_the_jax_package(self):
        found = []
        for path in port_sources():
            for node in ast.walk(ast.parse(path.read_text(), str(path))):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                found += [(path.name, n) for n in names
                          if n.split(".")[0] in FORBIDDEN]
        assert len(port_sources()) > 20
        assert found == []

    def test_every_module_imports_with_jax_blocked(self):
        code = (
            "import sys, importlib, pkgutil\n"
            f"for name in {sorted(FORBIDDEN)!r}:\n"
            "    sys.modules[name] = None\n"
            "import ai4e_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    ai4e_tpu_torch.__path__, 'ai4e_tpu_torch.')]\n"
            "for m in mods:\n"
            "    if m != 'ai4e_tpu_torch.__main__':  # it runs the CLI\n"
            "        importlib.import_module(m)\n"
            "print(len(mods))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert int(out.stdout.split()[-1]) >= 20

    def test_entry_points_default_to_cuda_and_raise_without_it(
            self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ModelRuntime()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_unet(widths=WIDTHS)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_worker(landcover_spec())
        assert ModelRuntime(device="cpu").device == torch.device("cpu")
