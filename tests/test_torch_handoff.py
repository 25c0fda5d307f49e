"""The camera-trap pipeline in the port: ``runtime.handoffs.crops_handoff``
against the JAX package's, and the spec-driven detector -> crops ->
species-batch composite (``cli.build_worker``'s ``pipeline_to`` and
``batch`` keys) through a control plane, under one TaskId, against the JAX
package's worker on the same weights.

The composite runs the deployment's shape at a small size (a 64 px
detector of widths 8 with ``score_threshold`` 0, so it always hands off,
and a 16 px species ResNet) in four pairings: the JAX worker behind the
JAX control plane in one process (the reference, as
``tests/test_crops_handoff.py`` runs it), the port's worker behind the
port's control plane in one process, and the port's worker over HTTP
behind the port's and behind the JAX package's control plane, whose task
store then carries the crops' npy body through its upsert as
``surrogateescape`` JSON."""

import asyncio
import copy
import io
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu.cli import build_control_plane as jax_build_control_plane
from ai4e_tpu.cli import build_worker as jax_build_worker
from ai4e_tpu.config import FrameworkConfig as JaxConfig
from ai4e_tpu.platform_assembly import LocalPlatform as JaxPlatform
from ai4e_tpu.platform_assembly import PlatformConfig as JaxPlatformConfig
from ai4e_tpu.runtime.families import build_detector as jax_build_detector
from ai4e_tpu.runtime.families import build_resnet as jax_build_resnet
from ai4e_tpu.runtime.handoffs import crops_handoff as jax_crops_handoff
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.cli import build_control_plane, build_worker
from ai4e_tpu_torch.config import FrameworkConfig
from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
from ai4e_tpu_torch.runtime.handoffs import crops_handoff

torch.set_num_threads(2)


def detections(*boxes, score=0.9):
    return {"detections": [
        {"box": list(b), "score": score, "class_id": 0} for b in boxes]}


def painted(shape, regions, fill=0, dtype=np.uint8):
    img = np.full(shape, fill, dtype)
    for (y0, y1, x0, x1), value in regions:
        img[y0:y1, x0:x1] = value
    return img


#: tests/test_crops_handoff.py's cases: (handoff kwargs, result, image).
HANDOFF_CASES = {
    "box-contents": (
        dict(crop_size=8), detections((10, 20, 30, 40)),
        painted((64, 64, 3), [((10, 30, 20, 40), (200, 50, 25))])),
    "clamped-and-degenerate": (
        dict(crop_size=4), detections((-10, -5, 40, 50), (5.2, 5.8, 5.4, 5.9)),
        painted((32, 32, 3), [], fill=128)),
    "empty": (dict(crop_size=4, max_crops=2, min_score=0.5),
              {"detections": []}, painted((16, 16, 3), [])),
    "below-min-score": (dict(crop_size=4, max_crops=2, min_score=0.5),
                        detections((0, 0, 8, 8), score=0.1),
                        painted((16, 16, 3), [])),
    "max-crops-cap": (dict(crop_size=4, max_crops=2, min_score=0.5),
                      detections((0, 0, 8, 8), (1, 1, 9, 9), (2, 2, 10, 10)),
                      painted((16, 16, 3), [])),
    "outside-image": (dict(crop_size=4), detections((40, 40, 50, 50)),
                      painted((32, 32, 3), [], fill=7)),
    "min-score-inclusive": (dict(crop_size=4, min_score=0.5),
                            detections((0, 0, 8, 8), score=0.5),
                            painted((16, 16, 3), [])),
    "min-score-strict-below": (dict(crop_size=4, min_score=0.5),
                               detections((0, 0, 8, 8), score=0.49999),
                               painted((16, 16, 3), [])),
    "first-n-in-order": (
        dict(crop_size=4, max_crops=2),
        detections((0, 0, 8, 8), (0, 8, 8, 16), (0, 16, 8, 24)),
        painted((32, 32, 3), [((0, 8, 0, 8), 10), ((0, 8, 8, 16), 20),
                              ((0, 8, 16, 24), 30)])),
    "no-detections-key": (dict(crop_size=4), {}, painted((8, 8, 3), [])),
    "detections-none": (dict(crop_size=4), {"detections": None},
                        painted((8, 8, 3), [])),
    "result-none": (dict(crop_size=4), None, painted((8, 8, 3), [])),
    "float-example": (dict(crop_size=4), detections((0, 0, 8, 8)),
                      np.full((16, 16, 3), 0.5, np.float32)),
}


class TestCropsHandoff:
    @pytest.mark.parametrize("case", sorted(HANDOFF_CASES))
    def test_same_bytes_as_jax(self, case):
        kwargs, result, image = HANDOFF_CASES[case]
        want = jax_crops_handoff("/v1/next", **kwargs)(
            copy.deepcopy(result), image.copy())
        got = crops_handoff("/v1/next", **kwargs)(copy.deepcopy(result),
                                                  image.copy())
        assert got == want
        if want is not None:
            stack = np.load(io.BytesIO(got[1]))
            assert stack.dtype == np.uint8
            assert stack.shape[1:] == (kwargs["crop_size"],) * 2 + (3,)

    def test_crop_holds_the_box(self):
        kwargs, result, image = HANDOFF_CASES["box-contents"]
        _, body = crops_handoff("/v1/next", **kwargs)(result, image)
        stack = np.load(io.BytesIO(body))
        assert stack[0, :, :, 0].min() > 150 and stack[0, :, :, 2].max() < 60


# -- the composite -----------------------------------------------------------

DET = {"family": "detector", "name": "det", "image_size": 64,
       "widths": [8, 8, 8], "score_threshold": 0.0, "max_detections": 4,
       "buckets": [1], "async_path": "/detect-async",
       "pipeline_to": {"endpoint": "/v1/crops/cls-batch-async",
                       "payload": "crops", "crop_size": 16, "max_crops": 3}}
CLS = {"family": "resnet", "name": "cls", "image_size": 16,
       "stage_sizes": [1], "width": 8, "num_classes": 4, "buckets": [4],
       "batch": {"async_path": "/cls-batch-async", "max_items": 8}}
#: A detector gated on a non-empty ``detections`` that replays the
#: original image to a second detector (an empty handoff body).
GATED = dict(DET, score_threshold=0.2, pipeline_to={
    "endpoint": "/v1/crops/det2-async", "when_nonempty": "detections"})
DET2 = dict(DET, name="det2", async_path="/det2-async")
del DET2["pipeline_to"]
SPECS = {"crops": [DET, CLS],
         "nothing-detected": [dict(DET, score_threshold=0.999), CLS],
         "replay-original": [GATED, DET2]}
SCORE_TOL = 0.0125   # test_torch_detector's
BOX_TOL = 0.6
LOGIT_ATOL = 5e-3    # test_torch_resnet's
CONF_ATOL = 1e-2
N_IMAGES = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def servable_kwargs(spec: dict) -> dict:
    return {k: v for k, v in spec.items()
            if k not in ("family", "async_path", "pipeline_to", "batch")}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Each model's JAX weights (its ``build_*`` at seed 0, which the JAX
    worker builds too) as a ``.npz`` the port's spec restores."""
    out = tmp_path_factory.mktemp("ckpt")
    builders = {"detector": jax_build_detector, "resnet": jax_build_resnet}
    paths = {}
    for spec in (DET, CLS):
        servable = builders[spec["family"]](**servable_kwargs(spec))
        path = str(out / f"{spec['family']}.npz")
        convert.save_npz(jax.tree.map(np.asarray, servable.params), path)
        paths[spec["family"]] = path
    return paths


def images() -> list[np.ndarray]:
    return [np.random.default_rng(seed).integers(0, 256, (64, 64, 3),
                                                 dtype=np.uint8)
            for seed in range(N_IMAGES)]


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


async def drive(gw, get_result) -> list[tuple]:
    """Each image through ``/v1/public/detect``: ``(final status, stage
    result, final result)``."""
    out = []
    for img in images():
        resp = await gw.post("/v1/public/detect", data=npy(img))
        assert resp.status == 200, await resp.text()
        tid = (await resp.json())["TaskId"]
        r = await gw.get(f"/v1/taskmanagement/task/{tid}",
                         params={"wait": "30"})
        final = await r.json()
        assert final["TaskId"] == tid
        out.append((final["Status"], await get_result(tid, "det"),
                    await get_result(tid, None)))
    return out


async def in_process(models: list[dict], port: bool, checkpoints=None):
    """The worker (the port's or JAX's) behind its own package's control
    plane in this process, as ``tests/test_crops_handoff.py`` wires it."""
    spec = {"service_name": "crops", "prefix": "v1/crops", "models": models}
    if port:
        for model in spec["models"]:
            model["checkpoint"] = checkpoints[model["family"]]
        platform = LocalPlatform(PlatformConfig(retry_delay=0.05))
        worker, batcher, _ = build_worker(spec, device="cpu")
    else:
        platform = JaxPlatform(JaxPlatformConfig(retry_delay=0.05))
        worker, batcher, _ = jax_build_worker(JaxConfig(), spec)
    worker.service.task_manager = platform.task_manager
    worker.store = platform.store
    await batcher.start()
    svc = TestClient(TestServer(worker.service.app))
    await svc.start_server()
    base = str(svc.make_url("")).rstrip("/")
    platform.publish_async_api("/v1/public/detect",
                               base + "/v1/crops/detect-async")
    for model in models[1:]:
        path = (model.get("batch", {}).get("async_path")
                or model["async_path"])
        platform.register_internal_route(base + "/v1/crops" + path)
    gw = TestClient(TestServer(platform.gateway.app))
    await gw.start_server()
    await platform.start()

    async def get_result(tid, stage):
        found = platform.store.get_result(tid, stage=stage)
        return None if found is None else json.loads(found[0])

    try:
        return await drive(gw, get_result)
    finally:
        await platform.stop()
        await batcher.stop()
        await gw.close()
        await svc.close()


async def over_http(models: list[dict], control_plane: str, checkpoints):
    """The port's worker with ``"taskstore"`` at a control plane (the
    port's or JAX's) over HTTP on loopback ports."""
    cp_port, wk_port = free_port(), free_port()
    worker_url = f"http://127.0.0.1:{wk_port}"
    routes = {"apis": [
        {"prefix": "/v1/public/detect", "mode": "async",
         "backend": worker_url + "/v1/crops/detect-async"}] + [
        {"backend": worker_url + "/v1/crops" + (
            m.get("batch", {}).get("async_path") or m["async_path"]),
         "mode": "async", "internal": True} for m in models[1:]]}
    env = {"AI4E_PLATFORM_RETRY_DELAY": "0.05"}
    if control_plane == "jax":
        platform = jax_build_control_plane(JaxConfig.from_env(env), routes)
    else:
        platform = build_control_plane(FrameworkConfig.from_env(env), routes)
    for model in models:
        model["checkpoint"] = checkpoints[model["family"]]
    worker, batcher, _ = build_worker(
        {"service_name": "crops", "prefix": "v1/crops",
         "taskstore": f"http://127.0.0.1:{cp_port}", "models": models},
        device="cpu")
    gw = TestClient(TestServer(platform.gateway.app, port=cp_port))
    await gw.start_server()
    await platform.start()
    await batcher.start()
    svc = TestServer(worker.service.app, port=wk_port)
    await svc.start_server()

    async def get_result(tid, stage):
        params = {"taskId": tid, **({"stage": stage} if stage else {})}
        r = await gw.get("/v1/taskstore/result", params=params)
        return json.loads(await r.read()) if r.status == 200 else None

    try:
        return await drive(gw, get_result)
    finally:
        await platform.stop()
        await batcher.stop()
        for client in (worker.service.task_manager, worker.store):
            await client.close()
        await svc.close()
        await gw.close()


@pytest.fixture(scope="module")
def reference():
    """The JAX worker's answers, per spec."""
    return {name: asyncio.run(in_process(copy.deepcopy(models), port=False))
            for name, models in SPECS.items()}


def clear(scores: list[float], k: int) -> bool:
    """Whether the reference's k-th detection is clear of its neighbours'
    scores by more than twice ``SCORE_TOL`` (its place in the order, and
    so its crop's, cannot move)."""
    return all(abs(scores[k] - scores[j]) > 2 * SCORE_TOL
               for j in (k - 1, k + 1) if 0 <= j < len(scores))


def crop_rect(box, h=64, w=64):
    y0, x0, y1, x1 = box
    y0 = int(np.clip(np.floor(y0), 0, h - 1))
    x0 = int(np.clip(np.floor(x0), 0, w - 1))
    return (y0, x0, int(np.clip(np.ceil(y1), y0 + 1, h)),
            int(np.clip(np.ceil(x1), x0 + 1, w)))


def species_logits(stage: dict, img: np.ndarray) -> np.ndarray:
    """The JAX species model's logits on the crops the JAX handoff makes
    of the reference's stage result."""
    servable = jax_build_resnet(**servable_kwargs(CLS))
    _, body = jax_crops_handoff("x", crop_size=16, max_crops=3)(stage, img)
    return np.asarray(servable.apply_fn(
        servable.params, jnp.asarray(np.load(io.BytesIO(body)))))


def assert_same_pipeline(got: list, want: list) -> int:
    """The port's ``(status, stage, final)`` per image against the JAX
    worker's; returns how many species items were held to the
    reference's."""
    checked = 0
    for img, (status, stage, final), (w_status, w_stage, w_final) in zip(
            images(), got, want):
        assert status == w_status == "completed - 3 images, 0 errors"
        dets, w_dets = stage["detections"], w_stage["detections"]
        assert len(dets) == len(w_dets) == 4
        assert final["count"] == min(len(dets), 3) and final["failed"] == 0
        scores = [d["score"] for d in w_dets]
        logits = species_logits(w_stage, img)
        for k, (d, w) in enumerate(zip(dets, w_dets)):
            if not clear(scores, k):
                continue
            assert d["class_id"] == w["class_id"]
            assert abs(d["score"] - w["score"]) <= SCORE_TOL
            np.testing.assert_allclose(d["box"], w["box"], rtol=0,
                                       atol=BOX_TOL)
            if k >= 3 or crop_rect(d["box"]) != crop_rect(w["box"]):
                continue  # another crop: the species answer may differ
            item, w_item = final["items"][k], w_final["items"][k]
            assert item["index"] == w_item["index"] == k
            top2 = np.sort(logits[k])[-2:]
            if top2[1] - top2[0] > 2 * LOGIT_ATOL:
                assert item["result"]["class_id"] == \
                    w_item["result"]["class_id"]
                assert item["result"]["label"] == w_item["result"]["label"]
            assert abs(item["result"]["confidence"]
                       - w_item["result"]["confidence"]) < CONF_ATOL
            checked += 1
    return checked


class TestCompositePipeline:
    @pytest.mark.parametrize("pairing", ["in-process", "port-control-plane",
                                         "jax-control-plane"])
    def test_crops_pipeline_matches_jax_worker(self, pairing, reference,
                                               checkpoints):
        models = copy.deepcopy(SPECS["crops"])
        if pairing == "in-process":
            got = asyncio.run(in_process(models, True, checkpoints))
        else:
            got = asyncio.run(over_http(models, pairing.split("-")[0],
                                        checkpoints))
        assert assert_same_pipeline(got, reference["crops"]) >= 1

    def test_nothing_detected_completes_at_the_detector(self, reference,
                                                        checkpoints):
        """The handoff returns None: the detector stage completes the task
        with its own (empty) result, and no stage result is stored."""
        got = asyncio.run(in_process(copy.deepcopy(SPECS["nothing-detected"]),
                                     True, checkpoints))
        for (status, stage, final), want in zip(got,
                                                reference["nothing-detected"]):
            assert (status, stage, final) == want
            assert status == "completed - detections"
            assert final == {"detections": []} and stage is None

    def test_gated_handoff_replays_the_original_body(self, reference,
                                                     checkpoints):
        """``when_nonempty`` with an empty body: the second detector gets
        the task's original image, so its answer is the first's."""
        got = asyncio.run(in_process(copy.deepcopy(SPECS["replay-original"]),
                                     True, checkpoints))
        for (status, stage, final), (w_status, w_stage, w_final) in zip(
                got, reference["replay-original"]):
            assert status == w_status == "completed - detections"
            assert (stage is None) == (w_stage is None)
            if stage is None:  # nothing at 0.2: the gate completed it
                assert final == {"detections": []}
                continue
            # det2 keeps every score (threshold 0) of the same image and
            # weights: the gated stage's detections lead its list.
            assert len(final["detections"]) == len(w_final["detections"]) == 4
            assert final["detections"][:len(stage["detections"])] == \
                stage["detections"]
