"""The platform's async main path as separate OS processes joined only by
HTTP, as ``tests/test_cli_multiprocess.py`` runs the JAX package's: a
control plane (``python -m <package> control-plane``) and a worker
(``python -m <package> worker`` with ``"taskstore"``), in three pairings:

(a) the port's control plane and the port's worker (``--device cpu``);
(b) the JAX package's control plane and the port's worker;
(c) the port's control plane and the JAX package's worker.

The worker serves land cover (widths 8/16, tile 32) and longcontext (the
CI geometry of ``test_torch_seqformer.py``); the port's worker restores the
JAX servables' params through ``convert.save_npz``, the JAX worker draws
the same params from its own seed. Sync and async answers through the
gateway are held against the JAX servables in this process, to the
tolerances of ``test_torch_worker.py`` and ``test_torch_seqformer.py``."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ai4e_tpu.runtime.families import build_seqformer as jax_build_seqformer
from ai4e_tpu.runtime.families import build_unet as jax_build_unet
from ai4e_tpu_torch import convert

ROOT = Path(__file__).resolve().parent.parent
TILE, WIDTHS = 32, (8, 16)
SEQ = dict(seq_len=256, input_dim=24, dim=64, depth=2, heads=2)
VOCAB = 512
N_SYNC, N_ASYNC = 2, 4
DEADLINE_S = 240.0  # for any one process to come up or go down


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def npy(arr: np.ndarray) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def http(url: str, data: bytes | None = None) -> bytes:
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/octet-stream"} if data else {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read()


@pytest.fixture(scope="module")
def jax_servables():
    return {
        "landcover": jax_build_unet(tile=TILE, widths=WIDTHS, num_classes=4,
                                    buckets=(1, 8)),
        "longcontext": jax_build_seqformer(**SEQ, vocab_size=VOCAB,
                                           attention="flash", buckets=(1, 4)),
    }


@pytest.fixture(scope="module")
def checkpoints(jax_servables, tmp_path_factory):
    out = {}
    for name, servable in jax_servables.items():
        path = tmp_path_factory.mktemp("ckpt") / f"{name}.npz"
        convert.save_npz(jax.tree.map(np.asarray, servable.params), str(path))
        out[name] = str(path)
    return out


def models_spec(store_url: str, checkpoints: dict | None) -> dict:
    """deploy/specs/models.json's landcover and longcontext entries at the
    test widths, behind the control plane at ``store_url``."""
    models = [
        {"family": "unet", "name": "landcover", "tile": TILE,
         "widths": list(WIDTHS), "num_classes": 4, "buckets": [1, 8],
         "sync_path": "/classify", "async_path": "/classify-async"},
        {"family": "seqformer", "name": "longcontext", **SEQ,
         "num_classes": 16, "vocab_size": VOCAB, "attention": "flash",
         "buckets": [1, 4], "sync_path": "/score",
         "async_path": "/score-async"},
    ]
    if checkpoints:
        for model in models:
            model["checkpoint"] = checkpoints[model["name"]]
    return {"service_name": "gpu-worker", "prefix": "v1/models",
            "taskstore": store_url, "models": models}


def routes_spec(worker_url: str) -> dict:
    """deploy/specs/routes.json's land-cover and longcontext routes, without
    ``autoscale``."""
    be = worker_url + "/v1/models"
    return {"apis": [
        {"prefix": "/v1/landcover/classify-async",
         "backend": be + "/classify-async", "mode": "async",
         "concurrency": 4, "retry_delay": 0.05},
        {"prefix": "/v1/landcover/classify", "backend": be + "/classify",
         "mode": "sync"},
        {"prefix": "/v1/longcontext/score-async",
         "backend": be + "/score-async", "mode": "async", "concurrency": 8,
         "retry_delay": 0.05},
        {"prefix": "/v1/longcontext/score", "backend": be + "/score",
         "mode": "sync"},
    ]}


def child_env(jax_side: bool) -> dict:
    """The children's environment: one compute thread each and one JAX
    device (not the suite's virtual eight), since the suite runs beside
    other test processes on the same cores."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("AI4E_")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               AI4E_PLATFORM_RETRY_DELAY="0.05", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    if jax_side:
        env.update(JAX_PLATFORMS="cpu", AI4E_RUNTIME_PLATFORM="cpu")
    return env


def wait_up(url: str, proc: subprocess.Popen, log: Path) -> None:
    deadline = time.time() + DEADLINE_S
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"{url}: process exited {proc.returncode}:\n"
                                 + log.read_text()[-3000:])
        try:
            http(url)
            return
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.2)
    raise AssertionError(f"{url} never came up:\n" + log.read_text()[-3000:])


def landcover_answer(servable, image: np.ndarray) -> dict:
    out = servable.apply_fn(servable.params, jnp.asarray(image[None]))
    return json.loads(json.dumps(servable.postprocess(
        {k: np.asarray(v)[0] for k, v in out.items()})))


def longcontext_answer(servable, seq: np.ndarray) -> dict:
    logits = servable.apply_fn(servable.params,
                               jnp.asarray(seq[None].astype(np.int32)))
    return json.loads(json.dumps(servable.postprocess(np.asarray(logits)[0])))


def check_histogram(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"class_histogram"}
    assert 0 not in got["class_histogram"].values()
    assert sum(got["class_histogram"].values()) == TILE * TILE
    counts = [np.array([h["class_histogram"].get(str(c), 0)
                        for c in range(4)]) for h in (got, want)]
    assert np.abs(counts[0] - counts[1]).max() <= 0.01 * TILE * TILE, (got,
                                                                       want)


def check_score(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"class_id", "confidence"}
    assert got["class_id"] == want["class_id"]
    assert abs(got["confidence"] - want["confidence"]) <= 1e-2


PAIRINGS = {
    "port-port": ("ai4e_tpu_torch", "ai4e_tpu_torch"),
    "jax-port": ("ai4e_tpu", "ai4e_tpu_torch"),
    "port-jax": ("ai4e_tpu_torch", "ai4e_tpu"),
}


@pytest.mark.parametrize("pairing", list(PAIRINGS))
def test_control_plane_and_worker_as_processes(pairing, jax_servables,
                                               checkpoints, tmp_path):
    cp_pkg, wk_pkg = PAIRINGS[pairing]
    cp_port, wk_port = free_port(), free_port()
    cp_url, wk_url = (f"http://127.0.0.1:{cp_port}",
                      f"http://127.0.0.1:{wk_port}")
    port_worker = wk_pkg == "ai4e_tpu_torch"
    (tmp_path / "models.json").write_text(json.dumps(
        models_spec(cp_url, checkpoints if port_worker else None)))
    (tmp_path / "routes.json").write_text(json.dumps(routes_spec(wk_url)))
    cp_cmd = [sys.executable, "-m", cp_pkg, "control-plane",
              "--routes", str(tmp_path / "routes.json"), "--port",
              str(cp_port)]
    wk_cmd = [sys.executable, "-m", wk_pkg, "worker",
              "--models", str(tmp_path / "models.json"), "--port",
              str(wk_port)] + (["--device", "cpu"] if port_worker else [])
    logs = {"cp": tmp_path / "cp.log", "wk": tmp_path / "wk.log"}
    procs = {}
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (N_SYNC + N_ASYNC, TILE, TILE, 3), np.uint8)
    seqs = rng.integers(0, VOCAB, (N_SYNC + N_ASYNC, SEQ["seq_len"]),
                        dtype=np.uint16)
    try:
        for name, cmd, jax_side in (("cp", cp_cmd, cp_pkg == "ai4e_tpu"),
                                    ("wk", wk_cmd, not port_worker)):
            with open(logs[name], "wb") as log:
                procs[name] = subprocess.Popen(
                    cmd, cwd=ROOT, env=child_env(jax_side), stdout=log,
                    stderr=subprocess.STDOUT)
        wait_up(cp_url + "/healthz", procs["cp"], logs["cp"])
        wait_up(wk_url + "/v1/models/", procs["wk"], logs["wk"])

        for model, data, answer, check in (
                ("landcover", images, landcover_answer, check_histogram),
                ("longcontext", seqs, longcontext_answer, check_score)):
            api = {"landcover": "/v1/landcover/classify",
                   "longcontext": "/v1/longcontext/score"}[model]
            got = [json.loads(http(cp_url + api, npy(x)))
                   for x in data[:N_SYNC]]
            task_ids = [json.loads(http(cp_url + api + "-async",
                                        npy(x)))["TaskId"]
                        for x in data[N_SYNC:]]
            for task_id in task_ids:
                record = json.loads(http(
                    f"{cp_url}/v1/taskmanagement/task/{task_id}?wait=60"))
                want_status = ("completed - class_histogram"
                               if model == "landcover"
                               else "completed - class_id, confidence")
                assert record["Status"] == want_status, record
                assert record["BackendStatus"] == "completed", record
                got.append(json.loads(http(
                    f"{cp_url}/v1/taskstore/result?taskId={task_id}")))
            for x, result in zip(data, got):
                check(result, answer(jax_servables[model], x))

        procs["wk"].send_signal(signal.SIGTERM)
        assert procs["wk"].wait(timeout=DEADLINE_S) == 0, \
            logs["wk"].read_text()[-3000:]
        text = logs["wk"].read_text()
        if port_worker:
            assert " on cpu" in text, text[-3000:]
            # No kernel runs on the CPU: the plain versions serve there.
            assert ('kernel launches while serving {"normalize_image": 0, '
                    '"fused_seg_postprocess": 0, "flash_attention": 0}'
                    in text), text[-3000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
