"""The port's examples (``ai4e_tpu_torch/examples``) against the JAX
package's (``examples/*.py``), each as a child process on the CPU.

Each pair is driven alike over HTTP and held to the same output: the echo
service's sync answer and its async task to ``completed - echoed N
bytes``, then a clean exit on SIGTERM (``APIService.run``'s drain); one
task through the async platform to ``completed - scored N bytes``; the
load generator's JSON summary keys (both clients against the port's
platform); the streaming pipeline's printed events in order: both stages'
chunks before their ``stage ... completed`` line and the terminal line,
the same token counts (the LMs' seed-0 weights)."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import requests

ROOT = Path(__file__).resolve().parent.parent
START_S = 90.0   # a child's server answers within this
RUN_S = 240.0    # a child that runs to its end does so within this


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env() -> dict:
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=f"{ROOT}{os.pathsep}"
                           f"{os.environ.get('PYTHONPATH', '')}")


def command(pkg: str, name: str) -> list[str]:
    if pkg == "jax":
        return [sys.executable, str(ROOT / "examples" / f"{name}.py")]
    return [sys.executable, "-m", f"ai4e_tpu_torch.examples.{name}"]


def start(pkg: str, name: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen(command(pkg, name) + list(args), cwd=ROOT,
                            env=env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait_up(url: str, proc: subprocess.Popen) -> None:
    deadline = time.monotonic() + START_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"exited {proc.returncode}: "
                                 f"{proc.stdout.read()[-3000:]}")
        try:
            requests.get(url, timeout=2)
            return
        except requests.ConnectionError:
            time.sleep(0.2)
    raise AssertionError(f"{url} not up within {START_S} s")


def stop(proc: subprocess.Popen) -> tuple[int, str]:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return proc.returncode, out


def poll_task(url: str, prefix: str = "completed") -> dict:
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        status = requests.get(url, timeout=10).json()
        if status["Status"].startswith(("completed", "failed")):
            assert status["Status"].startswith(prefix), status
            return status
        time.sleep(0.1)
    raise AssertionError(f"{url} did not finish")


def echo_run(pkg: str) -> dict:
    port = free_port()
    proc = start(pkg, "echo_service", str(port))
    base = f"http://127.0.0.1:{port}/v1/echo"
    try:
        wait_up(f"{base}/echo", proc)
        sync = requests.post(f"{base}/echo", data=b'{"hello":"world"}',
                             timeout=30).json()
        task = requests.post(f"{base}/echo-async", data=b'{"x":1}',
                             timeout=30).json()
        done = poll_task(f"{base}/task/{task['TaskId']}")
    finally:
        rc, out = stop(proc)
    return {"sync": sync, "task_keys": sorted(task),
            "status": done["Status"], "status_keys": sorted(done), "rc": rc,
            "out": out}


@pytest.fixture(scope="module")
def echo():
    return {pkg: echo_run(pkg) for pkg in ("jax", "torch")}


def test_echo_answers_as_jax_s(echo):
    assert echo["torch"]["sync"] == echo["jax"]["sync"] == {
        "echo": '{"hello":"world"}'}
    assert echo["torch"]["task_keys"] == echo["jax"]["task_keys"]


def test_echo_task_completes_as_jax_s(echo):
    assert echo["torch"]["status"] == echo["jax"]["status"] == \
        "completed - echoed 7 bytes"
    assert echo["torch"]["status_keys"] == echo["jax"]["status_keys"]


def test_echo_exits_cleanly_on_sigterm(echo):
    """``APIService.run``: aiohttp's runner takes the signal, the drain
    hook runs, the process exits 0, as JAX's does."""
    assert echo["torch"]["rc"] == echo["jax"]["rc"] == 0, echo["torch"]["out"]


def platform_run(pkg: str, payload: Path | None = None) -> dict:
    """One task through ``pkg``'s async platform; with ``payload``, both
    load generators against it too."""
    gw, be = free_port(), free_port()
    proc = start(pkg, "async_platform", str(gw), str(be))
    base = f"http://127.0.0.1:{gw}"
    out = {}
    try:
        wait_up(f"{base}/healthz", proc)
        task = requests.post(f"{base}/v1/camera-trap/detect",
                             data=b"\xff" * 1000, timeout=30).json()
        done = poll_task(f"{base}/v1/taskmanagement/task/{task['TaskId']}")
        out = {"task_keys": sorted(task), "status": done["Status"]}
        if payload is not None:
            out["loadgen"] = {p: loadgen_run(p, base, payload)
                              for p in ("jax", "torch")}
    finally:
        rc, log = stop(proc)
    out["printed"] = log.splitlines()[:1]
    return out


def loadgen_run(pkg: str, gateway: str, payload: Path) -> dict:
    proc = subprocess.run(
        command(pkg, "loadgen") + [
            "--gateway", gateway, "--path", "/v1/camera-trap/detect",
            "--payload", str(payload), "--concurrency", "4",
            "--duration", "2", "--ramp", "0.5", "--task-timeout", "30"],
        cwd=ROOT, env=env(), capture_output=True, text=True, timeout=RUN_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def platforms(tmp_path_factory):
    payload = tmp_path_factory.mktemp("loadgen") / "payload.bin"
    payload.write_bytes(b"\x01" * 64)
    return {"jax": platform_run("jax"),
            "torch": platform_run("torch", payload)}


def test_async_platform_completes_a_task_as_jax_s(platforms):
    assert platforms["torch"]["status"] == platforms["jax"]["status"] == \
        "completed - scored 1000 bytes"
    assert platforms["torch"]["task_keys"] == platforms["jax"]["task_keys"]


def test_async_platform_prints_its_ports_as_jax_s(platforms):
    for pkg in ("jax", "torch"):
        line, = platforms[pkg]["printed"]
        assert line.startswith("gateway on :") and ", backend on :" in line


def test_loadgen_summaries_have_jax_s_keys(platforms):
    port, jax_ = (platforms["torch"]["loadgen"][p] for p in ("torch", "jax"))
    assert sorted(port) == sorted(jax_)
    assert port["metric"] == "async_loadgen_throughput"
    assert port["completed"] > 0 and port["failed"] == 0, port
    assert port["client_errors"] == {}, port


def stream_lines(pkg: str) -> list[str]:
    args = ["--device", "cpu"] if pkg == "torch" else []
    proc = subprocess.run(command(pkg, "streaming_pipeline") + args,
                          cwd=ROOT, env=env(), capture_output=True,
                          text=True, timeout=RUN_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [line for line in proc.stdout.splitlines() if line.strip()]


@pytest.fixture(scope="module")
def streams():
    return {pkg: stream_lines(pkg) for pkg in ("jax", "torch")}


def event_order(lines: list[str]) -> list[str]:
    """The printed events with each run of chunks of a stage as one."""
    order = []
    for line in lines:
        if line.startswith("  chunk  ["):
            what = "chunk " + line.split("[")[1].split("]")[0]
        elif line.startswith(("  stage  [", "terminal:", "transcribe ",
                              "warming ")):
            what = line.strip()
        else:
            continue
        if not order or order[-1] != what:
            order.append(what)
    return order


def test_streaming_events_arrive_in_jax_s_order(streams):
    order = event_order(streams["torch"])
    assert order == event_order(streams["jax"])
    assert order.index("chunk transcribe") < order.index(
        "stage  [transcribe] completed") < order.index("chunk summarize") \
        < order.index("stage  [summarize] completed")
    assert order[-2].startswith("terminal: completed")


def test_streaming_token_counts_are_jax_s(streams):
    assert streams["torch"][-1] == streams["jax"][-1]
    assert streams["torch"][-1].startswith("transcribe streamed 24 tokens")
