"""The port's multi-process serving bridge (``parallel/multihost.py``) in
real gloo process groups on the CPU, mirroring ``tests/test_multihost.py``:

- 2 and 4 ranks: rank 0 broadcasts batches, the others mirror; each
  follower fetches only its rows; the float16 wire; an injected fetch
  failure poisons exactly the follower's rows and the next batch heals
  (``tests/helpers/torch_multihost_proc.py``);
- ``python -m ai4e_tpu_torch worker`` twice with ``WORLD_SIZE=2``: the
  primary serves while the follower mirrors; with
  ``AI4E_RUNTIME_MESH_SPEC=sp=2`` the pair serves a SeqFormer whose
  sequence is split over the two ranks (ring attention), each answer
  equal to one device's on the same seed-0 weights within
  ``SP_LOGIT_ATOL``; ``AI4E_FAULT_FETCH_FAIL_NTHS`` on the follower fails
  only the affected tasks of a batch-API stack.

Every process group has its own timeout; a rank still running past it is
killed and the test fails."""

import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
from test_torch_parallel import free_port

from ai4e_tpu_torch.runtime.families import build_servable
from ai4e_tpu_torch.runtime.registry import ModelRuntime

ROOT = Path(__file__).resolve().parent.parent
PROC = ROOT / "tests" / "helpers" / "torch_multihost_proc.py"
GROUP_TIMEOUT_S = 240
UP_TIMEOUT_S = 120
#: ring attention (float32 blocks merged by logsumexp) against plain full
#: attention in bfloat16 on one device: the SeqFormer's logits.
SP_LOGIT_ATOL = 2e-2
SEQ = {"family": "seqformer", "name": "seq", "seq_len": 32, "vocab_size": 64,
       "dim": 32, "depth": 1, "heads": 2, "num_classes": 4, "buckets": [4],
       "sync_path": "/score", "async_path": "/score-async"}


def npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


class TestMultihostServing:
    def _run_procs(self, nprocs: int):
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, str(PROC), str(i), str(nprocs), port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT)
            for i in range(nprocs)]
        outs = []
        try:
            for p in procs:
                try:
                    out, _ = p.communicate(timeout=GROUP_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    out = b"(killed: past the group's timeout)"
                outs.append((p.returncode, out.decode(errors="replace")))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
        for rc, out in outs:
            assert rc == 0, f"rank failed rc={rc}\n{out[-4000:]}"
        assert "PRIMARY_OK" in outs[0][1]
        for i in range(1, nprocs):
            assert "FOLLOWER_OK" in outs[i][1]

    def test_two_process_broadcast_and_mirror(self):
        self._run_procs(2)

    def test_four_process_sharded_ingestion(self):
        self._run_procs(4)


def start_pair(spec: dict, tmp_path: Path, env_for=None):
    """Two ``python -m ai4e_tpu_torch worker`` ranks on one process group;
    returns ``(procs, base_url)`` once rank 0 answers."""
    spec_path = tmp_path / "models.json"
    spec_path.write_text(json.dumps(spec))
    master, wk_port = free_port(), free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(master), WORLD_SIZE="2", RANK=str(rank))
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        env.update((env_for or (lambda r: {}))(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ai4e_tpu_torch", "worker", "--models",
             str(spec_path), "--port", str(wk_port), "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=ROOT))
    base = f"http://127.0.0.1:{wk_port}"
    deadline = time.time() + UP_TIMEOUT_S
    while time.time() < deadline:
        if any(p.poll() is not None for p in procs):
            break
        try:
            with urllib.request.urlopen(f"{base}/{spec['prefix']}/",
                                        timeout=2):
                return procs, base
        except (urllib.error.URLError, OSError):
            time.sleep(0.5)
    raise AssertionError(drain(procs))


def stop_pair(procs) -> None:
    """SIGTERM the primary; both ranks must exit 0 (the follower on the
    shutdown sentinel)."""
    try:
        procs[0].send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=60)
        assert all(p.returncode == 0 for p in procs), drain(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def drain(procs) -> str:
    notes = []
    for i, p in enumerate(procs):
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)
        out = p.stdout.read().decode(errors="replace") if p.stdout else ""
        notes.append(f"rank {i}: rc={p.returncode}\n{out[-3000:]}")
    return "\n".join(notes)


def post(url: str, body: bytes, timeout: float = 60) -> dict:
    req = urllib.request.Request(url, data=body)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class TestMultihostWorkerCLI:
    def test_primary_serves_follower_mirrors(self, tmp_path):
        spec = {"service_name": "echo-mh", "prefix": "v1/echo",
                "models": [{"family": "echo", "name": "echo", "size": 8,
                            "buckets": [4], "sync_path": "/echo",
                            "async_path": "/echo-async"}]}
        # The axis knobs' branch: fsdp=2 leaves dp=1, and the batch still
        # splits over the two ranks (dp x fsdp).
        procs, base = start_pair(spec, tmp_path,
                                 lambda r: {"AI4E_RUNTIME_FSDP": "2"})
        try:
            with urllib.request.urlopen(f"{base}/v1/echo/models",
                                        timeout=10) as resp:
                entry = json.loads(resp.read())["models"][0]
            assert entry["batch_buckets"] == [4] and "mesh" not in entry
            out = post(f"{base}/v1/echo/echo",
                       npy(np.arange(8, dtype=np.float32)))
            assert out["echo"] == [float(i) for i in range(8)], out
        finally:
            stop_pair(procs)

    def test_sp2_pair_serves_the_seqformer_as_one_device(self, tmp_path):
        """``AI4E_RUNTIME_MESH_SPEC=sp=2``: the mesh entry on
        ``/v1/models`` and every answer's logits within ``SP_LOGIT_ATOL``
        of one device's (plain full attention) on the same weights."""
        spec = {"service_name": "seq-sp", "prefix": "v1/seq",
                "models": [SEQ]}
        seqs = np.random.default_rng(5).integers(0, 64, (6, 32))
        single = ModelRuntime("cpu")
        kw = {k: v for k, v in SEQ.items()
              if k not in ("family", "sync_path", "async_path")}
        servable = build_servable("seqformer", **dict(kw, attention="full"))
        single.register(servable)
        want = single.run_batch("seq", seqs.astype(np.int32))
        procs, base = start_pair(
            spec, tmp_path,
            lambda r: {"AI4E_RUNTIME_MESH_SPEC": "sp=2"})
        try:
            with urllib.request.urlopen(f"{base}/v1/seq/models",
                                        timeout=10) as resp:
                entry = json.loads(resp.read())["models"][0]
            assert entry["mesh"]["spec"] == "sp=2"
            assert entry["mesh"]["tier"] == "mesh-sp2"
            assert entry["mesh"]["process_count"] == 2
            for seq, ref in zip(seqs, want):
                out = post(f"{base}/v1/seq/score",
                           npy(seq.astype(np.uint16)))
                probs = np.exp(ref - ref.max())
                probs /= probs.sum()
                assert out["class_id"] == int(ref.argmax()) or (
                    np.sort(ref)[-1] - np.sort(ref)[-2] < SP_LOGIT_ATOL)
                assert abs(out["confidence"] - float(probs.max())) < \
                    SP_LOGIT_ATOL
        finally:
            stop_pair(procs)


class TestMultihostFaultInjection:
    def test_injected_fetch_failure_fails_the_affected_tasks(self, tmp_path):
        """The follower's first served fetch fails
        (``AI4E_FAULT_FETCH_FAIL_NTHS=1``; warmup fetches nothing): items
        on its rows fail with 'invalidated', the others complete, and the
        next stack is whole."""
        spec = {"service_name": "echo-mh", "prefix": "v1/echo",
                "models": [{"family": "echo", "name": "echo", "size": 8,
                            "buckets": [4], "batch": {"max_items": 8}}]}
        procs, base = start_pair(
            spec, tmp_path,
            lambda r: {"AI4E_FAULT_FETCH_FAIL_NTHS": "1"} if r == 1 else {})
        try:
            stack = npy(np.arange(32, dtype=np.float32).reshape(4, 8))
            first = post(f"{base}/v1/echo/echo-batch", stack)
            assert first["count"] == 4
            assert first["failed"] >= 1, first
            errors = [it["error"] for it in first["items"] if "error" in it]
            assert any("invalidated" in e for e in errors), errors
            good = [it for it in first["items"] if "error" not in it]
            assert good, first
            second = post(f"{base}/v1/echo/echo-batch", stack)
            assert second["failed"] == 0, second
        finally:
            stop_pair(procs)
