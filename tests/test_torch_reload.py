"""The port's worker verbs for hot reload and drain, over HTTP on the CPU,
against the JAX package's worker on the same requests:

- ``POST {prefix}/models/{name}/reload``: the answers for 200, 400, 403,
  404 and 409 (``tests/test_hot_reload.py``'s cases) are the JAX worker's,
  each body equal but for the checkpoint's path (an orbax directory there,
  a ``.npz`` here) and for a tree mismatch's wording (orbax's there);
- ``POST``/``GET {prefix}/worker/drain`` and ``POST {prefix}/worker/resume``:
  the same states, the same 503 + ``Retry-After`` + ``X-Draining`` refusals,
  a reload during a drain refused with 409 as JAX refuses it;
- the orbax round trip: the JAX package's ``save_params`` writes an orbax
  checkpoint of land cover and of longcontext weights at CI widths,
  ``scripts/orbax_to_npz.py`` converts it, the port's worker reloads the
  ``.npz``, and its answers equal those of JAX's worker reloaded from the
  orbax checkpoint (within ``test_torch_worker.py``'s and
  ``test_torch_seqformer.py``'s tolerances).
"""

import asyncio
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu.checkpoint import save_params
from ai4e_tpu.metrics.registry import MetricsRegistry as JaxMetrics
from ai4e_tpu.parallel import MeshSpec, make_mesh
from ai4e_tpu.runtime import InferenceWorker as JaxWorker
from ai4e_tpu.runtime import MicroBatcher as JaxBatcher
from ai4e_tpu.runtime import ModelRuntime as JaxRuntime
from ai4e_tpu.runtime import build_servable as jax_build
from ai4e_tpu_torch.convert import save_npz
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.runtime.batcher import MicroBatcher
from ai4e_tpu_torch.runtime.families import build_servable
from ai4e_tpu_torch.runtime.registry import ModelRuntime
from ai4e_tpu_torch.runtime.worker import InferenceWorker

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PREFIX = "/v1/echo"
TILE = 32
PIXELS = TILE * TILE
UNET = dict(name="landcover", tile=TILE, widths=(8, 16), num_classes=4,
            buckets=(1, 4))
SEQ = dict(name="longcontext", seq_len=128, input_dim=24, dim=32, depth=2,
           heads=2, num_classes=16, vocab_size=256, attention="flash",
           buckets=(1, 4))


def npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def echo_payload() -> bytes:
    return npy(np.arange(16, dtype=np.float32))


def jax_stack(family, kw, checkpoint_root=None, max_wait_ms=1.0):
    mesh = make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    runtime = JaxRuntime(mesh=mesh)
    servable = runtime.register(jax_build(family, **kw))
    runtime.warmup(parallel=False)
    batcher = JaxBatcher(runtime, max_wait_ms=max_wait_ms,
                         metrics=JaxMetrics())
    worker = JaxWorker("w", runtime, batcher, prefix=PREFIX,
                       metrics=JaxMetrics(), checkpoint_root=checkpoint_root)
    worker.serve_model(servable, sync_path="/run")
    return worker, batcher, servable


def port_stack(family, kw, checkpoint_root=None, max_wait_ms=1.0):
    runtime = ModelRuntime(device="cpu")
    servable = runtime.register(build_servable(family, **kw))
    runtime.warmup()
    metrics = MetricsRegistry()
    batcher = MicroBatcher(runtime, max_wait_ms=max_wait_ms, metrics=metrics)
    worker = InferenceWorker("w", runtime, batcher, prefix=PREFIX,
                             metrics=metrics, checkpoint_root=checkpoint_root)
    worker.serve_model(servable, sync_path="/run")
    return worker, batcher, servable


@contextlib.asynccontextmanager
async def serving(*stacks):
    """Start each (worker, batcher, servable)'s batcher and a test client;
    yields the clients in order."""
    clients = []
    try:
        for worker, batcher, _ in stacks:
            await batcher.start()
            client = TestClient(TestServer(worker.service.app))
            await client.start_server()
            clients.append(client)
        yield clients
    finally:
        for client in clients:
            await client.close()
        for _, batcher, _ in stacks:
            await batcher.stop()


async def answer(resp) -> tuple[int, object]:
    text = await resp.text()
    try:
        return resp.status, json.loads(text)
    except json.JSONDecodeError:
        return resp.status, text


def echo_checkpoints(tmp_path, params: dict, name: str) -> tuple[str, str]:
    """The same echo params tree as an orbax checkpoint (for JAX's worker)
    and a ``.npz`` (for the port's)."""
    orbax = str(tmp_path / name)
    save_params(orbax, {k: np.float32(v) if np.ndim(v) == 0 else v
                        for k, v in params.items()})
    npz = str(tmp_path / f"{name}.npz")
    save_npz(params, npz)
    return orbax, npz


class TestReloadAnswers:
    def test_reload_swaps_weights_and_bumps_version(self, tmp_path):
        orbax, npz = echo_checkpoints(tmp_path, {"scale": np.float32(3.0)},
                                      "echo_v2")

        async def main():
            stacks = (jax_stack("echo", dict(name="echo", size=16,
                                             buckets=(4,))),
                      port_stack("echo", dict(name="echo", size=16,
                                              buckets=(4,))))
            out = []
            async with serving(*stacks) as clients:
                for client, path in zip(clients, (orbax, npz)):
                    run = f"{PREFIX}/run"
                    before = await answer(await client.post(
                        run, data=echo_payload()))
                    reload = await answer(await client.post(
                        f"{PREFIX}/models/echo/reload",
                        json={"checkpoint": path}))
                    after = await answer(await client.post(
                        run, data=echo_payload()))
                    listing = await answer(await client.get(
                        f"{PREFIX}/models"))
                    again = await answer(await client.post(
                        f"{PREFIX}/models/echo/reload"))
                    out.append((before, reload, after, listing, again, path))
            return out

        (jax_out, port_out) = asyncio.run(main())
        for got, want in zip(port_out[:3], jax_out[:3]):
            if isinstance(want[1], dict) and "checkpoint" in want[1]:
                want = (want[0], {**want[1], "checkpoint": port_out[5]})
            assert got == want
        assert port_out[1] == (200, {"model": "echo", "checkpoint": port_out[5],
                                     "params_version": 2, "generation": 1})
        assert port_out[2][1]["echo"][:3] == [0.0, 3.0, 6.0]
        (entry,) = port_out[3][1]["models"]
        assert (entry["params_version"], entry["checkpoint"]) == (2, port_out[5])
        assert port_out[4][1]["params_version"] == jax_out[4][1][
            "params_version"] == 3

    @pytest.mark.parametrize("body,root", [
        (None, False),                                  # 400 no checkpoint
        (b"{", False),                                  # 400 invalid JSON
        (b"[1]", False),                                # 400 not an object
        ({"checkpoint": 5}, False),                     # 400 not a string
        ({"checkpoint": "relative/echo"}, False),       # 400 relative
        ({"checkpoint": "/elsewhere/echo.npz"}, True),  # 403 outside root
        ({"checkpoint": "ROOT/echo_v2", "generation": "x"}, False),  # 400
        ({"checkpoint": "ROOT/wrong"}, False),          # 409 tree mismatch
    ], ids=["no-checkpoint", "invalid-json", "not-object", "not-string",
            "relative", "outside-root", "bad-generation", "mismatch"])
    def test_refusals_equal_jax_s(self, tmp_path, body, root):
        echo_checkpoints(tmp_path, {"scale": np.float32(3.0)}, "echo_v2")
        echo_checkpoints(tmp_path, {"scale": np.zeros((3, 3), np.float32)},
                         "wrong")
        checkpoint_root = str(tmp_path) if root else None

        def request(port: bool):
            if isinstance(body, dict):
                b = dict(body)
                if isinstance(b.get("checkpoint"), str):
                    b["checkpoint"] = b["checkpoint"].replace(
                        "ROOT", str(tmp_path))
                    if port and b["checkpoint"].startswith(str(tmp_path)):
                        b["checkpoint"] += ".npz"
                return {"json": b}
            return {} if body is None else {"data": body}

        async def main():
            stacks = (jax_stack("echo", dict(name="echo", size=16,
                                             buckets=(4,)), checkpoint_root),
                      port_stack("echo", dict(name="echo", size=16,
                                              buckets=(4,)), checkpoint_root))
            async with serving(*stacks) as clients:
                out = []
                for port, client in zip((False, True), clients):
                    resp = await client.post(
                        f"{PREFIX}/models/echo/reload", **request(port))
                    served = await answer(await client.post(
                        f"{PREFIX}/run", data=echo_payload()))
                    out.append((await answer(resp), served))
                return out

        (want, want_served), (got, got_served) = asyncio.run(main())
        if got[0] == 409:
            # JAX's refusal comes from orbax's restore onto the served tree
            # (a shape it cannot restore), the port's from the trees'
            # specs: the same status, each naming the mismatch.
            assert want[0] == 409 and "(3, 3)" in want[1]["error"]
            assert got[1]["error"] == (
                "checkpoint tree does not match the served model: served "
                "{'scale': ((), 'float32')} vs reload {'scale': ((3, 3), "
                "'float32')}")
        else:
            assert got == want, (got, want)
            assert got[0] in (400, 403)
        assert got_served == want_served  # serving unchanged
        assert got_served[1]["echo"][:3] == [0.0, 1.0, 2.0]

    def test_unknown_model_is_404_as_jax(self):
        async def main():
            stacks = (jax_stack("echo", dict(name="echo", size=16,
                                             buckets=(4,))),
                      port_stack("echo", dict(name="echo", size=16,
                                              buckets=(4,))))
            async with serving(*stacks) as clients:
                return [await answer(await c.post(
                    f"{PREFIX}/models/nope/reload")) for c in clients]

        want, got = asyncio.run(main())
        assert got == want == (404, {"error": "unknown model"})

    @pytest.mark.parametrize("what", ["orbax-dir", "missing-npz"])
    def test_unreadable_checkpoint_is_400_naming_the_converter(
            self, tmp_path, what):
        orbax, _ = echo_checkpoints(tmp_path, {"scale": np.float32(3.0)},
                                    "echo_v2")
        path = orbax if what == "orbax-dir" else str(tmp_path / "gone.npz")

        async def main():
            async with serving(port_stack("echo", dict(
                    name="echo", size=16, buckets=(4,)))) as (client,):
                return await answer(await client.post(
                    f"{PREFIX}/models/echo/reload",
                    json={"checkpoint": path}))

        status, body = asyncio.run(main())
        assert status == 400
        if what == "orbax-dir":
            assert "scripts/orbax_to_npz.py SRC DST.npz" in body["error"]
        else:
            assert body["error"].startswith("reload failed: FileNotFoundError")


class TestDrain:
    def test_drain_refuse_status_resume_equal_jax_s(self, tmp_path):
        _, npz = echo_checkpoints(tmp_path, {"scale": np.float32(3.0)}, "v2")

        async def one(client, path):
            out = {}
            out["drain"] = await answer(await client.post(
                f"{PREFIX}/worker/drain"))
            resp = await client.post(f"{PREFIX}/run", data=echo_payload())
            out["refused"] = (resp.status, {
                k: resp.headers.get(k) for k in
                ("Retry-After", "X-Draining", "X-Shed-Reason")})
            out["status"] = await answer(await client.get(
                f"{PREFIX}/worker/drain"))
            resp = await client.post(f"{PREFIX}/models/echo/reload",
                                     json={"checkpoint": path})
            out["reload"] = (await answer(resp),
                             resp.headers.get("X-Draining"))
            out["metrics_drained"] = "ai4e_rollout_drain_state 2" in await (
                await client.get("/metrics")).text()
            out["again"] = await answer(await client.post(
                f"{PREFIX}/worker/drain"))
            out["resume"] = await answer(await client.post(
                f"{PREFIX}/worker/resume"))
            out["served"] = await answer(await client.post(
                f"{PREFIX}/run", data=echo_payload()))
            out["metrics_active"] = "ai4e_rollout_drain_state 0" in await (
                await client.get("/metrics")).text()
            return out

        async def main():
            stacks = (jax_stack("echo", dict(name="echo", size=16,
                                             buckets=(4,))),
                      port_stack("echo", dict(name="echo", size=16,
                                              buckets=(4,))))
            async with serving(*stacks) as clients:
                return [await one(c, npz) for c in clients]

        want, got = asyncio.run(main())
        for out in (want, got):
            out["drain"][1].pop("drain_s")
            out["again"][1].pop("drain_s")
        assert got["drain"] == want["drain"] == (200, {
            "state": "drained", "retired": 0, "forced": 0, "clean": True})
        assert got["again"] == want["again"]
        assert got["refused"] == want["refused"] == (503, {
            "Retry-After": "1", "X-Draining": "1",
            "X-Shed-Reason": "draining at worker"})
        # The whole of JAX's status, ``decode_active`` included.
        assert got["status"][1] == want["status"][1]
        assert got["status"][1]["state"] == "drained"
        assert got["reload"] == want["reload"]
        assert got["reload"][0][0] == 409 and got["reload"][1] == "1"
        assert got["resume"] == want["resume"] == (200, {"state": "active"})
        assert got["served"] == want["served"]
        assert got["metrics_drained"] and got["metrics_active"]

    def test_uncut_requests_are_retired_with_503_as_jax(self):
        """A request waiting in the batcher's window when the drain begins
        is retired: the sync caller gets 503 + X-Draining, not a result."""
        async def one(stack, client):
            worker, batcher, _ = stack
            pending = asyncio.ensure_future(client.post(
                f"{PREFIX}/run", data=echo_payload()))
            for _ in range(200):
                if batcher.pending_count:
                    break
                await asyncio.sleep(0.005)
            drained = await answer(await client.post(f"{PREFIX}/worker/drain"))
            resp = await pending
            return (drained[1]["retired"], resp.status,
                    resp.headers.get("X-Draining"), batcher.drain_complete)

        async def main():
            stacks = (jax_stack("echo", dict(name="echo", size=16,
                                             buckets=(4,)), max_wait_ms=5000),
                      port_stack("echo", dict(name="echo", size=16,
                                              buckets=(4,)), max_wait_ms=5000))
            async with serving(*stacks) as clients:
                return [await one(s, c) for s, c in zip(stacks, clients)]

        want, got = asyncio.run(main())
        assert got == want == (1, 503, "1", True)


def convert_with_script(orbax: str, npz: str) -> None:
    out = subprocess.run([sys.executable, str(ROOT / "scripts/orbax_to_npz.py"),
                          orbax, npz], capture_output=True, text=True,
                         timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith(f"to {npz}")


def new_params(family: str, seed: int) -> dict:
    if family == "unet":
        from ai4e_tpu.models.unet import create_unet
        _, params = create_unet(jax.random.PRNGKey(seed), tile=TILE,
                                num_classes=UNET["num_classes"],
                                widths=UNET["widths"])
    else:
        from ai4e_tpu.models.seqformer import create_seqformer
        keys = ("seq_len", "input_dim", "dim", "depth", "heads",
                "num_classes", "vocab_size", "attention")
        _, params = create_seqformer(jax.random.PRNGKey(seed),
                                     **{k: SEQ[k] for k in keys})
    return jax.tree.map(np.asarray, params)


def landcover_payloads():
    return [npy(img) for img in np.random.default_rng(4).integers(
        0, 256, (3, TILE, TILE, 3), np.uint8)]


def longcontext_payloads():
    return [npy(seq) for seq in np.random.default_rng(4).integers(
        0, SEQ["vocab_size"], (3, SEQ["seq_len"])).astype(np.uint16)]


def same_landcover(got: dict, want: dict) -> None:
    counts = [np.array([r["class_histogram"].get(str(c), 0)
                        for c in range(UNET["num_classes"])]) for r in (got, want)]
    assert sum(counts[0]) == PIXELS
    assert np.abs(counts[0] - counts[1]).max() <= 0.01 * PIXELS, (got, want)


def same_longcontext(got: dict, want: dict) -> None:
    assert got["class_id"] == want["class_id"], (got, want)
    assert abs(got["confidence"] - want["confidence"]) <= 1e-2


class TestOrbaxRoundTrip:
    @pytest.mark.parametrize("family,kw,payloads,same", [
        ("unet", UNET, landcover_payloads, same_landcover),
        ("seqformer", SEQ, longcontext_payloads, same_longcontext),
    ], ids=["landcover", "longcontext"])
    def test_converted_checkpoint_serves_jax_s_answers(
            self, tmp_path, family, kw, payloads, same):
        orbax = str(tmp_path / f"{kw['name']}_v2")
        save_params(orbax, new_params(family, seed=11))
        npz = str(tmp_path / f"{kw['name']}_v2.npz")
        convert_with_script(orbax, npz)
        headers = {"Content-Type": "application/octet-stream"}

        async def one(client, path):
            before = [await answer(await client.post(
                f"{PREFIX}/run", data=p, headers=headers)) for p in payloads()]
            reload = await answer(await client.post(
                f"{PREFIX}/models/{kw['name']}/reload",
                json={"checkpoint": path}))
            after = [await answer(await client.post(
                f"{PREFIX}/run", data=p, headers=headers)) for p in payloads()]
            return before, reload, after

        async def main():
            stacks = (jax_stack(family, kw, checkpoint_root=str(tmp_path)),
                      port_stack(family, kw, checkpoint_root=str(tmp_path)))
            async with serving(*stacks) as clients:
                return [await one(c, p) for c, p in zip(clients, (orbax, npz))]

        (jb, jr, ja), (pb, pr, pa) = asyncio.run(main())
        assert jr[0] == pr[0] == 200, (jr, pr)
        assert pr[1] == {**jr[1], "checkpoint": npz}
        for got, want in zip(pa, ja):
            assert got[0] == want[0] == 200
            same(got[1], want[1])
        assert [a[1] for a in pa] != [b[1] for b in pb]  # new weights serve
