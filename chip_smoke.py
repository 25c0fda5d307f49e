"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each of which raises on failure:

1. device: the card's name and power limit; CUDA must be present;
2. build: every CUDA C++ kernel of the served path, from ``ai4e_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   served shapes and at a ragged one, then timed (kernel, plain version,
   one-call library yardstick) with CUDA events, median of 25 runs;
4. end to end: the land-cover worker of ``deploy/specs/models.json`` (tile
   256, widths 64..512, buckets 1/16/64, random weights from seed 0) built
   and served by the same ``build_worker``/``serve`` code that
   ``python -m ai4e_tpu_torch worker`` runs, on a loopback port, driven over
   HTTP with sequential sync requests and concurrent async ones. Every
   histogram is checked against the plain ops applied on the card, both
   kernels must equal their plain versions on the served UNet's own logits,
   and each kernel must have launched during the run.

The last two lines of output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import io
import json
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
N_SYNC = 8
N_ASYNC = 192
COUNT_TOLERANCE = 0.01      # per-class share of a tile's pixels, see phase 4


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing --------------------------------------------------------------


def device_ms(fn, reps: int = 25) -> float:
    """Median device time of one ``fn()`` call, in ms. A spin kernel keeps
    the card busy while the host enqueues ``fn``'s launches, so the events
    bracket device work only, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 1: device -----------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return kind


# -- phase 2: build ------------------------------------------------------


def phase_build() -> None:
    from ai4e_tpu_torch.ops import _native

    t0 = time.perf_counter()
    per_source = _native.build()
    log(f"build: {time.perf_counter() - t0:.1f}s wall "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in per_source.items())})")
    for name in _native.SOURCES:
        for line in _native.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# -- phase 3: kernels ----------------------------------------------------


def check_normalize(shape, mean, std, gen) -> float:
    from ai4e_tpu_torch.ops import image_preprocess as ip

    x = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen)
    x = x.cuda()
    got = ip.normalize_image(x, mean, std)
    scale, bias = ip.channel_affine(mean, std, shape[-1])
    want = ip.normalize_image_plain(x, scale, bias)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"normalize {shape}: {got.shape} {got.dtype}")
    err = float((got - want).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"normalize {shape}: max abs err {err} > 1e-6")
    log(f"  normalize {tuple(shape)}: max abs err {err}")
    return err


def plant_ties_and_nans(logits: torch.Tensor, gen) -> torch.Tensor:
    """Ties between classes 0/1 and 2/3, a NaN at class 0 (wins) and NaNs
    at classes 1..3 (never win), on random pixels."""
    b, h, w, c = logits.shape
    flat = logits.view(-1, c)
    idx = torch.randperm(flat.shape[0], generator=gen)[:4 * 997]
    ties0, ties2, nan0, nan_rest = idx.view(4, -1)
    flat[ties0, 1] = flat[ties0, 0]
    flat[ties2, 3] = flat[ties2, 2]
    flat[nan0, 0] = float("nan")
    flat[nan_rest, 1 + torch.arange(len(nan_rest)) % (c - 1)] = float("nan")
    return logits


def check_seg(shape, dtype, with_classmap, gen, plant=False) -> float:
    from ai4e_tpu_torch.ops import seg_postprocess as sp

    logits = torch.randn(shape, generator=gen)
    if plant:
        plant_ties_and_nans(logits, gen)
    logits = logits.to(dtype).cuda()
    got = sp.fused_seg_postprocess(logits, with_classmap=with_classmap)
    want = sp.fused_seg_postprocess_plain(logits, with_classmap=with_classmap)
    torch.cuda.synchronize()
    if set(got) != set(want):
        raise AssertionError(f"seg {shape}: keys {set(got)} != {set(want)}")
    for key in want:
        if not torch.equal(got[key], want[key]):
            bad = int((got[key] != want[key]).sum())
            raise AssertionError(f"seg {shape} {dtype} {key}: {bad} differ")
    if int(got["counts"].sum()) != shape[0] * shape[1] * shape[2]:
        raise AssertionError(f"seg {shape}: counts do not sum to B*H*W")
    log(f"  seg {tuple(shape)} {str(dtype)[6:]} classmap={with_classmap}"
        f"{' ties+NaN' if plant else ''}: exact")
    return 0.0


def phase_kernels() -> list[dict]:
    from ai4e_tpu_torch.ops import image_preprocess as ip
    from ai4e_tpu_torch.ops import seg_postprocess as sp

    gen = torch.Generator().manual_seed(SEED)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    norm_err = max(check_normalize((64, 256, 256, 3), None, None, gen),
                   check_normalize((3, 250, 250, 3), mean, std, gen))
    seg_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for with_map in (False, True):
            seg_err = max(seg_err, check_seg((64, 256, 256, 4), dtype,
                                             with_map, gen))
            seg_err = max(seg_err, check_seg((3, 250, 250, 4), dtype,
                                             with_map, gen, plant=True))

    # Timing at the served shapes: bucket 64, default mean/std, counts only.
    x = torch.randint(0, 256, (64, 256, 256, 3), dtype=torch.uint8,
                      generator=gen).cuda()
    scale, bias = ip.channel_affine(None, None, 3)
    n = x.numel()
    norm_bound, norm_by = bound_ms(n * 1 + n * 4, 2 * n)
    norm = {
        "name": "normalize_image",
        "route": "cuda",
        "source": "ai4e_tpu_torch/csrc/image_preprocess.cu",
        "replaces": "ai4e_tpu/ops/pallas/image_preprocess.py:24 "
                    "(_normalize_kernel)",
        "shape": [64, 256, 256, 3],
        "ms": device_ms(lambda: ip.normalize_image(x)),
        "plain_ms": device_ms(lambda: ip.normalize_image_plain(x, scale, bias)),
        # No single PyTorch call widens uint8 and applies a per-channel
        # affine: the plain version is already the shortest library form.
        "library_ms": None,
        "bound_ms": norm_bound,
        "bound_by": norm_by,
        "max_abs_err": norm_err,
    }
    logits = torch.randn((64, 256, 256, 4), generator=gen).cuda()
    b, h, w, c = logits.shape
    seg_bound, seg_by = bound_ms(logits.numel() * 4 + b * c * 4,
                                 b * h * w * (c - 1))
    seg = {
        "name": "fused_seg_postprocess",
        "route": "cuda",
        "source": "ai4e_tpu_torch/csrc/seg_postprocess.cu",
        "replaces": "ai4e_tpu/ops/pallas/seg_postprocess.py:34 "
                    "(_argmax_kernel; with class_histogram :74)",
        "shape": [64, 256, 256, 4],
        "ms": device_ms(
            lambda: sp.fused_seg_postprocess(logits, with_classmap=False)),
        "plain_ms": device_ms(
            lambda: sp.fused_seg_postprocess_plain(logits, with_classmap=False)),
        # Yardstick only (argmax without the histogram); the port never
        # calls it, since torch.argmax lets a NaN win.
        "library_ms": device_ms(lambda: torch.argmax(logits, dim=-1)),
        "bound_ms": seg_bound,
        "bound_by": seg_by,
        "max_abs_err": seg_err,
    }
    for k in (norm, seg):
        log(f"  {k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} "
            f"ms, library {k['library_ms']} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']})")
    return [norm, seg]


# -- phase 4: end to end -------------------------------------------------


def landcover_spec() -> dict:
    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    model = dict(next(m for m in spec["models"] if m["name"] == "landcover"))
    model.pop("checkpoint")  # no weights in the repository: seed-0 random
    return {"service_name": spec["service_name"], "prefix": spec["prefix"],
            "models": [model]}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def reference_counts(servable, images: np.ndarray) -> np.ndarray:
    """The served function on the card through the plain ops, in batches
    of the largest bucket."""
    from ai4e_tpu_torch.ops.image_preprocess import (channel_affine,
                                                     normalize_image_plain)
    from ai4e_tpu_torch.ops.seg_postprocess import fused_seg_postprocess_plain

    scale, bias = channel_affine(None, None, 3)
    out = []
    with torch.inference_mode():
        for i in range(0, len(images), servable.max_bucket):
            x = torch.from_numpy(images[i:i + servable.max_bucket]).cuda()
            logits = servable.module(normalize_image_plain(x, scale, bias))
            out.append(fused_seg_postprocess_plain(
                logits, with_classmap=False)["counts"].cpu().numpy())
    return np.concatenate(out)


def check_served_logits(servable, images: np.ndarray) -> None:
    """Both kernels against their plain versions on what the served path
    feeds them for one largest-bucket batch: the uint8 tiles, then the
    UNet's own float32 logits of those tiles. Exact."""
    from ai4e_tpu_torch.ops import image_preprocess as ip
    from ai4e_tpu_torch.ops import seg_postprocess as sp

    x = torch.from_numpy(images[:servable.max_bucket]).cuda()
    scale, bias = ip.channel_affine(None, None, 3)
    with torch.inference_mode():
        normalized = ip.normalize_image(x)
        if not torch.equal(normalized, ip.normalize_image_plain(x, scale, bias)):
            raise AssertionError("normalize differs on the served tiles")
        logits = servable.module(normalized)
        got = sp.fused_seg_postprocess(logits, with_classmap=True)
        want = sp.fused_seg_postprocess_plain(logits, with_classmap=True)
    for key in want:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"seg {key} differs on the served logits")
    log(f"e2e: kernels equal their plain versions on the served "
        f"{tuple(logits.shape)} {logits.dtype} logits")


def check_histogram(result: dict, want: np.ndarray, pixels: int) -> int:
    """Served JSON against reference counts: same schema, zero classes left
    out, sum == H*W; returns the largest per-class difference."""
    hist = {int(k): v for k, v in result["class_histogram"].items()}
    if set(result) != {"class_histogram"}:
        raise AssertionError(f"response keys {set(result)}")
    if sum(hist.values()) != pixels or 0 in hist.values():
        raise AssertionError(f"histogram {hist} does not cover {pixels} px")
    got = np.array([hist.get(c, 0) for c in range(len(want))])
    diff = int(np.abs(got - want).max())
    # bf16 logits of one tile depend on cuDNN's algorithm for the batch
    # shape it rode in, so a near-tie pixel can flip class: allow 1%.
    if diff > COUNT_TOLERANCE * pixels:
        raise AssertionError(f"histogram {got} vs reference {want}")
    return diff


async def drive(worker, batcher, port: int, images: np.ndarray) -> dict:
    import aiohttp

    from ai4e_tpu_torch.cli import serve
    from ai4e_tpu_torch.ops import image_preprocess, seg_postprocess

    stop = asyncio.Event()
    server = asyncio.create_task(serve(worker, batcher, "127.0.0.1", port, stop))
    base = f"http://127.0.0.1:{port}/{worker.service.prefix.strip('/')}"
    headers = {"Content-Type": "application/octet-stream"}
    bodies = [npy_bytes(img) for img in images]
    retries = 0
    try:
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as http:
            for _ in range(100):
                try:
                    async with http.get(base + "/") as r:
                        if r.status == 200:
                            break
                except aiohttp.ClientConnectionError:
                    pass
                await asyncio.sleep(0.05)
            image_preprocess.launches = seg_postprocess.launches = 0

            sync_ms, sync_results = [], []
            for body in bodies[:N_SYNC]:
                t0 = time.perf_counter()
                async with http.post(base + "/classify", data=body,
                                     headers=headers) as r:
                    if r.status != 200:
                        raise AssertionError(f"sync {r.status}: {await r.text()}")
                    sync_results.append(await r.json())
                sync_ms.append((time.perf_counter() - t0) * 1e3)

            async def one_async(body: bytes) -> str:
                nonlocal retries
                while True:
                    async with http.post(base + "/classify-async", data=body,
                                         headers=headers) as r:
                        if r.status == 503:
                            retries += 1
                            await asyncio.sleep(0.02)
                            continue
                        if r.status != 200:
                            raise AssertionError(f"async {r.status}")
                        task_id = (await r.json())["TaskId"]
                        break
                while True:
                    async with http.get(f"{base}/task/{task_id}") as r:
                        status = (await r.json())["Status"]
                    if status.startswith("completed"):
                        if status != "completed - class_histogram":
                            raise AssertionError(status)
                        return task_id
                    if status.startswith("failed"):
                        raise AssertionError(f"task {task_id}: {status}")
                    await asyncio.sleep(0.01)

            t0 = time.perf_counter()
            task_ids = await asyncio.gather(
                *(one_async(b) for b in bodies[N_SYNC:]))
            async_s = time.perf_counter() - t0
            launches = {"normalize_image": image_preprocess.launches,
                        "fused_seg_postprocess": seg_postprocess.launches}
            async with http.get(base + "/models") as r:
                listing = await r.json()
            async with http.get(f"http://127.0.0.1:{port}/metrics") as r:
                metrics_text = await r.text()
    finally:
        stop.set()
        await server
    async_results = [json.loads(worker.store.get_result(t)[0])
                     for t in task_ids]
    return {"sync_ms": sync_ms, "sync_results": sync_results,
            "async_results": async_results, "async_s": async_s,
            "retries_503": retries, "launches": launches,
            "listing": listing, "metrics": metrics_text}


def batches_over(metrics_text: str, size: int) -> int:
    """Executed batches with more than ``size`` examples, from the
    ``ai4e_batch_size`` histogram of the worker's /metrics."""
    total = above = 0
    for line in metrics_text.splitlines():
        if line.startswith("ai4e_batch_size_bucket"):
            le = line.split('le="')[1].split('"')[0]
            count = int(float(line.rsplit(" ", 1)[1]))
            if le != "+Inf" and float(le) <= size:
                above = max(above, count)  # cumulative count up to ``size``
            if le == "+Inf":
                total = count
    return total - above


def phase_end_to_end() -> dict:
    from ai4e_tpu_torch.cli import build_worker

    spec = landcover_spec()
    t0 = time.perf_counter()
    worker, batcher, _ = build_worker(spec, device="cuda")
    log(f"e2e: worker built and warmed (buckets 1/16/64) in "
        f"{time.perf_counter() - t0:.1f}s")
    servable = worker.runtime.models["landcover"]
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (N_SYNC + N_ASYNC, 256, 256, 3), np.uint8)
    out = asyncio.run(drive(worker, batcher, free_port(), images))

    check_served_logits(servable, images)
    want = reference_counts(servable, images)
    pixels = 256 * 256
    diffs = [check_histogram(r, want[i], pixels)
             for i, r in enumerate(out["sync_results"] + out["async_results"])]
    exact = sum(d == 0 for d in diffs)
    big = batches_over(out["metrics"], 16)
    if big < 1:
        raise AssertionError("no batch reached bucket 64")
    for name, n in out["launches"].items():
        if n < 1:
            raise AssertionError(f"kernel {name} never launched on the main path")
    if [m["name"] for m in out["listing"]["models"]] != ["landcover"]:
        raise AssertionError(f"/models: {out['listing']}")

    _, _, phases = worker.runtime.run_batch_phases(
        "landcover", np.zeros((64, 256, 256, 3), np.uint8))
    e2e = {
        "sync_p50_ms": statistics.median(out["sync_ms"]),
        "async_tiles_per_s": N_ASYNC / out["async_s"],
        "async_requests": N_ASYNC,
        "retries_503": out["retries_503"],
        "batches_in_bucket_64": big,
        "histograms_exact": f"{exact}/{len(diffs)}",
        "max_count_diff_px": max(diffs),
        "bucket64_phases_ms": {k: v * 1e3 for k, v in phases.items()},
        "launches": out["launches"],
    }
    log(f"e2e: {json.dumps(e2e)}")
    return e2e


def main() -> None:
    kind = phase_device()
    phase_build()
    log("kernels: parity against the plain versions on the card")
    kernels = phase_kernels()
    e2e = phase_end_to_end()
    for k in kernels:
        k["launches"] = e2e["launches"][k["name"]]
        # The same numbers under the names the port's docs use.
        k["kernel_ms"], k["max_err"] = k["ms"], k["max_abs_err"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
