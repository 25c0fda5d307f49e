"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each of which raises on failure:

1. device: the card's name and power limit; CUDA must be present;
2. build: every CUDA C++ kernel of the served path, from ``ai4e_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   served shapes and at ragged ones (normalize bit for bit at buckets 1,
   16 and 64, ragged, misaligned and C in {1, 3, 4, 8}), then timed
   (kernel, plain version, one-call library yardstick; for normalize also
   ``torch.empty(..., float32).copy_(x)``, a bandwidth yardstick of
   another function) with CUDA events, median of 25 runs (5 for
   the flash kernel's plain version, which materialises 8.6 GB of scores
   at the served shape and runs in batch chunks). The flash forward is
   also held and timed on the served model's own layout, strided views of
   a fused (B, S, 3, H, D) projection, and timed with lse at the training
   shape; its registers, spills and shared memory come from the build
   log;
4. end to end: the land-cover worker of ``deploy/specs/models.json`` (tile
   256, widths 64..512, buckets 1/16/64, random weights from seed 0) built
   and served by the same ``build_worker``/``serve`` code that
   ``python -m ai4e_tpu_torch worker`` runs, on a loopback port, driven over
   HTTP with sequential sync requests and concurrent async ones. Every
   histogram is checked against the plain ops applied on the card, both
   kernels must equal their plain versions on the served UNet's own logits,
   and each kernel must have launched during the run;
5. end to end: the long-context SeqFormer of ``deploy/specs/models.json``
   (``longcontext``: S 4096, dim 256, depth 4, heads 2, vocab 32768,
   buckets 1/16/64, random weights from seed 0) served the same way, driven
   with sequential sync and concurrent async requests of uint16 token ids.
   Every answer is checked against the same weights run on the card with
   plain full attention, the flash kernel against its plain version on the
   served model's own layer-0 q/k/v, and the kernel must have launched at
   least depth times per executed batch;
6. train then serve: the flash-attention backward (one C call: the
   preparation pass, the fused bf16 kernel ``flash_bwd_wgmma`` and the dQ
   conversion; CUDA-core kernels for float32) against its plain version on
   the card at the training shape (8, 2, 4096, 128) bf16, at S_q = 129
   and at ragged, causal and cross shapes in both types; under
   ``torch.use_deterministic_algorithms(True)`` (dQ's adds ordered) two
   calls must give bit-equal dq, dk and dv, within the tolerance of the
   plain version, at the training shape and at S = 1000 for every head
   dim, causal and not; the full-width
   SeqFormer's parameter gradients on one training batch with ``flash``
   against ``full`` attention; ``train_longcontext`` (S 4096, dim 256,
   depth 4, heads 2, vocab 32768, batch 8, 200 steps, float32 masters) on
   the card through the forward and the backward, each launched at least
   depth x steps times, with loss, step phases, sequences/s and peak
   memory recorded; ``make_checkpoint``'s ``.npz`` restored by
   ``build_worker`` and served over HTTP, sync and async, on the trainer's
   held-out sequences, whose served accuracy must be at least 0.5 and
   within 2 of 64 sequences of the trainer's eval; then the backward timed
   at the training shape: the whole call by CUDA events, each of its three
   kernels by ``torch.profiler``, with the fused kernel's registers,
   spills and shared memory from the build log, and the whole call and
   the fused kernel again under the deterministic flag
   (``deterministic_ms``).

The last two lines of output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import contextlib
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
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
N_SYNC = 8
N_ASYNC = 192
COUNT_TOLERANCE = 0.01      # per-class share of a tile's pixels, see phase 4
FLASH_SERVED = (64, 2, 4096, 128)  # bucket 64 of longcontext, one layer
PLAIN_CHUNK = 8                    # sequences per plain-version call
N_LC_SYNC = 4
N_LC_ASYNC = 64
LC_GAP = 1e-2    # class must agree where the reference's top-two gap exceeds it
LC_CONF_ATOL = 1e-2
BWD_TRAIN = (8, 2, 4096, 128)  # a longcontext training batch, one layer
# Largest relative gap, ||g_flash - g_full|| / ||g_full||, allowed between a
# parameter's gradient through the flash kernels and through plain full
# attention (which takes its softmax in bf16) on one training batch.
MODEL_GRAD_RTOL = 5e-2
N_TRAIN_SYNC = 4
SERVED_ACC_SLACK = 2  # of 64 held-out sequences: bucket shapes differ
MIN_SERVED_ACC = 0.5  # eight times chance (1/16)


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


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
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


def check_normalize(shape, mean, std, gen, misaligned=False) -> float:
    """The kernel equals the plain version bit for bit (``torch.equal``);
    ``misaligned`` takes a view one byte into its storage."""
    from ai4e_tpu_torch.ops import image_preprocess as ip

    n = int(np.prod(shape))
    flat = torch.randint(0, 256, (n + int(misaligned),), dtype=torch.uint8,
                         generator=gen).cuda()
    x = flat[int(misaligned):].view(shape)
    got = ip.normalize_image(x, mean, std)
    scale, bias = ip.channel_affine(mean, std, shape[-1])
    want = ip.normalize_image_plain(x, scale, bias)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"normalize {shape}: {got.shape} {got.dtype}")
    if not torch.equal(got, want):
        raise AssertionError(f"normalize {shape}: {int((got != want).sum())} "
                             f"of {n} differ from the plain version")
    log(f"  normalize {tuple(shape)}{' misaligned' if misaligned else ''}: "
        f"exact")
    return float((got - want).abs().max())


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
    norm_err = max(
        [check_normalize((b, 256, 256, 3), None, None, gen)
         for b in (1, 16, 64)]
        + [check_normalize((64, 256, 256, 3), mean, std, gen),
           check_normalize((3, 250, 250, 3), mean, std, gen),
           check_normalize((1, 7, 5, 3), mean, std, gen),  # n % 16 != 0
           check_normalize((2, 31, 29, 3), mean, std, gen, misaligned=True)]
        + [check_normalize((2, 33, 17, c), tuple(np.linspace(0.1, 0.8, c)),
                           tuple(np.linspace(0.2, 0.9, c)), gen)
           for c in (1, 4, 8)])
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
        # Bandwidth yardstick, another function: one PyTorch call that
        # widens the same uint8 tensor and moves the same bytes, no affine.
        "copy_yardstick_ms": device_ms(lambda: torch.empty(
            x.shape, dtype=torch.float32, device=x.device).copy_(x)),
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
    log(f"  normalize_image: copy_ yardstick {norm['copy_yardstick_ms']:.4f} ms")
    return [norm, seg]


def flash_plain_chunked(q, k, v, causal=False, return_lse=False):
    """The flash kernel's plain version, PLAIN_CHUNK sequences at a time:
    its float32 scores of the whole served batch would take 8.6 GB."""
    from ai4e_tpu_torch.ops.flash_attention import flash_attention_plain

    outs = [flash_attention_plain(q[i:i + PLAIN_CHUNK], k[i:i + PLAIN_CHUNK],
                                  v[i:i + PLAIN_CHUNK], causal, return_lse)
            for i in range(0, q.shape[0], PLAIN_CHUNK)]
    if return_lse:
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def flash_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max error in units of the kernel's tolerance,
    ``ops.flash_attention.tolerance``)."""
    from ai4e_tpu_torch.ops.flash_attention import tolerance

    err = (got.float() - want.float()).abs()
    return float(err.max()), float((err / tolerance(want)).max())


def check_flash(q, k, v, causal: bool, what: str) -> tuple[float, float]:
    """The flash kernel against its plain version on the same tensors;
    returns (output, lse) max abs errors."""
    from ai4e_tpu_torch.ops.flash_attention import LSE_ATOL, flash_attention

    got, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    want, want_lse = flash_plain_chunked(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != q.dtype:
        raise AssertionError(f"flash {what}: {got.shape} {got.dtype}")
    err, of_tol = flash_err(got, want)
    lse_err = float((lse - want_lse).abs().max())
    if not (of_tol <= 1 and lse_err <= LSE_ATOL):
        raise AssertionError(f"flash {what}: max abs err {err} ({of_tol:.3g} "
                             f"of the tolerance), lse {lse_err} (tolerance "
                             f"{LSE_ATOL})")
    log(f"  flash {what}: max abs err {err:.3g} ({of_tol:.3g} of the "
        f"tolerance), lse {lse_err:.3g} (tolerance {LSE_ATOL})")
    return err, lse_err


def flash_kernel_report(kernel: str = "flash_fwd_wgmma",
                        smem_entry: str = "fwd_smem") -> dict:
    """A Hopper flash kernel (``kernel``) at each head dim, from ``nvcc
    -Xptxas -v``: registers a thread (the launch bound's cap; the consumer
    warpgroups raise theirs with setmaxnreg) and spill bytes, beside its
    dynamic shared memory a CTA (``ai4e_flash_attention_<smem_entry>``).
    A second instantiation on a bool (the backward's ordered dQ) reports
    under its head dim's ``"ordered"``."""
    import ctypes
    import re

    from ai4e_tpu_torch.ops import _native

    smem = getattr(_native.load("flash_attention"),
                   f"ai4e_flash_attention_{smem_entry}")
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    report, cur = {}, None
    for line in _native.build_log("flash_attention").splitlines():
        if "Compiling entry function" in line:
            found = re.search(kernel + r"ILi(\d+)E(?:Lb([01])E)?", line)
            cur = None
            if found:
                d = int(found.group(1))
                cur = report.setdefault(d, {})
                if found.group(2) == "1":
                    cur = cur.setdefault("ordered", {})
                else:
                    cur["smem_bytes"] = smem(d)
        elif cur is not None and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            cur["spill_bytes"] = int(stores) + int(loads)
        elif cur is not None and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    if sorted(report) != [16, 32, 64, 128]:
        raise AssertionError(f"{kernel} missing from the build log: "
                             f"{sorted(report)}")
    return report


def phase_flash() -> dict:
    """Flash attention: parity at the served shape (contiguous and as the
    served model's strided view of its fused projection), at ragged and
    cross shapes in both types, causal and not; then timing at the served
    shape in both layouts and, with lse, at the training shape."""
    import torch.nn.functional as F

    from ai4e_tpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(b, h, s_q, s_k, d, dtype):
        return tuple(torch.randn((b, h, s, d), generator=gen, device="cuda")
                     .to(dtype) for s in (s_q, s_k, s_k))

    errs = []
    b, h, s, d = FLASH_SERVED
    served = qkv(b, h, s, s, d, torch.bfloat16)
    errs.append(check_flash(*served, False, f"served {FLASH_SERVED} bf16"))
    fused = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    strided = tuple(fused[:, :, i].transpose(1, 2) for i in range(3))
    errs.append(check_flash(*strided, False,
                            f"served {FLASH_SERVED} bf16, (B, S, 3, H, D) view"))
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            errs.append(check_flash(
                *qkv(2, 3, 1000, 1000, 64, dtype), causal,
                f"(2, 3, 1000, 64) {str(dtype)[6:]} causal={causal}"))
        errs.append(check_flash(*qkv(2, 3, 192, 320, 64, dtype), False,
                                f"cross 192x320 d64 {str(dtype)[6:]}"))

    q, k, v = served
    nbytes = 4 * q.numel() * q.element_size()  # q, k, v read, out written
    flops = 4 * b * h * s * s * d              # QK^T and PV, non-causal
    bound, by = bound_ms(nbytes, flops, BF16_OPS_PER_S)
    b8 = BWD_TRAIN[0]
    flash = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "ai4e_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ai4e_tpu/ops/pallas/flash_attention.py:73 "
                    "(_flash_kernel)",
        "shape": list(FLASH_SERVED),
        "ms": device_ms(lambda: flash_attention(q, k, v)),
        "plain_ms": device_ms(lambda: flash_plain_chunked(q, k, v), reps=5),
        # Yardstick only: the port never calls it.
        "library_ms": device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v)),
        "bound_ms": bound,
        "bound_by": by,
        "bound_peak": "bf16 tensor cores 989 TFLOP/s, HBM 3.35 TB/s",
        "max_abs_err": max(e for e, _ in errs),
        "lse_max_abs_err": max(e for _, e in errs),
        # The served model's own layout, and the training step's call.
        "strided_ms": device_ms(lambda: flash_attention(*strided)),
        "lse_train_shape": list(BWD_TRAIN),
        "lse_train_ms": device_ms(lambda: flash_attention(
            q[:b8], k[:b8], v[:b8], return_lse=True)),
        "ptxas": flash_kernel_report(),
    }
    flash["tflops"] = flops / flash["ms"] / 1e9
    flash["strided_tflops"] = flops / flash["strided_ms"] / 1e9
    flash["lse_train_tflops"] = flops * b8 / b / flash["lse_train_ms"] / 1e9
    log(f"  flash_attention {FLASH_SERVED} bf16: kernel {flash['ms']:.4f} ms "
        f"({flash['tflops']:.1f} TFLOP/s), (B, S, 3, H, D) view "
        f"{flash['strided_ms']:.4f} ms ({flash['strided_tflops']:.1f} "
        f"TFLOP/s), plain {flash['plain_ms']:.4f} ms, library (SDPA) "
        f"{flash['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
    log(f"  flash_attention {BWD_TRAIN} bf16 with lse: "
        f"{flash['lse_train_ms']:.4f} ms ({flash['lse_train_tflops']:.1f} "
        f"TFLOP/s)")
    for dd, rep in sorted(flash["ptxas"].items()):
        log(f"  flash_fwd_wgmma D={dd}: {rep['registers']} registers, "
            f"{rep['spill_bytes']} spill bytes, {rep['smem_bytes']} bytes "
            f"of shared memory a CTA")
    return flash


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


async def drive(worker, batcher, port: int, bodies: list[bytes], n_sync: int,
                route: tuple[str, str, str], kernels: dict) -> dict:
    """Serve ``worker`` on a loopback port and post ``bodies``: the first
    ``n_sync`` one after another to the sync path, the rest at once to the
    async path, each polled until its status reads ``done``. ``route`` is
    (sync path, async path, done); ``kernels`` maps each kernel's name to
    the module holding its launch count, set to 0 just before the requests
    and read just after."""
    import aiohttp

    from ai4e_tpu_torch.cli import serve

    sync_path, async_path, done = route
    stop = asyncio.Event()
    server = asyncio.create_task(serve(worker, batcher, "127.0.0.1", port, stop))
    base = f"http://127.0.0.1:{port}/{worker.service.prefix.strip('/')}"
    headers = {"Content-Type": "application/octet-stream"}
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
            for module in kernels.values():
                module.launches = 0

            sync_ms, sync_results = [], []
            for body in bodies[:n_sync]:
                t0 = time.perf_counter()
                async with http.post(base + sync_path, data=body,
                                     headers=headers) as r:
                    if r.status != 200:
                        raise AssertionError(f"sync {r.status}: {await r.text()}")
                    sync_results.append(await r.json())
                sync_ms.append((time.perf_counter() - t0) * 1e3)

            async def one_async(body: bytes) -> str:
                nonlocal retries
                while True:
                    async with http.post(base + async_path, data=body,
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
                        if status != done:
                            raise AssertionError(status)
                        return task_id
                    if status.startswith("failed"):
                        raise AssertionError(f"task {task_id}: {status}")
                    await asyncio.sleep(0.01)

            t0 = time.perf_counter()
            task_ids = await asyncio.gather(
                *(one_async(b) for b in bodies[n_sync:]))
            async_s = time.perf_counter() - t0
            launches = {name: module.launches
                        for name, module in kernels.items()}
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
    from ai4e_tpu_torch.ops import image_preprocess, seg_postprocess

    out = asyncio.run(drive(
        worker, batcher, free_port(), [npy_bytes(img) for img in images],
        N_SYNC, ("/classify", "/classify-async", "completed - class_histogram"),
        {"normalize_image": image_preprocess,
         "fused_seg_postprocess": seg_postprocess}))

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


# -- phase 5: long-context end to end ------------------------------------


def longcontext_spec() -> dict:
    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    model = dict(next(m for m in spec["models"] if m["name"] == "longcontext"))
    model.pop("checkpoint")  # no weights in the repository: seed-0 random
    return {"service_name": spec["service_name"], "prefix": spec["prefix"],
            "models": [model]}


def reference_logits(servable, config: dict, seqs: np.ndarray) -> np.ndarray:
    """The served weights on the card with plain full attention, 16
    sequences at a time."""
    from ai4e_tpu_torch.models import create_seqformer

    keys = ("seq_len", "input_dim", "dim", "depth", "heads", "num_classes",
            "vocab_size")
    ref = create_seqformer(**{k: config[k] for k in keys}, attention="full",
                           device="cuda")
    ref.load_state_dict(servable.module.state_dict())
    with torch.inference_mode():
        return torch.cat([
            ref(torch.from_numpy(seqs[i:i + 16].astype(np.int32)).cuda())
            for i in range(0, len(seqs), 16)]).cpu().numpy()


def check_served_attention(servable, seqs: np.ndarray) -> float:
    """The flash kernel against its plain version on what the served model
    feeds its first layer for one largest-bucket batch; returns the max abs
    error."""
    from ai4e_tpu_torch.ops.flash_attention import flash_attention

    module = servable.module
    block = module.blocks[0]
    with torch.inference_mode():
        x = torch.from_numpy(seqs[:servable.max_bucket].astype(np.int32)).cuda()
        h = module.embed(x) + module.pos_emb
        b, s, dim = h.shape
        heads = block.attn.heads
        qkv = block.attn.qkv(block.ln1(h)).view(b, s, 3, heads, dim // heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        got = flash_attention(q, k, v)
        want = flash_plain_chunked(q, k, v)
    err, of_tol = flash_err(got, want)
    if not of_tol <= 1:
        raise AssertionError(f"flash on the served layer-0 q/k/v: max abs "
                             f"err {err} ({of_tol:.3g} of the tolerance)")
    log(f"lc: flash equals its plain version on the served layer-0 "
        f"{tuple(q.shape)} q/k/v within {err:.3g} ({of_tol:.3g} of the "
        f"tolerance)")
    return err


def check_scores(results: list[dict], logits: np.ndarray) -> int:
    """Served JSON against the full-attention reference: same schema, the
    same class wherever the reference's top two are more than LC_GAP apart,
    confidence within LC_CONF_ATOL. Returns how many classes agree."""
    agree = 0
    for result, row in zip(results, logits):
        if set(result) != {"class_id", "confidence"}:
            raise AssertionError(f"response keys {set(result)}")
        probs = np.exp(row.astype(np.float64) - row.max())
        probs /= probs.sum()
        top, second = np.sort(probs)[::-1][:2]
        same = result["class_id"] == int(np.argmax(probs))
        agree += same
        if not same and top - second > LC_GAP:
            raise AssertionError(f"class {result['class_id']} vs reference "
                                 f"{int(np.argmax(probs))} (gap {top - second})")
        if abs(result["confidence"] - top) > LC_CONF_ATOL:
            raise AssertionError(f"confidence {result['confidence']} vs "
                                 f"reference {top}")
    return agree


def phase_longcontext() -> dict:
    from ai4e_tpu_torch.cli import build_worker
    from ai4e_tpu_torch.ops import flash_attention

    spec = longcontext_spec()
    config = spec["models"][0]
    t0 = time.perf_counter()
    worker, batcher, _ = build_worker(spec, device="cuda")
    log(f"lc: worker built and warmed (buckets "
        f"{'/'.join(map(str, config['buckets']))}) in "
        f"{time.perf_counter() - t0:.1f}s")
    servable = worker.runtime.models["longcontext"]
    rng = np.random.default_rng(SEED)
    seqs = rng.integers(0, config["vocab_size"],
                        (N_LC_SYNC + N_LC_ASYNC, config["seq_len"]),
                        dtype=np.uint16)
    out = asyncio.run(drive(
        worker, batcher, free_port(), [npy_bytes(s) for s in seqs], N_LC_SYNC,
        (config["sync_path"], config["async_path"],
         "completed - class_id, confidence"),
        {"flash_attention": flash_attention}))

    served_err = check_served_attention(servable, seqs)
    agree = check_scores(out["sync_results"] + out["async_results"],
                         reference_logits(servable, config, seqs))
    batches = sum(int(float(line.rsplit(" ", 1)[1]))
                  for line in out["metrics"].splitlines()
                  if line.startswith("ai4e_batch_size_count"))
    big = batches_over(out["metrics"], 16)
    if big < 1:
        raise AssertionError("no batch reached bucket 64")
    launches = out["launches"]["flash_attention"]
    if launches < config["depth"] * batches:
        raise AssertionError(f"flash launched {launches} times for {batches} "
                             f"batches of depth {config['depth']}")
    if [m["name"] for m in out["listing"]["models"]] != ["longcontext"]:
        raise AssertionError(f"/models: {out['listing']}")

    _, _, phases = worker.runtime.run_batch_phases(
        "longcontext", np.zeros((64, config["seq_len"]), np.int32))
    lc = {
        "sync_p50_ms": statistics.median(out["sync_ms"]),
        "async_sequences_per_s": N_LC_ASYNC / out["async_s"],
        "async_requests": N_LC_ASYNC,
        "retries_503": out["retries_503"],
        "batches": batches,
        "batches_in_bucket_64": big,
        "classes_agree_with_full_attention":
            f"{agree}/{N_LC_SYNC + N_LC_ASYNC}",
        "served_layer0_flash_err": served_err,
        "bucket64_phases_ms": {k: v * 1e3 for k, v in phases.items()},
        "launches": out["launches"],
    }
    log(f"lc: {json.dumps(lc)}")
    return lc


# -- phase 6: train then serve --------------------------------------------


def flash_bwd_plain_chunked(q, k, v, out, lse, do, causal=False,
                            parts="qkv"):
    """The backward kernels' plain version, PLAIN_CHUNK sequences at a
    time; (dq, dk, dv), None where ``parts`` leaves one out."""
    from ai4e_tpu_torch.ops.flash_attention import flash_attention_bwd_plain

    outs = [flash_attention_bwd_plain(
        q[i:i + PLAIN_CHUNK], k[i:i + PLAIN_CHUNK], v[i:i + PLAIN_CHUNK],
        out[i:i + PLAIN_CHUNK], lse[i:i + PLAIN_CHUNK], do[i:i + PLAIN_CHUNK],
        causal, parts) for i in range(0, q.shape[0], PLAIN_CHUNK)]
    return tuple(None if part[0] is None else torch.cat(part)
                 for part in zip(*outs))


def check_flash_bwd(q, k, v, do, causal: bool,
                    what: str) -> tuple[float, float]:
    """The backward against its plain version on the same tensors (out and
    lse from the forward kernel); returns the max abs errors of (dK/dV,
    dQ)."""
    from ai4e_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_bwd,
                                                    grad_tolerance)

    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal)
    want = flash_bwd_plain_chunked(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    errs, notes = {}, []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"flash bwd {what} {name}: {g.shape} {g.dtype}")
        err = (g.float() - w.float()).abs()
        of_tol = float((err / grad_tolerance(w)).max())
        errs[name] = float(err.max())
        notes.append(f"{name} {errs[name]:.3g} ({of_tol:.3g} of the tolerance)")
        if not of_tol <= 1:
            raise AssertionError(f"flash bwd {what} {name}: max abs err "
                                 f"{errs[name]} ({of_tol:.3g} of the tolerance)")
    log(f"  flash bwd {what}: {', '.join(notes)}")
    return max(errs["dk"], errs["dv"]), errs["dq"]


def phase_flash_bwd_parity() -> tuple[float, float]:
    """The backward at the training shape, at S_q = 129 (one row past two
    of the fused kernel's 64-row query tiles) and at ragged, causal and
    cross shapes in both types; returns the max abs errors."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def tensors(b, h, s_q, s_k, d, dtype):
        return tuple(torch.randn((b, h, s, d), generator=gen, device="cuda")
                     .to(dtype) for s in (s_q, s_k, s_k, s_q))

    b, h, s, d = BWD_TRAIN
    errs = [check_flash_bwd(*tensors(b, h, s, s, d, torch.bfloat16), False,
                            f"training {BWD_TRAIN} bf16"),
            check_flash_bwd(*tensors(2, 3, 129, 200, d, torch.bfloat16),
                            False, "S_q 129 x S_k 200 d128 bf16")]
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            errs.append(check_flash_bwd(
                *tensors(2, 3, 1000, 1000, 64, dtype), causal,
                f"(2, 3, 1000, 64) {str(dtype)[6:]} causal={causal}"))
        errs.append(check_flash_bwd(*tensors(2, 3, 192, 320, 64, dtype), False,
                                    f"cross 192x320 d64 {str(dtype)[6:]}"))
    return max(e for e, _ in errs), max(e for _, e in errs)


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` inside, the caller's
    setting restored after."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def check_flash_bwd_ordered(q, k, v, do, causal: bool, what: str) -> None:
    """Under PyTorch's deterministic flag the bf16 backward orders its dQ
    adds: two calls must give bit-equal dq, dk and dv, each within
    ``grad_tolerance`` of the plain version (computed outside the flag,
    whose cuBLAS products would refuse to run under it)."""
    from ai4e_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_bwd,
                                                    grad_tolerance)

    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    want = flash_bwd_plain_chunked(q, k, v, out, lse, do, causal)
    with deterministic_algorithms():
        first = flash_attention_bwd(q, k, v, out, lse, do, causal)
        second = flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
    notes = []
    for name, a, b, w in zip(("dq", "dk", "dv"), first, second, want):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"flash bwd ordered {what} {name}: {bad} of "
                                 f"{a.numel()} differ between two calls")
        of_tol = float(((a.float() - w.float()).abs() / grad_tolerance(w))
                       .max())
        notes.append(f"{name} {of_tol:.3g}")
        if not of_tol <= 1:
            raise AssertionError(f"flash bwd ordered {what} {name}: "
                                 f"{of_tol:.3g} of the tolerance")
    log(f"  flash bwd ordered {what}: two calls bit-equal; of the tolerance "
        f"{', '.join(notes)}")


def phase_flash_bwd_ordered() -> None:
    """The deterministic bf16 backward at the training shape and at a
    ragged S for every head dim, causal and not."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def tensors(b, h, s, d):
        return tuple(torch.randn((b, h, s, d), generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(4))

    for causal in (False, True):
        check_flash_bwd_ordered(*tensors(*BWD_TRAIN), causal,
                                f"training {BWD_TRAIN} causal={causal}")
        for d in (16, 32, 64, 128):
            check_flash_bwd_ordered(*tensors(2, 2, 1000, d), causal,
                                    f"(2, 2, 1000, {d}) causal={causal}")


def longcontext_config() -> dict:
    keys = ("seq_len", "input_dim", "dim", "depth", "heads", "num_classes",
            "vocab_size")
    return {k: longcontext_spec()["models"][0][k] for k in keys}


def phase_model_grad() -> dict:
    """The full-width SeqFormer (float32 masters, bf16 body) on one
    training batch: every parameter's gradient through the flash kernels
    against the same through plain full attention."""
    from ai4e_tpu_torch.models import create_seqformer
    from ai4e_tpu_torch.train.make_checkpoints import longcontext_batch
    from ai4e_tpu_torch.train.step import cross_entropy_loss

    config = longcontext_config()
    toks, labels = longcontext_batch(np.random.default_rng(SEED), 8,
                                     config["seq_len"], config["vocab_size"],
                                     config["num_classes"])
    x, y = torch.from_numpy(toks).cuda(), torch.from_numpy(labels).cuda()
    grads, losses = {}, {}
    for attention in ("flash", "full"):
        model = create_seqformer(**config, attention=attention,
                                 param_dtype=torch.float32, device="cuda")
        params = dict(model.named_parameters())
        loss = cross_entropy_loss(model(x), y)
        grads[attention] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        losses[attention] = float(loss.detach())
        del model, params, loss
    worst_name, worst = "", 0.0
    for name, want in grads["full"].items():
        gap = float((grads["flash"][name] - want).norm()
                    / want.norm().clamp_min(1e-30))
        if gap > worst:
            worst_name, worst = name, gap
    del grads
    torch.cuda.empty_cache()
    if not worst <= MODEL_GRAD_RTOL:
        raise AssertionError(f"model gradient {worst_name}: flash vs full "
                             f"relative gap {worst} > {MODEL_GRAD_RTOL}")
    log(f"train: model gradients, flash against full attention on one "
        f"batch: worst relative gap {worst:.3g} ({worst_name}; tolerance "
        f"{MODEL_GRAD_RTOL}), loss {losses['flash']:.6f} vs "
        f"{losses['full']:.6f}")
    return {"worst_relative_gap": worst, "worst_param": worst_name,
            "loss_flash": losses["flash"], "loss_full": losses["full"]}


def phase_train() -> dict:
    """``train_longcontext`` at its defaults on the card; the launch counts
    are set to 0 just before and read just after."""
    from ai4e_tpu_torch.ops import flash_attention as fa
    from ai4e_tpu_torch.train.make_checkpoints import train_longcontext

    config = longcontext_config()
    fa.launches = fa.bwd_launches = 0
    result = train_longcontext(device="cuda")
    launches = {"flash_attention": fa.launches,
                "flash_attention_bwd": fa.bwd_launches}
    steps = len(result["losses"])
    for name, n in launches.items():
        if n < config["depth"] * steps:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"steps of depth {config['depth']}")
    losses = result["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training loss is not finite: {losses}")
    phases = result["phases_ms"][1:]  # the first step pays one-off costs
    step_ms = [sum(p.values()) for p in phases]
    median_ms = statistics.median(step_ms)
    batch = result["batch"]
    train = {
        "steps": steps,
        "batch": batch,
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "loss_every_25": losses[::25],
        "step_ms_median": median_ms,
        "phase_ms_median": {k: statistics.median(p[k] for p in phases)
                            for k in phases[0]},
        "sequences_per_s": batch * 1e3 / median_ms,
        "loop_sequences_per_s": steps * batch / result["loop_seconds"],
        "peak_memory_gib": result["peak_bytes"] / 2 ** 30,
        "eval_accuracy": result["eval"]["accuracy"],
        "reached_min_eval_0.85": result["eval"]["accuracy"] >= 0.85,
        "launches": launches,
    }
    log(f"train: {json.dumps(train)}")
    return {"record": train, "result": result}


def phase_serve_trained(result: dict) -> dict:
    """The trained weights through ``make_checkpoint`` and ``build_worker``,
    served over HTTP on the trainer's held-out sequences."""
    from ai4e_tpu_torch.cli import build_worker
    from ai4e_tpu_torch.ops import flash_attention
    from ai4e_tpu_torch.train.make_checkpoints import (longcontext_batch,
                                                       make_checkpoint)

    entry = make_checkpoint("longcontext", str(ROOT / "build" / "chip_smoke"),
                            min_eval=MIN_SERVED_ACC, result=result)
    spec = longcontext_spec()
    config = spec["models"][0]
    config["checkpoint"] = entry["path"]
    worker, batcher, _ = build_worker(spec, device="cuda")
    # The trainer's eval set: 4 batches of 16 drawn from seed + 1.
    rng = np.random.default_rng(SEED + 1)
    seqs, labels = zip(*(longcontext_batch(rng, 16, config["seq_len"],
                                           config["vocab_size"],
                                           config["num_classes"])
                         for _ in range(4)))
    seqs, labels = np.concatenate(seqs), np.concatenate(labels)
    out = asyncio.run(drive(
        worker, batcher, free_port(),
        [npy_bytes(s.astype(np.uint16)) for s in seqs], N_TRAIN_SYNC,
        (config["sync_path"], config["async_path"],
         "completed - class_id, confidence"),
        {"flash_attention": flash_attention}))
    served = np.array([r["class_id"]
                       for r in out["sync_results"] + out["async_results"]])
    if out["launches"]["flash_attention"] < config["depth"]:
        raise AssertionError(f"flash launched {out['launches']} times "
                             f"serving the trained weights")
    hits = int((served == labels).sum())
    train_hits = round(result["eval"]["accuracy"] * len(labels))
    if abs(hits - train_hits) > SERVED_ACC_SLACK:
        raise AssertionError(f"served {hits}/{len(labels)} right, the "
                             f"trainer's eval {train_hits}")
    if hits < MIN_SERVED_ACC * len(labels):
        raise AssertionError(f"served accuracy {hits}/{len(labels)} < "
                             f"{MIN_SERVED_ACC}")
    serve = {"served_accuracy": hits / len(labels),
             "trainer_eval_accuracy": result["eval"]["accuracy"],
             "sync_p50_ms": statistics.median(out["sync_ms"]),
             "async_sequences_per_s": (len(seqs) - N_TRAIN_SYNC) / out["async_s"],
             "launches": out["launches"]}
    log(f"serve trained: {json.dumps(serve)}")
    return serve


def kernel_device_ms(fn, names: tuple[str, ...], reps: int = 25) -> dict:
    """Mean device time a call of ``fn`` spends in the kernels whose names
    contain each of ``names``, in ms, from a ``torch.profiler`` trace of
    ``reps`` calls after warm-up. Raises if one of them did not run."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = dict.fromkeys(names, 0.0)
    for event in prof.key_averages():
        for name in names:
            if name in event.key:
                times[name] += event.self_device_time_total / reps / 1e3
    missing = [name for name, ms in times.items() if ms <= 0]
    if missing:
        raise AssertionError(f"no device time for {missing} in the trace")
    return times


def phase_flash_bwd_timing(errs: tuple[float, float],
                           launches: dict) -> list[dict]:
    """The backward timed at the training shape: the whole call
    (``flash_attention_bwd``) by CUDA events, each of its kernels by
    ``torch.profiler``, beside the plain version and, as a yardstick only,
    SDPA's backward."""
    import torch.nn.functional as F

    from ai4e_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    b, h, s, d = BWD_TRAIN
    q, k, v, do = (torch.randn(BWD_TRAIN, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
    # Yardstick only, the whole backward (dq, dk, dv): the port never calls it.
    library = device_ms(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do, retain_graph=True))

    def call():
        return fa.flash_attention_bwd(q, k, v, out, lse, do)

    parts = kernel_device_ms(call, ("flash_bwd_prep", "flash_bwd_wgmma",
                                    "flash_bwd_dq_convert"))
    c_out, c_lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)

    def causal_call():
        return fa.flash_attention_bwd(q, k, v, c_out, c_lse, do, True)

    causal_ms = device_ms(causal_call)
    with deterministic_algorithms():  # dQ's adds ordered
        ordered_ms = device_ms(call)
        ordered_parts = kernel_device_ms(call, ("flash_bwd_wgmma",))
        ordered_causal_ms = device_ms(causal_call)
    # q, k, v, out, do read and dq, dk, dv written once in bf16, lse read in
    # float32; five products (S, dP, dV, dK, dQ), two flops a multiply-add.
    flops = 2 * 5 * b * h * s * s * d
    bound, by = bound_ms(8 * b * h * s * d * 2 + b * h * s * 4, flops,
                         BF16_OPS_PER_S)
    entry = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "ai4e_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ai4e_tpu/ops/pallas/flash_attention.py:160 "
                    "(_flash_bwd_dkv_kernel) and :197 (_flash_bwd_dq_kernel)",
        "shape": list(BWD_TRAIN),
        # The whole call: preparation pass, fused kernel, dQ conversion.
        "ms": device_ms(call),
        "fused_kernel_ms": parts["flash_bwd_wgmma"],
        "causal_ms": causal_ms,
        # Under torch.use_deterministic_algorithms(True): the whole call
        # (with PyTorch's NaN fill of the fresh outputs and scratch, which
        # the flag turns on) and its fused kernel; bit-equal from call to
        # call.
        "deterministic_ms": ordered_ms,
        "deterministic_fused_kernel_ms": ordered_parts["flash_bwd_wgmma"],
        "deterministic_causal_ms": ordered_causal_ms,
        "prep_ms": parts["flash_bwd_prep"],
        "convert_ms": parts["flash_bwd_dq_convert"],
        "plain_ms": device_ms(lambda: flash_bwd_plain_chunked(
            q, k, v, out, lse, do), reps=5),
        "library_ms": library,
        "library": "F.scaled_dot_product_attention backward (dq, dk, dv)",
        "bound_ms": bound,
        "bound_by": by,
        "bound_peak": "bf16 tensor cores 989 TFLOP/s, HBM 3.35 TB/s",
        "max_abs_err": max(errs),
        "dkv_max_abs_err": errs[0],
        "dq_max_abs_err": errs[1],
        "launches": launches["flash_attention_bwd"],
        "ptxas": flash_kernel_report("flash_bwd_wgmma", "bwd_smem"),
    }
    entry["tflops"] = flops / entry["ms"] / 1e9
    entry["fused_kernel_tflops"] = flops / entry["fused_kernel_ms"] / 1e9
    log(f"  flash_attention_bwd {BWD_TRAIN} bf16: whole call "
        f"{entry['ms']:.4f} ms ({entry['tflops']:.1f} TFLOP/s; fused kernel "
        f"{entry['fused_kernel_ms']:.4f} ms, {entry['fused_kernel_tflops']:.1f}"
        f" TFLOP/s; prep {entry['prep_ms']:.4f}, convert "
        f"{entry['convert_ms']:.4f}), plain {entry['plain_ms']:.4f} ms, SDPA "
        f"backward {library:.4f} ms, bound {bound:.4f} ms ({by}); "
        f"deterministic: whole call {ordered_ms:.4f} ms, fused kernel "
        f"{entry['deterministic_fused_kernel_ms']:.4f} ms")
    for dd, rep in sorted(entry["ptxas"].items()):
        log(f"  flash_bwd_wgmma D={dd}: {rep['registers']} registers, "
            f"{rep['spill_bytes']} spill bytes, {rep['smem_bytes']} bytes of "
            f"shared memory a CTA; ordered: {rep.get('ordered')}")
    return [entry]


def phase_train_then_serve() -> list[dict]:
    log("train: backward kernels against their plain version on the card")
    errs = phase_flash_bwd_parity()
    phase_flash_bwd_ordered()
    phase_model_grad()
    train = phase_train()
    phase_serve_trained(train["result"])
    return phase_flash_bwd_timing(errs, train["record"]["launches"])


def main() -> None:
    kind = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in float32
    phase_build()
    log("kernels: parity against the plain versions on the card")
    kernels = phase_kernels() + [phase_flash()]
    e2e = phase_end_to_end()
    lc = phase_longcontext()
    for k in kernels:
        k["launches"] = {**e2e["launches"], **lc["launches"]}[k["name"]]
    kernels += phase_train_then_serve()
    for k in kernels:
        # The same numbers under the names the port's docs use.
        k["kernel_ms"], k["max_err"] = k["ms"], k["max_abs_err"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
