"""Where the time goes in a batch of the PyTorch port, on one GPU.

    python3 scripts/torch_profile.py [--model landcover|longcontext]
                                     [--train] [--out build/torch_profile_<model>.json]

Builds the servable of that name in ``deploy/specs/models.json`` (land
cover: tile 256, widths 64..512; longcontext: the SeqFormer at S 4096, dim
256, depth 4, heads 2, vocab 32768), with random weights from seed 0, on
the card, and reports for each bucket (1, 16, 64):

- the ``run_batch_phases`` split (h2d / execute / d2h, host clock ended by a
  synchronize), median of 10 batches;
- the device time of ``apply_fn`` alone (CUDA events), median of 10;

then, at bucket 64:

- a ``torch.profiler`` trace of 3 batches: device time by operator and by
  kernel, and the device's busy share of the traced window;
- the model's forward with its bit-exact bfloat16 gelu chain against
  ``F.gelu(approximate="tanh")``, timed in turns (chain, F.gelu, F.gelu,
  chain), to price the chain.

With ``--train`` (longcontext only) it profiles training instead: the
``Trainer`` of ``train.make_checkpoints.train_longcontext`` (batch 8,
float32 masters, flash attention and its backward kernels), 3 warm-up
steps, then a ``torch.profiler`` trace of 3 steps: device time by operator
and by kernel, and the device's busy share.

Needs CUDA; exits non-zero without it. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def events_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def busy_share(prof) -> tuple[float, float]:
    """(device-busy ms, traced window ms) from the kernels' intervals."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1e3, (spans[-1][1] - spans[0][0]) / 1e3


def print_profile(prof, n: int, report: dict) -> None:
    """Busy share and device time by operator and by kernel, per one of
    the ``n`` traced batches or steps, into ``report`` and the log."""
    busy_ms, window_ms = busy_share(prof)
    report.update({"device_busy_ms_per_batch": busy_ms / n,
                   "window_ms_per_batch": window_ms / n,
                   "busy_share": busy_ms / window_ms if window_ms else None})
    print(f"profile: busy {busy_ms / n:.2f} ms of {window_ms / n:.2f} ms "
          f"per batch", flush=True)
    cuda = torch.autograd.DeviceType.CUDA
    for kind, keep in (("operators", lambda e: e.device_type != cuda),
                       ("kernels", lambda e: e.device_type == cuda)):
        rows = sorted(((e.key, e.self_device_time_total / n / 1e3,
                        e.count // n)
                       for e in prof.key_averages()
                       if keep(e) and e.self_device_time_total > 0),
                      key=lambda t: -t[1])
        report[f"{kind}_device_ms_per_batch"] = [
            {"name": k, "ms": ms, "calls": c} for k, ms, c in rows[:40]]
        print(f"  by {kind}:", flush=True)
        for k, ms, c in rows[:15]:
            print(f"  {ms:9.3f} ms  x{c:<4d} {k[:110]}", flush=True)


def profile_training(model: dict, report: dict) -> None:
    from torch.profiler import ProfilerActivity, profile

    from ai4e_tpu_torch.models import create_seqformer
    from ai4e_tpu_torch.train.make_checkpoints import longcontext_batch
    from ai4e_tpu_torch.train.step import Trainer, adamw

    keys = ("seq_len", "input_dim", "dim", "depth", "heads", "num_classes",
            "vocab_size")
    net = create_seqformer(**{k: model[k] for k in keys}, attention="flash",
                           param_dtype=torch.float32, device="cuda")
    tr = Trainer(net, optimizer=lambda p: adamw(p, 1e-3, weight_decay=1e-5))
    rng = np.random.default_rng(0)
    batches = [longcontext_batch(rng, 8, model["seq_len"],
                                 model["vocab_size"]) for _ in range(6)]
    for toks, labels in batches[:3]:
        tr.train_step(toks, labels)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for toks, labels in batches[3:]:
            tr.train_step(toks, labels)
        torch.cuda.synchronize()
    report["profile_train_batch8"] = {}
    print_profile(prof, 3, report["profile_train_batch8"])


def batch_of(model: dict, n: int, rng) -> np.ndarray:
    """n random requests of the model's wire: uint8 tiles or token ids."""
    if model["family"] == "unet":
        return rng.integers(0, 256, (n, model["tile"], model["tile"], 3),
                            np.uint8)
    return rng.integers(0, model["vocab_size"], (n, model["seq_len"]),
                        dtype=np.int32)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="landcover",
                        choices=("landcover", "longcontext"))
    parser.add_argument("--train", action="store_true",
                        help="profile training steps (longcontext)")
    parser.add_argument("--out", default=None,
                        help="default build/torch_profile_<model>.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: CUDA is not available")
    if args.train and args.model != "longcontext":
        raise SystemExit("torch_profile: --train needs --model longcontext")

    import torch.nn.functional as F

    from ai4e_tpu_torch.models import seqformer, unet
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    model = dict(next(m for m in spec["models"] if m["name"] == args.model))
    for key in ("checkpoint", "sync_path", "async_path"):
        model.pop(key, None)
    report: dict = {"card": card, "model": args.model}
    out = Path(args.out or ROOT / "build" / (
        f"torch_profile_{args.model}{'_train' if args.train else ''}.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.train:
        profile_training(model, report)
        out.write_text(json.dumps(report, indent=1))
        print(f"wrote {out}", flush=True)
        return
    runtime = ModelRuntime(device="cuda")
    servable = runtime.register(build_servable(**model))
    runtime.warmup()
    rng = np.random.default_rng(0)
    report["buckets"] = {}

    for bucket in servable.batch_buckets:
        batch = batch_of(model, bucket, rng)
        phases = [runtime.run_batch_phases(args.model, batch)[2]
                  for _ in range(10)]
        split = {k: statistics.median(p[k] for p in phases) * 1e3
                 for k in phases[0]}
        x = torch.from_numpy(batch).cuda()
        with torch.inference_mode():
            apply_ms = events_ms(lambda: servable.apply_fn(servable.module, x))
        report["buckets"][bucket] = {"phases_ms": split, "apply_ms": apply_ms,
                                     "requests_per_s": bucket / apply_ms * 1e3}
        print(f"bucket {bucket}: phases {split} apply {apply_ms:.3f} ms",
              flush=True)

    x = torch.from_numpy(batch_of(model, 64, rng)).cuda()
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            servable.apply_fn(servable.module, x)
        torch.cuda.synchronize()
    report["profile_bucket64"] = {}
    print_profile(prof, 3, report["profile_bucket64"])

    # The forward reads ``gelu`` from its model module's globals.
    owner = unet if model["family"] == "unet" else seqformer
    xin = (torch.rand((64, 256, 256, 3), device="cuda")
           if model["family"] == "unet" else x)
    chain = owner.gelu
    times = {"chain": [], "F.gelu": []}
    with torch.inference_mode():
        for variant in ("chain", "F.gelu", "F.gelu", "chain"):
            owner.gelu = chain if variant == "chain" else (
                lambda t: F.gelu(t, approximate="tanh"))
            times[variant].append(events_ms(lambda: servable.module(xin), 5))
    owner.gelu = chain
    report["gelu_forward_ms_bucket64"] = times
    print(f"forward at bucket 64: gelu chain {times['chain']} ms, "
          f"F.gelu {times['F.gelu']} ms", flush=True)

    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"done in {time.perf_counter() - t0:.1f}s", flush=True)
