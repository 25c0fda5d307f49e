"""Time the bf16 flash-attention forward against variants of itself, in
turns, on one GPU.

    python3 scripts/flash_forward_variants.py [--ablate] [--out PATH] [DIR ...]

Each DIR holds a ``flash_attention.cu`` (and the headers it includes) with
the port's C entry points: for example a parent commit's
``ai4e_tpu_torch/csrc``, unpacked with ``git archive`` into a git-ignored
directory. This checkout's kernel (``ai4e_tpu_torch/csrc``) is always
included. ``--ablate`` adds copies of it with one part of the softmax
taken out, which give wrong outputs and serve only to price that part:

- ``no_softmax``: the mask, row maxima, ex2 and row sums of every tile
  after the first;
- ``no_ex2``: P = score * scale * log2(e) - m, without the ex2;
- ``no_rescale``: O is not rescaled when a row's maximum grows.

The variants run in turns, all of them and then all in reverse order.
Each is timed with CUDA events (median of 25 runs after warm-up) at the
served shape (64, 2, 4096, 128) bf16, contiguous and as strided views of
a fused (B, S, 3, H, D) projection, with lse at (8, 2, 4096, 128), and
causal; ``F.scaled_dot_product_attention`` is timed once beside them as a
yardstick. Each variant's output at 2 of the 64 sequences is held
against the plain version (in units of the kernel's tolerance). One JSON
line per reading is printed and all of them are written to ``--out``.
Needs CUDA; exits non-zero without it. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ai4e_tpu_torch.ops import _native  # noqa: E402
from ai4e_tpu_torch.ops import flash_attention as fa  # noqa: E402

SERVED = (64, 2, 4096, 128)
TRAIN_BATCH = 8
CSRC = ROOT / "ai4e_tpu_torch" / "csrc"
ABLATIONS = {
    "no_softmax": ("      online_softmax<kBlockN>(s, m2, l_row, corr, scale2, "
                   "mask(it),\n                              it * kBlockN, "
                   "p.s_k, p.causal, row_a, t);\n", ""),
    "no_ex2": ("    s[i] = hopper::ex2(fmaf(s[i], scale2, -m2[(i >> 1) & 1]));",
               "    s[i] = fmaf(s[i], scale2, -m2[(i >> 1) & 1]);"),
    "no_rescale": ("          o[part][i] *= corr[(i >> 1) & 1];\n", ""),
}


def device_ms(fn, reps: int = 25) -> float:
    """Median device time of one ``fn()`` call, in ms, behind a spin
    kernel so the events bracket device work only."""
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


def ablated(name: str, out_dir: Path) -> Path:
    """A copy of this checkout's csrc/ with ABLATIONS[name] applied."""
    old, new = ABLATIONS[name]
    source = (CSRC / "flash_attention.cu").read_text()
    if old not in source:
        raise SystemExit(f"ablation {name}: its line is not in "
                         f"csrc/flash_attention.cu any more")
    target = out_dir / name
    target.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (target / header.name).write_text(header.read_text())
    (target / "flash_attention.cu").write_text(source.replace(old, new))
    return target


def use(csrc: Path) -> None:
    """Route the flash wrappers to the library built from ``csrc``."""
    _native.CSRC_DIR = csrc.resolve()
    _native._loaded.pop("flash_attention", None)
    fa._fns.clear()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("dirs", nargs="*", type=Path)
    parser.add_argument("--ablate", action="store_true")
    parser.add_argument("--out", type=Path,
                        default=ROOT / "build" / "flash_forward_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_forward_variants: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    variants = {"checkout": CSRC}
    variants.update({str(d): d for d in args.dirs})
    if args.ablate:
        work = ROOT / "build" / "flash_forward_variants"
        variants.update({n: ablated(n, work) for n in ABLATIONS})
    for name, csrc in variants.items():  # build all before timing any
        use(csrc)
        _native.build(["flash_attention"])

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, s, d = SERVED
    q, k, v = (torch.randn(SERVED, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    fused = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    strided = tuple(fused[:, :, i].transpose(1, 2) for i in range(3))
    want = fa.flash_attention_plain(q[:2], k[:2], v[:2])
    flops = 4 * b * h * s * s * d
    readings = [{"variant": "sdpa", "ms": device_ms(
        lambda: F.scaled_dot_product_attention(q, k, v))}]
    print(json.dumps(readings[0]), flush=True)
    order = list(variants) + list(reversed(variants))
    for name in order:
        use(variants[name])
        got = fa.flash_attention(q[:2], k[:2], v[:2])
        of_tol = float(((got.float() - want.float()).abs()
                        / fa.tolerance(want)).max())
        t = TRAIN_BATCH
        reading = {
            "variant": name,
            "ms": device_ms(lambda: fa.flash_attention(q, k, v)),
            "strided_ms": device_ms(lambda: fa.flash_attention(*strided)),
            "lse_train_ms": device_ms(lambda: fa.flash_attention(
                q[:t], k[:t], v[:t], return_lse=True)),
            "causal_ms": device_ms(
                lambda: fa.flash_attention(q, k, v, causal=True)),
            "err_of_tolerance": of_tol,
        }
        reading["tflops"] = flops / reading["ms"] / 1e9
        readings.append(reading)
        print(json.dumps(reading), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "shape": list(SERVED),
                                    "readings": readings}, indent=1))
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
