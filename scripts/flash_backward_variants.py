"""Time the bf16 flash-attention backward against variants of itself, in
turns, on one GPU.

    python3 scripts/flash_backward_variants.py [--ablate] [--ordered]
        [--out PATH] [DIR ...]

Each DIR holds a ``flash_attention.cu`` (and the headers it includes) with
the port's C entry points: either one backward entry
(``ai4e_flash_attention_bwd``: preparation pass, fused kernel, dQ
conversion) or the two of the earlier design (``_bwd_dkv`` and ``_bwd_dq``,
which take Delta from the caller; the call then computes Delta with
``bwd_delta`` first, as that design's wrapper did). For example a parent
commit's ``ai4e_tpu_torch/csrc``, unpacked with ``git archive`` into a
git-ignored directory::

    mkdir -p build/parent && git archive HEAD ai4e_tpu_torch/csrc \\
        | tar -x -C build/parent
    python3 scripts/flash_backward_variants.py --ablate \\
        build/parent/ai4e_tpu_torch/csrc

This checkout's kernel (``ai4e_tpu_torch/csrc``) is always included.
A fused entry from before its ``ordered`` argument is called without
it. ``--ordered`` adds each variant that has that argument once
more (``<name>_ordered``), run under
``torch.use_deterministic_algorithms(True)``: dQ's adds in a fixed order.
``--ablate`` adds copies of it with one part taken out, which give wrong
gradients and serve only to price that part:

- ``no_reduce``: dQ's bulk reduce-add into the accumulator;
- ``no_ex2``: P^T = s * scale * log2(e) - lse2, without the ex2;
- ``no_dq_product``: the dQ = dS.K product (its tile is still stored and
  added).

The variants run in turns, all of them and then all in reverse order, at
the training shape (8, 2, 4096, 128) bf16, non-causal and causal. Each
reading has the whole call's time by CUDA events (median of 25 runs after
warm-up), each kernel's device time by ``torch.profiler`` (mean of 25
calls), and the gradients of 1 of the 8 sequences against the plain
version (in units of ``grad_tolerance``). SDPA's backward is timed once
beside them as a yardstick. One JSON line per reading is printed and all of
them are written to ``--out``. Needs CUDA; exits non-zero without it.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
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

TRAIN = (8, 2, 4096, 128)
CSRC = ROOT / "ai4e_tpu_torch" / "csrc"
ABLATIONS = {
    "no_reduce": ("""        hopper::bulk_reduce_add(
            p.dq_acc + ((long long)bh * p.s_pad + q0) * D +
                dq_box * kBwdBlockM * S::kDqCols,
            base + S::kDQ + c * S::kDqBytes, S::kDqBytes);
""", ""),
    "no_ex2": ("float x = hopper::ex2(fmaf(s[i], scale2, "
               "(e & 1) ? -l2.y : -l2.x));",
               "float x = fmaf(s[i], scale2, (e & 1) ? -l2.y : -l2.x);"),
    "no_dq_product": ("""#pragma unroll
      for (int kc = 0; kc < S::kDqKeys / 16; ++kc) {
        hopper::wgmma_ss<1, 1>(
            dq, ds_desc(ds_tile, dq_key0 / 16 + kc),
            mnmajor_desc<D>(k_tile + dq_box * kBwdBlockN * S::kSwizzle,
                            kBwdBlockN, dq_key0 / 16 + kc),
            kc > 0);
      }
""", ""),
}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
# The two backward entries of the earlier design: q, k, v, do, lse, delta,
# then the outputs (dk, dv or dq), B, H, S_q, S_k, D, strides, scale,
# causal, bf16, stream, device.
TWO_KERNEL_ARGTYPES = {
    "bwd_dkv": [_P] * 8 + [_I] * 5 + [_LL, ctypes.c_float, _I, _I, _P, _I],
    "bwd_dq": [_P] * 7 + [_I] * 5 + [_LL, ctypes.c_float, _I, _I, _P, _I],
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


def kernels_ms(fn, reps: int = 25) -> dict:
    """Mean device time a call of ``fn`` spends in each kernel, by name."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:120]: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages() if e.self_device_time_total > 0}


def ablated(name: str, out_dir: Path) -> Path:
    """A copy of this checkout's csrc/ with ABLATIONS[name] applied."""
    old, new = ABLATIONS[name]
    source = (CSRC / "flash_attention.cu").read_text()
    if old not in source:
        raise SystemExit(f"ablation {name}: its lines are not in "
                         f"csrc/flash_attention.cu any more")
    target = out_dir / name
    target.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (target / header.name).write_text(header.read_text())
    (target / "flash_attention.cu").write_text(source.replace(old, new))
    return target


def ptxas_summary() -> dict:
    """The loaded library's fused backward at D = 128 (its default
    instantiation, dQ unordered) from ``nvcc -Xptxas -v``: registers, spill bytes, and how many of ptxas's warnings say that
    wgmma instructions were serialised (C7520)."""
    import re

    log = _native.build_log("flash_attention")
    summary = {"wgmma_serialised_warnings": log.count("C7520")}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if ("Compiling entry function" in line
                and "flash_bwd_wgmmaILi128E" in line and "Lb1E" not in line):
            for follow in lines[i + 1:i + 4]:
                if "spill stores" in follow:
                    stores, loads = re.findall(r"(\d+) bytes spill", follow)
                    summary["spill_bytes"] = int(stores) + int(loads)
                if "Used" in follow and "registers" in follow:
                    summary["registers"] = int(re.search(
                        r"Used (\d+) registers", follow).group(1))
    return summary


def use(csrc: Path) -> ctypes.CDLL:
    """Route the flash wrappers to the library built from ``csrc``."""
    _native.CSRC_DIR = csrc.resolve()
    _native._loaded.pop("flash_attention", None)
    fa._fns.clear()
    return _native.load("flash_attention")


def two_kernel_call(lib: ctypes.CDLL):
    """The earlier design's backward: Delta by ``bwd_delta``, then the
    dK/dV kernel and the dQ kernel, as its wrapper launched them."""
    fns = {}
    for which, types in TWO_KERNEL_ARGTYPES.items():
        fn = getattr(lib, f"ai4e_flash_attention_{which}")
        fn.argtypes, fn.restype = types, ctypes.c_int
        fns[which] = fn

    def call(q, k, v, out, lse, do, causal=False):
        b, h, s_q, d = q.shape
        s_k = k.shape[2]
        delta = fa.bwd_delta(out, do)
        dq, dk, dv = (fa._bshd_like(q, s_q), fa._bshd_like(k, s_k),
                      fa._bshd_like(v, s_k))
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr())
        inputs = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *do.stride()[:3])
        tail = (d ** -0.5, int(causal), 1,
                torch.cuda.current_stream().cuda_stream, q.device.index or 0)
        for which, outs in (("bwd_dkv", (dk, dv)), ("bwd_dq", (dq,))):
            strides = [st for t in outs for st in t.stride()[:3]]
            arr = (ctypes.c_longlong * (12 + len(strides)))(*inputs, *strides)
            err = fns[which](*head, *(t.data_ptr() for t in outs), b, h, s_q,
                             s_k, d, arr, *tail)
            _native.check(err, f"flash_attention {which}")
        return dq, dk, dv
    return call


def legacy_fused_call(lib: ctypes.CDLL):
    """``flash_bwd_cuda`` on a fused entry that predates the ``ordered``
    argument: the wrapper's call, with that argument left out."""
    fn = lib.ai4e_flash_attention_bwd
    types = fa._ARGTYPES["bwd"]
    fn.argtypes, fn.restype = types[:19] + types[20:], ctypes.c_int

    def call(*args, **kwargs):
        fa._fns["bwd"] = lambda *a: fn(*a[:19], *a[20:])
        return fa.flash_bwd_cuda(*args, **kwargs)
    return call


def ordered_call(*args, **kwargs):
    """``flash_bwd_cuda`` under PyTorch's deterministic-algorithms flag."""
    torch.use_deterministic_algorithms(True)
    try:
        return fa.flash_bwd_cuda(*args, **kwargs)
    finally:
        torch.use_deterministic_algorithms(False)


def fused_call(lib: ctypes.CDLL, csrc: Path):
    if not hasattr(lib, "ai4e_flash_attention_bwd"):
        return two_kernel_call(lib)
    if "int ordered" not in (csrc / "flash_attention.cu").read_text():
        return legacy_fused_call(lib)
    return fa.flash_bwd_cuda


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("dirs", nargs="*", type=Path)
    parser.add_argument("--ablate", action="store_true")
    parser.add_argument("--ordered", action="store_true")
    parser.add_argument("--out", type=Path,
                        default=ROOT / "build" / "flash_backward_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_backward_variants: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    variants = {"checkout": CSRC}
    variants.update({str(d): d for d in args.dirs})
    if args.ordered:
        variants.update({f"{name}_ordered": csrc
                         for name, csrc in list(variants.items())
                         if "int ordered" in
                         (csrc / "flash_attention.cu").read_text()})
    if args.ablate:
        work = ROOT / "build" / "flash_backward_variants"
        variants.update({n: ablated(n, work) for n in ABLATIONS})
    calls, ptxas = {}, {}
    for name, csrc in variants.items():  # build all before timing any
        lib = use(csrc)
        calls[name] = (ordered_call if name.endswith("_ordered")
                       else fused_call(lib, csrc))
        ptxas[name] = ptxas_summary()
        print(json.dumps({"variant": name, "ptxas": ptxas[name]}), flush=True)

    use(CSRC)  # the forward that makes out and lse: this checkout's
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, s, d = TRAIN
    q, k, v, do = (torch.randn(TRAIN, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    fwd = {causal: fa.flash_attention(q, k, v, causal=causal, return_lse=True)
           for causal in (False, True)}
    want = fa.flash_attention_bwd_plain(q[:1], k[:1], v[:1], fwd[False][0][:1],
                                        fwd[False][1][:1], do[:1])
    flops = 2 * 5 * b * h * s * s * d
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
    readings = [{"variant": "sdpa_backward", "ms": device_ms(
        lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do,
                                    retain_graph=True))}]
    print(json.dumps(readings[0]), flush=True)
    order = list(variants) + list(reversed(variants))
    for name in order:
        use(variants[name])
        call = calls[name]
        out, lse = fwd[False]
        got = call(q[:1], k[:1], v[:1], out[:1], lse[:1], do[:1])
        of_tol = max(float(((g.float() - w.float()).abs()
                            / fa.grad_tolerance(w)).max())
                     for g, w in zip(got, want))
        parts = kernels_ms(lambda: call(q, k, v, out, lse, do))
        reading = {
            "variant": name,
            "ms": device_ms(lambda: call(q, k, v, out, lse, do)),
            "kernels_ms": parts,
            "flash_kernels_ms": sum(ms for key, ms in parts.items()
                                    if "flash_bwd" in key),
            "causal_ms": device_ms(lambda: call(q, k, v, *fwd[True], do,
                                                causal=True)),
            "err_of_tolerance": of_tol,
            "ptxas": ptxas[name],
        }
        reading["tflops"] = flops / reading["ms"] / 1e9
        readings.append(reading)
        print(json.dumps(reading), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "shape": list(TRAIN),
                                    "readings": readings}, indent=1))
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
