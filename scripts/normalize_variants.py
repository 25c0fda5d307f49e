"""Time the uint8 normalize kernel against variants of itself, in turns, on
one GPU.

    python3 scripts/normalize_variants.py [--out PATH] [DIR ...]

Each DIR holds an ``image_preprocess.cu`` with the port's C entry
``ai4e_normalize_u8``, for example a parent commit's
``ai4e_tpu_torch/csrc``, unpacked with ``git archive`` into a git-ignored
directory::

    mkdir -p build/parent && git archive HEAD ai4e_tpu_torch/csrc \\
        | tar -x -C build/parent
    python3 scripts/normalize_variants.py build/parent/ai4e_tpu_torch/csrc

An entry from before the wrapper planned the grid (no ``grid``
argument) is called with its own argument list. Besides the DIRs:

- ``checkout``: this checkout's kernel (``ai4e_tpu_torch/csrc``), the
  coalesced register path on a persistent grid, with streaming stores
  (``__stcs``, evict first);
- ``plain_stores``: the same with plain stores;
- ``unroll4``, ``unroll16``: the same with 4 or 16 words in flight a
  thread instead of 8;
- ``ldcs``: the same with streaming loads (``__ldcs``) for ``__ldg``;
- ``occupancy8``: the same with its registers capped for 8 CTAs an SM
  (``__launch_bounds__(256, 8)``);
- ``one_word_a_thread``: the checkout's kernel on a grid of one word a
  thread (no persistent grid);
- ``bulk_ring``: the Hopper streaming shape, from ``BULK_RING`` below: a
  persistent grid of CTAs that each walk 4 KB input chunks through a
  4-stage shared-memory ring filled by 1-D bulk copies on mbarriers,
  convert them into one of two 16 KB staging buffers and write each with a
  1-D bulk store (``cp.async.bulk.global.shared::cta``);
- ``copy_yardstick``: ``torch.empty(..., float32).copy_(x)``, one PyTorch
  call that widens the same uint8 tensor and moves the same bytes without
  the affine (another function: a bandwidth yardstick only);
- ``plain``: ``normalize_image_plain``.

Every variant must equal the plain version bit for bit (``torch.equal``)
at every shape, the ragged ones included, before any is timed. Then all
run in turns, all of them and then all in reverse order, at buckets 1, 16
and 64 of 256x256x3 tiles: median of 25 runs after warm-up by CUDA events
behind a spin kernel, as ``chip_smoke.py`` times. One JSON line per reading
is printed and all of them are written to ``--out``. Needs CUDA; exits
non-zero without it. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ai4e_tpu_torch.ops import _native  # noqa: E402
from ai4e_tpu_torch.ops import image_preprocess as ip  # noqa: E402

CSRC = ROOT / "ai4e_tpu_torch" / "csrc"
WORK = ROOT / "build" / "normalize_variants"
BUCKETS = (1, 16, 64)
TILE = (256, 256, 3)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# Ragged and misaligned shapes every variant must get right, with C.
RAGGED = [((1, 7, 5, 3), 3), ((2, 33, 17, 3), 3), ((1, 1, 1, 1), 1),
          ((3, 61, 67, 4), 4), ((2, 45, 29, 8), 8), ((1, 100, 103, 5), 5)]
PATCHES = {
    "plain_stores": ("__stcs(out + w, make_float4(v[0], v[1], v[2], v[3]));",
                     "out[w] = make_float4(v[0], v[1], v[2], v[3]);"),
    "unroll4": ("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;"),
    "unroll16": ("constexpr int kUnroll = 8;", "constexpr int kUnroll = 16;"),
    "ldcs": ("__ldg(in + w)", "__ldcs(in + w)"),
    "occupancy8": ("__global__ void __launch_bounds__(kThreads)\n"
                   "normalize_u8_kernel",
                   "__global__ void __launch_bounds__(kThreads, 8)\n"
                   "normalize_u8_kernel"),
}

# Design (a): the Hopper streaming shape. Same C entry as the checkout's;
# it plans its own grid (the `grid` argument is only validated).
BULK_RING = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "hopper.cuh"

namespace {

constexpr int kMaxChannels = 8;
constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kChunk = 4096;                       // input bytes a chunk
constexpr int kWords = kChunk / 4;                 // 4-byte words a chunk
constexpr int kIn = 0;                             // the input ring
constexpr int kOut = kStages * kChunk;             // two staging buffers
constexpr int kBar = kOut + 2 * 4 * kChunk;        // kStages mbarriers
constexpr int kSmem = kBar + 8 * kStages;

struct ChannelAffine {
  float scale[kMaxChannels];
  float bias[kMaxChannels];
};

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes)
               : "memory");
}

// Chunks [0, n16 / kChunk) rounded up; bytes [n16, n) (fewer than 16)
// by plain loads in CTA 0.
__global__ void __launch_bounds__(kThreads)
normalize_bulk(const uint8_t* __restrict__ in, float* __restrict__ out,
               long long n, long long n16, int c, ChannelAffine affine) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float scale[kMaxChannels], bias[kMaxChannels];
  const int t = threadIdx.x;
  const uint32_t base = hopper::smem_addr(smem);
  if (t < c) {
    scale[t] = affine.scale[t];
    bias[t] = affine.bias[t];
  }
  if (t == 0) {
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(base + kBar + 8 * st, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (blockIdx.x == 0 && n16 + t < n) {
    const int ch = (int)((n16 + t) % c);
    out[n16 + t] = __fadd_rn(__fmul_rn((float)in[n16 + t], scale[ch]), bias[ch]);
  }
  const long long n_chunks = (n16 + kChunk - 1) / kChunk;
  const long long first = blockIdx.x, step = gridDim.x;
  const int mine = first < n_chunks ? (int)((n_chunks - first + step - 1) / step) : 0;
  auto bytes_of = [&](long long j) {
    const long long left = n16 - j * kChunk;
    return (uint32_t)(left < kChunk ? left : kChunk);
  };
  auto load = [&](int m) {
    const long long j = first + m * step;
    const int st = m % kStages;
    const uint32_t bar = base + kBar + 8 * st;
    hopper::mbar_expect_tx(bar, bytes_of(j));
    hopper::bulk_load(base + kIn + st * kChunk, in + j * kChunk, bytes_of(j), bar);
  };
  if (t == 0) {
    for (int m = 0; m < kStages && m < mine; ++m) load(m);
  }
  for (int m = 0; m < mine; ++m) {
    const long long j = first + m * step;
    const int st = m % kStages, ob = m & 1;
    if (t == 0) hopper::bulk_wait_read<1>();  // buffer ob's store of m - 2
    __syncthreads();
    hopper::mbar_wait(base + kBar + 8 * st, (m / kStages) & 1);
    const uint32_t* words = reinterpret_cast<const uint32_t*>(smem + kIn + st * kChunk);
    float4* staged = reinterpret_cast<float4*>(smem + kOut + ob * 4 * kChunk);
    const int n_words = (int)(bytes_of(j) / 4);
    const int phase = (int)((j * kChunk) % c);
#pragma unroll
    for (int i = 0; i < kWords / kThreads; ++i) {
      const int w = t + i * kThreads;
      if (w < n_words) {
        const uint32_t word = words[w];
        const int p = (phase + 4 * w) % c;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ch = (p + k) % c;
          v[k] = __fadd_rn(__fmul_rn((float)((word >> (8 * k)) & 0xffu), scale[ch]), bias[ch]);
        }
        staged[w] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    hopper::fence_proxy_async();
    __syncthreads();
    if (t == 0) {
      bulk_store(out + j * kChunk, base + kOut + ob * 4 * kChunk, 4 * bytes_of(j));
      hopper::bulk_commit();
      if (m + kStages < mine) load(m + kStages);
    }
  }
  if (t == 0) hopper::bulk_wait<0>();
}

}  // namespace

extern "C" int ai4e_normalize_u8(const void* in, void* out, long long n, int c,
                                 const float* scale, const float* bias,
                                 long long grid, void* stream, int device) {
  if (c < 1 || c > kMaxChannels || grid < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  static int resident = 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(normalize_bulk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, normalize_bulk,
                                                          kThreads, kSmem);
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm;
  }
  ChannelAffine affine = {};
  for (int k = 0; k < c; ++k) {
    affine.scale[k] = scale[k];
    affine.bias[k] = bias[k];
  }
  const long long n16 = n / 16 * 16;
  long long ctas = (n16 + kChunk - 1) / kChunk;
  if (ctas > resident) ctas = resident;
  if (ctas < 1) ctas = 1;
  normalize_bulk<<<(unsigned)ctas, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (float*)out, n, n16, c, affine);
  return (int)cudaGetLastError();
}

extern "C" int ai4e_normalize_u8_resident(int device, int* ctas) {
  *ctas = 1;  // unused: this variant plans its own grid
  return (int)cudaSetDevice(device);
}
"""


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


def variant_dir(name: str, source: str) -> Path:
    """A csrc/ copy under build/ holding ``source`` as image_preprocess.cu."""
    target = WORK / name
    target.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (target / header.name).write_text(header.read_text())
    (target / "image_preprocess.cu").write_text(source)
    return target


def patched(name: str) -> Path:
    old, new = PATCHES[name]
    source = (CSRC / "image_preprocess.cu").read_text()
    if old not in source:
        raise SystemExit(f"variant {name}: its line is not in "
                         f"csrc/image_preprocess.cu any more")
    return variant_dir(name, source.replace(old, new))


def use(csrc: Path) -> ctypes.CDLL:
    """Route the normalize wrapper to the library built from ``csrc``."""
    _native.CSRC_DIR = csrc.resolve()
    _native._loaded.pop("image_preprocess", None)
    ip._fn = None
    ip._resident_ctas.clear()
    return _native.load("image_preprocess")


def legacy_call(lib: ctypes.CDLL):
    """An entry from before the ``grid`` argument: (in, out, n, c, scale,
    bias, stream, device), its grid planned inside."""
    fn = lib.ai4e_normalize_u8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int

    def call(x, mean=None, std=None):
        c = x.shape[-1]
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        scale, bias = ip.channel_affine(mean, std, c)
        out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), c,
                 (ctypes.c_float * c)(*scale.tolist()),
                 (ctypes.c_float * c)(*bias.tolist()),
                 torch.cuda.current_stream().cuda_stream, x.device.index or 0)
        _native.check(err, "normalize (legacy entry)")
        return out
    return call


def one_word_a_thread(x, mean=None, std=None):
    """The checkout's kernel on a grid of one word a thread."""
    device = x.device.index or 0
    ip._resident(device)
    saved = ip._resident_ctas[device]
    ip._resident_ctas[device] = 1 << 30
    try:
        return ip.normalize_image(x, mean, std)
    finally:
        ip._resident_ctas[device] = saved


def copy_yardstick(x, mean=None, std=None):
    return torch.empty(x.shape, dtype=torch.float32,
                       device=x.device).copy_(x)


def plain(x, mean=None, std=None):
    return ip.normalize_image_plain(x, *ip.channel_affine(mean, std,
                                                          x.shape[-1]))


def check_exact(name: str, call, gen) -> None:
    """``call`` equals the plain version bit for bit at the buckets, the
    ragged shapes (ImageNet mean and std where C = 3) and a misaligned
    view."""
    cases = [((b, *TILE), None, None) for b in BUCKETS]
    imagenet = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    for shape, c in RAGGED:
        mean_std = imagenet if c == 3 else (tuple(np.linspace(0.1, 0.9, c)),
                                            tuple(np.linspace(0.2, 0.3, c)))
        cases.append((shape, *mean_std))
    for shape, mean, std in cases:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen)
        x = x.cuda()
        got, want = call(x, mean, std), plain(x, mean, std)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {shape}: "
                                 f"{int((got != want).sum())} differ")
    flat = torch.randint(0, 256, (2 * 31 * 29 * 3 + 1,), dtype=torch.uint8,
                         generator=gen).cuda()
    x = flat[1:].view(2, 31, 29, 3)  # misaligned by one byte
    if not torch.equal(call(x), plain(x)):
        raise AssertionError(f"{name}: misaligned view differs")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("dirs", nargs="*", type=Path)
    parser.add_argument("--out", type=Path,
                        default=ROOT / "build" / "normalize_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("normalize_variants: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    dirs = {"checkout": CSRC}
    dirs.update({str(d): d for d in args.dirs})
    dirs.update({name: patched(name) for name in PATCHES})
    dirs["bulk_ring"] = variant_dir("bulk_ring", BULK_RING)
    calls = {}
    for name, csrc in dirs.items():  # build all before timing any
        lib = use(csrc)
        source = (csrc / "image_preprocess.cu").read_text()
        calls[name] = (ip.normalize_image if "long long grid" in source
                       else legacy_call(lib))
        log = _native.build_log("image_preprocess")
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    calls["one_word_a_thread"] = one_word_a_thread
    dirs["one_word_a_thread"] = CSRC
    calls["copy_yardstick"] = copy_yardstick
    calls["plain"] = plain

    gen = torch.Generator().manual_seed(0)
    for name, call in calls.items():
        if name == "copy_yardstick":
            continue
        use(dirs.get(name, CSRC))
        check_exact(name, call, gen)
        print(json.dumps({"variant": name, "exact": True}), flush=True)

    inputs = {b: torch.randint(0, 256, (b, *TILE), dtype=torch.uint8,
                               generator=gen).cuda() for b in BUCKETS}
    readings = []
    order = list(calls) + list(reversed(calls))
    for name in order:
        use(dirs.get(name, CSRC))
        call = calls[name]
        reading = {"variant": name}
        for b, x in inputs.items():
            ms = device_ms(lambda: call(x))
            reading[f"bucket{b}_ms"] = ms
            reading[f"bucket{b}_tb_per_s"] = 5 * x.numel() / ms / 1e9
        readings.append(reading)
        print(json.dumps(reading), flush=True)
    bounds = {f"bucket{b}_bound_ms": 5 * x.numel() / HBM_BYTES_PER_S * 1e3
              for b, x in inputs.items()}
    print(json.dumps(bounds), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "tile": list(TILE),
                                    "bounds": bounds, "readings": readings},
                                   indent=1))
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
