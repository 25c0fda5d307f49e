// uint8 image normalisation for Hopper: (B, H, W, C) uint8 -> float32.
//
// Replaces the TPU kernel `_normalize_kernel` in
// ai4e_tpu/ops/pallas/image_preprocess.py (driven by `normalize_image`):
// out = x * scale[c] + bias[c], with scale = 1/(255*std) and bias = -mean/std.
//
// Bound on the H100: memory traffic. Each element is one byte read, four
// bytes written and one multiply-add, about 0.4 operations per byte, far
// below the ~20 float32 operations per byte where the arithmetic would
// start to matter. A bucket-64 batch of 256x256x3 tiles moves 62.9 MB,
// so it needs at least 18.8 us at 3.35 TB/s.
//
// Design for that bound: every access of a warp covers whole cache lines.
// The tensor is contiguous NHWC, so element i belongs to channel i % C, and
// it is walked as 4-byte words: word w (input bytes 4w .. 4w + 3) becomes
// the float4 at output element 4w. Thread t of a warp reads word w0 + t and
// writes float4 w0 + t, so one load instruction moves 128 contiguous bytes
// and one store instruction 512, both in whole 128-byte lines. Each thread
// issues kUnroll loads before its first store, to keep enough bytes in
// flight. The grid is persistent (as many CTAs as are resident at once,
// capped by the work there is) and a multiple of C CTAs, so the grid's
// stride in words is a multiple of C: a thread's channel phase (4w mod C)
// never changes, and its four scales and biases are loaded once into
// registers. That makes every C from 1 to kMaxChannels as fast as any
// other, so the kernel is not specialised on C. The stores are streaming
// (`__stcs`, evict first): the output is written once here and is as
// large as L2 at bucket 64 (0.028 against 0.032 ms with plain stores,
// timed in turns on an H100 80GB HBM3 at 700 W). The last n % 4 elements
// are done one by one by the first threads. Multiply and add are rounded
// separately (no FMA contraction), so the result is bit-identical to the
// plain PyTorch version, which runs them as two operations.
//
// A thread that writes 64 contiguous output bytes with four 16-byte stores
// would make each store instruction of a warp touch 16 lines where 4 would
// do, half of each 32-byte sector at a time. scripts/normalize_variants.py
// times this kernel in turns against other versions and variants.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 8;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // words a thread has in flight

struct ChannelAffine {
  float scale[kMaxChannels];
  float bias[kMaxChannels];
};

__global__ void __launch_bounds__(kThreads)
normalize_u8_kernel(const uint32_t* __restrict__ in, float4* __restrict__ out,
                    long long n_words, const uint8_t* __restrict__ tail_in,
                    float* __restrict__ tail_out, int n_tail, int c,
                    ChannelAffine affine) {
  __shared__ float scale[kMaxChannels];
  __shared__ float bias[kMaxChannels];
  if ((int)threadIdx.x < c) {
    scale[threadIdx.x] = affine.scale[threadIdx.x];
    bias[threadIdx.x] = affine.bias[threadIdx.x];
  }
  __syncthreads();

  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;  // C | stride
  if (g < n_tail) {  // elements past the last whole word
    const int ch = (int)((4 * n_words + g) % c);
    tail_out[g] = __fadd_rn(__fmul_rn((float)tail_in[g], scale[ch]), bias[ch]);
  }
  float s[4], b[4];
  const int phase = (int)((4 * g) % c);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ch = (phase + k) % c;
    s[k] = scale[ch];
    b[k] = bias[ch];
  }
  for (long long w0 = g; w0 < n_words; w0 += kUnroll * stride) {
    uint32_t word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = w0 + u * stride;
      word[u] = w < n_words ? __ldg(in + w) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = w0 + u * stride;
      if (w < n_words) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = __fadd_rn(
              __fmul_rn((float)((word[u] >> (8 * k)) & 0xffu), s[k]), b[k]);
        }
        __stcs(out + w, make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  }
}

}  // namespace

// CTAs of normalize_u8_kernel resident at once on `device`, to `ctas`: the
// persistent grid's cap (the wrapper plans the grid, `launch_plan`).
// Returns a cudaError_t (0 on success).
extern "C" int ai4e_normalize_u8_resident(int device, int* ctas) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, normalize_u8_kernel, kThreads, 0);
  }
  *ctas = sms * per_sm;
  return (int)err;
}

// C entry point, bound with ctypes. `in` and `out` are device pointers, `in`
// 4-byte and `out` 16-byte aligned, both contiguous, n elements; `scale`
// and `bias` are host arrays of `c` floats; `grid` is the number of CTAs of
// 256 threads, a multiple of `c` (`launch_plan` in ops/image_preprocess.py);
// `stream` is the caller's cudaStream_t. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int ai4e_normalize_u8(const void* in, void* out, long long n, int c,
                                 const float* scale, const float* bias,
                                 long long grid, void* stream, int device) {
  if (c < 1 || c > kMaxChannels || grid < 1 || grid % c != 0 ||
      grid > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  ChannelAffine affine = {};
  for (int k = 0; k < c; ++k) {
    affine.scale[k] = scale[k];
    affine.bias[k] = bias[k];
  }
  const long long n_words = n / 4;
  normalize_u8_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (float4*)out, n_words,
      (const uint8_t*)in + 4 * n_words, (float*)out + 4 * n_words,
      (int)(n % 4), c, affine);
  return (int)cudaGetLastError();
}

// The attributes of normalize_u8_kernel, for the validation harness
// (ops/validate.py). Writes 5 ints to `out`: dynamic shared memory a CTA as
// launched (none), static shared memory, registers a thread, local (spill)
// bytes a thread, threads a CTA. Returns a cudaError_t (0 on success).
extern "C" int ai4e_normalize_u8_attrs(int device, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, normalize_u8_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = 0;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = kThreads;
  return 0;
}
