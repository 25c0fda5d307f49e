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
// Design for that bound: every thread moves 16 input bytes with one 16-byte
// load and writes 64 output bytes with four 16-byte stores, so a warp reads
// 512 and writes 2048 contiguous bytes per access. The tensor is contiguous
// NHWC, so element i belongs to channel i % C; the per-channel scale and bias
// are staged in shared memory once per block, and no row of width W*C has to
// be pre-tiled (the TPU kernel tiled it for its 128-lane rows). The ragged
// tail (n % 16 elements) is a scalar loop in the last thread. Multiply and add
// are rounded separately (no FMA contraction), so the result is bit-identical
// to the plain PyTorch version, which runs them as two operations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 8;
constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;

struct ChannelAffine {
  float scale[kMaxChannels];
  float bias[kMaxChannels];
};

__global__ void __launch_bounds__(kThreads)
normalize_u8_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                    long long n, int c, ChannelAffine affine) {
  __shared__ float scale[kMaxChannels];
  __shared__ float bias[kMaxChannels];
  if ((int)threadIdx.x < c) {
    scale[threadIdx.x] = affine.scale[threadIdx.x];
    bias[threadIdx.x] = affine.bias[threadIdx.x];
  }
  __syncthreads();

  const long long i0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kBytesPerThread;
  if (i0 >= n) return;
  int ch = (int)(i0 % c);
  if (i0 + kBytesPerThread <= n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(in + i0);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
    float v[kBytesPerThread];
#pragma unroll
    for (int k = 0; k < kBytesPerThread; ++k) {
      v[k] = __fadd_rn(__fmul_rn((float)bytes[k], scale[ch]), bias[ch]);
      ch = (ch + 1 == c) ? 0 : ch + 1;
    }
    float4* dst = reinterpret_cast<float4*>(out + i0);
#pragma unroll
    for (int q = 0; q < kBytesPerThread / 4; ++q) {
      dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
    for (long long i = i0; i < n; ++i) {
      out[i] = __fadd_rn(__fmul_rn((float)in[i], scale[ch]), bias[ch]);
      ch = (ch + 1 == c) ? 0 : ch + 1;
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. `in` and `out` are device pointers, 16-byte
// aligned and contiguous; `scale` and `bias` are host arrays of `c` floats;
// `stream` is the caller's cudaStream_t. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int ai4e_normalize_u8(const void* in, void* out, long long n, int c,
                                 const float* scale, const float* bias,
                                 void* stream, int device) {
  if (c < 1 || c > kMaxChannels) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  ChannelAffine affine = {};
  for (int k = 0; k < c; ++k) {
    affine.scale[k] = scale[k];
    affine.bias[k] = bias[k];
  }
  const long long threads_needed = (n + kBytesPerThread - 1) / kBytesPerThread;
  const unsigned blocks = (unsigned)((threads_needed + kThreads - 1) / kThreads);
  normalize_u8_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (float*)out, n, c, affine);
  return (int)cudaGetLastError();
}
