// Segmentation postprocess for Hopper: per-pixel argmax over C class logits,
// fused with the per-image class histogram.
// (B, H, W, C) float32 or bfloat16 logits -> (B, C) int32 counts, plus the
// (B, H, W) uint8 class map when asked for.
//
// Replaces the TPU kernel `_argmax_kernel` in
// ai4e_tpu/ops/pallas/seg_postprocess.py (driven by `segmentation_argmax`),
// and the XLA one-hot sum `class_histogram` that counted its map.
//
// Semantics kept from the TPU kernel: the argmax compares with strict `>`
// from c = 0 upward, so ties go to the lower class, and a NaN logit never
// wins unless it sits at c = 0 (every comparison with NaN is false).
//
// Bound on the H100: memory traffic. Each pixel is C logits read and at most
// one byte written, with C-1 comparisons. A bucket-64 batch of 256x256x4
// float32 logits is 67.1 MB read: at least 20.0 us at 3.35 TB/s counts-only,
// 21.3 us with the 4.2 MB map written too.
//
// Design for that bound: one thread per pixel reads its C logits with one
// vector load when C == 4 (16 bytes of float32, 8 of bfloat16), so a warp
// reads 512 contiguous bytes; the map is written only when asked for; the
// histogram never leaves the chip until the end. Each thread counts its own
// pixels in registers, a warp sums those with shuffles, a block sums its
// warps in shared memory, and the block adds its C totals to the zeroed
// (B, C) output with one atomic each. A block covers pixels of one image only
// (a one-dimensional grid of B x blocks per image, the image outer, so B has
// no 65,535 limit), so no count crosses images. The TPU kernel's
// transpose to (B, C, H, W) existed for its 128-lane axis and is not needed:
// the logits are read in NHWC as the UNet head writes them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 8;

__device__ __forceinline__ float bf16_to_float(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);
}

__device__ __forceinline__ float logit_at(const float* p, int k) { return p[k]; }
__device__ __forceinline__ float logit_at(const uint16_t* p, int k) {
  return bf16_to_float(p[k]);
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const uint16_t* p, float v[4]) {
  // Four bfloat16 in one 8-byte load; element 0 is the low half of .x.
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// kC > 0: the class count is a compile-time constant and each thread keeps
// its counts in registers. kC == 0: any class count `c` up to 256 (class
// 255 is the uint8 map's last), counted with shared-memory atomics (no
// vector load, no register counts).
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
seg_postprocess_kernel(const T* __restrict__ logits,
                       uint8_t* __restrict__ classmap,
                       int* __restrict__ counts, int hw, int c,
                       int per_image) {
  extern __shared__ int block_hist[];
  const int nc = kC > 0 ? kC : c;
  for (int k = threadIdx.x; k < nc; k += blockDim.x) block_hist[k] = 0;
  __syncthreads();

  const int b = blockIdx.x / per_image, block = blockIdx.x % per_image;
  const T* image = logits + (size_t)b * hw * nc;
  uint8_t* map = classmap == nullptr ? nullptr : classmap + (size_t)b * hw;
  int local[kC > 0 ? kC : 1] = {};

  // The loop bound is block-uniform, so every lane of a warp runs the same
  // iterations and reaches the shuffles below together.
  const int stride = per_image * blockDim.x;
  for (int base = block * blockDim.x; base < hw; base += stride) {
    const int p = base + threadIdx.x;
    if (p >= hw) continue;
    const T* px = image + (size_t)p * nc;
    int best_k = 0;
    if constexpr (kC == 4) {
      float v[4];
      load4(px, v);
      float best = v[0];
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        if (v[k] > best) { best = v[k]; best_k = k; }
      }
    } else {
      float best = logit_at(px, 0);
      for (int k = 1; k < nc; ++k) {
        const float v = logit_at(px, k);
        if (v > best) { best = v; best_k = k; }
      }
    }
    if (map != nullptr) map[p] = (uint8_t)best_k;
    if constexpr (kC > 0) {
#pragma unroll
      for (int k = 0; k < kC; ++k) local[k] += (best_k == k);
    } else {
      atomicAdd(&block_hist[best_k], 1);
    }
  }

  if constexpr (kC > 0) {
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      int v = local[k];
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, offset);
      }
      if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(&block_hist[k], v);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nc; k += blockDim.x) {
    if (block_hist[k] != 0) atomicAdd(&counts[(size_t)b * nc + k], block_hist[k]);
  }
}

template <typename T>
cudaError_t launch(const void* logits, void* classmap, void* counts, int batch,
                   int hw, int c, cudaStream_t stream) {
  const int per_block = kThreads * kPixelsPerThread;
  const int per_image = (hw + per_block - 1) / per_block;
  const long long grid = (long long)per_image * batch;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t shared = (size_t)c * sizeof(int);
  if (c == 4) {
    seg_postprocess_kernel<T, 4><<<(unsigned)grid, kThreads, shared, stream>>>(
        (const T*)logits, (uint8_t*)classmap, (int*)counts, hw, c, per_image);
  } else {
    seg_postprocess_kernel<T, 0><<<(unsigned)grid, kThreads, shared, stream>>>(
        (const T*)logits, (uint8_t*)classmap, (int*)counts, hw, c, per_image);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. `logits` is a contiguous (B, H*W, C)
// device array, float32 (`bf16` == 0) or bfloat16 (`bf16` == 1), aligned to
// 16 bytes; `classmap` is a (B, H*W) uint8 device array or null (counts
// only); `counts` is a zeroed (B, C) int32 device array; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int ai4e_seg_postprocess(const void* logits, void* classmap,
                                    void* counts, int batch, int hw, int c,
                                    int bf16, void* stream, int device) {
  if (c < 1 || c > 256 || batch < 0 || hw < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || hw == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  err = bf16 ? launch<uint16_t>(logits, classmap, counts, batch, hw, c, s)
             : launch<float>(logits, classmap, counts, batch, hw, c, s);
  return (int)err;
}

// The attributes of the kernel that `ai4e_seg_postprocess` launches for `c`
// classes of float32 (`bf16` == 0) or bfloat16 logits, for the validation
// harness (ops/validate.py). Writes 5 ints to `out`: dynamic shared memory
// a CTA as launched (the block's histogram), static shared memory,
// registers a thread, local (spill) bytes a thread, threads a CTA. Returns
// a cudaError_t (0 on success).
extern "C" int ai4e_seg_postprocess_attrs(int c, int bf16, int device,
                                          int* out) {
  if (c < 1 || c > 256) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (c == 4) {
    err = bf16 ? cudaFuncGetAttributes(&a, seg_postprocess_kernel<uint16_t, 4>)
               : cudaFuncGetAttributes(&a, seg_postprocess_kernel<float, 4>);
  } else {
    err = bf16 ? cudaFuncGetAttributes(&a, seg_postprocess_kernel<uint16_t, 0>)
               : cudaFuncGetAttributes(&a, seg_postprocess_kernel<float, 0>);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = c * (int)sizeof(int);
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = kThreads;
  return 0;
}
