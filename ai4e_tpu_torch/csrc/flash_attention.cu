// Flash attention for Hopper, forward and backward: online-softmax attention
// that never writes the (S_q, S_k) score matrix to device memory, in either
// pass.
// q (B, H, S_q, D), k/v (B, H, S_k, D), float32 or bfloat16, any B/H/S
// strides with unit stride on D -> out in q's dtype, written through its own
// B/H/S strides, plus the float32 (B, H, S_q) logsumexp when asked for.
//
// Forward. Replaces the TPU kernel `_flash_kernel` in
// ai4e_tpu/ops/pallas/flash_attention.py:73 (driven by `_forward_call` and
// `flash_attention`). Its arithmetic is kept: scores in float32 scaled by
// D**-0.5, masked entries set to NEG_INF = -1e30 (the running max starts
// there too), rows rescaled online, out = acc / max(l, 1e-30) cast to the
// input type, lse = m + log(max(l, 1e-30)). Key tiles wholly above the causal
// diagonal are skipped, as `_block_relevant` does. The TPU version shrank its
// blocks to divisors of S (`_dividing_block`); here ragged tails are masked,
// so a prime S costs no more than its neighbours.
//
// Bound on the H100: operations. 4*B*H*S_q*S_k*D flops (halved for causal)
// against q, k, v and out read or written once: at the served shape
// (64, 2, 4096, 128) bf16 that is 1.10e12 flop and 0.27 GB, at least 1.112
// ms at the 989 TFLOP/s bf16 tensor-core peak and 0.08 ms at 3.35 TB/s.
//
// Design for that bound (bfloat16, the served type; Hopper's wgmma is the
// only way to the tensor cores' full rate, and TMA moves tiles without
// spending the computing threads' registers or instructions): one CTA of
// three warpgroups per (b*h, 128 query rows). Warpgroup 0 is the producer:
// one thread issues TMA loads, Q once, then K and V tiles of 128 keys into a
// two-stage ring in shared memory, each stage with a "full" mbarrier (TMA
// bytes landed) and an "empty" one (both consumers done with it), and the
// warpgroup gives up its registers (setmaxnreg) to the two consumer
// warpgroups, each of which owns 64 query rows. A consumer computes
// S = Q.K^T with wgmma m64n128k16 (Q and K K-major in shared memory, bf16
// in, float32 accumulate), keeps S in registers, runs the online softmax
// there (a row's max and sum are shared by the 4 lanes that hold it), packs
// P to bf16 straight from S's accumulator layout into wgmma's register A
// operand and adds O += P.V with V read MN-major from shared memory; O stays
// in float32 registers. The tensor cores are kept busy two ways: inside a
// consumer, S(i) = Q.K(i)^T and P(i-1).V(i-1) are issued together and the
// softmax of tile i runs while P.V does; and the two consumers take turns
// to issue (named barriers), so one's softmax runs while the other's
// products do. Tiles are swizzled by TMA at 128 bytes (64 bf16: D = 128 is
// two boxes a row; D = 32 and 16 swizzle at 64 and 32 bytes) and the wgmma
// descriptors match. The epilogue divides by l, rounds to bf16 through a
// padded shared tile, and stores 16-byte row chunks through the output's
// strides. Each P is rounded to bf16 for the second product; the row sums
// use the float32 values. D**-0.5 scales the float32 product inside the
// exponent's FMA, 2^(score * D**-0.5 * log2(e) - m) with m the row maximum
// in that base-2 domain (converted back to the natural log for lse); a
// pre-scaled q would not be exact in bf16, and the TPU scaled an exact
// float32 copy. TMA zero-fills rows past S, so keys past S_k are still
// masked explicitly. Not yet done: a persistent grid.
//
// float32 inputs take a plain CUDA-core kernel (32-row tiles, one FMA chain
// per score) that repeats the TPU's float32 products exactly: it is not on the
// served path.
//
// Backward. Replaces `_flash_bwd_dkv_kernel` and `_flash_bwd_dq_kernel`
// (driven by `_flash3_bwd`), the FlashAttention-2 recurrence. Both rebuild
// P = exp(scale * (q.k^T) - lse) from the forward's logsumexp, with q not
// pre-scaled (`_bwd_recompute`), and dS = P * (dO.V^T - Delta), where
// Delta = rowsum(dO * O) comes from the caller in float32. Masked entries
// (causal, ragged tails, padded query rows, whose lse is not a row's) are set
// to P = 0 explicitly. Two deterministic kernels, no atomics, as on the TPU:
// - dK/dV: one CTA of four warps per (b*h, 64-key tile), K and V resident in
//   shared memory; it loops over query tiles, Q, dO, lse and Delta
//   double-buffered (cp.async for Q and dO). Each warp rebuilds S^T and P^T
//   for its 16 key rows, then dP^T = V.dO^T and dS^T = P^T * (dP^T - Delta),
//   and accumulates dV += P^T.dO and dK += dS^T.Q in float32 registers (P
//   and dS rounded to bf16 for the tensor-core products); dK is scaled by
//   D**-0.5 once at the end. Query tiles wholly above the diagonal are
//   skipped. The query tile is 64 rows: at D = 128 the two accumulators
//   take 128 registers a thread and the kernel 254 in all, without a spill
//   (`-Xptxas -v` on sm_90a); a 32-row tile took fewer registers and ran
//   slower.
// - dQ: the forward's shape. One CTA per (b*h, 64 query rows), Q and dO
//   resident, K/V tiles double-buffered; dQ += dS.K in float32 registers,
//   scaled once at the end.
// Bound on the H100: operations. dK/dV does four products (S, dP, dV, dK),
// 8*B*H*S_q*S_k*D flops; dQ three (S, dP, dQ), 6*B*H*S_q*S_k*D: at the
// training shape (8, 2, 4096, 128) bf16, 0.28 and 0.21 TFLOP, 0.28 and 0.21
// ms at the bf16 tensor-core peak. Both also take plain float32 CUDA-core
// kernels for float32 inputs, for the tests.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, S_q) contiguous, or null
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int heads, s_q, s_k, causal;
  float scale;
};

// -- bfloat16 backward: mma.sync tiles -----------------------------------

constexpr int kBlockM = 64;  // query rows per tile, 16 per warp
constexpr int kBlockN = 64;  // keys per tile

template <int D>
struct Tiles {
  static constexpr int kStride = D + 8;              // bf16 per smem row
  static constexpr int kElems = kBlockM * kStride;   // one 64-row tile
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then unread).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [row0, row0 + kRows) of one (S, D) bf16 matrix with row stride `ss`
// into a padded shared tile; rows at or past `rows` are zero-filled, so a
// masked key multiplies a zero V row and never a stale NaN.
template <int D, int kRows = kBlockN>
__device__ __forceinline__ void load_tile(uint16_t* tile,
                                          const uint16_t* base, long long ss,
                                          int row0, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool valid = row0 + r < rows;
    const uint16_t* src = valid ? base + (row0 + r) * ss + col : base;
    cp_async_16(smem_u32(tile + r * Tiles<D>::kStride + col), src, valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- bfloat16 forward: TMA, wgmma, warp specialisation ----------------------

constexpr int kFwdBlockM = 128;  // query rows per CTA, 64 per consumer
constexpr int kFwdBlockN = 128;  // keys per tile
constexpr int kFwdStages = 2;    // K/V ring depth
constexpr int kFwdThreads = 384; // producer warpgroup + two consumers
// setmaxnreg: 128 * 40 + 256 * 232 = 65536, the SM's register file.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// Named barriers: 1 + c, consumer c's epilogue; kTurn + c, consumer c's
// turn to issue its products (see the consumer loop).
constexpr int kTurn = 3;

// The CTA's shared memory, in bytes from a 1024-aligned base: Q, the K and
// V rings (each tile as TMA boxes, see hopper.cuh), two 64-row output
// staging tiles padded by 16 bytes a row, then the mbarriers.
template <int D>
struct FwdSmem {
  static constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;  // bytes a row
  static constexpr int kBoxCols = kSwizzle / 2;
  static constexpr int kLayout = hopper::layout_type(kSwizzle);
  static constexpr int kQBytes = kFwdBlockM * D * 2;
  static constexpr int kKVBytes = kFwdBlockN * D * 2;  // one stage of K or V
  static constexpr int kOStride = D + 8;                // bf16 a staging row
  static constexpr int kOBytes = 64 * kOStride * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kFwdStages * kKVBytes;
  static constexpr int kO = kV + kFwdStages * kKVBytes;
  static constexpr int kBar = kO + 2 * kOBytes;
  // q_full, then k_full, v_full, k_empty, v_empty for each stage.
  static constexpr int kBars = 1 + 4 * kFwdStages;
  static constexpr size_t kBytes = kBar + kBars * 8 + 1024;  // + alignment
};

// The TMA maps of q, k and v, and which coordinate (s, h, b) each map's
// dimensions 1..3 take (hopper::make_operand_map).
struct FwdMaps {
  CUtensorMap q, k, v;
  int q_sel, k_sel, v_sel;
};

// K-major descriptor of rows [row0, row0 + 8n) of a tile of `rows` rows at
// `tile`, 16-column step kc.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int row0, int kc) {
  using S = FwdSmem<D>;
  const int col = kc * 16;
  return hopper::smem_desc(tile + (col / S::kBoxCols) * rows * S::kSwizzle +
                               row0 * S::kSwizzle + (col % S::kBoxCols) * 2,
                           16, 8 * S::kSwizzle, S::kLayout);
}

// MN-major descriptor of V's keys [16 kc, 16 kc + 16), all D columns.
template <int D>
__device__ __forceinline__ uint64_t v_desc(uint32_t tile, int kc) {
  using S = FwdSmem<D>;
  return hopper::smem_desc(tile + kc * 16 * S::kSwizzle,
                           kFwdBlockN * S::kSwizzle, 8 * S::kSwizzle,
                           S::kLayout);
}

// One tile (all D columns, `rows` rows from row `row0` of S) of a q, k or v
// map into shared memory at `dst`, as D / kBoxCols boxes.
template <int D>
__device__ __forceinline__ void load_boxes(uint32_t dst, const CUtensorMap* map,
                                           int sel, uint32_t bar, int rows,
                                           int row0, int h, int b) {
  using S = FwdSmem<D>;
#pragma unroll
  for (int j = 0; j < D / S::kBoxCols; ++j) {
    hopper::tma_load_4d(dst + j * rows * S::kSwizzle, map, bar,
                        j * S::kBoxCols, hopper::coord(sel, 1, row0, h, b),
                        hopper::coord(sel, 2, row0, h, b),
                        hopper::coord(sel, 3, row0, h, b));
  }
}

// S = Q.K^T for one consumer's 64 rows (from row0 of the Q tile) and the
// 128 keys of a K tile, issued and committed as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kFwdBlockN / 2],
                                         uint32_t q_tile, int row0,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    hopper::wgmma_ss<0, 0>(s, kmajor_desc<D>(q_tile, kFwdBlockM, row0, kc),
                           kmajor_desc<D>(k_tile, kFwdBlockN, 0, kc), kc > 0);
  }
  hopper::wgmma_commit();
}

// O += P.V, P (bf16) from registers, V MN-major from shared memory, issued
// and committed as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&a)[kFwdBlockN / 16][4],
    uint32_t v_tile) {
#pragma unroll
  for (int kc = 0; kc < kFwdBlockN / 16; ++kc) {
    hopper::wgmma_rs<1>(o, a[kc], v_desc<D>(v_tile, kc), 1);
  }
  hopper::wgmma_commit();
}

// Online softmax of one S tile in place (s becomes P in float32) for this
// thread's rows row_a and row_a + 8, keys from k0. Entries past S_k or
// above the causal diagonal are set to NEG_INF first where `mask`. Row
// maxima m2 are kept in the base-2 domain, max(score) * scale * log2(e), so
// P = 2^(score * scale2 - m2) is one FMA and one ex2; corr is the factor
// the running sums (done here) and O (done by the caller) are scaled by.
__device__ __forceinline__ void online_softmax(float (&s)[kFwdBlockN / 2],
                                               float (&m2)[2], float (&l)[2],
                                               float (&corr)[2], float scale2,
                                               bool mask, int k0, int s_k,
                                               int causal, int row_a, int t) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < kFwdBlockN / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      if (key >= s_k || (causal && key > row_a + 8 * ((i >> 1) & 1))) {
        s[i] = kNegInf;
      }
    }
  }
  // The row maximum of the raw scores, scaled once: scale2 > 0, so this is
  // exactly the maximum of the scaled ones.
  float m_new[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kFwdBlockN / 2; ++i) {
    m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
    m_new[r] = fmaxf(m2[r], m_new[r] * scale2);
    corr[r] = hopper::ex2(m2[r] - m_new[r]);
    m2[r] = m_new[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kFwdBlockN / 2; ++i) {
    s[i] = hopper::ex2(fmaf(s[i], scale2, -m2[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
}

// P in float32 (an S accumulator) -> the bf16 register A fragments of P.V.
__device__ __forceinline__ void pack_p(uint32_t (&a)[kFwdBlockN / 16][4],
                                       const float (&s)[kFwdBlockN / 2]) {
#pragma unroll
  for (int kc = 0; kc < kFwdBlockN / 16; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kc][r] = pack_bf16(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma(const __grid_constant__ Params p,
                const __grid_constant__ FwdMaps maps) {
  using S = FwdSmem<D>;
  extern __shared__ __align__(16) uint8_t fwd_smem[];
  const uint32_t raw = hopper::smem_addr(fwd_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem = fwd_smem + (base - raw);
  const uint32_t bars = base + S::kBar, q_full = bars;
  auto k_full = [=](int st) { return bars + 8 * (1 + st); };
  auto v_full = [=](int st) { return bars + 8 * (1 + kFwdStages + st); };
  auto k_empty = [=](int st) { return bars + 8 * (1 + 2 * kFwdStages + st); };
  auto v_empty = [=](int st) { return bars + 8 * (1 + 3 * kFwdStages + st); };
  // Tile it's K and V in the ring.
  auto k_tile = [=](int it) {
    return base + S::kK + (it % kFwdStages) * S::kKVBytes;
  };
  auto v_tile = [=](int it) {
    return base + S::kV + (it % kFwdStages) * S::kKVBytes;
  };

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * kFwdBlockM;
  int n_tiles = (p.s_k + kFwdBlockN - 1) / kFwdBlockN;
  if (p.causal) {
    n_tiles = min(n_tiles, (q0 + kFwdBlockM - 1) / kFwdBlockN + 1);
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < kFwdStages; ++st) {
      hopper::mbar_init(k_full(st), 1);
      hopper::mbar_init(v_full(st), 1);
      hopper::mbar_init(k_empty(st), 8);  // lane 0 of each consumer warp
      hopper::mbar_init(v_empty(st), 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(q_full, S::kQBytes);
      load_boxes<D>(base + S::kQ, &maps.q, maps.q_sel, q_full, kFwdBlockM,
                    q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kFwdStages;
        const uint32_t parity = ((it / kFwdStages) & 1) ^ 1;
        hopper::mbar_wait(k_empty(st), parity);
        hopper::mbar_expect_tx(k_full(st), S::kKVBytes);
        load_boxes<D>(k_tile(it), &maps.k, maps.k_sel, k_full(st),
                      kFwdBlockN, it * kFwdBlockN, h, b);
        hopper::mbar_wait(v_empty(st), parity);
        hopper::mbar_expect_tx(v_full(st), S::kKVBytes);
        load_boxes<D>(v_tile(it), &maps.v, maps.v_sel, v_full(st),
                      kFwdBlockN, it * kFwdBlockN, h, b);
      }
    }
  } else {
    // Consumer c: query rows [q0 + 64c, q0 + 64c + 64). Accumulator layout
    // in hopper.cuh: this thread holds rows row_a and row_a + 8. Tile it's
    // softmax overlaps the product P(it-1).V(it-1) on the tensor cores:
    // S(it) = Q.K(it)^T and O += P(it-1).V(it-1) are issued together, the
    // softmax starts when S is in, and O is rescaled once P.V is done. The
    // two consumers take turns to issue (ping-pong on named barriers), so
    // one's softmax runs while the other's products do.
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row_a = q0 + 64 * c + 16 * warp + g;
    const uint32_t q_tile = base + S::kQ;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    const float scale2 = p.scale * kLog2e;  // see online_softmax
    float m2[2] = {kNegInf, kNegInf};
    float l_row[2] = {0.f, 0.f};  // this lane's share until the epilogue
    float s[kFwdBlockN / 2];
    uint32_t a[kFwdBlockN / 16][4];  // P of the previous tile, bf16
    float corr[2];
    auto mask = [&](int it) {
      return (it + 1) * kFwdBlockN > p.s_k ||
             (p.causal && (it + 1) * kFwdBlockN - 1 > q0 + 64 * c);
    };

    const int other = 1 - c;
    if (c == 1) hopper::named_barrier_arrive(kTurn, 256);  // consumer 0 first
    hopper::mbar_wait(q_full, 0);
    hopper::mbar_wait(k_full(0), 0);
    hopper::named_barrier_sync(kTurn + c, 256);
    hopper::wgmma_fence();
    issue_qk<D>(s, q_tile, 64 * c, k_tile(0));
    hopper::named_barrier_arrive(kTurn + other, 256);
    hopper::wgmma_wait<0>();
    hopper::fence_operand(s);
    if (lane == 0) hopper::mbar_arrive(k_empty(0));
    online_softmax(s, m2, l_row, corr, scale2, mask(0), 0, p.s_k, p.causal,
                   row_a, t);
    pack_p(a, s);
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % kFwdStages, prev = (it - 1) % kFwdStages;
      hopper::mbar_wait(k_full(st), (it / kFwdStages) & 1);
      hopper::mbar_wait(v_full(prev), ((it - 1) / kFwdStages) & 1);
      hopper::named_barrier_sync(kTurn + c, 256);
      hopper::wgmma_fence();
      issue_qk<D>(s, q_tile, 64 * c, k_tile(it));
      issue_pv<D>(o, a, v_tile(it - 1));
      hopper::named_barrier_arrive(kTurn + other, 256);
      hopper::wgmma_wait<1>();  // S(it) is in; P(it-1).V(it-1) may run on
      hopper::fence_operand(s);
      if (lane == 0) hopper::mbar_arrive(k_empty(st));
      online_softmax(s, m2, l_row, corr, scale2, mask(it), it * kFwdBlockN,
                     p.s_k, p.causal, row_a, t);
      hopper::wgmma_wait<0>();
      hopper::fence_operand(o);
      hopper::fence_operand(a);
      if (lane == 0) hopper::mbar_arrive(v_empty(prev));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      pack_p(a, s);
    }
    const int last = n_tiles - 1;
    hopper::mbar_wait(v_full(last % kFwdStages), (last / kFwdStages) & 1);
    hopper::named_barrier_sync(kTurn + c, 256);
    hopper::wgmma_fence();
    issue_pv<D>(o, a, v_tile(last));
    // Consumer 1's last turn is handed to nobody: consumer 0 has issued
    // everything by then, and each barrier sees as many arrivals as syncs.
    if (c == 0) hopper::named_barrier_arrive(kTurn + other, 256);
    hopper::wgmma_wait<0>();
    hopper::fence_operand(o);
    if (lane == 0) hopper::mbar_arrive(v_empty(last % kFwdStages));
    const float m_row[2] = {m2[0] / kLog2e, m2[1] / kLog2e};  // natural log

    // Epilogue: out = O / max(l, 1e-30) in bf16 through this warpgroup's
    // staging tile, then 16-byte row chunks to global memory.
    uint16_t* stage =
        reinterpret_cast<uint16_t*>(smem + S::kO + c * S::kOBytes);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
      l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
      const float l = fmaxf(l_row[r], 1e-30f);
      const int local = 16 * warp + g + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint16_t* pair = stage + local * S::kOStride + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(pair) =
            pack_bf16(o[4 * j + 2 * r] / l, o[4 * j + 2 * r + 1] / l);
      }
      const int row = row_a + 8 * r;
      if (p.lse != nullptr && t == 0 && row < p.s_q) {
        p.lse[(long long)bh * p.s_q + row] = m_row[r] + logf(l);
      }
    }
    hopper::named_barrier_sync(1 + c, 128);
    uint16_t* out = static_cast<uint16_t*>(p.o) + b * p.o_sb + h * p.o_sh;
    constexpr int kChunks = D / 8;
    for (int i = tid; i < 64 * kChunks; i += 128) {
      const int local = i / kChunks, chunk = i % kChunks;
      const int row = q0 + 64 * c + local;
      if (row < p.s_q) {
        const uint16_t* from = stage + local * S::kOStride + chunk * 8;
        *reinterpret_cast<uint4*>(out + row * p.o_ss + chunk * 8) =
            *reinterpret_cast<const uint4*>(from);
      }
    }
  }
}

// -- float32: CUDA cores -------------------------------------------------

constexpr int kF32Block = 32;  // query rows per CTA and keys per tile

template <int D>
struct F32Tiles {
  static constexpr int kStride = D + 1;  // odd: a column falls in 32 banks
  static constexpr size_t kBytes =
      (2 * kF32Block * kStride + kF32Block * D + kF32Block * (kF32Block + 1)) * 4;
};

// Thread (r, quarter): query row r of the tile; scores of keys quarter + 4i;
// output dims quarter + 4i. The 4 threads of a row are adjacent lanes.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const Params p) {
  extern __shared__ __align__(16) float smem_f[];
  constexpr int kStride = F32Tiles<D>::kStride;
  float* q_s = smem_f;                     // [32][D+1], pre-scaled
  float* k_s = q_s + kF32Block * kStride;  // [32][D+1]
  float* v_s = k_s + kF32Block * kStride;  // [32][D]
  float* p_s = v_s + kF32Block * D;        // [32][33]

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * kF32Block;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int r = threadIdx.x / 4, quarter = threadIdx.x % 4;
  const int row = q0 + r;

  for (int i = threadIdx.x; i < kF32Block * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    // The TPU kernel scales q before the product: q * scale, then q . k.
    q_s[rr * kStride + d] = q0 + rr < p.s_q ? q[(q0 + rr) * p.q_ss + d] * p.scale : 0.f;
  }

  int n_tiles = (p.s_k + kF32Block - 1) / kF32Block;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kF32Block - 1) / kF32Block + 1);
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kF32Block;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kF32Block * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const bool valid = k0 + j < p.s_k;
      k_s[j * kStride + d] = valid ? k[(k0 + j) * p.k_ss + d] : 0.f;
      v_s[j * D + d] = valid ? v[(k0 + j) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[kF32Block / 4];
    float m_new = m;
#pragma unroll
    for (int i = 0; i < kF32Block / 4; ++i) {
      const int j = quarter + 4 * i;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) x = fmaf(q_s[r * kStride + d], k_s[j * kStride + d], x);
      const int key = k0 + j;
      if (key >= p.s_k || (p.causal && key > row)) x = kNegInf;
      s[i] = x;
      m_new = fmaxf(m_new, x);
    }
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));
    const float corr = expf(m - m_new);
    m = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kF32Block / 4; ++i) {
      s[i] = expf(s[i] - m);
      sum += s[i];
      p_s[r * (kF32Block + 1) + quarter + 4 * i] = s[i];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    __syncwarp();  // a row's P is written and read by the same warp

    float pv[D / 4];
#pragma unroll
    for (int i = 0; i < D / 4; ++i) pv[i] = 0.f;
    for (int j = 0; j < kF32Block; ++j) {
      const float pj = p_s[r * (kF32Block + 1) + j];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) pv[i] = fmaf(pj, v_s[j * D + quarter + 4 * i], pv[i]);
    }
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] = acc[i] * corr + pv[i];
  }

  if (row < p.s_q) {
    float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) o[quarter + 4 * i] = acc[i] / lc;
    if (p.lse != nullptr && quarter == 0) {
      p.lse[(long long)bh * p.s_q + row] = m + logf(lc);
    }
  }
}


// -- backward --------------------------------------------------------------

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, S_q) contiguous
  const float* delta;  // (B, H, S_q) contiguous: rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int heads, s_q, s_k, causal;
  float scale;
};

template <int D, int BM>
struct BwdTiles {
  static constexpr int kStride = Tiles<D>::kStride;
  static constexpr int kKV = kBlockN * kStride;  // K or V, 64 keys
  static constexpr int kQ = BM * kStride;        // Q or dO, BM queries
  // K, V; Q x2, dO x2 (bf16); lse x2, Delta x2 (float32).
  static constexpr size_t kBytes = (2 * kKV + 4 * kQ) * 2 + 4 * BM * 4;
};

// Rows [row0, row0 + n) of a float32 row vector into shared memory, zero
// past `rows`: plain loads, made visible by the next __syncthreads.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    dst[i] = row0 + i < rows ? src[row0 + i] : 0.f;
  }
}

// A warp's 16 rows of `a_tile` (row-major, padded rows) times the rows
// [0, BN) of `b_tile`, transposed: c[BN/8][4] += A . B^T over D. The A and
// B operands are both rows of D values, read with ldmatrix as the forward
// reads Q and K.
template <int D, int BN>
__device__ __forceinline__ void mma_rows(float c[][4], const uint16_t* a_tile,
                                         const uint16_t* b_tile, int warp,
                                         int lane) {
  constexpr int kStride = Tiles<D>::kStride;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(a, smem_u32(a_tile + row * kStride + kc * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < BN / 16; ++np) {
      uint32_t bb[4];
      const int brow = np * 16 + (lane & 7) + (lane >> 4) * 8;
      const int col = kc * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(bb, smem_u32(b_tile + brow * kStride + col));
      mma_bf16(c[2 * np], a, bb[0], bb[1]);
      mma_bf16(c[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// acc[D/8][4] += X . T for a warp: X is the 16 x 16 A fragment of k-chunk
// kc (repacked from an accumulator), T the rows [16 kc, 16 kc + 16) of a
// (rows, D) shared tile, read transposed as the forward reads V.
template <int D>
__device__ __forceinline__ void mma_acc_tile(float acc[][4], const uint32_t x[4],
                                             const uint16_t* tile, int kc,
                                             int lane) {
  constexpr int kStride = Tiles<D>::kStride;
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t tb[4];
    const int row = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = dp * 16 + (lane >> 4) * 8;
    ldmatrix_x4_trans(tb, smem_u32(tile + row * kStride + col));
    mma_bf16(acc[2 * dp], x, tb[0], tb[1]);
    mma_bf16(acc[2 * dp + 1], x, tb[2], tb[3]);
  }
}

// The A fragment of k-chunk kc from the accumulators of n-tiles 2kc, 2kc+1.
__device__ __forceinline__ void repack(uint32_t a[4], const float c[][4],
                                       int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// Rows (g, g + 8) of a warp's 16-row float32 accumulator, scaled, to bf16
// rows of `out` (row stride `ss`), rows at or past `rows` left out.
template <int D>
__device__ __forceinline__ void store_rows(uint16_t* out, long long ss,
                                           const float acc[][4], int row_a,
                                           int rows, int t, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + row * ss + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
    }
  }
}

// dK/dV, bfloat16. Fragment layout as in the forward, with keys as the rows:
// a thread carries key rows g and g + 8 of its warp's 16, and in the S^T and
// dP^T tiles query columns 8 nt + 2t, 8 nt + 2t + 1.
template <int D, int BM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16(const BwdParams p) {
  extern __shared__ __align__(16) uint16_t smem[];
  using T = BwdTiles<D, BM>;
  uint16_t* k_s = smem;
  uint16_t* v_s = k_s + T::kKV;
  uint16_t* q_s = v_s + T::kKV;     // stages 0, 1
  uint16_t* do_s = q_s + 2 * T::kQ;  // stages 0, 1
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * T::kQ);  // stages 0, 1
  float* dl_s = lse_s + 2 * BM;                              // stages 0, 1

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.x * kBlockN;
  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.k_sb + h * p.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint16_t* dout =
      static_cast<const uint16_t*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + (long long)bh * p.s_q;
  const float* delta = p.delta + (long long)bh * p.s_q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_a = k0 + warp * 16 + g;

  const int n_tiles = (p.s_q + BM - 1) / BM;
  // Causal: the first query tile that reaches key k0 (`_block_relevant`).
  const int it0 = p.causal ? k0 / BM : 0;

  load_tile<D>(k_s, k, p.k_ss, k0, p.s_k);
  load_tile<D>(v_s, v, p.v_ss, k0, p.s_k);
  if (it0 < n_tiles) {
    load_tile<D, BM>(q_s, q, p.q_ss, it0 * BM, p.s_q);
    load_tile<D, BM>(do_s, dout, p.do_ss, it0 * BM, p.s_q);
    load_rows(lse_s, lse, it0 * BM, p.s_q, BM);
    load_rows(dl_s, delta, it0 * BM, p.s_q, BM);
  }
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int it = it0; it < n_tiles; ++it) {
    const int stage = (it - it0) & 1;
    if (it + 1 < n_tiles) {  // prefetch into the stage tile it - 1 used
      const int nxt = stage ^ 1;
      load_tile<D, BM>(q_s + nxt * T::kQ, q, p.q_ss, (it + 1) * BM, p.s_q);
      load_tile<D, BM>(do_s + nxt * T::kQ, dout, p.do_ss, (it + 1) * BM, p.s_q);
      load_rows(lse_s + nxt * BM, lse, (it + 1) * BM, p.s_q, BM);
      load_rows(dl_s + nxt * BM, delta, (it + 1) * BM, p.s_q, BM);
    }
    cp_async_commit();  // always, so wait_group 1 covers tile `it`
    cp_async_wait_1();
    __syncthreads();

    const uint16_t* qs = q_s + stage * T::kQ;
    const uint16_t* dos = do_s + stage * T::kQ;
    const float* lse_t = lse_s + stage * BM;
    const float* dl_t = dl_s + stage * BM;
    const int q0 = it * BM;

    // S^T = K . Q^T, then P^T = exp(scale * S^T - lse), masked to 0.
    float s[BM / 8][4];
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    mma_rows<D, BM>(s, k_s, qs, warp, lane);
    const bool mask = q0 + BM > p.s_q ||
                      (p.causal && k0 + warp * 16 + 15 > q0);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t + (e & 1);
        float x = exp2f((s[nt][e] * p.scale - lse_t[qi]) * kLog2e);
        if (mask) {
          const int key = key_a + (e >> 1) * 8, row = q0 + qi;
          if (row >= p.s_q || (p.causal && key > row)) x = 0.f;
        }
        s[nt][e] = x;
      }
    }

    // dP^T = V . dO^T, then dS^T = P^T * (dP^T - Delta) in place.
    float ds[BM / 8][4];
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) ds[i][0] = ds[i][1] = ds[i][2] = ds[i][3] = 0.f;
    mma_rows<D, BM>(ds, v_s, dos, warp, lane);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[nt][e] = s[nt][e] * (ds[nt][e] - dl_t[nt * 8 + 2 * t + (e & 1)]);
      }
    }

    // dV += P^T . dO and dK += dS^T . Q: the queries are the k axis.
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      uint32_t a[4];
      repack(a, s, kc);
      mma_acc_tile<D>(dv_acc, a, dos, kc, lane);
      repack(a, ds, kc);
      mma_acc_tile<D>(dk_acc, a, qs, kc, lane);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  store_rows<D>(static_cast<uint16_t*>(p.dk) + b * p.dk_sb + h * p.dk_sh,
                p.dk_ss, dk_acc, key_a, p.s_k, t, p.scale);
  store_rows<D>(static_cast<uint16_t*>(p.dv) + b * p.dv_sb + h * p.dv_sh,
                p.dv_ss, dv_acc, key_a, p.s_k, t, 1.f);
}

// dQ, bfloat16: the forward's grid and layout, a thread carrying query rows
// g and g + 8 of its warp's 16.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(const BwdParams p) {
  extern __shared__ __align__(16) uint16_t smem[];
  constexpr int kElems = Tiles<D>::kElems;
  uint16_t* q_s = smem;
  uint16_t* do_s = smem + kElems;
  uint16_t* k_s = smem + 2 * kElems;  // stages 0, 1
  uint16_t* v_s = smem + 4 * kElems;  // stages 0, 1

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * kBlockM;
  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.k_sb + h * p.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint16_t* dout =
      static_cast<const uint16_t*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + warp * 16 + g;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool valid = row < p.s_q;
    lse_r[r] = valid ? p.lse[(long long)bh * p.s_q + row] : 0.f;
    dl_r[r] = valid ? p.delta[(long long)bh * p.s_q + row] : 0.f;
  }

  int n_tiles = (p.s_k + kBlockN - 1) / kBlockN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);

  load_tile<D>(q_s, q, p.q_ss, q0, p.s_q);
  load_tile<D>(do_s, dout, p.do_ss, q0, p.s_q);
  load_tile<D>(k_s, k, p.k_ss, 0, p.s_k);
  load_tile<D>(v_s, v, p.v_ss, 0, p.s_k);
  cp_async_commit();

  float dq_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(k_s + (stage ^ 1) * kElems, k, p.k_ss, (it + 1) * kBlockN, p.s_k);
      load_tile<D>(v_s + (stage ^ 1) * kElems, v, p.v_ss, (it + 1) * kBlockN, p.s_k);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const uint16_t* ks = k_s + stage * kElems;
    const uint16_t* vs = v_s + stage * kElems;
    const int k0 = it * kBlockN;

    // S = Q . K^T, then P = exp(scale * S - lse), masked to 0.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    mma_rows<D, kBlockN>(s, q_s, ks, warp, lane);
    const bool mask = k0 + kBlockN > p.s_k || q0 + warp * 16 + 16 > p.s_q ||
                      (p.causal && k0 + kBlockN - 1 > q0 + warp * 16);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2f((s[nt][e] * p.scale - lse_r[e >> 1]) * kLog2e);
        if (mask) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (key >= p.s_k || row >= p.s_q || (p.causal && key > row)) x = 0.f;
        }
        s[nt][e] = x;
      }
    }

    // dP = dO . V^T, then dS = P * (dP - Delta) in place.
    float ds[kBlockN / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) ds[i][0] = ds[i][1] = ds[i][2] = ds[i][3] = 0.f;
    mma_rows<D, kBlockN>(ds, do_s, vs, warp, lane);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = s[nt][e] * (ds[nt][e] - dl_r[e >> 1]);
    }

    // dQ += dS . K: the keys are the k axis.
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      uint32_t a[4];
      repack(a, ds, kc);
      mma_acc_tile<D>(dq_acc, a, ks, kc, lane);
    }
    __syncthreads();
  }

  store_rows<D>(static_cast<uint16_t*>(p.dq) + b * p.dq_sb + h * p.dq_sh,
                p.dq_ss, dq_acc, row_a, p.s_q, t, p.scale);
}

// -- backward, float32: CUDA cores -----------------------------------------

template <int D>
struct F32BwdTiles {
  static constexpr int kStride = D + 1;
  static constexpr int kRow = kF32Block * kStride;
  // Four (32, D) tiles, lse and Delta, two (32, 33) scratch tiles.
  static constexpr size_t kBytes =
      (4 * kRow + 2 * kF32Block + 2 * kF32Block * (kF32Block + 1)) * 4;
};

// Rows [row0, row0 + 32) of one (S, D) float32 matrix into a [32][D+1]
// shared tile, zero past `rows`.
template <int D>
__device__ __forceinline__ void load_f32_tile(float* tile, const float* base,
                                              long long ss, int row0,
                                              int rows) {
  for (int i = threadIdx.x; i < kF32Block * D; i += kThreads) {
    const int r = i / D, d = i % D;
    tile[r * (D + 1) + d] = row0 + r < rows ? base[(row0 + r) * ss + d] : 0.f;
  }
}

// dK/dV, float32. Thread (r, quarter): key row r of the CTA's 32; scores of
// queries quarter + 4i; output dims quarter + 4i.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const BwdParams p) {
  extern __shared__ __align__(16) float smem_f[];
  using T = F32BwdTiles<D>;
  constexpr int kS = T::kStride, kP = kF32Block + 1;
  float* k_s = smem_f;
  float* v_s = k_s + T::kRow;
  float* q_s = v_s + T::kRow;
  float* do_s = q_s + T::kRow;
  float* lse_s = do_s + T::kRow;
  float* dl_s = lse_s + kF32Block;
  float* p_s = dl_s + kF32Block;  // [32][33]: P^T of the tile
  float* ds_s = p_s + kF32Block * kP;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.x * kF32Block;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int r = threadIdx.x / 4, quarter = threadIdx.x % 4;
  const int key = k0 + r;

  load_f32_tile<D>(k_s, k, p.k_ss, k0, p.s_k);
  load_f32_tile<D>(v_s, v, p.v_ss, k0, p.s_k);
  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.f;

  const int n_tiles = (p.s_q + kF32Block - 1) / kF32Block;
  for (int it = p.causal ? k0 / kF32Block : 0; it < n_tiles; ++it) {
    const int q0 = it * kF32Block;
    __syncthreads();  // the previous tile's readers are done
    load_f32_tile<D>(q_s, q, p.q_ss, q0, p.s_q);
    load_f32_tile<D>(do_s, dout, p.do_ss, q0, p.s_q);
    load_rows(lse_s, p.lse + (long long)bh * p.s_q, q0, p.s_q, kF32Block);
    load_rows(dl_s, p.delta + (long long)bh * p.s_q, q0, p.s_q, kF32Block);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kF32Block / 4; ++i) {
      const int j = quarter + 4 * i, row = q0 + j;
      float sc = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        sc = fmaf(k_s[r * kS + d], q_s[j * kS + d], sc);
        dp = fmaf(v_s[r * kS + d], do_s[j * kS + d], dp);
      }
      float pv = expf(sc * p.scale - lse_s[j]);
      if (row >= p.s_q || (p.causal && key > row)) pv = 0.f;
      p_s[r * kP + j] = pv;
      ds_s[r * kP + j] = pv * (dp - dl_s[j]);
    }
    __syncwarp();  // a row's P^T and dS^T are written and read by one warp

    for (int j = 0; j < kF32Block; ++j) {
      const float pj = p_s[r * kP + j], dsj = ds_s[r * kP + j];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        dv[i] = fmaf(pj, do_s[j * kS + quarter + 4 * i], dv[i]);
        dk[i] = fmaf(dsj, q_s[j * kS + quarter + 4 * i], dk[i]);
      }
    }
  }

  if (key < p.s_k) {
    float* dkp = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh + key * p.dk_ss;
    float* dvp = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh + key * p.dv_ss;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      dkp[quarter + 4 * i] = dk[i] * p.scale;
      dvp[quarter + 4 * i] = dv[i];
    }
  }
}

// dQ, float32. Thread (r, quarter): query row r of the CTA's 32; scores of
// keys quarter + 4i; output dims quarter + 4i.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const BwdParams p) {
  extern __shared__ __align__(16) float smem_f[];
  using T = F32BwdTiles<D>;
  constexpr int kS = T::kStride, kP = kF32Block + 1;
  float* q_s = smem_f;
  float* do_s = q_s + T::kRow;
  float* k_s = do_s + T::kRow;
  float* v_s = k_s + T::kRow;
  float* ds_s = v_s + T::kRow;  // [32][33]: dS of the tile

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * kF32Block;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int r = threadIdx.x / 4, quarter = threadIdx.x % 4;
  const int row = q0 + r;
  const bool valid = row < p.s_q;
  const float lse_r = valid ? p.lse[(long long)bh * p.s_q + row] : 0.f;
  const float dl_r = valid ? p.delta[(long long)bh * p.s_q + row] : 0.f;

  load_f32_tile<D>(q_s, q, p.q_ss, q0, p.s_q);
  load_f32_tile<D>(do_s, dout, p.do_ss, q0, p.s_q);
  float dq[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;

  int n_tiles = (p.s_k + kF32Block - 1) / kF32Block;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kF32Block - 1) / kF32Block + 1);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kF32Block;
    __syncthreads();
    load_f32_tile<D>(k_s, k, p.k_ss, k0, p.s_k);
    load_f32_tile<D>(v_s, v, p.v_ss, k0, p.s_k);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kF32Block / 4; ++i) {
      const int j = quarter + 4 * i, key = k0 + j;
      float sc = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        sc = fmaf(q_s[r * kS + d], k_s[j * kS + d], sc);
        dp = fmaf(do_s[r * kS + d], v_s[j * kS + d], dp);
      }
      float pv = expf(sc * p.scale - lse_r);
      if (!valid || key >= p.s_k || (p.causal && key > row)) pv = 0.f;
      ds_s[r * kP + j] = pv * (dp - dl_r);
    }
    __syncwarp();

    for (int j = 0; j < kF32Block; ++j) {
      const float dsj = ds_s[r * kP + j];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) dq[i] = fmaf(dsj, k_s[j * kS + quarter + 4 * i], dq[i]);
    }
  }

  if (valid) {
    float* dqp = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh + row * p.dq_ss;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) dqp[quarter + 4 * i] = dq[i] * p.scale;
  }
}

template <typename Kernel, typename P>
cudaError_t launch(Kernel kernel, size_t smem, int block_rows, int rows,
                   const P& p, int batch_heads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((rows + block_rows - 1) / block_rows),
                  (unsigned)batch_heads);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The bf16 forward: q/k/v tensor maps built here, per call, from the
// pointers and strides in `p`; 384 threads and FwdSmem<D> bytes a CTA.
template <int D>
cudaError_t launch_fwd_bf16(const Params& p, int batch, int batch_heads,
                            cudaStream_t stream) {
  FwdMaps maps;
  cudaError_t err = hopper::make_operand_map(
      &maps.q, p.q, D, p.s_q, p.heads, batch, p.q_sb, p.q_sh, p.q_ss,
      kFwdBlockM, &maps.q_sel);
  if (err == cudaSuccess) {
    err = hopper::make_operand_map(&maps.k, p.k, D, p.s_k, p.heads, batch,
                                   p.k_sb, p.k_sh, p.k_ss, kFwdBlockN,
                                   &maps.k_sel);
  }
  if (err == cudaSuccess) {
    err = hopper::make_operand_map(&maps.v, p.v, D, p.s_k, p.heads, batch,
                                   p.v_sb, p.v_sh, p.v_ss, kFwdBlockN,
                                   &maps.v_sel);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = FwdSmem<D>::kBytes;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.s_q + kFwdBlockM - 1) / kFwdBlockM),
                  (unsigned)batch_heads);
  flash_fwd_wgmma<D><<<grid, kFwdThreads, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, int batch, int batch_heads, bool bf16,
                     cudaStream_t stream) {
  if (bf16) return launch_fwd_bf16<D>(p, batch, batch_heads, stream);
  return launch(flash_fwd_f32<D>, F32Tiles<D>::kBytes, kF32Block, p.s_q, p,
                batch_heads, stream);
}

// One 64-key (32 for float32) tile a CTA: the grid runs over S_k.
template <int D>
cudaError_t launch_dkv(const BwdParams& p, int batch_heads, bool bf16,
                       cudaStream_t stream) {
  if (bf16) {
    return launch(flash_bwd_dkv_bf16<D, kBlockM>, BwdTiles<D, kBlockM>::kBytes,
                  kBlockN, p.s_k, p, batch_heads, stream);
  }
  return launch(flash_bwd_dkv_f32<D>, F32BwdTiles<D>::kBytes, kF32Block,
                p.s_k, p, batch_heads, stream);
}

// One 64-row (32 for float32) query tile a CTA: the grid runs over S_q.
template <int D>
cudaError_t launch_dq(const BwdParams& p, int batch_heads, bool bf16,
                      cudaStream_t stream) {
  if (bf16) {
    return launch(flash_bwd_dq_bf16<D>, 6 * Tiles<D>::kElems * 2, kBlockM,
                  p.s_q, p, batch_heads, stream);
  }
  return launch(flash_bwd_dq_f32<D>, F32BwdTiles<D>::kBytes, kF32Block,
                p.s_q, p, batch_heads, stream);
}

// The backward's checks and parameters, shared by both entry points.
// `strides` holds (B, H, S) element strides of q, k, v, do and then of each
// output in `outs` order.
cudaError_t bwd_params(BwdParams* p, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* delta, int batch, int heads, int s_q,
                       int s_k, const long long* strides, float scale,
                       int causal, int device) {
  if (batch < 1 || heads < 1 || s_q < 1 || s_k < 1 ||
      (long long)batch * heads > 65535 || (causal && s_q != s_k)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  p->q = q; p->k = k; p->v = v; p->dout = dout; p->lse = lse; p->delta = delta;
  p->q_sb = strides[0]; p->q_sh = strides[1]; p->q_ss = strides[2];
  p->k_sb = strides[3]; p->k_sh = strides[4]; p->k_ss = strides[5];
  p->v_sb = strides[6]; p->v_sh = strides[7]; p->v_ss = strides[8];
  p->do_sb = strides[9]; p->do_sh = strides[10]; p->do_ss = strides[11];
  p->heads = heads; p->s_q = s_q; p->s_k = s_k; p->causal = causal;
  p->scale = scale;
  return cudaSuccess;
}

}  // namespace

// C entry point, bound with ctypes. q/k/v/out are device arrays of float32
// (`bf16` == 0) or bfloat16 (`bf16` == 1) with unit stride on D; `strides`
// holds 12 element strides: (B, H, S) of q, k, v and out, in that order.
// Pointers and strides must keep every row 16-byte aligned. `lse` is a
// contiguous float32 (B, H, S_q) device array or null; `scale` is D**-0.5;
// `stream` is the caller's cudaStream_t. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue if the driver refuses a bf16
// operand's tensor map.
extern "C" int ai4e_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* out, float* lse,
                                        int batch, int heads, int s_q, int s_k,
                                        int d, const long long* strides,
                                        float scale, int causal, int bf16,
                                        void* stream, int device) {
  if (batch < 0 || heads < 1 || s_q < 0 || s_k < 1 ||
      (long long)batch * heads > 65535 || (causal && s_q != s_k)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || s_q == 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out; p.lse = lse;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.heads = heads; p.s_q = s_q; p.s_k = s_k; p.causal = causal;
  p.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  const int bh = batch * heads;
  switch (d) {
    case 16: return (int)launch_d<16>(p, batch, bh, bf16 != 0, s);
    case 32: return (int)launch_d<32>(p, batch, bh, bf16 != 0, s);
    case 64: return (int)launch_d<64>(p, batch, bh, bf16 != 0, s);
    case 128: return (int)launch_d<128>(p, batch, bh, bf16 != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one CTA of the bf16 forward at head dim `d`, in
// bytes (0 for a head dim it does not take): for reports.
extern "C" int ai4e_flash_attention_fwd_smem(int d) {
  switch (d) {
    case 16: return (int)FwdSmem<16>::kBytes;
    case 32: return (int)FwdSmem<32>::kBytes;
    case 64: return (int)FwdSmem<64>::kBytes;
    case 128: return (int)FwdSmem<128>::kBytes;
    default: return 0;
  }
}

// C entry points of the backward, bound with ctypes. q/k/v/dout and the
// outputs are device arrays of float32 (`bf16` == 0) or bfloat16 (`bf16` ==
// 1) with unit stride on D, every row 16-byte aligned; `lse` and `delta` are
// contiguous float32 (B, H, S_q) device arrays: the forward's logsumexp and
// rowsum(dout * out). `strides` holds (B, H, S) element strides of q, k, v
// and dout, then of the outputs: dk and dv (18 in all) for dkv, dq (15) for
// dq. `scale` is D**-0.5. Return cudaGetLastError() after the launch.
extern "C" int ai4e_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int batch,
    int heads, int s_q, int s_k, int d, const long long* strides, float scale,
    int causal, int bf16, void* stream, int device) {
  BwdParams p;
  cudaError_t err = bwd_params(&p, q, k, v, dout, lse, delta, batch, heads,
                               s_q, s_k, strides, scale, causal, device);
  if (err != cudaSuccess) return (int)err;
  p.dq = nullptr; p.dk = dk; p.dv = dv;
  p.dq_sb = p.dq_sh = p.dq_ss = 0;
  p.dk_sb = strides[12]; p.dk_sh = strides[13]; p.dk_ss = strides[14];
  p.dv_sb = strides[15]; p.dv_sh = strides[16]; p.dv_ss = strides[17];
  const cudaStream_t s = (cudaStream_t)stream;
  const int bh = batch * heads;
  switch (d) {
    case 16: return (int)launch_dkv<16>(p, bh, bf16 != 0, s);
    case 32: return (int)launch_dkv<32>(p, bh, bf16 != 0, s);
    case 64: return (int)launch_dkv<64>(p, bh, bf16 != 0, s);
    case 128: return (int)launch_dkv<128>(p, bh, bf16 != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ai4e_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int batch, int heads,
    int s_q, int s_k, int d, const long long* strides, float scale,
    int causal, int bf16, void* stream, int device) {
  BwdParams p;
  cudaError_t err = bwd_params(&p, q, k, v, dout, lse, delta, batch, heads,
                               s_q, s_k, strides, scale, causal, device);
  if (err != cudaSuccess) return (int)err;
  p.dq = dq; p.dk = nullptr; p.dv = nullptr;
  p.dq_sb = strides[12]; p.dq_sh = strides[13]; p.dq_ss = strides[14];
  p.dk_sb = p.dk_sh = p.dk_ss = p.dv_sb = p.dv_sh = p.dv_ss = 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int bh = batch * heads;
  switch (d) {
    case 16: return (int)launch_dq<16>(p, bh, bf16 != 0, s);
    case 32: return (int)launch_dq<32>(p, bh, bf16 != 0, s);
    case 64: return (int)launch_dq<64>(p, bh, bf16 != 0, s);
    case 128: return (int)launch_dq<128>(p, bh, bf16 != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
