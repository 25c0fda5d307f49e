// Flash attention for Hopper, forward and backward: online-softmax attention
// that never writes the (S_q, S_k) score matrix to device memory, in either
// pass.
// q (B, H, S_q, D), k/v (B, H, S_k, D), float32 or bfloat16, any B/H/S
// strides with unit stride on D -> out in q's dtype, written through its own
// B/H/S strides, plus the float32 (B, H, S_q) logsumexp when asked for.
//
// Head dims: every kernel is instantiated at D = 16, 32, 64, 128 and 256
// (the tiles' width) and runs any head dim d up to it (`tile_d` picks the
// narrowest that holds d): the bf16 tensor maps' inner extent is d, so TMA
// reads the columns past d as zero, which leave every score and Delta
// unchanged and make the output and gradient columns past d zero; the
// float32 kernels mask them; every store stops at d. d is a whole number
// of 16-byte chunks (ops/flash_attention.py pads other rows). Grids are
// one-dimensional, B*H a factor of blockIdx.x, so B*H has no 65,535 limit.
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
// At D = 256 (`FwdTile`) a consumer's O accumulator is 128 registers a
// thread, so a K/V tile holds 64 keys, P.V runs as two N = 128 products, and
// the epilogue stages O in the Q tile's rows.
//
// float32 inputs take a plain CUDA-core kernel (32-row tiles, one FMA chain
// per score) that repeats the TPU's float32 products exactly: it is not on the
// served path.
//
// Backward. Replaces `_flash_bwd_dkv_kernel` (flash_attention.py:160) and
// `_flash_bwd_dq_kernel` (:197), driven by `_flash3_bwd`: the
// FlashAttention-2 recurrence. P = exp(scale * (q.k^T) - lse) is rebuilt
// from the forward's logsumexp, with q not pre-scaled (`_bwd_recompute`),
// dS = P * (dO.V^T - Delta) with Delta = rowsum(dO * O) in float32, then
// dV = P^T.dO, dK = scale * dS^T.Q and dQ = scale * dS.K. Masked entries
// (causal, keys past S_k, padded query rows, whose lse is not a row's) are
// set to P = 0 explicitly.
//
// Bound on the H100: operations. Five products (S, dP, dV, dK, dQ), 10 *
// B*H*S_q*S_k*D flops (about half under causal): at the training shape
// (8, 2, 4096, 128) bf16, 0.344 TFLOP, 0.347 ms at the bf16 tensor-core
// peak, against 0.1 GB of q, k, v, dO, O and gradients (0.03 ms).
//
// bfloat16: one fused kernel, `flash_bwd_wgmma` (FlashAttention-3's shape),
// between two small passes. One CTA of 384 threads per (b*h, 128 keys);
// under causal the key tiles that own the most query tiles start first.
// Warpgroup 0 is the producer (24 registers after setmaxnreg): one thread
// TMA-loads the CTA's K and V once, then walks the query tiles (from the
// diagonal under causal), loading each tile's 64 rows of Q and dO and, by
// bulk copies, their 64 lse and Delta values into a two-stage mbarrier ring.
// Warpgroups 1 and 2 are consumers (240 registers), each owning 64 of the
// keys, so that keys are the M dimension of their products. S^T = K.Q^T and
// dP^T = V.dO^T come from wgmma m64n64k16 (K, V, Q and dO K-major in shared
// memory); P^T and dS^T are computed in float32 in the accumulator layout
// and, packed to bf16, are exactly the register A operands of
// dV += P^T.dO and dK += dS^T.Q (dO and Q read MN-major). dK and dV stay in
// float32 registers for the whole loop and are stored once, dK scaled by
// D**-0.5: deterministic. For dQ the two consumers write their dS^T (bf16)
// into one shared tile of 128 keys x 64 queries, swizzled as TMA would store
// it, meet on a named barrier, and compute dQ = dS.K with A = dS read
// MN-major from that tile (tnspA) and B = K MN-major: at D = 128 each
// consumer takes 64 columns over all 128 keys, at a narrower D all columns
// over its own 64 keys. Both consumers run the same code: a wgmma that only
// one of them reaches made ptxas serialise every wgmma of the kernel
// (warning C7520) and spill 180 bytes at D = 128: 1.23 ms against 0.68 at
// the training shape.
// Each stores its float32 dQ tile to shared memory in register order
// (conflict-free) and one thread adds it into a float32 accumulator in
// device memory with one bulk reduce-add (cp.reduce.async.bulk .add.f32,
// done in L2). The accumulator is padded to s_pad = 64 * ceil(S_q / 64)
// rows, so padded rows need no guard. The dS^T tile is double-buffered, so
// one barrier per query tile orders both its reuse and the dQ tile's. By
// default dQ is therefore not bitwise deterministic from run to run: its
// float32 adds land in L2 in whatever order the CTAs reach them. Ordered
// (`kOrdered`, what the wrapper asks for under PyTorch's
// deterministic-algorithms flag), FlashAttention-3's deterministic mode: a
// counter per (b*h, query tile, dQ column block) in device memory, zeroed
// by the preparation pass, admits the adds in ascending key-tile order (at
// D < 128 consumer 0 before consumer 1). A writer warp of the producer
// warpgroup issues them, so the consumers only hand it their dQ tiles in
// shared memory: it spins on the counter with an acquire load, and
// increments it with release semantics once its adds are complete in L2
// (not only their tiles read), which it checks after the next tile's adds
// are issued. Ordered, the key tile is the grid's outer index, as under
// causal, and under causal each CTA walks its query tiles from the last
// one down. The
// reference's `_flash_bwd_dq_kernel` sums each dQ tile in one program, so
// its dQ is repeatable too. P and dS are rounded to
// bf16 for the tensor cores, with float32 accumulation. The passes around
// it: `flash_bwd_prep` (Delta in float32, lse * log2(e), both padded to
// s_pad, and the accumulator zeroed: one read of dO and O) and
// `flash_bwd_dq_convert` (dq = D**-0.5 * accumulator, rounded to bf16 and
// written through dq's strides). `-Xptxas -v`: 168 registers at entry (the
// launch bound's cap; the consumers raise theirs to 240), 0 spill bytes at
// every D; 198,696 bytes of shared memory a CTA at D = 128 (59,432 /
// 84,008 / 133,160 at D = 16 / 32 / 64). scripts/flash_backward_variants.py
// times it in turns against other csrc/ copies and ablated ones.
//
// At D = 256 the fused kernel is `flash_bwd_wgmma_wide` (see there): 64 keys
// a CTA, the two consumers splitting dK, dV and dQ's columns.
//
// float32 inputs take the same preparation pass, then plain CUDA-core
// kernels (dK/dV over 32-key CTAs, dQ over 32-row CTAs) that repeat the
// TPU's float32 products: for the tests, not on the trained path.

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
  // d: the operands' head dim, at most the instantiation's D (the tiles'
  // width), a multiple of 8 in bf16 and of 4 in float32; columns past it
  // read as zero and are not written.
  int heads, s_q, s_k, d, causal;
  float scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// A bf16 tile of D columns as TMA loads it (hopper.cuh): boxes of kBoxCols
// columns, rows kSwizzle bytes apart and swizzled at kSwizzle bytes.
template <int D>
struct Swizzled {
  static constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;  // bytes a row
  static constexpr int kBoxCols = kSwizzle / 2;
  static constexpr int kLayout = hopper::layout_type(kSwizzle);
};

// -- bfloat16 forward: TMA, wgmma, warp specialisation ----------------------

constexpr int kFwdBlockM = 128;  // query rows per CTA, 64 per consumer
constexpr int kFwdStages = 2;    // K/V ring depth
constexpr int kFwdThreads = 384; // producer warpgroup + two consumers
// setmaxnreg: 128 * 40 + 256 * 232 = 65536, the SM's register file.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// Named barriers: 1 + c, consumer c's epilogue; kTurn + c, consumer c's
// turn to issue its products (see the consumer loop).
constexpr int kTurn = 3;

// The bf16 forward's tiles at head dim D. Up to D = 128 a K/V tile holds
// 128 keys and each consumer stages its O for the epilogue in a tile of its
// own. At D = 256 a consumer's O accumulator alone is 128 float32 registers
// a thread (64 rows x 256), so a K/V tile holds 64 keys (S then takes 32
// registers, P 16), P.V runs as two N = 128 products, and O is staged in
// the consumer's own 64 rows of the Q tile, which no product reads once its
// key loop is done: Q (64 KB) and two stages of K and V (128 KB) then fill
// the shared memory.
template <int D>
struct FwdTile {
  static constexpr int kBlockN = D > 128 ? 64 : 128;  // keys a K/V tile
  static constexpr int kOParts = D > 128 ? 2 : 1;     // P.V products a tile
  static constexpr int kOCols = D / kOParts;          // columns of each
  static constexpr bool kStageInQ = D > 128;
};

// The CTA's shared memory, in bytes from a 1024-aligned base: Q, the K and
// V rings (each tile as TMA boxes, see hopper.cuh), up to D = 128 two
// 64-row output staging tiles padded by 16 bytes a row, then the mbarriers.
template <int D>
struct FwdSmem {
  static constexpr int kQBytes = kFwdBlockM * D * 2;
  // One stage of K or V.
  static constexpr int kKVBytes = FwdTile<D>::kBlockN * D * 2;
  static constexpr int kOStride = D + 8;  // bf16 a staging row
  static constexpr int kOBytes =
      FwdTile<D>::kStageInQ ? 0 : 64 * kOStride * 2;
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
  using S = Swizzled<D>;
  const int col = kc * 16;
  return hopper::smem_desc(tile + (col / S::kBoxCols) * rows * S::kSwizzle +
                               row0 * S::kSwizzle + (col % S::kBoxCols) * 2,
                           16, 8 * S::kSwizzle, S::kLayout);
}

// MN-major descriptor of rows [16 kc, 16 kc + 16) of a tile of `rows` rows
// at `tile`, all its columns from the box at `tile` on (V in P.V).
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows,
                                                 int kc) {
  using S = Swizzled<D>;
  return hopper::smem_desc(tile + kc * 16 * S::kSwizzle, rows * S::kSwizzle,
                           8 * S::kSwizzle, S::kLayout);
}

// One tile (all D columns, `rows` rows from row `row0` of S) of an operand
// map into shared memory at `dst`, as D / kBoxCols boxes.
template <int D>
__device__ __forceinline__ void load_boxes(uint32_t dst, const CUtensorMap* map,
                                           int sel, uint32_t bar, int rows,
                                           int row0, int h, int b) {
  using S = Swizzled<D>;
#pragma unroll
  for (int j = 0; j < D / S::kBoxCols; ++j) {
    hopper::tma_load_4d(dst + j * rows * S::kSwizzle, map, bar,
                        j * S::kBoxCols, hopper::coord(sel, 1, row0, h, b),
                        hopper::coord(sel, 2, row0, h, b),
                        hopper::coord(sel, 3, row0, h, b));
  }
}

// S = Q.K^T for one consumer's 64 rows (from row0 of the Q tile) and the
// keys of a K tile, issued and committed as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[FwdTile<D>::kBlockN / 2],
                                         uint32_t q_tile, int row0,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    hopper::wgmma_ss<0, 0>(
        s, kmajor_desc<D>(q_tile, kFwdBlockM, row0, kc),
        kmajor_desc<D>(k_tile, FwdTile<D>::kBlockN, 0, kc), kc > 0);
  }
  hopper::wgmma_commit();
}

// O += P.V, P (bf16) from registers, V MN-major from shared memory, issued
// and committed as one wgmma group: O's column block `part` (kOCols wide)
// reads V from its first box on.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[FwdTile<D>::kOParts][FwdTile<D>::kOCols / 2],
    const uint32_t (&a)[FwdTile<D>::kBlockN / 16][4], uint32_t v_tile) {
  using T = FwdTile<D>;
  using S = Swizzled<D>;
#pragma unroll
  for (int kc = 0; kc < T::kBlockN / 16; ++kc) {
#pragma unroll
    for (int part = 0; part < T::kOParts; ++part) {
      hopper::wgmma_rs<1>(
          o[part], a[kc],
          mnmajor_desc<D>(v_tile + part * (T::kOCols / S::kBoxCols) *
                                       T::kBlockN * S::kSwizzle,
                          T::kBlockN, kc),
          1);
    }
  }
  hopper::wgmma_commit();
}

// Online softmax of one S tile in place (s becomes P in float32) for this
// thread's rows row_a and row_a + 8, keys from k0. Entries past S_k or
// above the causal diagonal are set to NEG_INF first where `mask`. Row
// maxima m2 are kept in the base-2 domain, max(score) * scale * log2(e), so
// P = 2^(score * scale2 - m2) is one FMA and one ex2; corr is the factor
// the running sums (done here) and O (done by the caller) are scaled by.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2],
                                               float (&m2)[2], float (&l)[2],
                                               float (&corr)[2], float scale2,
                                               bool mask, int k0, int s_k,
                                               int causal, int row_a, int t) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
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
  for (int i = 0; i < N / 2; ++i) {
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
  for (int i = 0; i < N / 2; ++i) {
    s[i] = hopper::ex2(fmaf(s[i], scale2, -m2[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
}

// A float32 m64nN accumulator -> the bf16 register A fragments of a
// product whose k runs over its N columns (P in P.V).
template <int N>
__device__ __forceinline__ void pack_frag(uint32_t (&a)[N / 16][4],
                                          const float (&s)[N / 2]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
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
  using T = FwdTile<D>;
  constexpr int kBlockN = T::kBlockN;
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

  // One grid dimension: (b*h, query tile), query tiles fastest, so B*H
  // has no 65,535 limit.
  const int n_qt = (p.s_q + kFwdBlockM - 1) / kFwdBlockM;
  const int bh = blockIdx.x / n_qt, b = bh / p.heads, h = bh % p.heads;
  const int q0 = (blockIdx.x % n_qt) * kFwdBlockM;
  int n_tiles = (p.s_k + kBlockN - 1) / kBlockN;
  if (p.causal) {
    n_tiles = min(n_tiles, (q0 + kFwdBlockM - 1) / kBlockN + 1);
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
        load_boxes<D>(k_tile(it), &maps.k, maps.k_sel, k_full(st), kBlockN,
                      it * kBlockN, h, b);
        hopper::mbar_wait(v_empty(st), parity);
        hopper::mbar_expect_tx(v_full(st), S::kKVBytes);
        load_boxes<D>(v_tile(it), &maps.v, maps.v_sel, v_full(st), kBlockN,
                      it * kBlockN, h, b);
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

    float o[T::kOParts][T::kOCols / 2];
#pragma unroll
    for (int part = 0; part < T::kOParts; ++part) {
#pragma unroll
      for (int i = 0; i < T::kOCols / 2; ++i) o[part][i] = 0.f;
    }
    const float scale2 = p.scale * kLog2e;  // see online_softmax
    float m2[2] = {kNegInf, kNegInf};
    float l_row[2] = {0.f, 0.f};  // this lane's share until the epilogue
    float s[kBlockN / 2];
    uint32_t a[kBlockN / 16][4];  // P of the previous tile, bf16
    float corr[2];
    auto mask = [&](int it) {
      return (it + 1) * kBlockN > p.s_k ||
             (p.causal && (it + 1) * kBlockN - 1 > q0 + 64 * c);
    };
    auto fence_o = [&]() {
#pragma unroll
      for (int part = 0; part < T::kOParts; ++part) {
        hopper::fence_operand(o[part]);
      }
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
    online_softmax<kBlockN>(s, m2, l_row, corr, scale2, mask(0), 0, p.s_k,
                            p.causal, row_a, t);
    pack_frag<kBlockN>(a, s);
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
      online_softmax<kBlockN>(s, m2, l_row, corr, scale2, mask(it),
                              it * kBlockN, p.s_k, p.causal, row_a, t);
      hopper::wgmma_wait<0>();
      fence_o();
      hopper::fence_operand(a);
      if (lane == 0) hopper::mbar_arrive(v_empty(prev));
#pragma unroll
      for (int part = 0; part < T::kOParts; ++part) {
#pragma unroll
        for (int i = 0; i < T::kOCols / 2; ++i) {
          o[part][i] *= corr[(i >> 1) & 1];
        }
      }
      pack_frag<kBlockN>(a, s);
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
    fence_o();
    if (lane == 0) hopper::mbar_arrive(v_empty(last % kFwdStages));
    const float m_row[2] = {m2[0] / kLog2e, m2[1] / kLog2e};  // natural log

    // Epilogue: out = O / max(l, 1e-30) in bf16 through shared memory, then
    // 16-byte row chunks to global memory, the chunks past d left out. Up
    // to D = 128 the staging tile is this warpgroup's own, rows padded by
    // 16 bytes; at D = 256 it is this consumer's 64 rows of the Q tile,
    // swizzled as TMA loaded them (row r's 16-byte chunk j of a box at
    // chunk j ^ (r % 8)), so a warp's 4-byte stores fall in 32 banks.
    auto chunk_at = [&](int local, int chunk) -> uint8_t* {
      if constexpr (T::kStageInQ) {
        using W = Swizzled<D>;
        constexpr int kPerBox = W::kSwizzle / 16;  // chunks a box row
        const int row = 64 * c + local;
        return smem + S::kQ + (chunk / kPerBox) * kFwdBlockM * W::kSwizzle +
               row * W::kSwizzle + (((chunk % kPerBox) ^ (row % 8)) << 4);
      } else {
        return smem + S::kO + c * S::kOBytes +
               (local * S::kOStride + chunk * 8) * 2;
      }
    };
    constexpr int kPartChunks = T::kOCols / 8;  // 8-column chunks a part
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
      l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
      const float l = fmaxf(l_row[r], 1e-30f);
      const int local = 16 * warp + g + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int part = j / kPartChunks, jj = j % kPartChunks;
        *reinterpret_cast<uint32_t*>(chunk_at(local, j) + 4 * t) =
            pack_bf16(o[part][4 * jj + 2 * r] / l,
                      o[part][4 * jj + 2 * r + 1] / l);
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
      if (row < p.s_q && chunk * 8 < p.d) {
        *reinterpret_cast<uint4*>(out + row * p.o_ss + chunk * 8) =
            *reinterpret_cast<const uint4*>(chunk_at(local, chunk));
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

  // One grid dimension: (b*h, 32-row tile), tiles fastest.
  const int n_qt = (p.s_q + kF32Block - 1) / kF32Block;
  const int bh = blockIdx.x / n_qt, b = bh / p.heads, h = bh % p.heads;
  const int q0 = (blockIdx.x % n_qt) * kF32Block;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int r = threadIdx.x / 4, quarter = threadIdx.x % 4;
  const int row = q0 + r;

  for (int i = threadIdx.x; i < kF32Block * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    // The TPU kernel scales q before the product: q * scale, then q . k.
    q_s[rr * kStride + d] = q0 + rr < p.s_q && d < p.d
                                ? q[(q0 + rr) * p.q_ss + d] * p.scale
                                : 0.f;
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
      const bool valid = k0 + j < p.s_k && d < p.d;
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
    for (int i = 0; i < D / 4; ++i) {
      if (quarter + 4 * i < p.d) o[quarter + 4 * i] = acc[i] / lc;
    }
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
  const void* out;
  const void* dout;
  const float* lse;  // (B, H, S_q) contiguous: the forward's logsumexp
  // Written by flash_bwd_prep, each (B*H, s_pad) and zero past S_q:
  float* lse2;    // lse * log2(e)
  float* delta;   // rowsum(dO * O)
  float* dq_acc;  // bf16 only (else null): the float32 dQ accumulator
  // Ordered dQ only (else null): kSemsPerTile counters per (b*h, 64-row
  // query tile), zeroed by flash_bwd_prep; see flash_bwd_wgmma.
  int* dq_sem;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss, o_sb, o_sh, o_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  // d: the operands' head dim, as in Params.
  int batch, heads, s_q, s_k, s_pad, d, causal;
  float scale;
};

// Rows [row0, row0 + n) of a float32 row vector into shared memory, zero
// past `rows`: plain loads, made visible by the next __syncthreads.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    dst[i] = row0 + i < rows ? src[row0 + i] : 0.f;
  }
}

// rowsum(x * y) of one 16-byte chunk of each, in float32.
template <bool kBf16>
__device__ __forceinline__ float dot16(uint4 x, uint4 y) {
  const uint32_t a[4] = {x.x, x.y, x.z, x.w}, c[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kBf16) {  // two bf16 a word: the low half, then the high one
      acc = fmaf(__uint_as_float(a[i] << 16), __uint_as_float(c[i] << 16),
                 acc);
      acc = fmaf(__uint_as_float(a[i] & 0xffff0000u),
                 __uint_as_float(c[i] & 0xffff0000u), acc);
    } else {
      acc = fmaf(__uint_as_float(a[i]), __uint_as_float(c[i]), acc);
    }
  }
  return acc;
}

constexpr int kBwdBlockM = 64;    // query rows a tile of the loop; s_pad's unit
constexpr int kBwdBlockN = 128;   // keys a CTA, 64 per consumer warpgroup
constexpr int kBwdStages = 2;     // Q/dO ring depth
constexpr int kBwdThreads = 384;  // producer warpgroup + two consumers
// setmaxnreg: 128 * 24 + 256 * 240 = 64512, what the launch bound leaves.
constexpr int kBwdProducerRegs = 24, kBwdConsumerRegs = 240;
// Named barriers: kDsReady, both consumers' dS^T are in the shared tile;
// kDqReady + c, consumer c's dQ tile is in shared memory. Ordered dQ:
// kDqFull + c, consumer c's dQ tile is in shared memory for the writer
// warp; kDqEmpty + c, the writer's add has read it.
constexpr int kDsReady = 1, kDqReady = 2, kDqFull = 4, kDqEmpty = 6;
// Counters of the ordered dQ a query tile: one per column block of dQ
// (BwdSmem::kDqSplit, at most 2).
constexpr int kSemsPerTile = 2;

// The input pass of the backward, one CTA of 128 threads per (b*h, 64-row
// tile): Delta = rowsum(dO * O) in float32 (as `bwd_delta`) and lse *
// log2(e), zero past S_q, and for bf16 the tile of the dQ accumulator set to
// zero, with its counters when dQ is ordered. A row of D columns is read in
// 16-byte chunks by kLanes adjacent lanes, kLanes chunks at a time; chunks
// past d are not read.
template <bool kBf16, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep(const BwdParams p) {
  constexpr int kElem = kBf16 ? 2 : 4;  // bytes an element
  constexpr int kChunks = D * kElem / 16;
  constexpr int kLanes = kChunks < 32 ? kChunks : 32;
  constexpr int kRows = 32 / kLanes;    // rows a warp reads at once
  const int n_qt = p.s_pad / kBwdBlockM;
  const int bh = blockIdx.x / n_qt, it = blockIdx.x % n_qt;
  const int b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const char* dout = static_cast<const char*>(p.dout) +
                     (b * p.do_sb + h * p.do_sh) * kElem;
  const char* out = static_cast<const char*>(p.out) +
                    (b * p.o_sb + h * p.o_sh) * kElem;
  // 64 is a multiple of kWarps * kRows: every lane runs the same rounds.
  for (int r = warp * kRows + lane / kLanes; r < kBwdBlockM;
       r += kWarps * kRows) {
    const int row = it * kBwdBlockM + r;
    float acc = 0.f;
#pragma unroll
    for (int chunk = lane % kLanes; chunk < kChunks; chunk += kLanes) {
      const long long col = chunk * (16 / kElem);
      if (row < p.s_q && col < p.d) {
        acc += dot16<kBf16>(
            *reinterpret_cast<const uint4*>(
                dout + (row * p.do_ss + col) * kElem),
            *reinterpret_cast<const uint4*>(
                out + (row * p.o_ss + col) * kElem));
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane % kLanes == 0) {
      const long long i = (long long)bh * p.s_pad + row;
      p.delta[i] = acc;
      p.lse2[i] = row < p.s_q ? p.lse[(long long)bh * p.s_q + row] * kLog2e
                              : 0.f;
    }
  }
  if (p.dq_acc != nullptr) {
    float4* tile = reinterpret_cast<float4*>(
        p.dq_acc + ((long long)bh * p.s_pad + it * kBwdBlockM) * D);
    for (int i = threadIdx.x; i < kBwdBlockM * D / 4; i += kThreads) {
      tile[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (p.dq_sem != nullptr && threadIdx.x < kSemsPerTile) {
    p.dq_sem[((long long)bh * n_qt + it) * kSemsPerTile + threadIdx.x] = 0;
  }
}

// The fused bf16 kernel's shared memory, in bytes from a 1024-aligned base:
// K and V (128 keys), the Q and dO rings (64 rows a stage; all four as TMA
// boxes, see hopper.cuh), two dS^T tiles (128 keys x 64 queries, 128-byte
// rows swizzled at 128 bytes), each consumer's float32 dQ tile, the lse and
// Delta ring, then the mbarriers.
template <int D>
struct BwdSmem : Swizzled<D> {
  // dQ = dS.K of a query tile. At D = 128 the two consumers split its
  // columns, 64 each (a whole swizzle atom of K), summing over all 128
  // keys; at a narrower D each takes all D columns over its own 64 keys,
  // and both add into the same accumulator tile. Either way both run the
  // same code: a wgmma in a branch that only one of them takes would make
  // ptxas serialise every wgmma of the kernel.
  static constexpr int kDqSplit = D == 128 ? 2 : 1;
  static constexpr int kDqCols = D / kDqSplit;
  static constexpr int kDqKeys = 64 * kDqSplit;  // keys a consumer sums
  static constexpr int kKVBytes = kBwdBlockN * D * 2;           // K or V
  static constexpr int kQBytes = kBwdBlockM * D * 2;            // Q or dO
  static constexpr int kDsBytes = kBwdBlockN * kBwdBlockM * 2;  // dS^T
  static constexpr int kDqBytes = kBwdBlockM * kDqCols * 4;     // one dQ tile
  static constexpr int kRowBytes = kBwdBlockM * 4;              // lse or Delta
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;
  static constexpr int kDO = kQ + kBwdStages * kQBytes;
  static constexpr int kDS = kDO + kBwdStages * kQBytes;
  static constexpr int kDQ = kDS + 2 * kDsBytes;
  static constexpr int kLse = kDQ + 2 * kDqBytes;
  static constexpr int kDelta = kLse + kBwdStages * kRowBytes;
  static constexpr int kBar = kDelta + kBwdStages * kRowBytes;
  // kv_full, then full and empty for each stage.
  static constexpr int kBars = 1 + 2 * kBwdStages;
  static constexpr size_t kBytes = kBar + kBars * 8 + 1024;  // + alignment
};

// The TMA maps of q, k, v and dout, and their coordinate selectors.
struct BwdMaps {
  CUtensorMap q, k, v, dout;
  int q_sel, k_sel, v_sel, do_sel;
};

// One consumer's dS^T (its 64 keys x the tile's 64 queries), packed as
// wgmma's register A operand, into a shared dS^T tile: 128 key rows of 64
// queries, 128 bytes a row, swizzled at 128 bytes as TMA would store it
// (row r's 16-byte chunk j at chunk j ^ (r % 8)), so that dQ's wgmma reads
// dS from it MN-major. A warp's 32 lanes store into 32 distinct banks.
__device__ __forceinline__ void store_ds(uint8_t* tile,
                                         const uint32_t (&a)[4][4], int row_a,
                                         int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      *reinterpret_cast<uint32_t*>(tile + (row_a + 8 * rr) * 128 +
                                   ((j ^ g) << 4) + 4 * t) =
          a[j / 2][2 * (j % 2) + rr];
    }
  }
}

// MN-major descriptor (A of dQ = dS.K, tnspA) of keys [16 kc, 16 kc + 16)
// of a dS^T tile: its 64 queries are one 128-byte swizzle atom.
__device__ __forceinline__ uint64_t ds_desc(uint32_t tile, int kc) {
  return hopper::smem_desc(tile + kc * 16 * 128, kBwdBlockN * 128, 8 * 128,
                           hopper::layout_type(128));
}

// Rows row_a and row_a + 8 of a consumer's m64nD float32 accumulator
// (hopper.cuh's layout), times `scale`, as bf16 into rows of `out` (row
// stride `ss`); rows at or past `rows` and columns at or past `cols` (a
// multiple of 8) are left out.
template <int D>
__device__ __forceinline__ void store_rows(uint16_t* out, long long ss,
                                           const float (&acc)[D / 2],
                                           int row_a, int rows, int cols,
                                           int t, float scale) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row_a + 8 * rr;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j >= cols) break;
      *reinterpret_cast<uint32_t*>(out + row * ss + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2 * rr] * scale,
                    acc[4 * j + 2 * rr + 1] * scale);
    }
  }
}

// kOrdered: each dQ tile's reduce-adds land in one fixed order, so dQ is the
// same bit for bit from call to call (see the file's header).
template <int D, bool kOrdered>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_wgmma(const __grid_constant__ BwdParams p,
                const __grid_constant__ BwdMaps maps) {
  using S = BwdSmem<D>;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  const uint32_t raw = hopper::smem_addr(bwd_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem = bwd_smem + (base - raw);
  const uint32_t bars = base + S::kBar, kv_full = bars;
  auto full = [=](int st) { return bars + 8 * (1 + st); };
  auto empty = [=](int st) { return bars + 8 * (1 + kBwdStages + st); };

  // This CTA's (b*h, key tile). Under causal the key tile is the outer
  // index, so the tiles that own the most query tiles start first. Ordered,
  // too: key tile kt's adds wait for key tile kt - 1's, so a wave that
  // held all key tiles of a few b*h would start as a staircase of that
  // many steps; with the key tile outer, a wave holds a few key tiles of
  // every b*h, and the key tiles of the next wave find their turn come.
  const int n_kt = (p.s_k + kBwdBlockN - 1) / kBwdBlockN;
  const int n_bh = p.batch * p.heads;
  const bool kt_outer = p.causal || kOrdered;
  const int kt = kt_outer ? blockIdx.x / n_bh : blockIdx.x % n_kt;
  const int bh = kt_outer ? blockIdx.x % n_bh : blockIdx.x / n_kt;
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = kt * kBwdBlockN;
  const int n_qt = p.s_pad / kBwdBlockM;
  // Causal: the first query tile that reaches key k0 (`_block_relevant`).
  const int it0 = p.causal ? k0 / kBwdBlockM : 0;
  // The n-th query tile this CTA walks. Ordered and causal, from the last
  // down to it0: every key tile then starts on the last query tile, each
  // one add behind the key tile before it, and a key tile with fewer query
  // tiles ends sooner, so the lags do not add up along the diagonal as
  // they would from it0 = 2 kt upwards.
  const bool descend = kOrdered && p.causal;
  const int n_tiles = n_qt - it0;
  auto tile_of = [=](int n) { return descend ? n_qt - 1 - n : it0 + n; };

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      hopper::mbar_init(full(st), 1);
      hopper::mbar_init(empty(st), 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread loads K and V, then keeps the Q/dO ring full.
    hopper::setmaxnreg_dec<kBwdProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * S::kKVBytes);
      load_boxes<D>(base + S::kK, &maps.k, maps.k_sel, kv_full, kBwdBlockN,
                    k0, h, b);
      load_boxes<D>(base + S::kV, &maps.v, maps.v_sel, kv_full, kBwdBlockN,
                    k0, h, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int it = tile_of(n), st = n % kBwdStages;
        hopper::mbar_wait(empty(st), ((n / kBwdStages) & 1) ^ 1);
        const int q0 = it * kBwdBlockM;
        hopper::mbar_expect_tx(full(st),
                               2 * S::kQBytes + 2 * S::kRowBytes);
        load_boxes<D>(base + S::kQ + st * S::kQBytes, &maps.q, maps.q_sel,
                      full(st), kBwdBlockM, q0, h, b);
        load_boxes<D>(base + S::kDO + st * S::kQBytes, &maps.dout,
                      maps.do_sel, full(st), kBwdBlockM, q0, h, b);
        const long long row = (long long)bh * p.s_pad + q0;
        hopper::bulk_load(base + S::kLse + st * S::kRowBytes, p.lse2 + row,
                          S::kRowBytes, full(st));
        hopper::bulk_load(base + S::kDelta + st * S::kRowBytes,
                          p.delta + row, S::kRowBytes, full(st));
      }
    } else if (kOrdered && threadIdx.x / 32 == 1) {
      // Ordered dQ writer (warp 1), off the consumers' path: per query tile
      // it takes each consumer's dQ tile from shared memory and adds it
      // into the accumulator once the tile's counter reads kt (every key
      // tile below kt reaches query tile `it`: under causal key tile j
      // starts at query tile 2j <= 2kt <= it); at D < 128 consumer 0's add
      // is done before consumer 1's is issued. It then hands the shared
      // tiles back, and releases a tile's counters once its adds are done
      // in L2, checked after the next tile's are issued. A CTA waits only
      // on lower key tiles of its b*h, which with the key tile as the
      // grid's outer index are CTAs launched before it, resident or done:
      // no deadlock.
      const int lane = threadIdx.x % 32;
      int* prev = nullptr;
      for (int n = 0; n < n_tiles; ++n) {
        const int it = tile_of(n);
        int* const sem = p.dq_sem + ((long long)bh * n_qt + it) * kSemsPerTile;
        float* const acc = p.dq_acc + ((long long)bh * p.s_pad +
                                       it * kBwdBlockM) * D;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          hopper::named_barrier_sync(kDqFull + c, 160);
          if (lane == 0) {
            const int blk = S::kDqSplit == 2 ? c : 0;
            if (c == 0 || S::kDqSplit == 2) {
              hopper::sem_wait_eq(sem + blk, kt);
            } else {
              hopper::bulk_wait<0>();  // same tile: consumer 0's add first
            }
            hopper::bulk_reduce_add(acc + blk * kBwdBlockM * S::kDqCols,
                                    base + S::kDQ + c * S::kDqBytes,
                                    S::kDqBytes);
            hopper::bulk_commit();
          }
        }
        if (lane == 0) hopper::bulk_wait_read<0>();
        __syncwarp();
        if (n + 1 < n_tiles) {
          hopper::named_barrier_arrive(kDqEmpty, 160);
          hopper::named_barrier_arrive(kDqEmpty + 1, 160);
        }
        if (lane == 0 && prev != nullptr) {
          hopper::bulk_wait<S::kDqSplit>();  // this tile's adds may pend
          for (int blk = 0; blk < S::kDqSplit; ++blk) {
            hopper::sem_release_inc(prev + blk);
          }
        }
        prev = sem;
      }
      if (lane == 0 && prev != nullptr) {
        hopper::bulk_wait<0>();
        for (int blk = 0; blk < S::kDqSplit; ++blk) {
          hopper::sem_release_inc(prev + blk);
        }
      }
    }
  } else {
    // Consumer c: keys [k0 + 64c, k0 + 64c + 64), the M dimension of its
    // products; this thread holds keys key_a and key_a + 8 and, of each
    // query tile, the queries 8j + 2t and 8j + 2t + 1 (hopper.cuh).
    hopper::setmaxnreg_inc<kBwdConsumerRegs>();
    const int c = wg - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int local_a = 64 * c + 16 * warp + g;  // row in the K/V/dS^T tiles
    const int key_a = k0 + local_a;
    const uint32_t k_tile = base + S::kK, v_tile = base + S::kV;
    const float scale2 = p.scale * kLog2e;  // P = 2^(s * scale2 - lse2)
    // dQ: this consumer's column block of K and first key (see BwdSmem).
    const int dq_box = S::kDqSplit == 2 ? c : 0;
    const int dq_key0 = S::kDqSplit == 2 ? 0 : 64 * c;

    float dv[D / 2], dk[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int it = tile_of(n), st = n % kBwdStages;
      const int q0 = it * kBwdBlockM;
      const uint32_t q_tile = base + S::kQ + st * S::kQBytes;
      const uint32_t do_tile = base + S::kDO + st * S::kQBytes;
      const uint32_t ds_tile = base + S::kDS + (n & 1) * S::kDsBytes;
      hopper::mbar_wait(full(st), (n / kBwdStages) & 1);
      // Declared here, each tile's first product overwrites (scale_d = 0)
      // registers that carry nothing from the tile before.
      float s[kBwdBlockM / 2], dp[kBwdBlockM / 2], dq[S::kDqCols / 2];
      uint32_t a_p[kBwdBlockM / 16][4], a_ds[kBwdBlockM / 16][4];

      // S^T = K.Q^T and dP^T = V.dO^T, keys as rows, as two wgmma groups:
      // P^T is computed while dP^T is in the tensor cores, dS^T while
      // dV += P^T.dO is, and dK += dS^T.Q runs through the dS barrier.
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        hopper::wgmma_ss<0, 0>(
            s, kmajor_desc<D>(k_tile, kBwdBlockN, 64 * c, kc),
            kmajor_desc<D>(q_tile, kBwdBlockM, 0, kc), kc > 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        hopper::wgmma_ss<0, 0>(
            dp, kmajor_desc<D>(v_tile, kBwdBlockN, 64 * c, kc),
            kmajor_desc<D>(do_tile, kBwdBlockM, 0, kc), kc > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);

      // P^T = 2^(s * scale2 - lse2), masked to 0.
      const float* lse2 = reinterpret_cast<const float*>(
          smem + S::kLse + st * S::kRowBytes);
      const float* delta = reinterpret_cast<const float*>(
          smem + S::kDelta + st * S::kRowBytes);
      const bool mask = q0 + kBwdBlockM > p.s_q || k0 + kBwdBlockN > p.s_k ||
                        (p.causal && k0 + 64 * c + 63 > q0);
#pragma unroll
      for (int j = 0; j < kBwdBlockM / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float x = hopper::ex2(fmaf(s[i], scale2, (e & 1) ? -l2.y : -l2.x));
          if (mask) {
            const int key = key_a + 8 * (e >> 1);
            const int row = q0 + 8 * j + 2 * t + (e & 1);
            if (row >= p.s_q || key >= p.s_k || (p.causal && key > row)) {
              x = 0.f;
            }
          }
          s[i] = x;
        }
      }
      pack_frag<kBwdBlockM>(a_p, s);

      // dV += P^T.dO, the queries as k, P^T from registers.
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBwdBlockM / 16; ++kc) {
        hopper::wgmma_rs<1>(dv, a_p[kc],
                            mnmajor_desc<D>(do_tile, kBwdBlockM, kc), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // dP^T is in; dV may run on
      hopper::fence_operand(dp);

      // dS^T = P^T (dP^T - Delta), to registers and the shared dS^T tile.
#pragma unroll
      for (int j = 0; j < kBwdBlockM / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dp[i] = s[i] * (dp[i] - ((e & 1) ? dl.y : dl.x));
        }
      }
      pack_frag<kBwdBlockM>(a_ds, dp);
      store_ds(smem + S::kDS + (n & 1) * S::kDsBytes, a_ds, local_a, g, t);
      hopper::fence_proxy_async();

      // dK += dS^T.Q, dS^T from registers.
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBwdBlockM / 16; ++kc) {
        hopper::wgmma_rs<1>(dk, a_ds[kc],
                            mnmajor_desc<D>(q_tile, kBwdBlockM, kc), 1);
      }
      hopper::wgmma_commit();

      // Both dS^T are in; this consumer's last dQ reduce has read its tile
      // (ordered: the writer warp's, waited for below).
      if (!kOrdered && tid == 0) hopper::bulk_wait_read<0>();
      hopper::named_barrier_sync(kDsReady, 256);
      // dQ (64 queries x kDqCols from column dq_box * kDqCols) += dS.K over
      // keys [dq_key0, dq_key0 + kDqKeys) of the tile (see BwdSmem).
#pragma unroll
      for (int kc = 0; kc < S::kDqKeys / 16; ++kc) {
        hopper::wgmma_ss<1, 1>(
            dq, ds_desc(ds_tile, dq_key0 / 16 + kc),
            mnmajor_desc<D>(k_tile + dq_box * kBwdBlockN * S::kSwizzle,
                            kBwdBlockN, dq_key0 / 16 + kc),
            kc > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dv);
      hopper::fence_operand(dk);
      hopper::fence_operand(a_p);
      hopper::fence_operand(a_ds);
      hopper::fence_operand(dq);
      if (lane == 0) hopper::mbar_arrive(empty(st));
      // The tile in register order, float4 j * 128 + tid = dq[4j .. 4j+3],
      // then one bulk reduce-add into the accumulator's tile (ordered: by
      // the writer warp, once it has read the tile before).
      if (kOrdered && n > 0) hopper::named_barrier_sync(kDqEmpty + c, 160);
      float4* tile = reinterpret_cast<float4*>(smem + S::kDQ + c * S::kDqBytes);
#pragma unroll
      for (int j = 0; j < S::kDqCols / 8; ++j) {
        tile[j * 128 + tid] =
            make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
      }
      hopper::fence_proxy_async();
      if constexpr (kOrdered) {
        hopper::named_barrier_arrive(kDqFull + c, 160);
      } else {
        hopper::named_barrier_sync(kDqReady + c, 128);
        if (tid == 0) {
          hopper::bulk_reduce_add(
              p.dq_acc + ((long long)bh * p.s_pad + q0) * D +
                  dq_box * kBwdBlockM * S::kDqCols,
              base + S::kDQ + c * S::kDqBytes, S::kDqBytes);
          hopper::bulk_commit();
        }
      }
    }
    // The shared dQ tile must outlive the last reduce.
    if (tid == 0) hopper::bulk_wait<0>();

    store_rows<D>(static_cast<uint16_t*>(p.dk) + b * p.dk_sb + h * p.dk_sh,
                  p.dk_ss, dk, key_a, p.s_k, p.d, t, p.scale);
    store_rows<D>(static_cast<uint16_t*>(p.dv) + b * p.dv_sb + h * p.dv_sh,
                  p.dv_ss, dv, key_a, p.s_k, p.d, t, 1.f);
  }
}

// -- backward, bfloat16, D > 128 ---------------------------------------------

// The fused kernel at D = 256 ("wide"). At 64 keys a consumer, dK and dV
// would take 128 + 128 float32 registers a thread, over the 240 a consumer
// has; and K and V at 128 keys with two stages of Q and dO would take
// 256 KB of shared memory. So a CTA owns 64 keys, and its two consumer
// warpgroups split the D columns: consumer c keeps dK and dV of columns
// [c D/2, (c + 1) D/2) for all 64 keys (64 + 64 registers), and both
// compute the same S^T = K.Q^T and dP^T = V.dO^T over all D (the price of
// the split: those two of the five products run twice, 1.4 times the
// flops; sharing them through shared memory would make the consumers wait
// on each other). Each consumer then adds dV += P^T.dO and dK += dS^T.Q
// for its columns, writes its dS^T to a tile of its own, and computes
// dQ = dS.K for its columns, 64 at a time, added into the float32
// accumulator from registers by vector reductions in L2 (no shared
// staging tile: it would not fit). Ordered (`kOrdered`), consumer c of key
// tile kt adds a query tile's dQ once that tile's counter c reads kt, and
// adds one to it once its adds are visible. Smem: K and V (32 KB each), two
// stages of Q and dO (128 KB), two dS^T tiles (16 KB), lse and Delta.
constexpr int kWideBlockN = 64;  // keys a CTA of the wide kernel

template <int D>
struct BwdWideSmem : Swizzled<D> {
  static constexpr int kCols = D / 2;  // dK/dV/dQ columns a consumer owns
  static constexpr int kKVBytes = kWideBlockN * D * 2;          // K or V
  static constexpr int kQBytes = kBwdBlockM * D * 2;            // Q or dO
  static constexpr int kDsBytes = kWideBlockN * kBwdBlockM * 2;  // dS^T
  static constexpr int kRowBytes = kBwdBlockM * 4;              // lse or Delta
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;
  static constexpr int kDO = kQ + kBwdStages * kQBytes;
  static constexpr int kDS = kDO + kBwdStages * kQBytes;
  static constexpr int kLse = kDS + 2 * kDsBytes;
  static constexpr int kDelta = kLse + kBwdStages * kRowBytes;
  static constexpr int kBar = kDelta + kBwdStages * kRowBytes;
  static constexpr int kBars = 1 + 2 * kBwdStages;  // kv_full, full, empty
  static constexpr size_t kBytes = kBar + kBars * 8 + 1024;  // + alignment
};

template <int D, bool kOrdered>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_wgmma_wide(const __grid_constant__ BwdParams p,
                     const __grid_constant__ BwdMaps maps) {
  using S = BwdWideSmem<D>;
  constexpr int kCols = S::kCols;
  extern __shared__ __align__(16) uint8_t wide_smem[];
  const uint32_t raw = hopper::smem_addr(wide_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem = wide_smem + (base - raw);
  const uint32_t bars = base + S::kBar, kv_full = bars;
  auto full = [=](int st) { return bars + 8 * (1 + st); };
  auto empty = [=](int st) { return bars + 8 * (1 + kBwdStages + st); };

  // This CTA's (b*h, key tile), in flash_bwd_wgmma's order.
  const int n_kt = (p.s_k + kWideBlockN - 1) / kWideBlockN;
  const int n_bh = p.batch * p.heads;
  const bool kt_outer = p.causal || kOrdered;
  const int kt = kt_outer ? blockIdx.x / n_bh : blockIdx.x % n_kt;
  const int bh = kt_outer ? blockIdx.x % n_bh : blockIdx.x / n_kt;
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = kt * kWideBlockN;
  const int n_qt = p.s_pad / kBwdBlockM;
  const int it0 = p.causal ? k0 / kBwdBlockM : 0;
  const bool descend = kOrdered && p.causal;
  const int n_tiles = n_qt - it0;
  auto tile_of = [=](int n) { return descend ? n_qt - 1 - n : it0 + n; };

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      hopper::mbar_init(full(st), 1);
      hopper::mbar_init(empty(st), 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread loads K and V, then keeps the Q/dO ring full.
    hopper::setmaxnreg_dec<kBwdProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * S::kKVBytes);
      load_boxes<D>(base + S::kK, &maps.k, maps.k_sel, kv_full, kWideBlockN,
                    k0, h, b);
      load_boxes<D>(base + S::kV, &maps.v, maps.v_sel, kv_full, kWideBlockN,
                    k0, h, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int it = tile_of(n), st = n % kBwdStages;
        hopper::mbar_wait(empty(st), ((n / kBwdStages) & 1) ^ 1);
        const int q0 = it * kBwdBlockM;
        hopper::mbar_expect_tx(full(st),
                               2 * S::kQBytes + 2 * S::kRowBytes);
        load_boxes<D>(base + S::kQ + st * S::kQBytes, &maps.q, maps.q_sel,
                      full(st), kBwdBlockM, q0, h, b);
        load_boxes<D>(base + S::kDO + st * S::kQBytes, &maps.dout,
                      maps.do_sel, full(st), kBwdBlockM, q0, h, b);
        const long long row = (long long)bh * p.s_pad + q0;
        hopper::bulk_load(base + S::kLse + st * S::kRowBytes, p.lse2 + row,
                          S::kRowBytes, full(st));
        hopper::bulk_load(base + S::kDelta + st * S::kRowBytes,
                          p.delta + row, S::kRowBytes, full(st));
      }
    }
  } else {
    // Consumer c: all 64 keys as the M dimension of S^T, dP^T, dV and dK;
    // this thread holds keys key_a and key_a + 8 and, of each query tile,
    // the queries 8j + 2t and 8j + 2t + 1 (hopper.cuh). Its columns start
    // at box `box0` of the K, V, Q and dO tiles.
    hopper::setmaxnreg_inc<kBwdConsumerRegs>();
    const int c = wg - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int local_a = 16 * warp + g;  // row in the K/V/dS^T tiles
    const int key_a = k0 + local_a;
    const uint32_t k_tile = base + S::kK, v_tile = base + S::kV;
    const uint32_t ds_tile = base + S::kDS + c * S::kDsBytes;
    const int box0 = c * kCols / S::kBoxCols;
    const float scale2 = p.scale * kLog2e;  // P = 2^(s * scale2 - lse2)

    float dv[kCols / 2], dk[kCols / 2];
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) dv[i] = dk[i] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int it = tile_of(n), st = n % kBwdStages;
      const int q0 = it * kBwdBlockM;
      const uint32_t q_tile = base + S::kQ + st * S::kQBytes;
      const uint32_t do_tile = base + S::kDO + st * S::kQBytes;
      hopper::mbar_wait(full(st), (n / kBwdStages) & 1);
      float s[kBwdBlockM / 2], dp[kBwdBlockM / 2];
      uint32_t a_p[kBwdBlockM / 16][4], a_ds[kBwdBlockM / 16][4];

      // S^T = K.Q^T and dP^T = V.dO^T over all D, as two wgmma groups.
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        hopper::wgmma_ss<0, 0>(
            s, kmajor_desc<D>(k_tile, kWideBlockN, 0, kc),
            kmajor_desc<D>(q_tile, kBwdBlockM, 0, kc), kc > 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        hopper::wgmma_ss<0, 0>(
            dp, kmajor_desc<D>(v_tile, kWideBlockN, 0, kc),
            kmajor_desc<D>(do_tile, kBwdBlockM, 0, kc), kc > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operand(s);

      // P^T = 2^(s * scale2 - lse2), masked to 0.
      const float* lse2 = reinterpret_cast<const float*>(
          smem + S::kLse + st * S::kRowBytes);
      const float* delta = reinterpret_cast<const float*>(
          smem + S::kDelta + st * S::kRowBytes);
      const bool mask = q0 + kBwdBlockM > p.s_q ||
                        k0 + kWideBlockN > p.s_k ||
                        (p.causal && k0 + kWideBlockN - 1 > q0);
#pragma unroll
      for (int j = 0; j < kBwdBlockM / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float x = hopper::ex2(fmaf(s[i], scale2, (e & 1) ? -l2.y : -l2.x));
          if (mask) {
            const int key = key_a + 8 * (e >> 1);
            const int row = q0 + 8 * j + 2 * t + (e & 1);
            if (row >= p.s_q || key >= p.s_k || (p.causal && key > row)) {
              x = 0.f;
            }
          }
          s[i] = x;
        }
      }
      pack_frag<kBwdBlockM>(a_p, s);

      // dV[:, this consumer's columns] += P^T.dO, P^T from registers.
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBwdBlockM / 16; ++kc) {
        hopper::wgmma_rs<1>(
            dv, a_p[kc],
            mnmajor_desc<D>(do_tile + box0 * kBwdBlockM * S::kSwizzle,
                            kBwdBlockM, kc),
            1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // dP^T is in; dV may run on
      hopper::fence_operand(dp);

      // dS^T = P^T (dP^T - Delta), to registers and this consumer's dS^T
      // tile, whose last reader (the previous tile's dQ) is done.
#pragma unroll
      for (int j = 0; j < kBwdBlockM / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dp[i] = s[i] * (dp[i] - ((e & 1) ? dl.y : dl.x));
        }
      }
      pack_frag<kBwdBlockM>(a_ds, dp);
      store_ds(smem + S::kDS + c * S::kDsBytes, a_ds, local_a, g, t);
      hopper::fence_proxy_async();

      // dK[:, this consumer's columns] += dS^T.Q, dS^T from registers.
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBwdBlockM / 16; ++kc) {
        hopper::wgmma_rs<1>(
            dk, a_ds[kc],
            mnmajor_desc<D>(q_tile + box0 * kBwdBlockM * S::kSwizzle,
                            kBwdBlockM, kc),
            1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dv);
      hopper::fence_operand(dk);
      hopper::fence_operand(a_p);
      hopper::fence_operand(a_ds);
      // This stage's Q, dO, lse and Delta are read; dQ reads K and dS^T.
      if (lane == 0) hopper::mbar_arrive(empty(st));
      hopper::named_barrier_sync(1 + c, 128);  // the whole dS^T is in

      // dQ (64 queries x 64 columns from block box0 + half) = dS.K, dS
      // read MN-major from the dS^T tile (tnspA), K MN-major; added into
      // the accumulator's column block from registers, float4 j * 128 +
      // tid = dq[4j .. 4j + 3], as flash_bwd_dq_convert reads it.
      float* const acc = p.dq_acc + ((long long)bh * p.s_pad + q0) * D;
      int* const sem =
          kOrdered ? p.dq_sem + ((long long)bh * n_qt + it) * kSemsPerTile + c
                   : nullptr;
#pragma unroll
      for (int half = 0; half < kCols / 64; ++half) {
        float dq[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kWideBlockN / 16; ++kc) {
          hopper::wgmma_ss<1, 1>(
              dq, ds_desc(ds_tile, kc),
              mnmajor_desc<D>(k_tile + (box0 + half) * kWideBlockN *
                                           S::kSwizzle,
                              kWideBlockN, kc),
              kc > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(dq);
        if (kOrdered && half == 0) {
          // Key tiles below kt have added into this query tile.
          if (tid == 0) hopper::sem_wait_eq(sem, kt);
          hopper::named_barrier_sync(3 + c, 128);
        }
        float* const blk = acc + (box0 + half) * kBwdBlockM * 64;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          hopper::red_add_v4(blk + (j * 128 + tid) * 4,
                             make_float4(dq[4 * j], dq[4 * j + 1],
                                         dq[4 * j + 2], dq[4 * j + 3]));
        }
      }
      if (kOrdered) {
        __threadfence();  // this thread's adds, before the counter moves
        hopper::named_barrier_sync(3 + c, 128);
        if (tid == 0) hopper::sem_release_inc(sem);
      }
    }

    const int cols = p.d - c * kCols;
    store_rows<kCols>(static_cast<uint16_t*>(p.dk) + b * p.dk_sb +
                          h * p.dk_sh + c * kCols,
                      p.dk_ss, dk, key_a, p.s_k, cols, t, p.scale);
    store_rows<kCols>(static_cast<uint16_t*>(p.dv) + b * p.dv_sb +
                          h * p.dv_sh + c * kCols,
                      p.dv_ss, dv, key_a, p.s_k, cols, t, 1.f);
  }
}

// dq = scale * the accumulator, rounded to bf16 and written through dq's
// strides, one thread per 8 of the d columns of a row (one 16-byte store).
// For each (b*h, 64-row tile) the accumulator holds D / kCols column blocks
// of kCols = min(D, 64), each as its warpgroup stored it: float4 j * 128 +
// thread is that thread's dq[4j .. 4j + 3] (rows 16w + g and 16w + g + 8,
// columns 8j + 2t and 8j + 2t + 1; hopper.cuh).
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_convert(const BwdParams p) {
  constexpr int kCols = D < 64 ? D : 64;
  const int chunks = p.d / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p.batch * p.heads * p.s_q * chunks) return;
  const int col = (int)(i % chunks) * 8;
  const long long rows = i / chunks;
  const int row = (int)(rows % p.s_q), bh = (int)(rows / p.s_q);
  const int b = bh / p.heads, h = bh % p.heads;
  const int r = row % kBwdBlockM;
  const int c = col / kCols, j = (col % kCols) / 8;
  const int thread = (r / 16) * 32 + (r % 8) * 4;  // lane t = 0 of the row
  const float* from = p.dq_acc + ((long long)bh * p.s_pad + row - r) * D +
                      c * kBwdBlockM * kCols + (j * 128 + thread) * 4 +
                      (r % 16) / 8 * 2;
  uint4 packed;
  uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 x = *reinterpret_cast<const float2*>(from + 4 * t);
    words[t] = pack_bf16(x.x * p.scale, x.y * p.scale);
  }
  *reinterpret_cast<uint4*>(static_cast<uint16_t*>(p.dq) + b * p.dq_sb +
                            h * p.dq_sh + row * p.dq_ss + col) = packed;
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
                                              int rows, int cols) {
  for (int i = threadIdx.x; i < kF32Block * D; i += kThreads) {
    const int r = i / D, d = i % D;
    tile[r * (D + 1) + d] =
        row0 + r < rows && d < cols ? base[(row0 + r) * ss + d] : 0.f;
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

  const int n_kt = (p.s_k + kF32Block - 1) / kF32Block;
  const int bh = blockIdx.x / n_kt, b = bh / p.heads, h = bh % p.heads;
  const int k0 = (blockIdx.x % n_kt) * kF32Block;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int r = threadIdx.x / 4, quarter = threadIdx.x % 4;
  const int key = k0 + r;

  load_f32_tile<D>(k_s, k, p.k_ss, k0, p.s_k, p.d);
  load_f32_tile<D>(v_s, v, p.v_ss, k0, p.s_k, p.d);
  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.f;

  const int n_tiles = (p.s_q + kF32Block - 1) / kF32Block;
  for (int it = p.causal ? k0 / kF32Block : 0; it < n_tiles; ++it) {
    const int q0 = it * kF32Block;
    __syncthreads();  // the previous tile's readers are done
    load_f32_tile<D>(q_s, q, p.q_ss, q0, p.s_q, p.d);
    load_f32_tile<D>(do_s, dout, p.do_ss, q0, p.s_q, p.d);
    load_rows(lse_s, p.lse + (long long)bh * p.s_q, q0, p.s_q, kF32Block);
    load_rows(dl_s, p.delta + (long long)bh * p.s_pad, q0, p.s_q, kF32Block);
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
      if (quarter + 4 * i < p.d) {
        dkp[quarter + 4 * i] = dk[i] * p.scale;
        dvp[quarter + 4 * i] = dv[i];
      }
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

  const int n_qt = (p.s_q + kF32Block - 1) / kF32Block;
  const int bh = blockIdx.x / n_qt, b = bh / p.heads, h = bh % p.heads;
  const int q0 = (blockIdx.x % n_qt) * kF32Block;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int r = threadIdx.x / 4, quarter = threadIdx.x % 4;
  const int row = q0 + r;
  const bool valid = row < p.s_q;
  const float lse_r = valid ? p.lse[(long long)bh * p.s_q + row] : 0.f;
  const float dl_r = valid ? p.delta[(long long)bh * p.s_pad + row] : 0.f;

  load_f32_tile<D>(q_s, q, p.q_ss, q0, p.s_q, p.d);
  load_f32_tile<D>(do_s, dout, p.do_ss, q0, p.s_q, p.d);
  float dq[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;

  int n_tiles = (p.s_k + kF32Block - 1) / kF32Block;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kF32Block - 1) / kF32Block + 1);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kF32Block;
    __syncthreads();
    load_f32_tile<D>(k_s, k, p.k_ss, k0, p.s_k, p.d);
    load_f32_tile<D>(v_s, v, p.v_ss, k0, p.s_k, p.d);
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
    for (int i = 0; i < D / 4; ++i) {
      if (quarter + 4 * i < p.d) dqp[quarter + 4 * i] = dq[i] * p.scale;
    }
  }
}

// Launches of the kernels above take one grid dimension, at most
// kMaxGrid CTAs: B*H is a factor of it, with no 65,535 limit of its own.
constexpr long long kMaxGrid = 0x7fffffff;

template <typename Kernel, typename P>
cudaError_t launch(Kernel kernel, size_t smem, int block_rows, int rows,
                   const P& p, int batch_heads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid =
      (long long)((rows + block_rows - 1) / block_rows) * batch_heads;
  if (grid > kMaxGrid) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The bf16 forward: q/k/v tensor maps built here, per call, from the
// pointers and strides in `p` (columns past p.d read as zero); 384 threads
// and FwdSmem<D> bytes a CTA.
template <int D>
cudaError_t launch_fwd_bf16(const Params& p, int batch, int batch_heads,
                            cudaStream_t stream) {
  constexpr int kBlockN = FwdTile<D>::kBlockN;
  FwdMaps maps;
  cudaError_t err = hopper::make_operand_map(
      &maps.q, p.q, p.d, D, p.s_q, p.heads, batch, p.q_sb, p.q_sh, p.q_ss,
      kFwdBlockM, &maps.q_sel);
  if (err == cudaSuccess) {
    err = hopper::make_operand_map(&maps.k, p.k, p.d, D, p.s_k, p.heads,
                                   batch, p.k_sb, p.k_sh, p.k_ss, kBlockN,
                                   &maps.k_sel);
  }
  if (err == cudaSuccess) {
    err = hopper::make_operand_map(&maps.v, p.v, p.d, D, p.s_k, p.heads,
                                   batch, p.v_sb, p.v_sh, p.v_ss, kBlockN,
                                   &maps.v_sel);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = FwdSmem<D>::kBytes;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid =
      (long long)((p.s_q + kFwdBlockM - 1) / kFwdBlockM) * batch_heads;
  if (grid > kMaxGrid) return cudaErrorInvalidValue;
  flash_fwd_wgmma<D><<<(unsigned)grid, kFwdThreads, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, int batch, int batch_heads, bool bf16,
                     cudaStream_t stream) {
  if (bf16) return launch_fwd_bf16<D>(p, batch, batch_heads, stream);
  return launch(flash_fwd_f32<D>, F32Tiles<D>::kBytes, kF32Block, p.s_q, p,
                batch_heads, stream);
}

// The fused bf16 backward at D: flash_bwd_wgmma up to D = 128, the wide
// kernel above it; its keys a CTA and shared memory a CTA.
template <int D, bool kOrdered>
auto bwd_kernel() {
  if constexpr (D > 128) {
    return flash_bwd_wgmma_wide<D, kOrdered>;
  } else {
    return flash_bwd_wgmma<D, kOrdered>;
  }
}
template <int D>
constexpr int bwd_block_n() { return D > 128 ? kWideBlockN : kBwdBlockN; }
template <int D>
constexpr size_t bwd_smem_bytes() {
  if constexpr (D > 128) {
    return BwdWideSmem<D>::kBytes;
  } else {
    return BwdSmem<D>::kBytes;
  }
}

// The backward: flash_bwd_prep, then for bf16 the fused kernel (q/k/v/dout
// tensor maps built here, per call, from the pointers and strides in `p`;
// 384 threads a CTA, one CTA per (b*h, bwd_block_n<D>() keys)) and the dQ
// conversion; for float32 the two CUDA-core kernels (32 keys, then 32 query
// rows a CTA).
template <int D>
cudaError_t launch_bwd(const BwdParams& p, bool bf16, cudaStream_t stream) {
  const long long n_bh = (long long)p.batch * p.heads;
  const long long prep_grid = n_bh * (p.s_pad / kBwdBlockM);
  if (prep_grid > kMaxGrid) return cudaErrorInvalidValue;
  if (bf16) {
    flash_bwd_prep<true, D><<<(unsigned)prep_grid, kThreads, 0, stream>>>(p);
  } else {
    flash_bwd_prep<false, D><<<(unsigned)prep_grid, kThreads, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!bf16) {
    err = launch(flash_bwd_dkv_f32<D>, F32BwdTiles<D>::kBytes, kF32Block,
                 p.s_k, p, (int)n_bh, stream);
    if (err != cudaSuccess) return err;
    return launch(flash_bwd_dq_f32<D>, F32BwdTiles<D>::kBytes, kF32Block,
                  p.s_q, p, (int)n_bh, stream);
  }
  constexpr int kBlockN = bwd_block_n<D>();
  BwdMaps maps;
  err = hopper::make_operand_map(&maps.q, p.q, p.d, D, p.s_q, p.heads,
                                 p.batch, p.q_sb, p.q_sh, p.q_ss, kBwdBlockM,
                                 &maps.q_sel);
  if (err == cudaSuccess) {
    err = hopper::make_operand_map(&maps.dout, p.dout, p.d, D, p.s_q,
                                   p.heads, p.batch, p.do_sb, p.do_sh,
                                   p.do_ss, kBwdBlockM, &maps.do_sel);
  }
  if (err == cudaSuccess) {
    err = hopper::make_operand_map(&maps.k, p.k, p.d, D, p.s_k, p.heads,
                                   p.batch, p.k_sb, p.k_sh, p.k_ss, kBlockN,
                                   &maps.k_sel);
  }
  if (err == cudaSuccess) {
    err = hopper::make_operand_map(&maps.v, p.v, p.d, D, p.s_k, p.heads,
                                   p.batch, p.v_sb, p.v_sh, p.v_ss, kBlockN,
                                   &maps.v_sel);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_smem_bytes<D>();
  auto* const kernel = p.dq_sem != nullptr ? bwd_kernel<D, true>()
                                           : bwd_kernel<D, false>();
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = n_bh * ((p.s_k + kBlockN - 1) / kBlockN);
  if (grid > kMaxGrid) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kBwdThreads, smem, stream>>>(p, maps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long threads = n_bh * p.s_q * (p.d / 8);
  if ((threads + 255) / 256 > kMaxGrid) return cudaErrorInvalidValue;
  flash_bwd_dq_convert<D><<<(unsigned)((threads + 255) / 256), 256, 0,
                            stream>>>(p);
  return cudaGetLastError();
}

// The instantiation that runs head dim d: the narrowest of 16, 32, 64, 128
// and 256 that holds it (0: none). Its tiles are that wide; the columns
// past d read as zero (flash_attention.py names the shapes it pads).
int tile_d(int d) {
  return d < 1 ? 0 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
                   : d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

}  // namespace

// C entry point, bound with ctypes. q/k/v/out are device arrays of float32
// (`bf16` == 0) or bfloat16 (`bf16` == 1) with unit stride on D; `strides`
// holds 12 element strides: (B, H, S) of q, k, v and out, in that order.
// Pointers and strides must keep every row 16-byte aligned, and d is at
// most 256, a multiple of 8 in bf16 and of 4 in float32 (rows of whole
// 16-byte chunks). `lse` is a contiguous float32 (B, H, S_q) device array
// or null; `scale` is the softmax scale (D**-0.5 of the model's head dim);
// `stream` is the caller's cudaStream_t. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape the kernels do not take
// or a bf16 operand's tensor map the driver refuses.
extern "C" int ai4e_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* out, float* lse,
                                        int batch, int heads, int s_q, int s_k,
                                        int d, const long long* strides,
                                        float scale, int causal, int bf16,
                                        void* stream, int device) {
  const int tile = tile_d(d);
  if (batch < 0 || heads < 1 || s_q < 0 || s_k < 1 || tile == 0 ||
      d % (bf16 ? 8 : 4) != 0 || (causal && s_q != s_k)) {
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
  p.heads = heads; p.s_q = s_q; p.s_k = s_k; p.d = d; p.causal = causal;
  p.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long bh = (long long)batch * heads;
  if (bh > kMaxGrid) return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 16: return (int)launch_d<16>(p, batch, (int)bh, bf16 != 0, s);
    case 32: return (int)launch_d<32>(p, batch, (int)bh, bf16 != 0, s);
    case 64: return (int)launch_d<64>(p, batch, (int)bh, bf16 != 0, s);
    case 128: return (int)launch_d<128>(p, batch, (int)bh, bf16 != 0, s);
    default: return (int)launch_d<256>(p, batch, (int)bh, bf16 != 0, s);
  }
}


// C entry point of the backward, bound with ctypes. q/k/v/out/dout and the
// gradients dq/dk/dv are device arrays of float32 (`bf16` == 0) or bfloat16
// (`bf16` == 1) with unit stride on D, every row 16-byte aligned, d as for
// the forward; `lse` is the forward's contiguous float32 (B, H, S_q)
// logsumexp. `strides` holds 24 element strides: (B, H, S) of q, k, v,
// dout, out, dq, dk and dv, in that order. `work` is float32 device scratch
// that the kernels fill: B * H * s_pad * (2 + T) floats for bf16, B * H *
// s_pad * 2 for float32, s_pad = S_q rounded up to a multiple of 64 and T
// the instantiation's head dim (tile_d(d)); `ordered` (bf16 only) adds the
// dQ adds' counters, B * H * s_pad / 32 int32 after those, and makes dq the
// same bit for bit from call to call. `scale` is the softmax scale. Returns
// cudaGetLastError() after the last launch, or cudaErrorInvalidValue for a
// shape the kernels do not take or a tensor map the driver refuses.
extern "C" int ai4e_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* work, void* dq, void* dk,
    void* dv, int batch, int heads, int s_q, int s_k, int d,
    const long long* strides, float scale, int causal, int bf16, int ordered,
    void* stream, int device) {
  const int tile = tile_d(d);
  if (batch < 1 || heads < 1 || s_q < 1 || s_k < 1 || tile == 0 ||
      d % (bf16 ? 8 : 4) != 0 || (long long)batch * heads > kMaxGrid ||
      (causal && s_q != s_k)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.dout = dout; p.lse = lse;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.do_sb = strides[9]; p.do_sh = strides[10]; p.do_ss = strides[11];
  p.o_sb = strides[12]; p.o_sh = strides[13]; p.o_ss = strides[14];
  p.dq_sb = strides[15]; p.dq_sh = strides[16]; p.dq_ss = strides[17];
  p.dk_sb = strides[18]; p.dk_sh = strides[19]; p.dk_ss = strides[20];
  p.dv_sb = strides[21]; p.dv_sh = strides[22]; p.dv_ss = strides[23];
  p.batch = batch; p.heads = heads; p.s_q = s_q; p.s_k = s_k; p.d = d;
  p.s_pad = (s_q + kBwdBlockM - 1) / kBwdBlockM * kBwdBlockM;
  p.causal = causal; p.scale = scale;
  const long long rows = (long long)batch * heads * p.s_pad;
  p.lse2 = work;
  p.delta = work + rows;
  p.dq_acc = bf16 ? work + 2 * rows : nullptr;
  p.dq_sem = bf16 && ordered
                 ? reinterpret_cast<int*>(work + (2 + (long long)tile) * rows)
                 : nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 16: return (int)launch_bwd<16>(p, bf16 != 0, s);
    case 32: return (int)launch_bwd<32>(p, bf16 != 0, s);
    case 64: return (int)launch_bwd<64>(p, bf16 != 0, s);
    case 128: return (int)launch_bwd<128>(p, bf16 != 0, s);
    default: return (int)launch_bwd<256>(p, bf16 != 0, s);
  }
}

namespace {

// `out` = {dynamic shared memory a CTA as launched, static shared memory,
// registers a thread, local (spill) bytes a thread, threads a CTA as
// launched} of `kernel`.
template <typename Kernel>
cudaError_t kernel_attrs(Kernel* kernel, size_t dynamic, int threads,
                         int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  out[0] = (int)dynamic;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = threads;
  return cudaSuccess;
}

template <int D>
cudaError_t flash_attrs(int which, int* out) {
  switch (which) {
    case 0: return kernel_attrs(flash_fwd_wgmma<D>, FwdSmem<D>::kBytes,
                                kFwdThreads, out);
    case 1: return kernel_attrs(flash_fwd_f32<D>, F32Tiles<D>::kBytes,
                                kThreads, out);
    case 2: return kernel_attrs(bwd_kernel<D, false>(), bwd_smem_bytes<D>(),
                                kBwdThreads, out);
    case 3: return kernel_attrs(bwd_kernel<D, true>(), bwd_smem_bytes<D>(),
                                kBwdThreads, out);
    case 4: return kernel_attrs(flash_bwd_prep<true, D>, 0, kThreads, out);
    case 5: return kernel_attrs(flash_bwd_prep<false, D>, 0, kThreads, out);
    case 6: return kernel_attrs(flash_bwd_dq_convert<D>, 0, 256, out);
    case 7: return kernel_attrs(flash_bwd_dkv_f32<D>, F32BwdTiles<D>::kBytes,
                                kThreads, out);
    case 8: return kernel_attrs(flash_bwd_dq_f32<D>, F32BwdTiles<D>::kBytes,
                                kThreads, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The attributes of one kernel of this file at instantiation `d` (16, 32,
// 64, 128 or 256), for the validation harness (ops/validate.py): `which` 0
// the bf16 forward, 1 the float32 forward, 2 and 3 the fused bf16 backward
// (dQ's adds in any order, ordered; at d = 256 the wide kernel), 4 and 5
// the preparation pass (bf16, float32), 6 the dQ conversion, 7 and 8 the
// float32 dK/dV and dQ kernels. Writes 5 ints to `out`: dynamic shared
// memory a CTA as launched, static shared memory, registers a thread, local
// (spill) bytes a thread, threads a CTA as launched. Returns a cudaError_t
// (0 on success).
extern "C" int ai4e_flash_attention_attrs(int which, int d, int device,
                                          int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (d) {
    case 16: return (int)flash_attrs<16>(which, out);
    case 32: return (int)flash_attrs<32>(which, out);
    case 64: return (int)flash_attrs<64>(which, out);
    case 128: return (int)flash_attrs<128>(which, out);
    case 256: return (int)flash_attrs<256>(which, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
