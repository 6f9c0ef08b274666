// Causal softmax attention, forward and backward, for Hopper (sm_90a):
//
//     O = softmax(mask(Q K^T * scale)) V      over (BH, T, D) tensors
//
// with logits in f32, masked keys at -1e30, matmul operands in the input
// dtype (f32 or bf16; P and dS rounded to bf16 for bf16 inputs) and f32
// sums. Three kernels:
//
//   flash_fwd_kernel        one CTA per (64-row Q tile, bh): the K/V tiles up
//                           to the diagonal with an online softmax; writes O
//                           and the f32 row log-sum-exp (LSE).
//   flash_bwd_dq_kernel     one CTA per (Q tile, bh): delta = rowsum(dO * O)
//                           in f32 (written out for the next kernel), then
//                           dQ over the K/V tiles up to the diagonal.
//   flash_bwd_dkdv_kernel   one CTA per (K tile, bh): dK and dV over the
//                           Q/dO tiles on or below the diagonal.
//
// A tile is 64 rows per warpgroup: one warpgroup a CTA, or two (128 rows)
// in the f32 backward at D = 64, where both share the streamed tiles.
//
// Both backward kernels recompute P = exp(S - LSE). Each output element is
// summed by one thread in a fixed order: no atomics, no split of a sum
// across CTAs, and a run is bit-identical to the next.
//
// Replaces neural_sound_generation_tpu/ops/pallas/attention.py
// ::flash_causal_attention (:321): _fwd_kernel (:165, pl.pallas_call at
// :280) and _bwd_kernel (:233, call at :302). The TPU kernel keeps a whole
// head resident in VMEM and runs one grid step per (batch, head); its
// backward walks Q tiles and accumulates dK/dV in scratch, which a
// sequential grid allows. On the GPU the CTAs run in no order, so dK/dV
// get a key-tile-major kernel of their own, and that kernel cannot see a
// whole softmax row: the forward saves the LSE for it.
//
// What bounds it on an H100. At BH = 64, T = 560, D = 64 the causal products
// are 2 * 2 * 64 * (560 * 561 / 2) * 64 = 2.57 GFLOP in the forward (3.86
// in dQ, which recomputes S and forms dP and dQ; 5.15 in dK/dV, which
// recomputes S and dP and forms dV and dK) against 36.8 MB of Q, K, V, O
// and the LSE (55.3 MB for each backward kernel), about 70 operations per
// byte, so the arithmetic rate bounds f32. On the CUDA cores (67 TFLOP/s)
// the forward needs 38.4 us, dQ 57.6, dK/dV 76.8; on the tensor cores an
// f32-accurate product is three TF32 products (3xTF32, below) at 495
// TFLOP/s: 15.6, 23.4 and 31.2 us; the bytes take 11.0, 16.5 and 16.5 us
// at 3.35 TB/s. bf16 inputs halve the bytes (5.5 us for the forward) and
// run the products at 989 TFLOP/s (2.6 us), so the bytes bound them. The
// design:
//
//   * Products. All six (S = Q K^T, P V, dP = dO V^T, dQ = dS K, dV =
//     P^T dO, dK = dS^T Q) are wgmma.mma_async of one warpgroup, M = 64
//     rows of the CTA's own tile: m64nNk8 TF32 for f32 inputs, m64n64k16
//     bf16 for bf16 inputs, so the CUDA cores no longer bound f32. For f32
//     each value v is split into hi = tf32(v) and lo = tf32(v - hi) and a
//     k-step is three products, lo.hi + hi.lo + hi.hi (the dropped lo.lo
//     and the rounding of lo leave about 2^-21 of |a||b| per term), as
//     csrc/vq_nearest.cu does.
//   * Accuracy. A tensor core's f32 accumulator aligns its terms to the
//     largest and truncates, so the running sums (O, dQ, dK, dV) take each
//     chain of kChain k-steps (32 keys in TF32, 64 in bf16) as a fresh
//     partial (scale-d = 0 on its first product) added with __fadd_rn. S and
//     dP are formed anew for every tile; their chains run over kChainD
//     k-steps (64 features in TF32, 128 in bf16), measured no less accurate
//     than chains of half that (PERF.md, PR 10).
//   * Operand layouts. Every staged tile is TMA's 128-byte-swizzled layout:
//     boxes of 128-byte rows (32 f32 or 64 bf16 columns). The products over
//     D (S = Q K^T, dP = dO V^T, and in the dK/dV kernel S^T = K Q^T and
//     dP^T = V dO^T, the key tile being the M rows) read both operands from
//     shared memory; for f32 the CTA's own tile is split once, hi in place
//     and lo beside it. P and dS (P^T and dS^T) become register A
//     fragments straight from the accumulator. TF32 wgmma reads B only
//     K-major, so for the four products that contract over the sequence
//     (P V, dS K, P^T dO, dS^T Q) the consumer writes a transposed copy of
//     the streamed tile (V, K, dO, Q) as it splits it; a TF32 accumulator
//     pair holds columns 2c and 2c + 1 where the A fragment wants c and
//     c + 4, so the copy permutes the keys of each group of eight to match
//     instead of shuffling registers. bf16 reads those tiles MN-major
//     (wgmma's transpose-B) as they arrive and needs no copy.
//   * Staging. The CTA's own tile once, and the streamed tiles (K/V in the
//     forward and dQ kernels, Q/dO in the dK/dV kernel) in a ring of S
//     stages (2; 1 for the f32 backward at D = 128), each guarded by an
//     mbarrier: one thread issues TMA (cp.async.bulk.tensor, a 3-D map over
//     (D, T, BH), zeros past T and D) for tile j + S as soon as tile j's
//     products are done. Rows whose byte stride TMA cannot take (D * size
//     not a multiple of 16, as bf16 at D = 20) are staged by the threads
//     with cp.async (zero-fill) into the same layout; the LSE and delta rows
//     are read plainly. The upper triangle's tiles are skipped and the
//     diagonal tile masked.
//   * Latency. One warpgroup alone exposes every latency of its loads,
//     exp and waits, so the f32 forward streams 32-key tiles and runs two
//     CTAs a SM, the f32 backward at D = 64 runs two warpgroups a CTA on
//     32-row streamed tiles that all 256 threads split (a warpgroup whose
//     rows see none of a tile skips its products), and the split loads
//     several chunks before it converts any.
//   * Registers. The accumulators, P or dS and one chain's A fragments fit
//     255 registers without spilling; at D = 128 two CTAs split dQ (or dK
//     and dV) by columns, each recomputing S and dP.
//
// What holds it above the bound (PERF.md has the figures): each warpgroup
// runs its products, its softmax and, for f32, the split and the
// transposed copies in turn, between the same barriers, and waits for each
// chain before its partial is added; the f32 copies fill the shared
// memory. A producer warp that splits while the consumers multiply is the
// next step. flash_attention_plan reports a launch's CTAs, registers,
// spills and shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <cstdint>
#include <initializer_list>
#include <mutex>
#include <utility>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kBM = 64;        // rows of a warpgroup's own tile (wgmma M)
constexpr int kChain = 4;      // k-steps of A from registers summed into one fresh partial
constexpr int kChainD = 8;     // k-steps over D summed into one fresh partial
constexpr float kNeg = -1e30f;  // the masked logit (attention.py _NEG)

// Per input type: columns in one 128-byte swizzle row, elements per k-step.
template <typename T>
struct Ty;
template <>
struct Ty<float> {
  static constexpr bool kTf32 = true;
  static constexpr int kEs = 4, kBox = 32, kStep = 8;
};
template <>
struct Ty<bf16> {
  static constexpr bool kTf32 = false;
  static constexpr int kEs = 2, kBox = 64, kStep = 16;
};

// The tiling of one (type, padded head width DP): BN streamed rows a tile
// (32 for f32 from DP = 64, so that the split copies fit beside two
// warpgroups' own tiles, or two forward CTAs share an SM), R and U the bytes
// of the CTA's own tile and of a streamed tile, NCH the columns of one
// product over D (wgmma N), NOUT the output columns of a backward CTA (64
// at DP = 128: two CTAs split dQ, or dK and dV, by columns, each
// recomputing S and dP, so that the accumulators fit the registers), UT
// the bytes of a transposed f32 copy of NOUT columns; the ring's depth,
// 2, or 1 for the f32 backward at DP = 128 (where the own tiles' lo copies
// leave room for one stage).
template <typename T, int DP>
struct Geo {
  static constexpr bool kTf32 = Ty<T>::kTf32;
  static constexpr int BN = kTf32 && DP > 32 ? 32 : 64;
  // consumer warpgroups of a backward CTA, each on its own 64 rows, sharing
  // the streamed tiles and their split (two for f32 at DP = 64)
  static constexpr int WG = kTf32 && DP == 64 ? 2 : 1;
  static constexpr int R = kBM * DP * Ty<T>::kEs;
  static constexpr int U = BN * DP * Ty<T>::kEs;
  static constexpr int NCH = DP < 64 ? DP : 64;
  static constexpr int NOUT = DP > 64 ? 64 : DP;
  static constexpr int SPLIT = DP / NOUT;
  static constexpr int UT = BN * NOUT * 4;
  static constexpr int kStagesFwd = 2;
  static constexpr int kStagesBwd = kTf32 && DP > 64 ? 1 : 2;
  // chunks of a streamed f32 tile each thread loads before it splits any
  static constexpr int kGroupFwd = DP > 64 ? 1 : 4;
  static constexpr int kGroupBwd = DP > 64 ? 1 : 2;
  // tile bytes of each kernel: own tiles (and their lo copies for f32),
  // the ring, and for f32 the split and transposed copies
  static constexpr int kFwd = (kTf32 ? 2 : 1) * R + kStagesFwd * 2 * U + (kTf32 ? 3 * U : 0);
  static constexpr int kDq =
      WG * (kTf32 ? 4 : 2) * R + kStagesBwd * 2 * U + (kTf32 ? 2 * U + 2 * UT : 0);
  static constexpr int kDkdv =
      WG * (kTf32 ? 4 : 2) * R + kStagesBwd * 2 * U + (kTf32 ? 2 * U + 4 * UT : 0);
};

// A kernel's dynamic shared memory: its tiles, then the barriers (64 bytes)
// and two rows of 64 floats, and the slack to align the tiles to 1024 bytes.
template <int kTiles>
constexpr int smem_bytes() {
  return kTiles + 64 + 2 * 64 * 4 + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of byte column `b` of row r in a tile of `rows` rows stored as
// boxes of 128-byte rows with TMA's 128-byte swizzle: box b / 128 starts at
// (b / 128) * rows * 128, and the 16-byte chunk j of row r sits at chunk
// j ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int rows, int r, int b) {
  return (b >> 7) * rows * 128 + r * 128 + ((((b & 127) >> 4) ^ (r & 7)) << 4) + (b & 15);
}

template <typename T>
__device__ __forceinline__ uint32_t swz_el(int rows, int r, int col) {
  return swz(rows, r, col * Ty<T>::kEs);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const float h = to_tf32(v);
  hi = __float_as_uint(h);
  lo = __float_as_uint(to_tf32(v - h));  // v - h is exact in f32
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- mbarriers, TMA, cp.async ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(smem_addr(bar))
      : "memory");
}

// 4 bytes from src, or `n` < 4 of them and zeros
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the threads' shared-memory accesses, then the async proxy's (TMA, wgmma)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- wgmma ------------------------------------------------------------------

// A shared-memory operand: 128-byte swizzle, 8-row groups 1024 bytes apart
// (SBO). LBO: 16 (unused) for K-major operands; for bf16 MN-major operands
// the distance between 64-column boxes, never crossed by an N = 64 product.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= uint64_t((lbo >> 4) & 0x3FFF) << 16;
  d |= uint64_t(1024 >> 4) << 32;
  d |= uint64_t(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d (64 x N, f32 fragments) = A (64 x k, registers) . B (N x k, shared
// memory) (+ d when scale_d is nonzero). Register i of d holds row 16 * warp
// + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
// TF32 A fragment: a[q] at row 16 * warp + lane / 4 + 8 * (q % 2), k
// lane % 4 + 4 * (q / 2); bf16: a[q] holds k 2 * (lane % 4) + 8 * (q / 2)
// and the next (mma.m16n8k16's A fragment).
__device__ __forceinline__ void mma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// bf16 with B MN-major (wgmma's transpose-B immediate): the streamed tile
// as it arrives, in the products that contract over its rows
__device__ __forceinline__ void mma_bf16_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The same products with A from shared memory too (descriptor da), both
// operands K-major.
__device__ __forceinline__ void mma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_tf32_ss(float (&d)[16], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_bf16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Registers a wgmma reads or writes must stay where they are until its
// wait: these empty statements keep them live and order their uses after it.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int L>
__device__ __forceinline__ void keep(uint32_t (&a)[L][4]) {
#pragma unroll
  for (int s = 0; s < L; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[s][q])::"memory");
}

// One chain: part = sum over k-steps c0 .. c0 + L - 1 of A . B into a fresh
// partial, retired before it returns. B's k-step ks sits (ks / 4) * box16 +
// (ks % 4) * step16 (16-byte units) past the descriptors dh (and dl, the lo
// halves, for TF32) of k-step 0. TF32 takes the small terms first: lo.hi,
// hi.lo, hi.hi. Straight-line code, so that ptxas keeps the wgmmas in one
// pipeline stage.
template <typename T, int NR, int L>
__device__ __forceinline__ void chain(float (&part)[NR], uint32_t (&ahi)[L][4],
                                      uint32_t (&alo)[L][4], uint64_t dh, uint64_t dl, int c0,
                                      int box16, int step16) {
  auto at = [&](int s) { return static_cast<uint64_t>(((c0 + s) / 4) * box16 +
                                                      ((c0 + s) % 4) * step16); };
  wgmma_fence();
  if constexpr (Ty<T>::kTf32) {
#pragma unroll
    for (int s = 0; s < L; ++s) mma_tf32(part, alo[s], dh + at(s), s);
#pragma unroll
    for (int s = 0; s < L; ++s) mma_tf32(part, ahi[s], dl + at(s), 1);
#pragma unroll
    for (int s = 0; s < L; ++s) mma_tf32(part, ahi[s], dh + at(s), 1);
  } else {
#pragma unroll
    for (int s = 0; s < L; ++s) mma_bf16_mn(part, ahi[s], dh + at(s), s);
  }
  wgmma_commit();
  wgmma_wait_all();
  keep(part);
  keep(ahi);
  if constexpr (Ty<T>::kTf32) keep(alo);
}

// A fragments of k-steps ks0 .. ks0 + L - 1 from an accumulator (P or dS,
// the contraction running over its columns). TF32: the pair of columns
// 2c, 2c + 1 of a step stands for the fragment's k = c and c + 4; the
// B operand's rows are permuted to match (split_tile). bf16: rounded to
// nearest even, the input dtype's operand (attention.py :159, :219, :224).
template <typename T, int NR, int L>
__device__ __forceinline__ void frags_acc(const float (&acc)[NR], int ks0, uint32_t (&hi)[L][4],
                                          uint32_t (&lo)[L][4]) {
#pragma unroll
  for (int s = 0; s < L; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (Ty<T>::kTf32) {
        split(acc[4 * (ks0 + s) + (((q & 1) << 1) | (q >> 1))], hi[s][q], lo[s][q]);
      } else {
        const int i = 8 * (ks0 + s) + 2 * q;
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[i], acc[i + 1]);
        hi[s][q] = *reinterpret_cast<const uint32_t*>(&v);
        lo[s][q] = 0;
      }
    }
}

// out (64 x BN) = own (64 x DP) . X^T, both operands in shared memory as
// staged (for TF32 hi in place and lo beside: own_lo, x_lo): the
// contraction over D in chains of kChainD k-steps, each into a fresh
// partial added with __fadd_rn. S and dP are formed anew for every tile,
// so a chain here is at most the whole of D (two chains at DP = 128).
template <typename T, int DP, int BN>
__device__ __forceinline__ void product_rows(float (&out)[BN / 2], float (&part)[32],
                                             const unsigned char* own,
                                             const unsigned char* own_lo,
                                             const unsigned char* x, const unsigned char* x_lo) {
  constexpr int KS = DP / Ty<T>::kStep;
  constexpr int L = KS < kChainD ? KS : kChainD;
  float(&p)[BN / 2] = *reinterpret_cast<float(*)[BN / 2]>(&part);
  const uint64_t ah = desc(smem_addr(own), 16), al = desc(smem_addr(own_lo), 16);
  const uint64_t bh = desc(smem_addr(x), 16), bl = desc(smem_addr(x_lo), 16);
  // k-step ks: box ks / 4 (kBM or BN rows of 128 bytes), 32 bytes a step
  auto a_at = [](int ks) { return static_cast<uint64_t>((ks / 4) * kBM * 8 + (ks % 4) * 2); };
  auto b_at = [](int ks) { return static_cast<uint64_t>((ks / 4) * BN * 8 + (ks % 4) * 2); };
#pragma unroll
  for (int c0 = 0; c0 < KS; c0 += L) {
    float(&d)[BN / 2] = c0 == 0 ? out : p;
    wgmma_fence();
    if constexpr (Ty<T>::kTf32) {
#pragma unroll
      for (int s = 0; s < L; ++s) mma_tf32_ss(d, al + a_at(c0 + s), bh + b_at(c0 + s), s);
#pragma unroll
      for (int s = 0; s < L; ++s) mma_tf32_ss(d, ah + a_at(c0 + s), bl + b_at(c0 + s), 1);
#pragma unroll
      for (int s = 0; s < L; ++s) mma_tf32_ss(d, ah + a_at(c0 + s), bh + b_at(c0 + s), 1);
    } else {
#pragma unroll
      for (int s = 0; s < L; ++s) mma_bf16_ss(d, ah + a_at(c0 + s), bh + b_at(c0 + s), s);
    }
    wgmma_commit();
    wgmma_wait_all();
    keep(d);
    if (c0 != 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) out[i] = __fadd_rn(out[i], p[i]);
    }
  }
}

// run (64 x NOUT) += A . X[:, col0 : col0 + NOUT], A the (64 x BN)
// accumulator `acc` (P or dS) and X the staged (BN x DP) tile: for TF32 its
// transposed copy (xt_hi, xt_lo: NOUT rows from col0, K-major over the
// permuted positions), for bf16 X itself read MN-major. Column blocks of
// NCH, each in chains of kChain k-steps into a fresh partial added with
// __fadd_rn.
template <typename T, int DP, int BN, int NOUT>
__device__ __forceinline__ void product_cols(float (&run)[NOUT / 2], float (&part)[32],
                                             const float (&acc)[BN / 2],
                                             const unsigned char* xt_hi,
                                             const unsigned char* xt_lo, int col0) {
  constexpr int NCH = Geo<T, DP>::NCH;
  constexpr int KS = BN / Ty<T>::kStep;
  constexpr int L = KS < kChain ? KS : kChain;
  float(&p)[NCH / 2] = *reinterpret_cast<float(*)[NCH / 2]>(&part);
#pragma unroll
  for (int nc = 0; nc < NOUT / NCH; ++nc) {
    uint64_t dh, dl;
    if constexpr (Ty<T>::kTf32) {
      dh = desc(smem_addr(xt_hi) + nc * NCH * 128, 16);
      dl = desc(smem_addr(xt_lo) + nc * NCH * 128, 16);
    } else {
      dh = dl = desc(smem_addr(xt_hi) + (col0 / 64 + nc) * BN * 128, BN * 128);
    }
#pragma unroll
    for (int c0 = 0; c0 < KS; c0 += L) {
      uint32_t ahi[L][4], alo[L][4];
      frags_acc<T>(acc, c0, ahi, alo);
      if constexpr (Ty<T>::kTf32)
        chain<T>(p, ahi, alo, dh, dl, c0, NOUT * 8, 2);
      else
        chain<T>(p, ahi, alo, dh, dl, c0, 512, 128);
#pragma unroll
      for (int i = 0; i < NCH / 2; ++i)
        run[nc * NCH / 2 + i] = __fadd_rn(run[nc * NCH / 2 + i], p[i]);
    }
  }
}

// ---- staging ----------------------------------------------------------------

// Rows r0 .. r0 + rows - 1 of one head's (t_len, d) matrix into `dst`
// (the swizzled boxes of a tile), the first nbox boxes: TMA by thread 0,
// counted on `bar`, or cp.async by every thread (zeros past T and d; a bf16
// pair that straddles the end of a row or sits at an odd address is copied
// by the thread itself). Boxes past nbox stay as they are (zero).
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* dst, const CUtensorMap* map,
                                           const T* src, int rows, int r0, int bh, int t_len,
                                           int d, int nbox, bool tma, uint64_t* bar) {
  if (tma) {
    if (threadIdx.x == 0)
      for (int b = 0; b < nbox; ++b)
        tma_load_3d(dst + b * rows * 128, map, b * Ty<T>::kBox, r0, bh, bar);
    return;
  }
  const int words = nbox * 32;  // 4-byte words of a row
  const uint32_t base = smem_addr(dst);
  for (int i = threadIdx.x; i < rows * words; i += blockDim.x) {
    const int r = i / words, wb = (i - r * words) * 4;
    const int col = wb / Ty<T>::kEs, gr = r0 + r;
    const uint32_t s = base + swz(rows, r, wb);
    const T* p = src + static_cast<long long>(gr) * d + col;
    if (gr >= t_len || col >= d) {
      cp_async_4(s, src, 0);
    } else if (Ty<T>::kEs == 4 ||
               (col + 1 < d && (reinterpret_cast<uintptr_t>(p) & 3) == 0)) {
      cp_async_4(s, p, 4);
    } else {
      const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
      const uint32_t word = h[0] | (col + 1 < d ? static_cast<uint32_t>(h[1]) << 16 : 0u);
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(s), "r"(word) : "memory");
    }
  }
}

// The staged f32 tile `x` (ROWS x DP, boxes of 32 columns): with kKmaj hi =
// tf32(x) in place and lo = tf32(x - hi) at the same offset in x_lo; with
// kTrans, of columns col0 .. col0 + NT, both transposed into t_hi and t_lo
// (NT rows by ROWS positions, boxes of 32 positions), position r stored at
// 8 * (r / 8) + (r % 8) / 2 + 4 * (r % 2): the column frags_acc's TF32
// fragment gives it. Columns past d are zero and stay zero. A warp's lanes
// take 32 consecutive rows of one 4-column chunk, so every access is free
// of bank conflicts; each thread loads kGroup chunks before it splits any,
// so that one warp a scheduler keeps several loads in flight (as many as
// the registers left beside the accumulators allow: Geo::kGroup*).
template <int ROWS, int DP, int NT, bool kKmaj, bool kTrans, int kGroup = 1, int kNT = kThreads>
__device__ __forceinline__ void split_tile(unsigned char* x, unsigned char* x_lo,
                                           unsigned char* t_hi, unsigned char* t_lo, int col0) {
  constexpr int kChunks = ROWS * DP / 4;
#pragma unroll 1
  for (int e0 = 0; e0 < kChunks; e0 += kGroup * kNT) {
    float4 v[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int e = e0 + u * kNT + threadIdx.x;
      if (e < kChunks)
        v[u] = *reinterpret_cast<const float4*>(x + swz_el<float>(ROWS, e % ROWS, 4 * (e / ROWS)));
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int e = e0 + u * kNT + threadIdx.x;
      if (e >= kChunks) continue;
      const int r = e % ROWS, col = 4 * (e / ROWS);
      const uint32_t off = swz_el<float>(ROWS, r, col);
      uint32_t h[4], l[4];
      split(v[u].x, h[0], l[0]);
      split(v[u].y, h[1], l[1]);
      split(v[u].z, h[2], l[2]);
      split(v[u].w, h[3], l[3]);
      if constexpr (kKmaj) {
        *reinterpret_cast<uint4*>(x + off) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(x_lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
      }
      if constexpr (kTrans) {
        if (col >= col0 && col < col0 + NT) {
          const int pos = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t t = swz_el<float>(NT, col - col0 + i, pos);
            *reinterpret_cast<uint32_t*>(t_hi + t) = h[i];
            *reinterpret_cast<uint32_t*>(t_lo + t) = l[i];
          }
        }
      }
    }
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// Zeros `bytes` (a multiple of 16) of shared memory, then initialises the
// barriers; ends with every thread past both.
__device__ __forceinline__ void start(unsigned char* smem, int bytes, uint64_t* bars, int n_bars) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (int b = 0; b < n_bars; ++b) mbar_init(&bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_async();
  __syncthreads();
}

// Waits for streamed tile `it` (stage it % S) and, on the first, the CTA's
// own tiles. cp.async: every committed group but the newest S - 1 has
// landed.
template <int S>
__device__ __forceinline__ void wait_tile(bool tma, uint64_t* own_bar, uint64_t* full, int it) {
  if (tma) {
    if (it == 0) mbar_wait(own_bar, 0);
    mbar_wait(&full[it % S], (it / S) & 1);
  } else {
    cp_async_wait<S - 1>();
  }
  __syncthreads();
}

// ---- the kernels --------------------------------------------------------------

// Each kernel's shared memory: its own tile(s) (for f32 hi in place and lo
// beside), the ring (stage s: the two streamed tiles, U bytes each), for
// f32 the split and transposed copies of the streamed tiles, then the
// barriers (own, full[S]) and two rows of 64 floats.

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const T* __restrict__ q,
                 const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t_len, int d, float scale, int tma) {
  using G = Geo<T, DP>;
  constexpr int BN = G::BN, U = G::U, NCH = G::NCH, S = G::kStagesFwd;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* q_s = smem;
  unsigned char* q_lo = q_s + G::R;  // f32
  unsigned char* ring = q_s + (G::kTf32 ? 2 : 1) * G::R;
  unsigned char* k_lo = ring + S * 2 * U;  // f32: K's lo, V^T's hi and lo
  unsigned char* vt_hi = k_lo + U;
  unsigned char* vt_lo = vt_hi + U;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::kFwd);
  uint64_t* full = bars + 1;

  const int tid = threadIdx.x, lane = tid % 32, c = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int bh = blockIdx.y;
  const long long base = static_cast<long long>(bh) * t_len * d;
  const int row0 = qt * kBM;
  const int n_tiles = min(row0 + kBM - 1, t_len - 1) / BN + 1;
  const int nbox = (d + Ty<T>::kBox - 1) / Ty<T>::kBox;
  const int ra = row0 + 16 * (tid / 32) + lane / 4;  // this thread's rows ra, ra + 8

  start(smem, G::kFwd, bars, 1 + S);
  auto issue = [&](int j) {  // K/V tile j into stage j % S
    unsigned char* st = ring + (j % S) * 2 * U;
    if (j < n_tiles) {
      if (tma && tid == 0) mbar_expect_tx(&full[j % S], 2 * BN * nbox * 128);
      stage_tile<T>(st, &kmap, k + base, BN, j * BN, bh, t_len, d, nbox, tma, &full[j % S]);
      stage_tile<T>(st + U, &vmap, v + base, BN, j * BN, bh, t_len, d, nbox, tma, &full[j % S]);
    }
    if (!tma) cp_async_commit();
  };
  if (tma && tid == 0) mbar_expect_tx(&bars[0], kBM * nbox * 128);
  stage_tile<T>(q_s, &qmap, q + base, kBM, row0, bh, t_len, d, nbox, tma, &bars[0]);
  for (int j = 0; j < S; ++j) issue(j);

  float o_acc[DP / 2], part[32], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    unsigned char* k_s = ring + (j % S) * 2 * U;
    unsigned char* v_s = k_s + U;
    wait_tile<S>(tma, &bars[0], full, j);
    if constexpr (G::kTf32) {
      if (j == 0) split_tile<kBM, DP, DP, true, false>(q_s, q_lo, nullptr, nullptr, 0);
      split_tile<BN, DP, DP, true, false, G::kGroupFwd>(k_s, k_lo, nullptr, nullptr, 0);
      split_tile<BN, DP, DP, false, true, G::kGroupFwd>(v_s, nullptr, vt_hi, vt_lo, 0);
    }
    fence_async();
    __syncthreads();

    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    product_rows<T, DP, BN>(s, part, q_s, q_lo, k_s, k_lo);

    // online softmax over this tile's keys
    float mx[2] = {kNeg, kNeg}, corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1;
      const int key = j * BN + 8 * (i >> 2) + 2 * c + (i & 1);
      s[i] = key <= ra + 8 * h && key < t_len ? s[i] * scale : kNeg;
      mx[h] = fmaxf(mx[h], s[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = expf(s[i] - m[h]);
      sum[h] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(sum[h]);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o_acc[i] *= corr[(i >> 1) & 1];

    product_cols<T, DP, BN, DP>(o_acc, part, s, G::kTf32 ? vt_hi : v_s, vt_lo, 0);
    __syncthreads();  // every warp's products have read stage j % S
    issue(j + S);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    if (row >= t_len) continue;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      if (((i >> 1) & 1) != h) continue;
      const int col = (i / (NCH / 2)) * NCH + 8 * ((i % (NCH / 2)) >> 2) + 2 * c + (i & 1);
      if (col < d) store_out(o + base + static_cast<long long>(row) * d + col, o_acc[i] / l[h]);
    }
    if (c == 0) lse[static_cast<long long>(bh) * t_len + row] = m[h] + logf(l[h]);
  }
  if (!tma) cp_async_wait<0>();
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads * Geo<T, DP>::WG, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int t_len, int d, float scale,
                    int tma) {
  using G = Geo<T, DP>;
  constexpr int BN = G::BN, U = G::U, NOUT = G::NOUT, S = G::kStagesBwd, WG = G::WG;
  constexpr int R = G::R, NT = kThreads * WG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  // own tiles, one per warpgroup: Q, dO, and for f32 their lo copies
  unsigned char* q_s = smem;
  unsigned char* do_s = q_s + WG * R;
  unsigned char* q_lo = do_s + WG * R;
  unsigned char* do_lo = q_lo + WG * R;
  unsigned char* ring = q_s + WG * (G::kTf32 ? 4 : 2) * R;
  unsigned char* k_lo = ring + S * 2 * U;  // f32: K's lo, V's lo, K^T's hi and lo
  unsigned char* v_lo = k_lo + U;
  unsigned char* kt_hi = v_lo + U;
  unsigned char* kt_lo = kt_hi + G::UT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::kDq);
  uint64_t* full = bars + 1;
  float* delta_s = reinterpret_cast<float*>(bars + 8);

  const int tid = threadIdx.x, wg = tid / kThreads, lane = tid % 32, c = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const long long base = static_cast<long long>(bh) * t_len * d;
  const long long rows_base = static_cast<long long>(bh) * t_len;
  const int row0 = qt * kBM * WG;    // the CTA's rows
  const int wrow0 = row0 + kBM * wg;  // this warpgroup's
  const int n_tiles = min(row0 + kBM * WG - 1, t_len - 1) / BN + 1;
  const int nbox = (d + Ty<T>::kBox - 1) / Ty<T>::kBox;
  const int ra = wrow0 + 16 * ((tid % kThreads) / 32) + lane / 4;
  const int zc = blockIdx.z * NOUT;  // this CTA's columns of dQ

  start(smem, G::kDq, bars, 1 + S);
  auto issue = [&](int j) {
    unsigned char* st = ring + (j % S) * 2 * U;
    if (j < n_tiles) {
      if (tma && tid == 0) mbar_expect_tx(&full[j % S], 2 * BN * nbox * 128);
      stage_tile<T>(st, &kmap, k + base, BN, j * BN, bh, t_len, d, nbox, tma, &full[j % S]);
      stage_tile<T>(st + U, &vmap, v + base, BN, j * BN, bh, t_len, d, nbox, tma, &full[j % S]);
    }
    if (!tma) cp_async_commit();
  };
  if (tma && tid == 0) mbar_expect_tx(&bars[0], 2 * WG * kBM * nbox * 128);
  for (int w = 0; w < WG; ++w) {
    const int r0 = row0 + kBM * w;
    stage_tile<T>(q_s + w * R, &qmap, q + base, kBM, r0, bh, t_len, d, nbox, tma, &bars[0]);
    stage_tile<T>(do_s + w * R, &domap, dout + base, kBM, r0, bh, t_len, d, nbox, tma, &bars[0]);
  }
  for (int j = 0; j < S; ++j) issue(j);

  // delta = rowsum(dO * O) in f32 (attention.py :200): two threads a row,
  // alternate columns, joined by one shuffle
  {
    const int r = tid / 2, gr = row0 + r;
    float part_sum = 0.f;
    if (gr < t_len)
      for (int cc = tid % 2; cc < d; cc += 2) {
        const long long at = base + static_cast<long long>(gr) * d + cc;
        part_sum = fmaf(to_f32(dout[at]), to_f32(o[at]), part_sum);
      }
    part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 1);
    if (tid % 2 == 0) {
      delta_s[r] = part_sum;
      if (gr < t_len && blockIdx.z == 0) delta[rows_base + gr] = part_sum;
    }
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lse_r[h] = ra + 8 * h < t_len ? lse[rows_base + ra + 8 * h] : 0.f;
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) delta_r[h] = delta_s[ra + 8 * h - row0];

  float dq_acc[NOUT / 2], part[32];
#pragma unroll
  for (int i = 0; i < NOUT / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    unsigned char* k_s = ring + (j % S) * 2 * U;
    unsigned char* v_s = k_s + U;
    wait_tile<S>(tma, &bars[0], full, j);
    if constexpr (G::kTf32) {
      if (j == 0)
        for (int w = 0; w < WG; ++w) {
          split_tile<kBM, DP, DP, true, false, 1, NT>(q_s + w * R, q_lo + w * R, nullptr,
                                                      nullptr, 0);
          split_tile<kBM, DP, DP, true, false, 1, NT>(do_s + w * R, do_lo + w * R, nullptr,
                                                      nullptr, 0);
        }
      split_tile<BN, DP, NOUT, true, true, G::kGroupBwd, NT>(k_s, k_lo, kt_hi, kt_lo, zc);
      split_tile<BN, DP, NOUT, true, false, G::kGroupBwd, NT>(v_s, v_lo, nullptr, nullptr, 0);
    }
    fence_async();
    __syncthreads();

    // a warpgroup whose rows see none of this tile's keys skips it
    if (j * BN <= wrow0 + kBM - 1 && wrow0 < t_len) {
      float s[BN / 2], dp[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
      product_rows<T, DP, BN>(s, part, q_s + wg * R, q_lo + wg * R, k_s, k_lo);
      product_rows<T, DP, BN>(dp, part, do_s + wg * R, do_lo + wg * R, v_s, v_lo);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1, row = ra + 8 * h;
        const int key = j * BN + 8 * (i >> 2) + 2 * c + (i & 1);
        const bool visible = key <= row && key < t_len && row < t_len;
        const float p = visible ? expf(s[i] * scale - lse_r[h]) : 0.f;
        s[i] = p * (dp[i] - delta_r[h]) * scale;  // dS
      }
      product_cols<T, DP, BN, NOUT>(dq_acc, part, s, G::kTf32 ? kt_hi : k_s, kt_lo, zc);
    }
    __syncthreads();
    issue(j + S);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    if (row >= t_len) continue;
#pragma unroll
    for (int i = 0; i < NOUT / 2; ++i) {
      if (((i >> 1) & 1) != h) continue;
      const int col = zc + 8 * (i >> 2) + 2 * c + (i & 1);
      if (col < d) store_out(dq + base + static_cast<long long>(row) * d + col, dq_acc[i]);
    }
  }
  if (!tma) cp_async_wait<0>();
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads * Geo<T, DP>::WG, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap, const T* __restrict__ q,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int t_len, int d, float scale, int tma) {
  using G = Geo<T, DP>;
  constexpr int BN = G::BN, U = G::U, NOUT = G::NOUT, UT = G::UT, S = G::kStagesBwd;
  constexpr int WG = G::WG, R = G::R, NT = kThreads * WG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  // own tiles, one per warpgroup: K, V, and for f32 their lo copies
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + WG * R;
  unsigned char* k_lo = v_s + WG * R;
  unsigned char* v_lo = k_lo + WG * R;
  unsigned char* ring = k_s + WG * (G::kTf32 ? 4 : 2) * R;
  unsigned char* q_lo = ring + S * 2 * U;  // f32: Q's and dO's lo, Q^T, dO^T
  unsigned char* do_lo = q_lo + U;
  unsigned char* qt_hi = do_lo + U;
  unsigned char* qt_lo = qt_hi + UT;
  unsigned char* dot_hi = qt_lo + UT;
  unsigned char* dot_lo = dot_hi + UT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::kDkdv);
  uint64_t* full = bars + 1;
  float* lse_s = reinterpret_cast<float*>(bars + 8);
  float* delta_s = lse_s + 64;

  const int tid = threadIdx.x, wg = tid / kThreads, lane = tid % 32, c = lane % 4;
  const int bh = blockIdx.y;
  const long long base = static_cast<long long>(bh) * t_len * d;
  const long long rows_base = static_cast<long long>(bh) * t_len;
  const int col0 = blockIdx.x * kBM * WG;  // the CTA's keys
  const int wcol0 = col0 + kBM * wg;        // this warpgroup's
  const int j0 = col0 / BN;                 // the first Q tile that sees them
  const int n_tiles = (t_len - 1) / BN + 1 - j0;
  const int nbox = (d + Ty<T>::kBox - 1) / Ty<T>::kBox;
  const int ka = wcol0 + 16 * ((tid % kThreads) / 32) + lane / 4;  // keys ka, ka + 8
  const int zc = blockIdx.z * NOUT;  // this CTA's columns of dK, dV

  start(smem, G::kDkdv, bars, 1 + S);
  auto issue = [&](int it) {  // Q/dO tile j0 + it into stage it % S
    unsigned char* st = ring + (it % S) * 2 * U;
    if (it < n_tiles) {
      const int r0 = (j0 + it) * BN;
      if (tma && tid == 0) mbar_expect_tx(&full[it % S], 2 * BN * nbox * 128);
      stage_tile<T>(st, &qmap, q + base, BN, r0, bh, t_len, d, nbox, tma, &full[it % S]);
      stage_tile<T>(st + U, &domap, dout + base, BN, r0, bh, t_len, d, nbox, tma, &full[it % S]);
    }
    if (!tma) cp_async_commit();
  };
  if (tma && tid == 0) mbar_expect_tx(&bars[0], 2 * WG * kBM * nbox * 128);
  for (int w = 0; w < WG; ++w) {
    const int r0 = col0 + kBM * w;
    stage_tile<T>(k_s + w * R, &kmap, k + base, kBM, r0, bh, t_len, d, nbox, tma, &bars[0]);
    stage_tile<T>(v_s + w * R, &vmap, v + base, kBM, r0, bh, t_len, d, nbox, tma, &bars[0]);
  }
  for (int it = 0; it < S; ++it) issue(it);

  float dk_acc[NOUT / 2], dv_acc[NOUT / 2], part[32];
#pragma unroll
  for (int i = 0; i < NOUT / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    unsigned char* q_t = ring + (it % S) * 2 * U;
    unsigned char* do_t = q_t + U;
    const int q0 = (j0 + it) * BN;
    wait_tile<S>(tma, &bars[0], full, it);
    if constexpr (G::kTf32) {
      if (it == 0)
        for (int w = 0; w < WG; ++w) {
          split_tile<kBM, DP, DP, true, false, 1, NT>(k_s + w * R, k_lo + w * R, nullptr,
                                                      nullptr, 0);
          split_tile<kBM, DP, DP, true, false, 1, NT>(v_s + w * R, v_lo + w * R, nullptr,
                                                      nullptr, 0);
        }
      split_tile<BN, DP, NOUT, true, true, G::kGroupBwd, NT>(q_t, q_lo, qt_hi, qt_lo, zc);
      split_tile<BN, DP, NOUT, true, true, G::kGroupBwd, NT>(do_t, do_lo, dot_hi, dot_lo, zc);
    }
    for (int i = tid; i < BN; i += NT) {
      const bool in = q0 + i < t_len;
      lse_s[i] = in ? lse[rows_base + q0 + i] : 0.f;
      delta_s[i] = in ? delta[rows_base + q0 + i] : 0.f;
    }
    fence_async();
    __syncthreads();

    // rows are this warpgroup's keys: S^T = K Q^T, P^T, dV += P^T dO; then
    // dP^T = V dO^T, dS^T, dK += dS^T Q (dP formed after dV, so that P and
    // dP are live together only while dS is formed). A warpgroup whose keys
    // no query of this tile sees skips it.
    if (q0 + BN - 1 >= wcol0 && wcol0 < t_len) {
      float s[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
      product_rows<T, DP, BN>(s, part, k_s + wg * R, k_lo + wg * R, q_t, q_lo);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int key = ka + 8 * ((i >> 1) & 1);
        const int col = 8 * (i >> 2) + 2 * c + (i & 1), qi = q0 + col;
        const bool visible = key <= qi && qi < t_len && key < t_len;
        s[i] = visible ? expf(s[i] * scale - lse_s[col]) : 0.f;  // P^T
      }
      product_cols<T, DP, BN, NOUT>(dv_acc, part, s, G::kTf32 ? dot_hi : do_t, dot_lo, zc);
      float dp[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) dp[i] = 0.f;
      product_rows<T, DP, BN>(dp, part, v_s + wg * R, v_lo + wg * R, do_t, do_lo);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * c + (i & 1);
        dp[i] = s[i] * (dp[i] - delta_s[col]) * scale;  // dS^T
      }
      product_cols<T, DP, BN, NOUT>(dk_acc, part, dp, G::kTf32 ? qt_hi : q_t, qt_lo, zc);
    }
    __syncthreads();
    issue(it + S);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = ka + 8 * h;
    if (key >= t_len) continue;
#pragma unroll
    for (int i = 0; i < NOUT / 2; ++i) {
      if (((i >> 1) & 1) != h) continue;
      const int col = zc + 8 * (i >> 2) + 2 * c + (i & 1);
      if (col < d) {
        const long long at = base + static_cast<long long>(key) * d + col;
        store_out(dk + at, dk_acc[i]);
        store_out(dv + at, dv_acc[i]);
      }
    }
  }
  if (!tma) cp_async_wait<0>();
}

// ---- host -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kErrNoEncoder = -1;
constexpr int kErrEncode = -2;

std::mutex g_lock;
EncodeTiled g_encode = nullptr;

int encoder() {
  std::lock_guard<std::mutex> guard(g_lock);
  if (!g_encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      g_encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return g_encode ? 0 : kErrNoEncoder;
}

// TMA takes rows whose byte stride is a multiple of 16 from 16-byte aligned
// bases; other rows are staged by the threads with cp.async.
template <typename T>
bool use_tma(int d, std::initializer_list<const void*> ptrs) {
  if ((d * Ty<T>::kEs) % 16) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// (BH, T, d) viewed as a 3-D tensor (d, T, BH), boxes of one 128-byte row
// by `rows` rows of one head, 128-byte swizzle, zeros past T and d.
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int bh, int t_len, int d, int rows) {
  constexpr int es = Ty<T>::kEs;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * es,
                                 static_cast<cuuint64_t>(d) * t_len * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Ty<T>::kBox), static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = g_encode(
      map, es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// Raises `kernel`'s dynamic shared-memory limit to `smem` on the current
// device, once per device: `done` (one per kernel instantiation) holds a bit
// for each device already set. Two threads may both set it; that is harmless.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// One kernel's launch: its instantiation, shared memory, and the maps of its
// own and streamed tiles (rows kBM and BN).
struct Launch {
  CUtensorMap maps[4];
  int tma;
};

template <typename T>
int prepare(Launch* ln, int bh, int t_len, int d, int bn,
            std::initializer_list<std::pair<const void*, int>> tensors) {
  ln->tma = 0;
  for (CUtensorMap& m : ln->maps) m = CUtensorMap{};
  for (const auto& t : tensors)
    if (!use_tma<T>(d, {t.first})) return 0;
  if (int e = encoder()) return e;
  int i = 0;
  for (const auto& t : tensors) {
    if (int e = encode<T>(&ln->maps[i++], t.first, bh, t_len, d, t.second ? kBM : bn)) return e;
  }
  ln->tma = 1;
  return 0;
}

template <typename T, int DP>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int t_len,
        int d, float scale, cudaStream_t stream) {
  using G = Geo<T, DP>;
  static std::atomic<unsigned long long> smem_set{0};
  constexpr int smem = smem_bytes<G::kFwd>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DP>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch ln;
  if (int e = prepare<T>(&ln, bh, t_len, d, G::BN, {{q, 1}, {k, 0}, {v, 0}})) return e;
  const dim3 grid((t_len + kBM - 1) / kBM, bh);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      ln.maps[0], ln.maps[1], ln.maps[2], static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, t_len, d, scale, ln.tma);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, int bh, int t_len, int d, float scale,
           cudaStream_t stream) {
  using G = Geo<T, DP>;
  static std::atomic<unsigned long long> smem_set{0};
  constexpr int smem = smem_bytes<G::kDq>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, DP>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch ln;
  if (int e = prepare<T>(&ln, bh, t_len, d, G::BN, {{q, 1}, {k, 0}, {v, 0}, {dout, 1}}))
    return e;
  const dim3 grid((t_len + kBM * G::WG - 1) / (kBM * G::WG), bh, G::SPLIT);
  flash_bwd_dq_kernel<T, DP><<<grid, kThreads * G::WG, smem, stream>>>(
      ln.maps[0], ln.maps[1], ln.maps[2], ln.maps[3], static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), t_len, d, scale, ln.tma);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* delta, void* dk, void* dv, int bh, int t_len, int d, float scale,
             cudaStream_t stream) {
  using G = Geo<T, DP>;
  static std::atomic<unsigned long long> smem_set{0};
  constexpr int smem = smem_bytes<G::kDkdv>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, DP>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch ln;
  if (int e = prepare<T>(&ln, bh, t_len, d, G::BN, {{q, 0}, {k, 1}, {v, 1}, {dout, 0}}))
    return e;
  const dim3 grid((t_len + kBM * G::WG - 1) / (kBM * G::WG), bh, G::SPLIT);
  flash_bwd_dkdv_kernel<T, DP><<<grid, kThreads * G::WG, smem, stream>>>(
      ln.maps[0], ln.maps[1], ln.maps[2], ln.maps[3], static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), lse,
      delta, static_cast<T*>(dk), static_cast<T*>(dv), t_len, d, scale, ln.tma);
  return static_cast<int>(cudaGetLastError());
}

// The launch `kernel` (0 forward, 1 dQ, 2 dK/dV) makes, into info[8]: CTAs,
// threads per CTA, registers per thread, local (spilled) bytes per thread,
// dynamic shared memory per CTA, CTAs resident per SM, streamed rows per
// tile, whether it stages with TMA.
template <typename T, int DP>
int plan(int kernel, const void* ptr, int bh, int t_len, int d, int* info) {
  using G = Geo<T, DP>;
  cudaFuncAttributes attr;
  int smem = 0, per_sm = 0;
  cudaError_t err;
  const int threads = kThreads * (kernel == 0 ? 1 : G::WG);
  auto query = [&](auto fn, int bytes, std::atomic<unsigned long long>& done) {
    smem = bytes;
    cudaError_t e = allow_smem(fn, bytes, done);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, bytes);
    return e;
  };
  static std::atomic<unsigned long long> fwd_set{0}, dq_set{0}, dkdv_set{0};
  if (kernel == 0)
    err = query(flash_fwd_kernel<T, DP>, smem_bytes<G::kFwd>(), fwd_set);
  else if (kernel == 1)
    err = query(flash_bwd_dq_kernel<T, DP>, smem_bytes<G::kDq>(), dq_set);
  else
    err = query(flash_bwd_dkdv_kernel<T, DP>, smem_bytes<G::kDkdv>(), dkdv_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = kBM * threads / kThreads;
  info[0] = ((t_len + rows - 1) / rows) * bh * (kernel == 0 ? 1 : G::SPLIT);
  info[1] = threads;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = smem;
  info[5] = per_sm;
  info[6] = G::BN;
  info[7] = use_tma<T>(d, {ptr}) ? 1 : 0;
  return 0;
}

template <typename T, int DP>
struct Tag {
  using type = T;
  static constexpr int dp = DP;
};

// Calls f with the instantiation for this head width and dtype: DP = d
// rounded up to 32, 64 or 128 (64 or 128 for bf16, whose products over D
// run in blocks of 64).
template <typename F>
int by_shape(int d, int is_bf16, F&& f) {
  if (d < 1 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) return d <= 64 ? f(Tag<bf16, 64>{}) : f(Tag<bf16, 128>{});
  if (d <= 32) return f(Tag<float, 32>{});
  return d <= 64 ? f(Tag<float, 64>{}) : f(Tag<float, 128>{});
}

}  // namespace

extern "C" {

// Each function launches on `stream` and returns 0, a cudaError_t or one of
// the negative codes above. The caller guarantees contiguous (bh, t_len, d)
// tensors of one dtype (is_bf16 = 1: bfloat16, else float32) on the current
// device, with 1 <= bh <= 65535, t_len >= 1 and 1 <= d <= 128; lse and
// delta are f32 (bh, t_len).

int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int bh, int t_len, int d, float scale, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_shape(d, is_bf16, [&](auto tag) {
    using D = decltype(tag);
    return fwd<typename D::type, D::dp>(q, k, v, o, lse, bh, t_len, d, scale, s);
  });
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* delta, void* dq, int bh,
                           int t_len, int d, float scale, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_shape(d, is_bf16, [&](auto tag) {
    using D = decltype(tag);
    return bwd_dq<typename D::type, D::dp>(q, k, v, o, dout, lse, delta, dq, bh, t_len, d,
                                           scale, s);
  });
}

int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv, int bh,
                             int t_len, int d, float scale, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_shape(d, is_bf16, [&](auto tag) {
    using D = decltype(tag);
    return bwd_dkdv<typename D::type, D::dp>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d,
                                             scale, s);
  });
}

// See plan(): `ptr` is q's pointer (TMA needs 16-byte aligned rows).
int flash_attention_plan(int kernel, const void* ptr, int bh, int t_len, int d, int is_bf16,
                         int* info) {
  return by_shape(d, is_bf16, [&](auto tag) {
    using D = decltype(tag);
    return plan<typename D::type, D::dp>(kernel, ptr, bh, t_len, d, info);
  });
}

const char* flash_attention_error_string(int code) {
  switch (code) {
    case kErrNoEncoder:
      return "cuTensorMapEncodeTiled is not available from the driver";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused the tensor map";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
