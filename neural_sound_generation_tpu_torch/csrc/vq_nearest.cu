// Nearest-code search for Hopper (sm_90a):
//
//     out[n] = argmin_k ( |cb[k]|^2 - 2 * x[n] . cb[k] )      ties -> smallest k
//
// x is (N, D) f32, cb is (K, D) f32, out is (N,) int32. |x[n]|^2 is constant
// per row and is dropped; |cb[k]|^2 is summed in f32 from the staged tiles.
// Any N >= 1, K >= 1 and D >= 1; an all-NaN row gives 0. No (N, K) score
// matrix reaches device memory, and one call is one launch.
//
// Replaces neural_sound_generation_tpu/ops/pallas/vq_kernel.py::_vq_kernel
// (one pass over a VMEM-resident codebook) and ::_vq_kernel_tiled (codebook
// streamed in 512-column blocks for large K). One kernel covers both.
//
// What bounds it on an H100: the dot products are 2*N*K*D operations against
// 4*(N + K)*D bytes of input, some 200 operations per byte at D = 256, so the
// arithmetic rate bounds it. On the CUDA cores (67 TFLOP/s of f32) that is
// 35 us at the training step's N = 8960, K = 512. On the tensor cores the f32
// product is three TF32 products (below), 6*N*K*D operations at 495 TFLOP/s:
// 14 us. The design:
//
//   * Work split. A CTA is one warpgroup (128 threads) and owns a tile of 64
//     input rows against a contiguous 1/S of the codebook. The S CTAs of a
//     tile form one thread-block cluster. S (1 to 16, a power of two) is the
//     least that gives at least as many CTAs as the card has SMs, so small N
//     still fills the card (N = 840: 14 tiles x 16); at most one CTA per 8
//     codes, and no larger than the cluster size that fits
//     (cudaOccupancyMaxActiveClusters). vq_nearest_plan reports the choice.
//   * Staging. The codebook streams through shared memory in tiles of 128
//     codes by 32 features, the x tile in 64 x 32 slices beside it, so any
//     D <= 1024 runs in D/32 steps per code tile. One thread issues both
//     loads with TMA (cp.async.bulk.tensor, 128-byte swizzle, zero fill past
//     N, K and D) into a ring of two stages, each guarded by an mbarrier, so
//     step s + 1 is in flight while step s computes. Two CTAs fit on an SM
//     (82 KB of shared memory and at most 255 registers a thread each). TMA
//     needs D % 4 == 0 and 16-byte aligned rows; otherwise the threads copy
//     the same swizzled layout themselves.
//   * Tensor cores, 3xTF32. Each f32 value v is split into hi = tf32(v) and
//     lo = tf32(v - hi): a code tile in place in shared memory (lo beside
//     it), the x slice in registers as wgmma's A fragments, so the tensor
//     cores read only the codebook from shared memory. wgmma.mma_async
//     m64n128k8 then sums lo_x.hi_e + hi_x.lo_e + hi_x.hi_e, the small terms
//     first. The dropped lo_x.lo_e and the rounding of lo leave about 2^-21
//     of |x||e| per term. |e|^2 is summed in f32 from the staged tiles as
//     they are split, so the wrapper launches nothing else.
//   * Near-ties. A tensor core's f32 accumulator aligns its terms to the
//     largest and truncates, so a sum kept in it over all D/8 k-steps drifts
//     (csrc/conv3x3.cu met this at 144 k-steps). Here each 32-feature step's
//     twelve products go into a fresh accumulator (scale-d = 0 on the first),
//     and the running dot product adds that partial with __fadd_rn: the
//     truncating part sums 12 terms, never more. The score's error stays some
//     1e-4 absolute at |x| = |e| = 16, below the 1e-5 relative gap that
//     separates a near-tie at distances of 512. Identical codes get
//     bit-identical scores wherever they sit in a tile or a cluster, so the
//     first index wins a tie.
//   * Merge. After each code tile every thread folds its 2 rows x 32 codes
//     into a running (min, index) per row with a lexicographic compare
//     (value, then smaller index); the four lanes of a row reduce with warp
//     shuffles into shared memory. After a cluster barrier CTA 0 of the
//     cluster reads its peers' 64 pairs through distributed shared memory,
//     reduces them the same way and writes the index; a second barrier keeps
//     the peers' shared memory alive until it has. The merge gives the same
//     answer in any order: no atomics, no scratch buffer, no second launch,
//     and the result is bit-identical run to run.
//
// What holds it several times above the tensor-core bound (PERF.md has the
// figures): the split runs on the CUDA cores between the same barriers as
// the products, and a step moves about 128 KB through shared memory (TMA
// 24, the code tile's split 48, the x fragments 8, wgmma's reads of the
// codes 48) for 768 cycles of products. A producer warpgroup that splits
// while a consumer multiplies is the next step.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kBM = 64;        // input rows per CTA (wgmma M)
constexpr int kBN = 128;       // codes per tile (wgmma N)
constexpr int kBK = 32;        // features per step: one 128-byte swizzle row
constexpr int kStages = 2;
constexpr int kMaxSplit = 16;  // non-portable cluster size
constexpr int kMinCodesPerCta = 8;
constexpr int kAElems = kBM * kBK;
constexpr int kBElems = kBN * kBK;
constexpr int kTmaBytes = (kAElems + kBElems) * 4;
// per stage: the x slice as staged, codebook hi, codebook lo; each
// 1024-byte aligned
constexpr int kStageBytes = (kAElems + 2 * kBElems) * 4;
constexpr int kSmemBytes = kStages * kStageBytes + kStages * 8 + kBM * 8 + kBN * 4 + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool better(float v, int i, float best_v, int best_i) {
  return v < best_v || (v == best_v && i < best_i);
}

__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - hi);  // v - hi is exact in f32
}

// ---- mbarriers and TMA ----------------------------------------------------

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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(smem_addr(bar))
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// K-major operand, 128-byte swizzle: rows of 32 f32 (128 bytes), 8-row
// groups 1024 bytes apart (SBO); LBO is unused for swizzled K-major layouts.
// A k-step of 8 features starts 32 bytes further into the swizzle row.
__device__ __forceinline__ uint64_t desc_sw128(const float* p) {
  uint64_t desc = (smem_addr(p) & 0x3FFFF) >> 4;
  desc |= uint64_t(1) << 16;
  desc |= uint64_t(1024 >> 4) << 32;
  desc |= uint64_t(1) << 62;
  return desc;
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

// d (64 x 128, f32 fragments) = A (64 x 8, tf32) . B (128 x 8, tf32)^T (+ d
// when scale_d is nonzero), A from registers, B from shared memory: a[q] is
// this thread's tf32 element
// (row 16 * warp + lane / 4 + 8 * (q % 2), feature lane % 4 + 4 * (q / 2)),
// the layout of mma.m16n8k8's A fragment in each warp's 16 rows.
__device__ __forceinline__ void wgmma_m64n128k8_rs(float (&d)[64], const float (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(db), "r"(scale_d));
}

// ---- staging ----------------------------------------------------------------

// Offset of feature j of row r in a staged tile: TMA's 128-byte swizzle puts
// the 16-byte chunk j / 4 of row r at chunk (j / 4) ^ (r % 8).
__device__ __forceinline__ int swizzled(int r, int j) {
  return r * kBK + ((((j >> 2) ^ (r & 7)) << 2) | (j & 3));
}

// Where TMA cannot stage (D % 4 != 0 or unaligned rows): the threads copy
// rows [r0, r0 + tile_rows) x features [d0, d0 + 32) of the (rows, d)
// matrix `src`, zero past its edges, into the same swizzled layout. Thread t
// writes chunk t % 8 of rows t / 8 + 16 i, the chunks split_codes reads.
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int rows, int d,
                                          int r0, int d0, float* dst, int tile_rows) {
  const int chunk = threadIdx.x % 8;
  for (int r = threadIdx.x / 8; r < tile_rows; r += kThreads / 8) {
    const int gr = r0 + r, gd = d0 + 4 * (chunk ^ (r & 7));
    const float* p = src + static_cast<size_t>(gr) * d + gd;
    const bool in = gr < rows;
    float4 v;
    v.x = in && gd < d ? p[0] : 0.f;
    v.y = in && gd + 1 < d ? p[1] : 0.f;
    v.z = in && gd + 2 < d ? p[2] : 0.f;
    v.w = in && gd + 3 < d ? p[3] : 0.f;
    reinterpret_cast<float4*>(dst)[r * 8 + chunk] = v;
  }
}

// Split a staged code tile into hi (in place) and lo (same offset). Thread t
// handles chunk t % 8 of rows t / 8 + 16 i and adds the squares of that
// chunk to sumsq[i]: over a code tile a lane always holds the same 4
// features of a row, so identical codes get identical partial sums
// (row_sumsq combines them).
__device__ __forceinline__ void split_codes(float* hi, float* lo, float* sumsq) {
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int i = 0; i < kBN * 8 / kThreads; ++i) {
    const int e = (threadIdx.x / 8 + 16 * i) * 8 + threadIdx.x % 8;
    const float4 v = h4[e];
    float4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    h4[e] = h;
    l4[e] = l;
    sumsq[i] = __fmaf_rn(v.w, v.w, __fmaf_rn(v.z, v.z,
               __fmaf_rn(v.y, v.y, __fmaf_rn(v.x, v.x, sumsq[i]))));
  }
}

// A row's |e|^2 from its 8 lanes' partial sums, by a butterfly: lane c
// holds the features of chunk c ^ (r % 8), and an xor butterfly with
// commutative adds gives the same total under any such relabelling, so
// identical codes get bit-identical |e|^2 wherever they sit.
__device__ __forceinline__ float row_sumsq(float q) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, off));
  return q;
}

template <bool kTma>
__global__ void __launch_bounds__(kThreads, 2)
vq_nearest_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap cmap,
                  const float* __restrict__ x, const float* __restrict__ cb,
                  int* __restrict__ out,
                  int n, int k, int d, int codes_per_cta) {
  extern __shared__ unsigned char smem_raw[];
  // the same offset in every CTA of the cluster, as the merge needs
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  float* red_v = reinterpret_cast<float*>(full + kStages);
  int* red_i = reinterpret_cast<int*>(red_v + kBM);
  float* tile_sq = reinterpret_cast<float*>(red_i + kBM);  // |e|^2 of the tile's codes

  cg::cluster_group cluster = cg::this_cluster();
  const int split_n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x / split_n) * kBM;
  const int c_begin = rank * codes_per_cta;
  const int c_end = min(k, c_begin + codes_per_cta);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kBN - 1) / kBN : 0;
  const int n_steps = (d + kBK - 1) / kBK;
  const int total = n_tiles * n_steps;
  const int tid = threadIdx.x;

  auto a_raw = [&](int s) { return reinterpret_cast<float*>(smem + s * kStageBytes); };
  auto b_hi = [&](int s) { return a_raw(s) + kAElems; };
  auto b_lo = [&](int s) { return b_hi(s) + kBElems; };
  auto issue = [&](int step) {  // one thread: TMA of step's x slice and code tile
    const int s = step % kStages;
    const int t = step / n_steps, c = step % n_steps;
    mbar_expect_tx(&full[s], kTmaBytes);
    tma_load_2d(a_raw(s), &xmap, c * kBK, row0, &full[s]);
    tma_load_2d(b_hi(s), &cmap, c * kBK, c_begin + t * kBN, &full[s]);
  };

  if (kTma && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int step = 0; step < kStages && step < total; ++step) issue(step);
  }
  __syncthreads();

  // accumulator fragment of m64nN: register i of this thread holds row
  // r0 + 8 * ((i / 2) % 2) and code column 8 * (i / 4) + 2 * (lane % 4) + i % 2
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  float best_v[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
  int best_i[2] = {INT_MAX, INT_MAX};
  float run[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;  // scale-d = 0 ignores it; keeps it defined

  int step = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int tile0 = c_begin + t * kBN;
    float sumsq[kBN * 8 / kThreads];
#pragma unroll
    for (int i = 0; i < 64; ++i) run[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBN * 8 / kThreads; ++i) sumsq[i] = 0.f;
    for (int c = 0; c < n_steps; ++c, ++step) {
      const int s = step % kStages;
      if (kTma) {
        mbar_wait(&full[s], (step / kStages) & 1);
      } else {
        load_tile(x, n, d, row0, c * kBK, a_raw(s), kBM);
        load_tile(cb, k, d, tile0, c * kBK, b_hi(s), kBN);
      }
      split_codes(b_hi(s), b_lo(s), sumsq);
      // the threads' shared-memory writes, then the tensor cores' reads
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      // this thread's A fragments of the x slice, split in registers
      float a_hi[kBK / 8][4], a_lo[kBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = a_raw(s)[swizzled(r0 + 8 * (q % 2), 8 * kk + 4 * (q / 2) + lane % 4)];
          split(v, a_hi[kk][q], a_lo[kk][q]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
        wgmma_m64n128k8_rs(part, a_lo[kk], desc_sw128(b_hi(s) + 8 * kk), kk);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
        wgmma_m64n128k8_rs(part, a_hi[kk], desc_sw128(b_lo(s) + 8 * kk), 1);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
        wgmma_m64n128k8_rs(part, a_hi[kk], desc_sw128(b_hi(s) + 8 * kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      // the products read a_hi, a_lo and write part until the wait
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) asm volatile("" : "+f"(a_hi[kk][q]), "+f"(a_lo[kk][q])::"memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        asm volatile("" : "+f"(part[i])::"memory");
        run[i] = __fadd_rn(run[i], part[i]);
      }
      __syncthreads();  // every warp's products have read stage s
      if (kTma && tid == 0 && step + kStages < total) issue(step + kStages);
    }
#pragma unroll
    for (int i = 0; i < kBN * 8 / kThreads; ++i) {
      const float q = row_sumsq(sumsq[i]);
      if (tid % 8 == 0) tile_sq[tid / 8 + 16 * i] = q;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int code = tile0 + 8 * j + 2 * (lane % 4) + e;
        if (code < c_end) {
          const float sq = tile_sq[code - tile0];
          const float v0 = sq - 2.f * run[4 * j + e];
          const float v1 = sq - 2.f * run[4 * j + 2 + e];
          if (better(v0, code, best_v[0], best_i[0])) {
            best_v[0] = v0;
            best_i[0] = code;
          }
          if (better(v1, code, best_v[1], best_i[1])) {
            best_v[1] = v1;
            best_i[1] = code;
          }
        }
      }
    }
  }

  // the four lanes of a row are lanes 4q .. 4q + 3 of one warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = best_v[h];
    int idx = best_i[h];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      if (better(ov, oi, v, idx)) {
        v = ov;
        idx = oi;
      }
    }
    if (lane % 4 == 0) {
      red_v[r0 + 8 * h] = v;
      red_i[r0 + 8 * h] = idx;
    }
  }

  cluster.sync();
  if (rank == 0 && tid < kBM) {
    float v = __int_as_float(0x7f800000);
    int idx = INT_MAX;
    for (int p = 0; p < split_n; ++p) {
      const float pv = *cluster.map_shared_rank(&red_v[tid], p);
      const int pi = *cluster.map_shared_rank(&red_i[tid], p);
      if (better(pv, pi, v, idx)) {
        v = pv;
        idx = pi;
      }
    }
    if (row0 + tid < n) out[row0 + tid] = idx < k ? idx : 0;  // all-NaN row -> 0
  }
  cluster.sync();  // peers' shared memory stays alive until CTA 0 has read it
}

// ---- host -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kMaxDevices = 64;
constexpr int kErrNoEncoder = -1;
constexpr int kErrEncode = -2;
constexpr int kErrNoCluster = -3;

struct DeviceSetup {
  bool done = false;
  int err = 0;
  int sms = 0;
  int max_split = 0;  // the largest power-of-two cluster both variants can run
};

std::mutex g_setup_lock;
DeviceSetup g_setup[kMaxDevices];
EncodeTiled g_encode = nullptr;

template <bool kTma>
int max_cluster(int* best) {
  auto kernel = vq_nearest_kernel<kTma>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  int found = 0;
  for (int s = kMaxSplit; s >= 1 && !found; s /= 2) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = s;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(s);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) == cudaSuccess && clusters > 0)
      found = s;
    else
      cudaGetLastError();  // a refused size is not an error of the launch
  }
  *best = found;
  return found ? 0 : kErrNoCluster;
}

const DeviceSetup& setup() {
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> guard(g_setup_lock);
  DeviceSetup& st = g_setup[dev % kMaxDevices];
  if (st.done) return st;
  st.done = true;
  if (!g_encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      g_encode = reinterpret_cast<EncodeTiled>(fn);
  }
  if (!g_encode) {
    st.err = kErrNoEncoder;
    return st;
  }
  st.err = static_cast<int>(cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, dev));
  int a = 0, b = 0;
  if (!st.err) st.err = max_cluster<true>(&a);
  if (!st.err) st.err = max_cluster<false>(&b);
  st.max_split = a < b ? a : b;
  return st;
}

// The cluster size: the least power of two whose CTAs cover the SMs, within
// the largest that fits, at most one CTA per kMinCodesPerCta codes.
int choose_split(const DeviceSetup& st, int row_tiles, int k) {
  int s = 1;
  while (s < st.max_split && static_cast<long long>(row_tiles) * s < st.sms &&
         2LL * s * kMinCodesPerCta <= k)
    s *= 2;
  return s;
}

bool use_tma(const float* x, const float* cb, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(cb) % 16 == 0;
}

int encode(CUtensorMap* map, const float* ptr, int rows, int d, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * sizeof(float)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = g_encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

}  // namespace

extern "C" {

// The launch vq_nearest_f32 makes for these sizes and pointers: the cluster
// size, the CTA count and whether it stages with TMA. Returns 0 or an error.
int vq_nearest_plan(const float* x, const float* cb, int n, int k, int d, int* split,
                    int* ctas, int* tma) {
  const DeviceSetup& st = setup();
  if (st.err) return st.err;
  const int row_tiles = (n + kBM - 1) / kBM;
  *split = choose_split(st, row_tiles, k);
  *ctas = row_tiles * *split;
  *tma = use_tma(x, cb, d) ? 1 : 0;
  return 0;
}

// Launches on `stream` and returns 0 on success, a cudaError_t, or one of
// the negative codes above. The caller guarantees n >= 1, k >= 1, 1 <= d <=
// 1024, contiguous f32 inputs and an int32 output on the current device.
int vq_nearest_f32(const float* x, const float* cb, int* out,
                   int n, int k, int d, void* stream) {
  const DeviceSetup& st = setup();
  if (st.err) return st.err;
  const int row_tiles = (n + kBM - 1) / kBM;
  const int split = choose_split(st, row_tiles, k);
  const int per_cta = (k + split - 1) / split;
  const bool tma = use_tma(x, cb, d);
  CUtensorMap xmap = {}, cmap = {};
  if (tma) {
    if (int e = encode(&xmap, x, n, d, kBM)) return e;
    if (int e = encode(&cmap, cb, k, d, kBN)) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(row_tiles * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      tma ? cudaLaunchKernelEx(&cfg, vq_nearest_kernel<true>, xmap, cmap, x, cb, out, n,
                               k, d, per_cta)
          : cudaLaunchKernelEx(&cfg, vq_nearest_kernel<false>, xmap, cmap, x, cb, out, n,
                               k, d, per_cta);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* vq_nearest_error_string(int code) {
  switch (code) {
    case kErrNoEncoder:
      return "cuTensorMapEncodeTiled is not available from the driver";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused the tensor map";
    case kErrNoCluster:
      return "no thread-block cluster of this kernel fits on the device";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
