// 3x3 SAME convolution in bf16 with f32 accumulation, for Hopper (sm_90a):
//
//     out[b, h, w, co] = bf16( sum_{dy, dx, ci} xpad[b, h + dy, w + dx, ci] * wt[dy, dx, ci, co] )
//
// x is (B, H, W, C) bf16 NHWC, wt (3, 3, C, C) bf16 HWIO, xpad x with a zero
// border of one pixel (SAME padding), out (B, H, W, C) bf16: every product of
// two bf16 values is exact in f32, the sum is kept in f32 and rounded to
// nearest even once. Any B, H, W >= 1; C a multiple of 16 up to 512. One
// call is one launch.
//
// Replaces scripts/ab_conv3x3.py::pallas_conv (pl.pallas_call :60) and
// ::pallas_conv_im2col (:95), the ResBlock's 3x3 convolution at the
// flagship's training shape (64, 20, 7, 256) -> 256, two ways that share one
// kernel template and one mainloop and differ only in how the A operand (the
// input pixels) reaches shared memory:
//
//   * taps (pallas_conv): for each chunk of 64 input channels the CTA stages
//     the halo of its pixels once, and the nine taps read it at their
//     shifts. The patch matrix is never built.
//   * im2col (pallas_conv_im2col): for each (tap, chunk) step the CTA
//     gathers its 64 pixels' patch-row slice, zero in the padding; an input
//     element is gathered once for each tap that sees it.
//
// What bounds it on an H100: at (64, 20, 7, 256) the products are
// 2 * 8960 * 2304 * 256 = 10.57 GFLOP against 10.4 MB of inputs and output,
// about 1000 operations per byte: the bf16 tensor-core rate bounds it,
// 10.7 us at 989 TFLOP/s (3.1 us for the bytes at 3.35 TB/s). The design:
//
//   * Work split. The pixels are flattened in (b, h, w) order; a CTA is one
//     warpgroup and owns a run of 64 pixels against 128 output channels, so
//     no tile slot is wasted but in the last run (280 CTAs at the A/B's
//     shape), and three CTAs fit on an SM (168 registers a thread, at most
//     75 KB of shared memory), so one CTA's loads and adds run while
//     another's products do.
//   * Steps. The K = 9C contraction runs in steps of one tap and 64 input
//     channels, chunk-major (the nine taps of chunk 0, then chunk 1, ...):
//     36 steps at C = 256.
//   * Products. Each step is two chains, one per 64-channel block, of four
//     wgmma.mma_async m64n64k16 bf16 -> f32: A from registers (ldmatrix from
//     the staged tile; the A fragment of warp w's rows 16w to 16w + 15 is
//     mma.m16n8k16's), shared by both blocks; B (the weights) from shared
//     memory through a descriptor, MN-major (C_out contiguous, wgmma's
//     transpose-B immediate), 128-byte swizzled. Both chains are launched
//     together and retired within the step; block 0's adds run while block
//     1 multiplies.
//   * Weights. TMA copies each step's 64 x 128 weight tile (two 64 x 64
//     boxes of wt viewed as (tap, C_in, C_out), zero past C) into a ring of
//     kStages stages, each guarded by an mbarrier, issued kAhead steps
//     ahead. The tensor map is encoded once per (device, pointer, C) and
//     cached.
//   * Activations. cp.async, 16 bytes a copy, a source size of 0 for the
//     padding and the ragged edge, into 128-byte rows whose 16-byte chunks
//     are XORed with the row (ldmatrix reads eight rows without bank
//     conflicts), committed with the same step's weights. The taps route
//     keeps two halo stages (chunk c and c + 1): the run's pixels from p0 -
//     W - 1 to p0 + 64 + W, or for W > 66 three 66-pixel segments, one per
//     tap row; a lane whose tap falls outside its pixel's image reads a
//     zero row.
//   * Accuracy. A tensor core's f32 accumulator aligns its terms to the
//     largest and truncates, so a running sum kept in it over 144 k16 steps
//     drifts. Each chain (four k16 slices, 64 products a sum) goes into a
//     fresh partial (scale-d = 0 on the first) and the running sum takes it
//     with __fadd_rn: 64 f32 registers of running sum and 2 x 32 of
//     partials a thread. The sums run in the same order on both routes, so
//     they agree bit for bit.
//   * ptxas keeps the wgmmas asynchronous only when no chain is in flight
//     across the loop's back edge while a partial is read, and when the
//     chains sit in straight-line code; it reports the serialization
//     otherwise (C7514, C7520).
//
// What holds it above the bound (PERF.md has the figures): shared memory.
// A step moves about 41 KB through it (taps; 49 KB im2col: the weight tile
// written by TMA and read by the tensor cores, 16 KB each, the A fragments
// 8 KB, the activations) for 256 cycles of products, against 128 bytes a
// cycle. A weight tile serves only 64 pixels because the fresh-partial rule
// costs 128 registers a thread. A cluster that multicasts the weight tile,
// a producer warpgroup, a persistent grid and TMA for the activations (the
// swizzled rows are TMA's own 128-byte layout, and the taps route's halo
// is one to three boxes of x viewed as (B H W, C)) are left for later.
// conv3x3_plan reports a launch's CTAs, registers and CTAs per SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kTaps = 0;
constexpr int kIm2col = 1;

constexpr int kThreads = 128;              // one warpgroup
constexpr int kCtasPerSm = 3;              // the register budget: 168 a thread
constexpr int kStages = 3;                 // weight ring depth
constexpr int kAhead = kStages - 1;        // steps loaded ahead of the current one
constexpr int kBM = 64;                    // pixels per block (wgmma M)
constexpr int kBoxN = 64;                  // output channels per block (wgmma N)
constexpr int kBN = 2 * kBoxN;             // output channels per CTA
constexpr int kKC = 64;                    // input channels per step
constexpr int kRowBytes = kKC * 2;         // an activation row: 64 channels, 128 bytes
constexpr int kBoxBytes = kKC * kBoxN * 2;  // a weight box: 8 KB, 1024-byte aligned
constexpr int kMaxC = 512;
// the weight descriptor, MN-major with 128-byte swizzle: K rows of 64
// channels, 128 bytes apart; 8-row groups 1024 bytes apart (SBO); the next
// 64-channel box 8 KB on (LBO, never crossed by an N = 64 product)
constexpr uint32_t kSBO = 1024;
constexpr uint32_t kLBO = kBoxBytes;

using bf16 = __nv_bfloat16;

struct Geom {
  long long m;  // B * H * W pixels
  int h, w, c;
  int s;        // taps: halo rows between tap rows, min(W, 66)
  int l;        // taps: halo rows per stage, 2S + 66
  int steps;    // 9 * ceil(C / 64)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk j (channels 8j .. 8j + 7) of row r of a staged
// activation tile: 128-byte rows, the chunk index XORed with r % 8, so that
// ldmatrix's eight rows of one chunk fall in eight different bank groups.
__device__ __forceinline__ uint32_t swizzled(int r, int j) {
  return r * kRowBytes + ((j ^ (r & 7)) << 4);
}

// ---- mbarriers, TMA, cp.async -------------------------------------------------

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

// 16 bytes from src, or zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- wgmma ------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  uint64_t desc = (addr & 0x3FFFF) >> 4;
  desc |= uint64_t(kLBO >> 4) << 16;
  desc |= uint64_t(kSBO >> 4) << 32;
  desc |= uint64_t(1) << 62;  // 128-byte swizzle
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 64, f32 fragments) = A (64 x 16, bf16) . B (16 x 64, bf16) (+ d
// when scale_d is nonzero); A from registers, a[q] the q-th register of
// mma.m16n8k16's A fragment for this warp's 16 rows; B MN-major in shared
// memory (transpose-B immediate 1). Register i of d holds row 16 * warp +
// lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Registers a wgmma reads or writes must stay where they are until its
// wait: these empty statements keep them live and order their uses after it.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void keep(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[j][q])::"memory");
}

// One step's chain over one 64-channel block of the weight tile: its four
// k16 slices into the fresh partial (scale-d = 0 on the first). In a last
// chunk of C % 64 channels the slices past C multiply zeros (the staged
// activations and TMA's fill of the weight rows past C). Straight-line
// code, so that ptxas keeps the wgmmas in one pipeline stage.
__device__ __forceinline__ void chain(float (&part)[32], const uint32_t (&a)[4][4],
                                      uint32_t b_addr) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_m64n64k16_rs(part, a[j], desc_b(b_addr + 2048 * j), j);
}

// The running sum's registers kOff .. kOff + 31 (block kOff / 32) take a
// finished partial.
template <int kOff>
__device__ __forceinline__ void add_partial(float (&run)[64], float (&part)[32]) {
  keep(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) run[kOff + i] = __fadd_rn(run[kOff + i], part[i]);
}

// ---- the kernel -------------------------------------------------------------

// Shared memory: the weight ring (kStages stages of two boxes), the
// barriers, a zero row, then the activations: taps two halo stages of L
// rows, im2col kStages gathered tiles of kBM rows.
constexpr int kStageBytes = 2 * kBoxBytes;
constexpr int kBarOff = kStages * kStageBytes;
constexpr int kZeroOff = kBarOff + 128;
constexpr int kAOff = kZeroOff + 256;

template <int kRoute>
constexpr int act_stages() {
  return kRoute == kTaps ? 2 : kStages;
}

template <int kRoute>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    conv3x3_kernel(const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ x,
                   bf16* __restrict__ out, const Geom g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  const uint32_t s_base = smem_addr(smem);
  const uint32_t s_zero = s_base + kZeroOff;
  const uint32_t s_act = s_base + kAOff;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long p0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int W = g.w, H = g.h, C = g.c;

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < kRowBytes / 16)
    reinterpret_cast<uint4*>(smem + kZeroOff)[tid] = make_uint4(0, 0, 0, 0);

  // which of the nine taps of pixel p fall inside its image (0 past the
  // last pixel)
  auto taps_inside = [&](long long p) -> uint32_t {
    uint32_t mask = 0;
    if (p < g.m) {
      const int w = static_cast<int>(p % W), h = static_cast<int>((p / W) % H);
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int hh = h + t / 3 - 1, ww = w + t % 3 - 1;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W) mask |= 1u << t;
      }
    }
    return mask;
  };

  // im2col: thread t gathers chunk t % 8 of rows t / 8 + 16 i
  constexpr int kGatherRows = kBM * 8 / kThreads;  // 4
  uint32_t gather_mask[kGatherRows];
  if constexpr (kRoute == kIm2col) {
#pragma unroll
    for (int i = 0; i < kGatherRows; ++i) gather_mask[i] = taps_inside(p0 + tid / 8 + 16 * i);
  }

  // this lane's ldmatrix row (pixel p0 + arow) and k half; taps: which of
  // its taps read the halo (the others read the zero row)
  const int arow = 16 * warp + (lane & 15);
  const int khalf = lane >> 4;
  uint32_t tap_mask = 0;
  if constexpr (kRoute == kTaps) tap_mask = taps_inside(p0 + arow);

  // step = chunk * 9 + tap: the weight tile of that tap, input channels
  // 64 chunk .. + 63, output channels n0 ..; the activations of that step
  // into their stage, one cp.async group a step
  auto issue = [&](int step) {
    const int stage = step % kStages;
    const int chunk = step / 9, tap = step % 9;
    if (tid == 0) {
      unsigned char* dst = smem + stage * kStageBytes;
      const bool second = n0 + kBoxN < C;
      mbar_expect_tx(&full[stage], second ? 2 * kBoxBytes : kBoxBytes);
      tma_load_3d(dst, &wmap, n0, chunk * kKC, tap, &full[stage]);
      if (second)
        tma_load_3d(dst + kBoxBytes, &wmap, n0 + kBoxN, chunk * kKC, tap, &full[stage]);
    }
    if constexpr (kRoute == kTaps) {
      if (tap == 0) {
        const uint32_t dst = s_act + (chunk & 1) * g.l * kRowBytes;
        for (int v = tid; v < g.l * 8; v += kThreads) {
          const int i = v >> 3, j = v & 7;
          const long long p = p0 - 1 - W + static_cast<long long>(i / g.s) * W + i % g.s;
          const int ch = chunk * kKC + 8 * j;
          const bool ok = p >= 0 && p < g.m && ch < C;
          cp_async_16(dst + swizzled(i, j), ok ? x + p * C + ch : x, ok);
        }
      }
    } else {
      const uint32_t dst = s_act + stage * kBM * kRowBytes;
      const int ch = chunk * kKC + 8 * (tid & 7);
      const long long shift = static_cast<long long>(tap / 3 - 1) * W + tap % 3 - 1;
#pragma unroll
      for (int i = 0; i < kGatherRows; ++i) {
        const int r = tid / 8 + 16 * i;
        const bool ok = ((gather_mask[i] >> tap) & 1) && ch < C;
        cp_async_16(dst + swizzled(r, tid & 7), ok ? x + (p0 + r + shift) * C + ch : x, ok);
      }
    }
    cp_async_commit();
  };

  __syncthreads();  // barriers initialised, zero row written
  for (int s = 0; s < kAhead; ++s) {
    if (s < g.steps) issue(s);
    else cp_async_commit();
  }

  // the running sums of the two 64 x 64 blocks, output channels n0 + 64 h
  // .. (run[32 h + i] is register i of block h: see wgmma_m64n64k16_rs),
  // and a partial per block
  float run[64], part0[32], part1[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) run[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) part0[i] = part1[i] = 0.f;

  // Each step: wait for its data, issue step + kAhead's loads, launch both
  // blocks' chains; block 0's adds run while block 1 multiplies. Every
  // chain is retired within its step: ptxas serializes wgmmas whose
  // accumulators are read while a chain is in flight across the loop's
  // back edge.
  for (int step = 0; step < g.steps; ++step) {
    const int stage = step % kStages;
    cp_async_wait<kAhead - 1>();  // this thread's copies of `step`
    mbar_wait(&full[stage], (step / kStages) & 1);
    __syncthreads();  // everyone's copies landed; step - 1's products are done
    if (step + kAhead < g.steps) issue(step + kAhead);
    else cp_async_commit();

    // this lane's row of the staged tile (the zero row for a tap outside
    // its pixel's image); k16 slice j is chunks 2j and 2j + 1 of the row
    uint32_t a_base;
    int a_row;
    if constexpr (kRoute == kTaps) {
      const int chunk = step / 9, tap = step % 9;
      a_row = (chunk & 1) * g.l + arow + (tap / 3) * g.s + tap % 3;
      a_base = (tap_mask >> tap) & 1 ? s_act : s_zero - a_row * kRowBytes;
    } else {
      a_row = stage * kBM + arow;
      a_base = s_act;
    }
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) ldmatrix_x4(a[j], a_base + swizzled(a_row, 2 * j + khalf));
    const uint32_t b_addr = s_base + stage * kStageBytes;
    wgmma_fence();
    chain(part0, a, b_addr);
    wgmma_commit();
    chain(part1, a, b_addr + kBoxBytes);
    wgmma_commit();
    wgmma_wait<1>();  // block 0 is done
    add_partial<0>(run, part0);
    wgmma_wait<0>();
    keep(a);
    add_partial<32>(run, part1);
  }
  cp_async_wait<0>();

  // one rounding to bf16; rows past the last pixel and columns past C are
  // not stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long m = p0 + 16 * warp + lane / 4 + 8 * hf;
      if (m >= g.m) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + kBoxN * h + 8 * j + 2 * (lane % 4);
        if (n >= C) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + m * C + n) = __floats2bfloat162_rn(
            run[32 * h + 4 * j + 2 * hf], run[32 * h + 4 * j + 2 * hf + 1]);
      }
    }
  }
}

// ---- host -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kMaxDevices = 64;
constexpr int kMapSlots = 16;
constexpr int kErrNoEncoder = -1;
constexpr int kErrEncode = -2;

struct MapSlot {
  bool used = false;
  int device = -1;
  const void* ptr = nullptr;
  int c = 0;
  CUtensorMap map;
};

std::mutex g_lock;
EncodeTiled g_encode = nullptr;
bool g_ready[kMaxDevices] = {};
MapSlot g_maps[kMapSlots];
int g_next_slot = 0;

template <int kRoute>
int smem_bytes(const Geom& g) {
  const int rows = kRoute == kTaps ? g.l : kBM;
  return 1024 + kAOff + act_stages<kRoute>() * rows * kRowBytes;
}

// once per device: the encoder and each kernel's shared-memory limit
int prepare(int device) {
  if (g_ready[device % kMaxDevices]) return 0;
  if (!g_encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      g_encode = reinterpret_cast<EncodeTiled>(fn);
  }
  if (!g_encode) return kErrNoEncoder;
  int limit = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_kernel<kTaps>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_kernel<kIm2col>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  g_ready[device % kMaxDevices] = true;
  return 0;
}

// wt viewed as (tap, C_in, C_out): boxes of one tap, 64 input rows by 64
// output channels, 128-byte swizzle, zeros past the edges. Encoded on a
// miss and kept, keyed by device, pointer and C.
int weight_map(int device, const void* wt, int c, CUtensorMap* map) {
  for (const MapSlot& s : g_maps) {
    if (s.used && s.device == device && s.ptr == wt && s.c == c) {
      *map = s.map;
      return 0;
    }
  }
  MapSlot& s = g_maps[g_next_slot];
  g_next_slot = (g_next_slot + 1) % kMapSlots;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(c), 9};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(c) * sizeof(bf16),
                                 static_cast<cuuint64_t>(c) * c * sizeof(bf16)};
  const cuuint32_t box[3] = {kBoxN, kKC, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  s.used = false;
  const CUresult r = g_encode(&s.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(wt),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrEncode;
  s.used = true;
  s.device = device;
  s.ptr = wt;
  s.c = c;
  *map = s.map;
  return 0;
}

bool geometry(int B, int H, int W, int C, Geom* g, dim3* grid) {
  if (B < 1 || H < 1 || W < 1 || C < 16 || C > kMaxC || C % 16) return false;
  constexpr int R = kBM;
  g->m = static_cast<long long>(B) * H * W;
  g->h = H;
  g->w = W;
  g->c = C;
  g->s = W < R + 2 ? W : R + 2;
  g->l = 2 * g->s + R + 2;
  g->steps = 9 * ((C + kKC - 1) / kKC);
  const long long tiles = (g->m + R - 1) / R;
  if (tiles > 0x7fffffffLL) return false;
  *grid = dim3(static_cast<unsigned>(tiles), (C + kBN - 1) / kBN);
  return true;
}

template <int kRoute>
int launch(const void* x, const void* wt, void* out, int B, int H, int W, int C, void* stream) {
  Geom g;
  dim3 grid;
  if (!geometry(B, H, W, C, &g, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  {
    std::lock_guard<std::mutex> guard(g_lock);
    if (int e = prepare(device)) return e;
    if (int e = weight_map(device, wt, C, &map)) return e;
  }
  conv3x3_kernel<kRoute><<<grid, kThreads, smem_bytes<kRoute>(g),
                           static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const bf16*>(x), static_cast<bf16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <int kRoute>
int plan(int B, int H, int W, int C, int* info) {
  Geom g;
  dim3 grid;
  if (!geometry(B, H, W, C, &g, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    std::lock_guard<std::mutex> guard(g_lock);
    if (int e = prepare(device)) return e;
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, conv3x3_kernel<kRoute>);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_kernel<kRoute>,
                                                        kThreads, smem_bytes<kRoute>(g));
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = static_cast<int>(grid.x * grid.y);
  info[1] = kThreads;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = smem_bytes<kRoute>(g);
  info[5] = per_sm;
  return 0;
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns 0 on success, a cudaError_t
// (cudaErrorInvalidValue for a shape the kernels do not take), or one of the
// negative codes above. x, wt and out are contiguous, 16-byte aligned bf16
// arrays on the current device: x and out (B, H, W, C), wt (3, 3, C, C).
int conv3x3_taps_bf16(const void* x, const void* wt, void* out, int B, int H, int W, int C,
                      void* stream) {
  return launch<kTaps>(x, wt, out, B, H, W, C, stream);
}

int conv3x3_im2col_bf16(const void* x, const void* wt, void* out, int B, int H, int W, int C,
                        void* stream) {
  return launch<kIm2col>(x, wt, out, B, H, W, C, stream);
}

// The launch a route (0 taps, 1 im2col) makes at this shape, into info[6]:
// CTAs, threads per CTA, registers per thread, local (spilled) bytes per
// thread, dynamic shared memory per CTA, CTAs resident per SM. Returns 0 or
// an error code as the launches do.
int conv3x3_plan(int route, int B, int H, int W, int C, int* info) {
  return route == kTaps ? plan<kTaps>(B, H, W, C, info) : plan<kIm2col>(B, H, W, C, info);
}

const char* conv3x3_error_string(int code) {
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
