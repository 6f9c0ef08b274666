// 3x3 SAME convolution in bf16 with f32 accumulation, for Hopper (sm_90a):
//
//     out[b, h, w, co] = bf16( sum_{dy, dx, ci} xpad[b, h + dy, w + dx, ci] * wt[dy, dx, ci, co] )
//
// x is (B, H, W, C) bf16 NHWC, wt (3, 3, C, C) bf16 HWIO, xpad x with a zero
// border of one pixel (SAME padding), out (B, H, W, C) bf16: every product of
// two bf16 values is exact in f32, the sum is kept in f32 and rounded to
// nearest even once. Any B, H, W >= 1; C a multiple of 16 up to 512.
//
// Replaces scripts/ab_conv3x3.py::pallas_conv (pl.pallas_call :60) and
// ::pallas_conv_im2col (:95), the ResBlock's 3x3 convolution at the
// flagship's training shape (64, 20, 7, 256) -> 256, two ways:
//
//   * conv3x3_taps_kernel (pallas_conv): a block owns a tile of whole
//     output rows of one image (TH rows of TW pixels, 64 outputs at most)
//     and 64 output channels. For each chunk of 32 input channels it stages
//     the tile's input halo ((TH + 2) x (TW + 2) pixels) and the chunk's
//     slice of all nine taps' weights in shared memory once, then
//     accumulates the nine shifted products: tap (dy, dx) reads the halo at
//     an offset of dy rows and dx pixels. The patch matrix is never built;
//     each input element is read from device memory once per block.
//   * conv3x3_im2col_kernel (pallas_conv_im2col): a block owns 64 output
//     rows in (b, h, w) order and 64 output channels and runs ONE
//     contraction of length 9C against wt viewed as (9C, C). Each 64-wide
//     K-tile of the patch row (a tap's run of input channels) is gathered
//     from device memory into shared memory, zero where the tap falls in the
//     padding; an input element is gathered once for each tap that sees it.
//
// Both multiply on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate), fragments loaded with ldmatrix (the weights transposed by
// ldmatrix.trans), and keep the running sums with IEEE f32 adds (see
// warp_k16). Four warps per block, each a 32 x 32 output tile.
//
// What bounds it on an H100: at (64, 20, 7, 256) the products are
// 2 * 8960 * 2304 * 256 = 10.57 GFLOP against 10.4 MB of inputs and output,
// about 1000 operations per byte: the bf16 tensor-core rate bounds it,
// 10.7 us at 989 TFLOP/s (3.1 us for the bytes at 3.35 TB/s). Reaching it
// needs wgmma, TMA and a pipeline of stages; this first version is simple
// and right: no cp.async overlap, one stage, mma.sync, and it leaves that
// work to the PR that redesigns it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;        // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kThreads = 128;  // four warps, 2 x 2 warp tiles of 32 x 32
constexpr int kKC = 32;        // input channels per chunk (taps kernel)
constexpr int kKT = 64;        // contraction per K-tile (im2col kernel)
constexpr int kPad = 8;        // bf16 padding per shared row: conflict-free ldmatrix
constexpr int kHaloStride = kKC + kPad;
constexpr int kTapStride = kBN + kPad;
constexpr int kMaxC = 512;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k16 step of a warp's 32 x 32 tile: A rows from two lane pointers (one
// per 16-row fragment; ldmatrix.x4 takes row lane & 15 and the k half
// lane >> 4), B from a (k, n) row-major shared tile at the step's first row.
// Each mma.sync sums its 16 products into a fresh zero and the running sum
// takes that partial with an IEEE f32 add: the tensor core's f32 sums align
// their terms to the largest and truncate, so a running sum kept inside it
// drifts toward zero by about an ulp per step (144 steps at C = 256) and
// flips the final bf16 rounding away from the plain version's far more often
// than a float32 sum in another order does.
__device__ __forceinline__ void warp_k16(float (&acc)[2][4][4], const __nv_bfloat16* a0,
                                         const __nv_bfloat16* a1, const __nv_bfloat16* b_tile,
                                         int b_stride, int lane, int n_warp) {
  uint32_t a[2][4];
  ldmatrix_x4(a[0], a0);
  ldmatrix_x4(a[1], a1);
  // matrices: k 0-7 / 8-15 at n, then at n + 8: lanes 0-15 rows k of the
  // first n8 block, lanes 16-31 of the second
  const __nv_bfloat16* brow = b_tile + (lane & 15) * b_stride + n_warp + (lane >> 4) * 8;
  uint32_t b[2][4];
  ldmatrix_x4_trans(b[0], brow);
  ldmatrix_x4_trans(b[1], brow + 16);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(part, a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[e]);
    }
  }
}

// Rounds the warp's accumulators once to bf16 and stores the rows that
// `row_out` maps to an output pixel (-1: none) and the channels below C.
template <typename RowMap>
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4], __nv_bfloat16* out,
                                           int C, int n0, int m_warp, int n_warp, int lane,
                                           RowMap row_out) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = row_out(m_warp + i * 16 + half * 8 + g);
      if (m < 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + n_warp + j * 8 + 2 * tig;
        if (n >= C) continue;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + m * C + n) = v;
      }
    }
  }
}

// Copies the chunk [c0, c0 + kKC) of the nine taps' weights, output
// channels [n0, n0 + kBN), into sw[tap][k][n]; zero past C.
__device__ __forceinline__ void load_tap_weights(__nv_bfloat16* sw, const __nv_bfloat16* wt,
                                                 int C, int c0, int n0) {
  constexpr int kVecs = 9 * kKC * (kBN / 8);
  for (int v = threadIdx.x; v < kVecs; v += kThreads) {
    const int nv = v % (kBN / 8);
    const int k = (v / (kBN / 8)) % kKC;
    const int tap = v / (kKC * (kBN / 8));
    const int ci = c0 + k, n = n0 + nv * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (ci < C && n < C) {
      val = *reinterpret_cast<const uint4*>(wt + (static_cast<long long>(tap) * C + ci) * C + n);
    }
    *reinterpret_cast<uint4*>(sw + (tap * kKC + k) * kTapStride + nv * 8) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
    conv3x3_taps_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                        __nv_bfloat16* __restrict__ out, int B, int H, int W, int C, int TH,
                        int TW) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem);  // [9][kKC][kTapStride]
  __nv_bfloat16* halo = sw + 9 * kKC * kTapStride;             // [(TH+2)(TW+2)][kHaloStride]

  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  int tile = blockIdx.x;
  const int w0 = (tile % tiles_w) * TW;
  tile /= tiles_w;
  const int h0 = (tile % tiles_h) * TH;
  const int b = tile / tiles_h;
  const int n0 = blockIdx.y * kBN;
  const int hw = TW + 2;
  const int positions = (TH + 2) * hw;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m_warp = (warp >> 1) * 32, n_warp = (warp & 1) * 32;
  // each lane's A row in each 16-row fragment, as a halo position at tap
  // (0, 0); rows past the tile read position 0 and are not stored
  int base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m_warp + i * 16 + (lane & 15);
    base[i] = r < TH * TW ? (r / TW) * hw + r % TW : 0;
  }
  const int koff = (lane >> 4) * 8;

  float acc[2][4][4] = {};
  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();
    load_tap_weights(sw, wt, C, c0, n0);
    for (int v = threadIdx.x; v < positions * (kKC / 8); v += kThreads) {
      const int cv = v % (kKC / 8);
      const int p = v / (kKC / 8);
      const int hh = h0 - 1 + p / hw, ww = w0 - 1 + p % hw;
      const int ci = c0 + cv * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci < C) {
        val = *reinterpret_cast<const uint4*>(
            x + ((static_cast<long long>(b) * H + hh) * W + ww) * C + ci);
      }
      *reinterpret_cast<uint4*>(halo + p * kHaloStride + cv * 8) = val;
    }
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * hw + tap % 3;
      const __nv_bfloat16* wtap = sw + tap * kKC * kTapStride;
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 16) {
        if (c0 + ks >= C) break;
        warp_k16(acc, halo + (base[0] + shift) * kHaloStride + ks + koff,
                 halo + (base[1] + shift) * kHaloStride + ks + koff, wtap + ks * kTapStride,
                 kTapStride, lane, n_warp);
      }
    }
  }
  store_tile(acc, out, C, n0, m_warp, n_warp, lane, [&](int r) -> long long {
    if (r >= TH * TW) return -1;
    const int h = h0 + r / TW, w = w0 + r % TW;
    if (h >= H || w >= W) return -1;
    return (static_cast<long long>(b) * H + h) * W + w;
  });
}

__global__ void __launch_bounds__(kThreads)
    conv3x3_im2col_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ wt, __nv_bfloat16* __restrict__ out,
                          int B, int H, int W, int C) {
  __shared__ __align__(16) __nv_bfloat16 sa[kBM][kKT + kPad];
  __shared__ __align__(16) __nv_bfloat16 sb[kKT][kTapStride];

  const long long M = static_cast<long long>(B) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = 9 * C;

  // the gather: thread t fills rows t / 8 + 16 i (i < 4), 8 channels at
  // column (t % 8) * 8 of each K-tile; its rows' pixels are fixed
  const int kv = threadIdx.x % 8;
  int ph[4], pw[4];
  long long pb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + threadIdx.x / 8 + 16 * i;
    if (m < M) {
      pw[i] = static_cast<int>(m % W);
      ph[i] = static_cast<int>((m / W) % H);
      pb[i] = m / (static_cast<long long>(W) * H);
    } else {
      pb[i] = -1;
      ph[i] = pw[i] = 0;
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m_warp = (warp >> 1) * 32, n_warp = (warp & 1) * 32;
  const int koff = (lane >> 4) * 8;
  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kKT) {
    __syncthreads();
    {
      // a tap's run of channels: C % 8 == 0, so 8 channels never straddle two taps
      const int k = k0 + kv * 8;
      const int tap = k / C, ci = k % C;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hh = ph[i] + dy, ww = pw[i] + dx;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k < K && pb[i] >= 0 && hh >= 0 && hh < H && ww >= 0 && ww < W) {
          val = *reinterpret_cast<const uint4*>(x + ((pb[i] * H + hh) * W + ww) * C + ci);
        }
        *reinterpret_cast<uint4*>(&sa[threadIdx.x / 8 + 16 * i][kv * 8]) = val;
      }
    }
    for (int v = threadIdx.x; v < kKT * (kBN / 8); v += kThreads) {
      const int nv = v % (kBN / 8), k = k0 + v / (kBN / 8), n = n0 + nv * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k < K && n < C) {
        val = *reinterpret_cast<const uint4*>(wt + static_cast<long long>(k) * C + n);
      }
      *reinterpret_cast<uint4*>(&sb[v / (kBN / 8)][nv * 8]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKT; ks += 16) {
      if (k0 + ks >= K) break;
      warp_k16(acc, &sa[m_warp + (lane & 15)][ks + koff], &sa[m_warp + 16 + (lane & 15)][ks + koff],
               &sb[ks][0], kTapStride, lane, n_warp);
    }
  }
  store_tile(acc, out, C, n0, m_warp, n_warp, lane, [&](int r) -> long long {
    const long long m = m0 + r;
    return m < M ? m : -1;
  });
}

bool valid(int B, int H, int W, int C) {
  return B >= 1 && H >= 1 && W >= 1 && C >= 16 && C <= kMaxC && C % 16 == 0;
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a shape the kernels do not take. x, wt and
// out are contiguous, 16-byte aligned bf16 arrays on the current device:
// x and out (B, H, W, C), wt (3, 3, C, C).
int conv3x3_taps_bf16(const void* x, const void* wt, void* out, int B, int H, int W, int C,
                      void* stream) {
  if (!valid(B, H, W, C)) return static_cast<int>(cudaErrorInvalidValue);
  const int TW = W < kBM ? W : kBM;
  const int TH = kBM / TW;
  const long long tiles =
      static_cast<long long>(B) * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(__nv_bfloat16) *
                      (9 * kKC * kTapStride + static_cast<size_t>(TH + 2) * (TW + 2) * kHaloStride);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_taps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), (C + kBN - 1) / kBN);
  conv3x3_taps_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<__nv_bfloat16*>(out), B, H, W, C, TH, TW);
  return static_cast<int>(cudaGetLastError());
}

int conv3x3_im2col_bf16(const void* x, const void* wt, void* out, int B, int H, int W, int C,
                        void* stream) {
  if (!valid(B, H, W, C)) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * H * W;
  const long long tiles = (rows + kBM - 1) / kBM;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), (C + kBN - 1) / kBN);
  conv3x3_im2col_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<__nv_bfloat16*>(out), B, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

const char* conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
