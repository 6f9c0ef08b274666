// Nearest-code search for Hopper (sm_90a):
//
//     out[n] = argmin_k ( cbsq[k] - 2 * x[n] . cb[k] )      ties -> smallest k
//
// x is (N, D) f32, cb is (K, D) f32, cbsq[k] = |cb[k]|^2 (computed by the
// caller), out is (N,) int32. |x[n]|^2 is constant per row and is dropped.
//
// Replaces neural_sound_generation_tpu/ops/pallas/vq_kernel.py::_vq_kernel
// (one pass over a VMEM-resident codebook) and ::_vq_kernel_tiled (codebook
// streamed in 512-column blocks for large K). One kernel covers both: it
// streams the codebook through shared memory for any K, so no (N, K) score
// matrix is ever written to device memory.
//
// What bounds it on an H100: at the flagship shape N=26880, D=256, K=512 the
// dot products are 2*N*K*D = 7.05 GFLOP of f32 FMA against 28 MB of input
// (about 250 FLOP per byte). At 67 TFLOP/s of f32 and 3.35 TB/s that is
// 0.105 ms of arithmetic against 0.008 ms of memory traffic, so the f32
// issue rate bounds it. The design aims at keeping the FMA pipes fed:
//
//   * a 256-thread block owns a 128-row by 128-code tile; 16-feature slices
//     of both are staged in shared memory, transposed, and each thread keeps
//     an 8x8 register tile of dot products, read with four 128-bit shared
//     loads per 64 FMAs (rows and codes split in two halves 64 apart, so the
//     loads of a quarter-warp hit distinct banks). Launch bounds of two
//     blocks per SM hold it to 126 registers without spills, which measured
//     faster than one block at 139 registers;
//   * after each code tile every thread folds its scores into a running
//     (min, index) per row, visiting codes in increasing order with '<';
//   * one block owns its rows over the whole codebook, so the 16 code lanes
//     of a row reduce lexicographically (value, then smaller index) with
//     warp shuffles and one lane writes the index: a tie goes to the
//     globally first index, as jnp.argmin does.
//
// At serving sizes (N = 840 to 6720) this gives 7 to 53 blocks, fewer than
// the card's 132 SMs; splitting the codebook across blocks would fill it,
// at the price of a merge across blocks. That waits until a trace shows
// the kernel matters end to end.
//
// Tensor cores (wgmma) and TMA would raise the ceiling and are left for
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsK = 16;                          // code lanes
constexpr int kThreadsN = 16;                          // row lanes
constexpr int kThreads = kThreadsK * kThreadsN;
constexpr int kHalf = 64;                              // rows/codes per half tile
constexpr int kTileN = 2 * kHalf;                      // 128 rows per block
constexpr int kTileK = 2 * kHalf;                      // 128 codes per tile
constexpr int kTileD = 16;                             // features per slice
constexpr int kPad = 4;                                // keeps float4 alignment
constexpr int kPerThread = 8;                          // 8x8 register tile

__device__ __forceinline__ bool better(float v, int i, float best_v, int best_i) {
  return v < best_v || (v == best_v && i < best_i);
}

// Element e of a thread's 8 rows (or codes): lane*4 + e in the first half
// tile, 64 + lane*4 + (e-4) in the second. Increasing in e.
__device__ __forceinline__ int slot(int lane, int e) {
  return (e < 4) ? lane * 4 + e : kHalf + lane * 4 + (e - 4);
}

__global__ void __launch_bounds__(kThreads, 2)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ cbsq,
                  int* __restrict__ out, int n, int k, int d) {
  __shared__ __align__(16) float xs[kTileD][kTileN + kPad];
  __shared__ __align__(16) float cs[kTileD][kTileK + kPad];

  const int tx = threadIdx.x % kThreadsK;
  const int ty = threadIdx.x / kThreadsK;
  const int row0 = blockIdx.x * kTileN;

  float best_v[kPerThread];
  int best_i[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    best_v[i] = __int_as_float(0x7f800000);  // +inf
    best_i[i] = 0x7fffffff;
  }

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    float acc[kPerThread][kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += kTileD) {
      // Consecutive threads read consecutive features of one row: coalesced.
      for (int e = threadIdx.x; e < kTileN * kTileD; e += kThreads) {
        const int r = e / kTileD, c = e % kTileD;
        const int gr = row0 + r, gc = d0 + c;
        xs[c][r] = (gr < n && gc < d) ? x[(size_t)gr * d + gc] : 0.f;
      }
      for (int e = threadIdx.x; e < kTileK * kTileD; e += kThreads) {
        const int r = e / kTileD, c = e % kTileD;
        const int gr = k0 + r, gc = d0 + c;
        cs[c][r] = (gr < k && gc < d) ? cb[(size_t)gr * d + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kTileD; ++c) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[c][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[c][kHalf + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&cs[c][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&cs[c][kHalf + tx * 4]);
        const float a[kPerThread] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[kPerThread] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kPerThread; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int code = k0 + slot(tx, j);
      if (code < k) {
        const float sq = cbsq[code];
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          const float v = sq - 2.f * acc[i][j];
          if (better(v, code, best_v[i], best_i[i])) {
            best_v[i] = v;
            best_i[i] = code;
          }
        }
      }
    }
  }

  // The 16 code lanes of a row are the low or the high half of one warp,
  // so xor-shuffles below 16 stay within the row.
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    float v = best_v[i];
    int idx = best_i[i];
#pragma unroll
    for (int off = kThreadsK / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      if (better(ov, oi, v, idx)) {
        v = ov;
        idx = oi;
      }
    }
    const int r = row0 + slot(ty, i);
    if (tx == 0 && r < n) out[r] = idx < k ? idx : 0;  // all-NaN row -> 0
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller guarantees n >= 1, k >= 1, d >= 1, contiguous f32 inputs and
// an int32 output on the current device.
int vq_nearest_f32(const float* x, const float* cb, const float* cbsq, int* out,
                   int n, int k, int d, void* stream) {
  const int row_blocks = (n + kTileN - 1) / kTileN;
  vq_nearest_kernel<<<row_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, cb, cbsq, out, n, k, d);
  return static_cast<int>(cudaGetLastError());
}

const char* vq_nearest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
