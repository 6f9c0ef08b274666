// Causal softmax attention, forward and backward, for Hopper (sm_90a):
//
//     O = softmax(mask(Q K^T * scale)) V      over (BH, T, D) tensors
//
// with logits in f32, masked keys at -1e30, matmul operands in the input
// dtype (f32 or bf16) and f32 accumulation. Three kernels:
//
//   flash_fwd_kernel        one CTA per (64-row Q tile, bh): K/V tiles up to
//                           the diagonal through shared memory with an
//                           online softmax; writes O and the f32 row
//                           log-sum-exp (LSE).
//   flash_bwd_dq_kernel     one CTA per (Q tile, bh): delta = rowsum(dO * O)
//                           in f32 (written out for the next kernel), then
//                           dQ over the K tiles up to the diagonal.
//   flash_bwd_dkdv_kernel   one CTA per (K tile, bh): dK and dV over the Q
//                           tiles on or below the diagonal.
//
// Both backward kernels recompute P = exp(S - LSE) from Q, K and the LSE.
// Each output element is summed by one thread in a fixed order: there are
// no atomics, and a run is bit-identical to the next.
//
// Replaces neural_sound_generation_tpu/ops/pallas/attention.py
// ::flash_causal_attention (:321): _fwd_kernel (:165, pl.pallas_call at
// :280) and _bwd_kernel (:233, call at :302). The TPU kernel keeps a whole
// head resident in VMEM and runs one grid step per (batch, head); its
// backward walks Q tiles and accumulates dK/dV in scratch, which a
// sequential grid allows. On the GPU the CTAs run in no order, so dK/dV
// get a key-tile-major kernel of their own, and that kernel cannot see a
// whole softmax row: the forward saves the LSE for it (the Pallas kernel
// saved nothing beyond O because (T, 1) rows lane-pad 1 -> 128 in VMEM).
//
// What bounds it on an H100: f32 FMAs on the CUDA cores (TF32 stays off):
// at BH = 64, T = 560, D = 64 the causal forward is about 2.6 GFLOP against
// 37 MB of Q, K, V and O, so operations bound it. The design aims at the
// FMA pipes: tiles are staged in shared memory as f32 (bf16 converted once
// on load), each thread owns a 4 x 4 block of the 64 x 64 score tile (four
// query rows, four keys 16 apart) fed by 16-byte shared loads, and row
// statistics are reduced over the 16 threads of a row group by shuffles.
// Row strides of D + 4 and 68 floats keep the 16-byte loads free of bank
// conflicts. The upper triangle's tiles are skipped; the diagonal tile is
// masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kTile = 64;         // rows of a Q tile and of a K/V tile
constexpr int kThreads = 256;     // 16 row groups x 16 column groups
constexpr int kLdp = kTile + 4;   // row stride of a (64, 64) score tile
constexpr float kNeg = -1e30f;    // the masked logit (attention.py _NEG)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// A matmul operand in the input dtype: P and dS are rounded to bf16 for bf16
// inputs (attention.py :159, :219, :224, :228); products of bf16 values are
// exact in f32, so f32 FMAs then accumulate as the MXU's f32 accumulator.
__device__ __forceinline__ float as_operand(const float*, float x) { return x; }
__device__ __forceinline__ float as_operand(const __nv_bfloat16*, float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows row0 .. row0+63 of a (T, d) matrix into a (64, DP) f32 tile with row
// stride DP + 4; rows past T and columns past d are zero.
template <typename T, int DP>
__device__ void load_tile(float* dst, const T* __restrict__ src, int row0, int t_len, int d) {
  for (int e = threadIdx.x; e < kTile * DP; e += kThreads) {
    const int r = e / DP, c = e - r * DP;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < t_len && c < d) x = to_f32(src[static_cast<long long>(gr) * d + c]);
    dst[r * (DP + 4) + c] = x;
  }
}

__device__ void load_rows(float* dst, const float* __restrict__ src, int row0, int t_len) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int gr = row0 + r;
    dst[r] = gr < t_len ? src[gr] : 0.f;
  }
}

// acc[i][j] = sum_k A[rg*4 + i][k] * B[cg + 16*j][k] over k < d4 (a multiple
// of 4; the tiles are zero past d).
template <int DP>
__device__ __forceinline__ void tile_abt(const float* A, const float* B, int rg, int cg, int d4,
                                         float acc[4][4]) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* a0 = A + rg * 4 * LD;
  const float* b0 = B + cg * LD;
#pragma unroll 2
  for (int k = 0; k < d4; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(a0 + i * LD + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(b0 + 16 * j * LD + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][jj] += sum_c P[rg*4 + i][c] * V[c][cg + 16*jj] over the 64 rows c of
// V; P is a (64, 64) tile with row stride kLdp.
template <int DP>
__device__ __forceinline__ void tile_pv(const float* P, const float* V, int rg, int cg,
                                        float acc[4][DP / 16]) {
  constexpr int LD = DP + 4, NC = DP / 16;
  const float* p0 = P + rg * 4 * kLdp;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(p0 + i * kLdp + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* vrow = V + (c + cc) * LD + cg;
      float vv[NC];
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) vv[jj] = vrow[16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pc = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) acc[i][jj] = fmaf(pc, vv[jj], acc[i][jj]);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int t_len, int d, float scale) {
  constexpr int LD = DP + 4, NC = DP / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  const int qt = blockIdx.x;
  const long long bh = blockIdx.y;
  const long long base = bh * t_len * d;
  const int row0 = qt * kTile;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int d4 = (d + 3) & ~3;
  const T* tag = nullptr;

  load_tile<T, DP>(Qs, q + base, row0, t_len, d);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    load_tile<T, DP>(Ks, k + base, kt * kTile, t_len, d);
    load_tile<T, DP>(Vs, v + base, kt * kTile, t_len, d);
    __syncthreads();
    float s[4][4];
    tile_abt<DP>(Qs, Ks, rg, cg, d4, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = row0 + rg * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt * kTile + cg + 16 * j;
        s[i][j] = (kj <= qi && kj < t_len) ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(rg * 4 + i) * kLdp + cg + 16 * j] = as_operand(tag, p);
      }
      l[i] = l[i] * corr + group16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();
    tile_pv<DP>(Ps, Vs, rg, cg, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = row0 + rg * 4 + i;
    if (qi >= t_len) continue;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int col = cg + 16 * jj;
      if (col < d) store_f32(o + base + static_cast<long long>(qi) * d + col, acc[i][jj] / l[i]);
    }
    if (cg == 0) lse[bh * t_len + qi] = m[i] + logf(l[i]);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int t_len, int d, float scale) {
  constexpr int LD = DP + 4, NC = DP / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ss = Vs + kTile * LD;
  float* lse_s = Ss + kTile * kLdp;
  float* delta_s = lse_s + kTile;
  const int qt = blockIdx.x;
  const long long bh = blockIdx.y;
  const long long base = bh * t_len * d;
  const int row0 = qt * kTile;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int d4 = (d + 3) & ~3;
  const T* tag = nullptr;

  load_tile<T, DP>(Qs, q + base, row0, t_len, d);
  load_tile<T, DP>(dOs, dout + base, row0, t_len, d);
  load_tile<T, DP>(Ks, o + base, row0, t_len, d);  // O, for delta only
  load_rows(lse_s, lse + bh * t_len, row0, t_len);
  __syncthreads();
  // delta = rowsum(dO * O) in f32 (attention.py :200)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    float part = 0.f;
    for (int c = cg; c < DP; c += 16) part += dOs[r * LD + c] * Ks[r * LD + c];
    part = group16_sum(part);
    if (cg == 0) {
      delta_s[r] = part;
      if (row0 + r < t_len) delta[bh * t_len + row0 + r] = part;
    }
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) acc[i][jj] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // O (first pass) or the previous tile is consumed
    load_tile<T, DP>(Ks, k + base, kt * kTile, t_len, d);
    load_tile<T, DP>(Vs, v + base, kt * kTile, t_len, d);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt<DP>(Qs, Ks, rg, cg, d4, s);
    tile_abt<DP>(dOs, Vs, rg, cg, d4, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, qi = row0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt * kTile + cg + 16 * j;
        const bool visible = kj <= qi && kj < t_len && qi < t_len;
        const float p = visible ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[r]) * scale;
        Ss[r * kLdp + cg + 16 * j] = as_operand(tag, ds);
      }
    }
    __syncthreads();
    tile_pv<DP>(Ss, Ks, rg, cg, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = row0 + rg * 4 + i;
    if (qi >= t_len) continue;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int col = cg + 16 * jj;
      if (col < d) store_f32(dq + base + static_cast<long long>(qi) * d + col, acc[i][jj]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int t_len, int d, float scale) {
  constexpr int LD = DP + 4, NC = DP / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;
  float* Ss = Ps + kTile * kLdp;
  float* lse_s = Ss + kTile * kLdp;
  float* delta_s = lse_s + kTile;
  const int kt = blockIdx.x;
  const int n_q = (t_len + kTile - 1) / kTile;
  const long long bh = blockIdx.y;
  const long long base = bh * t_len * d;
  const int col0 = kt * kTile;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int d4 = (d + 3) & ~3;
  const T* tag = nullptr;

  load_tile<T, DP>(Ks, k + base, col0, t_len, d);
  load_tile<T, DP>(Vs, v + base, col0, t_len, d);
  float acc_dk[4][NC], acc_dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) acc_dk[i][jj] = acc_dv[i][jj] = 0.f;

  for (int qt = kt; qt < n_q; ++qt) {
    __syncthreads();  // the previous Q tile is consumed
    load_tile<T, DP>(Qs, q + base, qt * kTile, t_len, d);
    load_tile<T, DP>(dOs, dout + base, qt * kTile, t_len, d);
    load_rows(lse_s, lse + bh * t_len, qt * kTile, t_len);
    load_rows(delta_s, delta + bh * t_len, qt * kTile, t_len);
    __syncthreads();
    // transposed tiles: row i is a key of this CTA, column j a query
    float s[4][4], dp[4][4];
    tile_abt<DP>(Ks, Qs, rg, cg, d4, s);
    tile_abt<DP>(Vs, dOs, rg, cg, d4, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = col0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j, qi = qt * kTile + c;
        const bool visible = kj <= qi && qi < t_len && kj < t_len;
        const float p = visible ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[c]) * scale;
        Ps[(rg * 4 + i) * kLdp + c] = as_operand(tag, p);
        Ss[(rg * 4 + i) * kLdp + c] = as_operand(tag, ds);
      }
    }
    __syncthreads();
    tile_pv<DP>(Ps, dOs, rg, cg, acc_dv);
    tile_pv<DP>(Ss, Qs, rg, cg, acc_dk);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = col0 + rg * 4 + i;
    if (kj >= t_len) continue;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int col = cg + 16 * jj;
      if (col < d) {
        const long long at = base + static_cast<long long>(kj) * d + col;
        store_f32(dk + at, acc_dk[i][jj]);
        store_f32(dv + at, acc_dv[i][jj]);
      }
    }
  }
}

template <int DP>
constexpr size_t tile_floats() { return static_cast<size_t>(kTile) * (DP + 4); }

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

template <typename T, int DP>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int t_len,
        int d, float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const size_t smem = (3 * tile_floats<DP>() + kTile * kLdp) * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DP>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kTile - 1) / kTile, bh);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, t_len, d, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, int bh, int t_len, int d, float scale,
           cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const size_t smem = (4 * tile_floats<DP>() + kTile * kLdp + 2 * kTile) * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, DP>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kTile - 1) / kTile, bh);
  flash_bwd_dq_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      t_len, d, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* delta, void* dk, void* dv, int bh, int t_len, int d, float scale,
             cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const size_t smem = (4 * tile_floats<DP>() + 2 * kTile * kLdp + 2 * kTile) * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, DP>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kTile - 1) / kTile, bh);
  flash_bwd_dkdv_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), t_len,
      d, scale);
  return static_cast<int>(cudaGetLastError());
}

// The head width rounded up to a supported tile width, or 0.
int padded_d(int d) {
  if (d < 1) return 0;
  if (d <= 32) return 32;
  if (d <= 64) return 64;
  if (d <= 128) return 128;
  return 0;
}

}  // namespace

extern "C" {

// Each function launches on `stream` and returns a cudaError_t (0 on
// success). The caller guarantees contiguous (bh, t_len, d) tensors of one
// dtype (bf16 = 1: bfloat16, else float32) on the current device, with
// 1 <= bh <= 65535, t_len >= 1 and 1 <= d <= 128; lse and delta are f32
// (bh, t_len).

int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int bh, int t_len, int d, float scale, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_d(d) | (bf16 ? 1 : 0)) {
    case 32: return fwd<float, 32>(q, k, v, o, lse, bh, t_len, d, scale, s);
    case 64: return fwd<float, 64>(q, k, v, o, lse, bh, t_len, d, scale, s);
    case 128: return fwd<float, 128>(q, k, v, o, lse, bh, t_len, d, scale, s);
    case 33: return fwd<__nv_bfloat16, 32>(q, k, v, o, lse, bh, t_len, d, scale, s);
    case 65: return fwd<__nv_bfloat16, 64>(q, k, v, o, lse, bh, t_len, d, scale, s);
    case 129: return fwd<__nv_bfloat16, 128>(q, k, v, o, lse, bh, t_len, d, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* delta, void* dq, int bh,
                           int t_len, int d, float scale, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_d(d) | (bf16 ? 1 : 0)) {
    case 32: return bwd_dq<float, 32>(q, k, v, o, dout, lse, delta, dq, bh, t_len, d, scale, s);
    case 64: return bwd_dq<float, 64>(q, k, v, o, dout, lse, delta, dq, bh, t_len, d, scale, s);
    case 128: return bwd_dq<float, 128>(q, k, v, o, dout, lse, delta, dq, bh, t_len, d, scale, s);
    case 33:
      return bwd_dq<__nv_bfloat16, 32>(q, k, v, o, dout, lse, delta, dq, bh, t_len, d, scale, s);
    case 65:
      return bwd_dq<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq, bh, t_len, d, scale, s);
    case 129:
      return bwd_dq<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta, dq, bh, t_len, d, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv, int bh,
                             int t_len, int d, float scale, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_d(d) | (bf16 ? 1 : 0)) {
    case 32: return bwd_dkdv<float, 32>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, scale, s);
    case 64: return bwd_dkdv<float, 64>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, scale, s);
    case 128:
      return bwd_dkdv<float, 128>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, scale, s);
    case 33:
      return bwd_dkdv<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, scale,
                                         s);
    case 65:
      return bwd_dkdv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, scale,
                                         s);
    case 129:
      return bwd_dkdv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, bh, t_len, d, scale,
                                          s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
