// Fused Adam with global-norm clip, weight decay and a parameter EMA, in one
// pass over flat vectors, for Hopper (sm_90a):
//
//     g'  = g * gscale            (when clip)
//     g'  = g' + wd * p           (when wd > 0)
//     m   = b1 * m + (1 - b1) * g'
//     v   = b2 * v + (1 - b2) * g' * g'
//     p   = p - lr * (m / bc1) / (sqrt(v / bc2) + eps)
//     ema = d * ema + (1 - d) * p (when has_ema)
//
// p, m, v and ema are updated in place (the Pallas kernel aliases them the
// same way). g, p and ema are f32; m and v are f32 or bf16, loaded to f32,
// updated in f32 and rounded to nearest even on store. The five per-step
// scalars [gscale, lr, bc1, bc2, d] are read from device memory, so the
// caller never waits on the host for the global norm, the schedule or the
// bias corrections.
//
// Replaces neural_sound_generation_tpu/ops/pallas/fused_adam.py::_kernel
// (called through fused_adam_update, pl.pallas_call at :118). The TPU grid
// of 1-D blocks of 256K elements becomes a grid of 256-thread blocks, each
// thread updating 4 neighbouring elements per iteration.
//
// What bounds it on an H100: about 11 f32 operations per element against
// 36 bytes moved (read g, p, m, v, ema; write p, m, v, ema; 28 bytes with
// bf16 moments), so memory bandwidth bounds it: 4.87M parameters are 175 MB
// per step, 0.052 ms at 3.35 TB/s. The design aims at full-width memory
// transactions: f32 vectors move as 16-byte loads and stores (bf16 moments
// as 8-byte ones) when every pointer is aligned for them, with a scalar
// tail for n not a multiple of 4 and a scalar path for unaligned views.
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), which the compiler never contracts into an FMA,
// in the order the plain PyTorch version evaluates them: the kernel and
// that version agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
  int clip, has_ema;
};

struct Scalars {
  float gscale, lr, bc1, bc2, d;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename M>
__device__ __forceinline__ M from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One element: p, m, v, e are updated in place (m and v in f32 here).
__device__ __forceinline__ void adam_element(float g, float& p, float& m, float& v, float& e,
                                             const Hyper& h, const Scalars& s) {
  if (h.clip) g = __fmul_rn(g, s.gscale);
  if (h.wd > 0.f) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
  const float m_hat = __fdiv_rn(m, s.bc1);
  const float v_hat = __fdiv_rn(v, s.bc2);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), h.eps)));
  if (h.has_ema) e = __fadd_rn(__fmul_rn(s.d, e), __fmul_rn(__fsub_rn(1.f, s.d), p));
}

// Four neighbouring elements as one vector: 16 bytes of f32, 8 of bf16.
__device__ __forceinline__ void load4(const float* ptr, long long i, float out[4]) {
  const float4 t = reinterpret_cast<const float4*>(ptr)[i];
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void store4(float* ptr, long long i, const float in[4]) {
  reinterpret_cast<float4*>(ptr)[i] = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* ptr, long long i, float out[4]) {
  const uint2 raw = reinterpret_cast<const uint2*>(ptr)[i];
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void store4(__nv_bfloat16* ptr, long long i, const float in[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(in[0], in[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(in[2], in[3]);
  uint2 raw;
  memcpy(&raw.x, &lo, sizeof(lo));
  memcpy(&raw.y, &hi, sizeof(hi));
  reinterpret_cast<uint2*>(ptr)[i] = raw;
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const float* __restrict__ g, float* __restrict__ p, M* __restrict__ m,
                  M* __restrict__ v, float* __restrict__ ema,
                  const float* __restrict__ scalars, long long n, Hyper h, int vec) {
  const Scalars s{scalars[0], scalars[1], scalars[2], scalars[3], scalars[4]};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n_vec = vec ? n / 4 : 0;

  for (long long i = first; i < n_vec; i += stride) {
    float gv[4], pv[4], mv[4], vv[4], ev[4] = {0.f, 0.f, 0.f, 0.f};
    load4(g, i, gv);
    load4(p, i, pv);
    load4(m, i, mv);
    load4(v, i, vv);
    if (h.has_ema) load4(ema, i, ev);
#pragma unroll
    for (int j = 0; j < 4; ++j) adam_element(gv[j], pv[j], mv[j], vv[j], ev[j], h, s);
    store4(p, i, pv);
    store4(m, i, mv);
    store4(v, i, vv);
    if (h.has_ema) store4(ema, i, ev);
  }

  // the tail past the last whole vector, or everything when unaligned
  for (long long i = 4 * n_vec + first; i < n; i += stride) {
    float pe = p[i], me = to_f32(m[i]), ve = to_f32(v[i]);
    float ee = h.has_ema ? ema[i] : 0.f;
    adam_element(g[i], pe, me, ve, ee, h, s);
    p[i] = pe;
    m[i] = from_f32<M>(me);
    v[i] = from_f32<M>(ve);
    if (h.has_ema) ema[i] = ee;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller guarantees n >= 1; contiguous, distinct, non-overlapping f32
// g, p and ema (ema may be null when has_ema is 0) and m, v of f32
// (moments_bf16 = 0) or bf16 (moments_bf16 = 1), all of n elements on the
// current device; scalars a device array [gscale, lr, bc1, bc2, d] of f32;
// vec = 1 only when every pointer is 16-byte aligned (8-byte for bf16
// moments).
int fused_adam_f32(const float* g, float* p, void* m, void* v, float* ema,
                   const float* scalars, long long n, int moments_bf16, float b1,
                   float one_minus_b1, float b2, float one_minus_b2, float eps, float wd,
                   int clip, int has_ema, int vec, void* stream) {
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, wd, clip, has_ema};
  const long long work = vec ? (n / 4 > 0 ? n / 4 : 1) : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (moments_bf16) {
    fused_adam_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        g, p, static_cast<__nv_bfloat16*>(m), static_cast<__nv_bfloat16*>(v), ema, scalars, n,
        h, vec);
  } else {
    fused_adam_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        g, p, static_cast<float*>(m), static_cast<float*>(v), ema, scalars, n, h, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
