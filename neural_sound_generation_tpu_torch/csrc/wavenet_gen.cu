// Whole-loop WaveNet generation for Hopper (sm_90a): the batch-1
// autoregressive loop of a mel-conditioned mixture-of-logistics WaveNet in
// one launch, or (teacher template flag) the teacher-forced logits of given
// inputs through the same arithmetic.
//
// Replaces neural_sound_generation_tpu/ops/pallas/wavenet_gen.py::
// _build_kernel (pallas_call at :357, reached from pallas_generate :378 and
// pallas_teacher_logits :389). What it computes, step t:
//
//   condz   = bf16(c_up[t]) @ w_cdot                          (L*G,)
//   for each layer l (h = the layer's input, bf16 values):
//     z     = [h | ring taps] @ w_in[l] + b_dil[l] + condz[l]  (G,)
//     gated = bf16(tanh(z[:G/2]) * sigmoid(z[G/2:]))
//     sr    = gated @ w_sr[l]                                  (S+R,)
//     skips += sr[:S];  ring[l][t] = h;  h = bf16(h + sr[S:] + b_res[l])
//   logits  = bf16(relu(bf16(relu(skips + b_skip)) @ w_post1 + b1)) @ w_post2 + b2
//   sample  : Gumbel-max over the first n_mix logits (first index on ties),
//             x = clip(mean + exp(max(ls, LOG_SCALE_MIN)) * (log u - log1p(-u)), -1, 1)
//             h = bf16(x * w_first + b_first)   (h0 = bf16(b_first))
//
// Tap j of layer l reads the ring at t - d_l * (K - 1 - j); the ring holds
// RD = (K - 1) * max(d) + 1 slots per layer, indexed t mod RD, and starts at
// zero (causal zero padding). The TPU kernel rotated its whole ring every
// step because Mosaic has no dynamic sublane index, and kept it in f32
// because its rotate is 32-bit only; here the ring is indexed circularly in
// device memory and stored in bf16, which is exact since it only ever holds
// bf16-rounded h. The noise is drawn by the caller (gumbel (T, n_mix),
// uniform (T,)), where the TPU kernel drew it with pltpu.prng_*.
//
// Products accumulate in f32 in a fixed order that the plain version in
// ops/cuda/wavenet_gen.py (_matvec) repeats: a column's rows are split into
// `ns` slices of `rps` consecutive rows (ns = threads / (cols / 8) when that
// is at least 1, else 1), each slice summed row by row from zero with fmaf
// (a bf16 x bf16 product is exact in f32, so the fma rounds once, as the
// plain version's add does), then the slice sums added in slice order.
//
// What bounds it on an H100: at the production configuration (24 layers,
// R 128, G 256, S 128, C 80, out 30) a step reads 7.3 MB of bf16 weights
// and does 7.3 MFLOP. Read once per step from device memory that is 2.2 us
// at 3.35 TB/s (48 ms for 22050 steps); the weights stay resident in the
// 50 MB L2 after the first step, and the FLOPs are negligible. The real
// floor is the serial chain: 2 * L dependent products per step, each a
// round of loads and a block-wide barrier. This first design is one
// 512-thread block that loops over t: h, the conditioning row, z, gated,
// sr and the skip sum live in shared memory, weights are read with 16-byte
// loads from global memory (L2) every step, barriers separate the dependent
// phases. One SM's share of the L2 bandwidth caps it. Spreading the
// weights over the shared memory of a thread-block cluster (wgmma, DSMEM)
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;              // bf16 columns per 16-byte load
constexpr int kThreads = 512;
constexpr int kMisc = 4;
constexpr float kLogScaleMin = static_cast<float>(-32.23619130191664);
constexpr float kULo = static_cast<float>(1e-5);
constexpr float kUHi = static_cast<float>(1.0 - 1e-5);

struct Params {
  const __nv_bfloat16* w_in;     // (L, K*R, G)
  const float* b_dil;            // (L, G)
  const __nv_bfloat16* w_sr;     // (L, G/2, S+R)
  const float* b_res;            // (L, R)
  const float* b_skip;           // (S,)
  const __nv_bfloat16* w_post1;  // (S, S)
  const float* b_post1;          // (S,)
  const __nv_bfloat16* w_post2;  // (S, OUTP)
  const float* b_post2;          // (OUTP,)
  const float* w_first;          // (R,)
  const float* b_first;          // (R,)
  const __nv_bfloat16* w_cdot;   // (C, L*G)
  const __nv_bfloat16* c_up;     // (T, C)
  const int* dil;                // (L,)
  const float* gumbel;           // (T, n_mix), sampling only
  const float* uniform;          // (T,), sampling only
  const float* x_teacher;        // (T,), teacher only
  __nv_bfloat16* ring;           // (L, RD, R), zero on entry
  float* out;                    // (T,) samples or (T, OUT) logits
  int T, L, K, R, G, S, C, OUT, OUTP, RD;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void fma8(float (&acc)[kVec], float x, uint4 w) {
  acc[0] = fmaf(x, lo_bf16(w.x), acc[0]);
  acc[1] = fmaf(x, hi_bf16(w.x), acc[1]);
  acc[2] = fmaf(x, lo_bf16(w.y), acc[2]);
  acc[3] = fmaf(x, hi_bf16(w.y), acc[3]);
  acc[4] = fmaf(x, lo_bf16(w.z), acc[4]);
  acc[5] = fmaf(x, hi_bf16(w.z), acc[5]);
  acc[6] = fmaf(x, lo_bf16(w.w), acc[6]);
  acc[7] = fmaf(x, hi_bf16(w.w), acc[7]);
}

// y[c] = sum_r x[r] * W[r * cols + c] for c < cols (cols % 8 == 0), x and y
// in shared memory, W 16-byte aligned in global memory, in the order set
// out at the top. Every thread of the block calls it; it ends with a
// barrier, after which y is complete and `partial` free again.
__device__ void matvec(const __nv_bfloat16* __restrict__ W, int rows, int cols,
                       const float* x, float* y, float* partial) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int groups = cols / kVec;
  const uint4* w4 = reinterpret_cast<const uint4*>(W);
  if (groups >= nt) {
    for (int g = tid; g < groups; g += nt) {
      float acc[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int r = 0; r < rows; ++r) fma8(acc, x[r], __ldg(w4 + (size_t)r * groups + g));
#pragma unroll
      for (int k = 0; k < kVec; ++k) y[g * kVec + k] = acc[k];
    }
    __syncthreads();
    return;
  }
  const int ns = nt / groups;
  const int rps = (rows + ns - 1) / ns;
  const int g = tid % groups, s = tid / groups;
  if (s < ns) {
    float acc[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int r0 = s * rps, r1 = min(rows, r0 + rps);
#pragma unroll 4
    for (int r = r0; r < r1; ++r) fma8(acc, x[r], __ldg(w4 + (size_t)r * groups + g));
    float* pp = partial + (size_t)s * cols + g * kVec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) pp[k] = acc[k];
  }
  __syncthreads();
  for (int c = tid; c < cols; c += nt) {
    float v = partial[c];
    for (int q = 1; q < ns; ++q) v = __fadd_rn(v, partial[(size_t)q * cols + c]);
    y[c] = v;
  }
  __syncthreads();
}

__device__ __forceinline__ float embed(float x, float w, float b) {
  return round_bf16(__fadd_rn(__fmul_rn(x, w), b));
}

template <bool kTeacher>
__global__ void __launch_bounds__(kThreads) wavenet_gen_kernel(Params p) {
  extern __shared__ float smem[];
  const int L = p.L, K = p.K, R = p.R, G = p.G, G2 = p.G / 2, S = p.S, RD = p.RD;
  float* condz = smem;                  // L*G
  float* xin = condz + L * G;           // K*R: [h | tap_0 .. tap_{K-2}]
  float* z = xin + K * R;               // G
  float* gated = z + G;                 // G/2
  float* sr = gated + G2;               // S+R
  float* skips = sr + S + R;            // S
  float* h = skips + S;                 // R
  float* hs = h + R;                    // S: the head's input
  float* o1 = hs + S;                   // S
  float* logits = o1 + S;               // OUTP
  float* crow = logits + p.OUTP;        // C
  float* partial = crow + p.C;          // threads * 8
  float* misc = partial + blockDim.x * kVec;  // kMisc
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_mix = p.OUT / 3;

  if (!kTeacher) {
    for (int r = tid; r < R; r += nt) h[r] = embed(0.f, p.w_first[r], p.b_first[r]);
  }
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    if (kTeacher) {
      const float xv = p.x_teacher[t];
      for (int r = tid; r < R; r += nt) h[r] = embed(xv, p.w_first[r], p.b_first[r]);
    }
    for (int c = tid; c < p.C; c += nt) crow[c] = __bfloat162float(p.c_up[(size_t)t * p.C + c]);
    for (int i = tid; i < S; i += nt) skips[i] = 0.f;
    __syncthreads();
    matvec(p.w_cdot, p.C, L * G, crow, condz, partial);

    const int slot = t % RD;
    for (int l = 0; l < L; ++l) {
      const int d = p.dil[l];
      __nv_bfloat16* ring_l = p.ring + (size_t)l * RD * R;
      for (int i = tid; i < K * R; i += nt) {
        if (i < R) {
          xin[i] = h[i];
          ring_l[(size_t)slot * R + i] = __float2bfloat16_rn(h[i]);
        } else {
          const int j = i / R - 1, r = i % R;
          int sl = (t - d * (K - 1 - j)) % RD;
          if (sl < 0) sl += RD;
          xin[i] = __bfloat162float(ring_l[(size_t)sl * R + r]);
        }
      }
      __syncthreads();
      matvec(p.w_in + (size_t)l * K * R * G, K * R, G, xin, z, partial);
      for (int i = tid; i < G2; i += nt) {
        const float a = __fadd_rn(__fadd_rn(z[i], p.b_dil[l * G + i]), condz[l * G + i]);
        const float b = __fadd_rn(__fadd_rn(z[G2 + i], p.b_dil[l * G + G2 + i]),
                                  condz[l * G + G2 + i]);
        const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-b)));
        gated[i] = round_bf16(__fmul_rn(tanhf(a), sig));
      }
      __syncthreads();
      matvec(p.w_sr + (size_t)l * G2 * (S + R), G2, S + R, gated, sr, partial);
      for (int i = tid; i < S; i += nt) skips[i] = __fadd_rn(skips[i], sr[i]);
      for (int i = tid; i < R; i += nt)
        h[i] = round_bf16(__fadd_rn(__fadd_rn(h[i], sr[S + i]), p.b_res[l * R + i]));
      __syncthreads();
    }

    for (int i = tid; i < S; i += nt)
      hs[i] = round_bf16(fmaxf(__fadd_rn(skips[i], p.b_skip[i]), 0.f));
    __syncthreads();
    matvec(p.w_post1, S, S, hs, o1, partial);
    for (int i = tid; i < S; i += nt)
      o1[i] = round_bf16(fmaxf(__fadd_rn(o1[i], p.b_post1[i]), 0.f));
    __syncthreads();
    matvec(p.w_post2, S, p.OUTP, o1, logits, partial);
    for (int i = tid; i < p.OUTP; i += nt) logits[i] = __fadd_rn(logits[i], p.b_post2[i]);
    __syncthreads();

    if (kTeacher) {
      for (int i = tid; i < p.OUT; i += nt) p.out[(size_t)t * p.OUT + i] = logits[i];
    } else {
      if (tid == 0) {
        const float* gum = p.gumbel + (size_t)t * n_mix;
        int best = 0;
        float best_s = __fadd_rn(logits[0], gum[0]);
        for (int k = 1; k < n_mix; ++k) {
          const float s = __fadd_rn(logits[k], gum[k]);
          if (s > best_s) {
            best_s = s;
            best = k;
          }
        }
        const float mean = logits[n_mix + best];
        const float ls = fmaxf(logits[2 * n_mix + best], kLogScaleMin);
        const float u = fminf(fmaxf(p.uniform[t], kULo), kUHi);
        const float noise = __fsub_rn(logf(u), log1pf(-u));
        const float x = fminf(fmaxf(__fadd_rn(mean, __fmul_rn(expf(ls), noise)), -1.f), 1.f);
        p.out[t] = x;
        misc[0] = x;
      }
      __syncthreads();
      const float xv = misc[0];
      for (int r = tid; r < R; r += nt) h[r] = embed(xv, p.w_first[r], p.b_first[r]);
    }
    __syncthreads();
  }
}

int smem_floats(int L, int K, int R, int G, int S, int C, int OUTP, int threads, int vec) {
  return L * G + K * R + G + G / 2 + (S + R) + S + R + S + S + OUTP + C + threads * vec + kMisc;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one launch, in bytes (the wrapper checks that
// its own formula agrees).
int wavenet_gen_smem_bytes(int L, int K, int R, int G, int S, int C, int OUTP, int threads,
                           int vec) {
  return 4 * smem_floats(L, K, R, G, S, C, OUTP, threads, vec);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller guarantees contiguous tensors on the current device, the shapes
// above, G, S+R, S, L*G and OUTP multiples of 8, 16-byte aligned weights,
// T >= 1, a zeroed ring, and threads == 512.
int wavenet_gen_launch(const void* w_in, const float* b_dil, const void* w_sr,
                       const float* b_res, const float* b_skip, const void* w_post1,
                       const float* b_post1, const void* w_post2, const float* b_post2,
                       const float* w_first, const float* b_first, const void* w_cdot,
                       const void* c_up, const int* dil, const float* gumbel,
                       const float* uniform, const float* x_teacher, void* ring, float* out,
                       int T, int L, int K, int R, int G, int S, int C, int OUT, int OUTP,
                       int RD, int threads, int smem, int teacher, void* stream) {
  if (threads != kThreads || smem != 4 * smem_floats(L, K, R, G, S, C, OUTP, threads, kVec))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.w_in = static_cast<const __nv_bfloat16*>(w_in);
  p.b_dil = b_dil;
  p.w_sr = static_cast<const __nv_bfloat16*>(w_sr);
  p.b_res = b_res;
  p.b_skip = b_skip;
  p.w_post1 = static_cast<const __nv_bfloat16*>(w_post1);
  p.b_post1 = b_post1;
  p.w_post2 = static_cast<const __nv_bfloat16*>(w_post2);
  p.b_post2 = b_post2;
  p.w_first = w_first;
  p.b_first = b_first;
  p.w_cdot = static_cast<const __nv_bfloat16*>(w_cdot);
  p.c_up = static_cast<const __nv_bfloat16*>(c_up);
  p.dil = dil;
  p.gumbel = gumbel;
  p.uniform = uniform;
  p.x_teacher = x_teacher;
  p.ring = static_cast<__nv_bfloat16*>(ring);
  p.out = out;
  p.T = T;
  p.L = L;
  p.K = K;
  p.R = R;
  p.G = G;
  p.S = S;
  p.C = C;
  p.OUT = OUT;
  p.OUTP = OUTP;
  p.RD = RD;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (teacher) {
    err = cudaFuncSetAttribute(wavenet_gen_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wavenet_gen_kernel<true><<<1, threads, smem, s>>>(p);
  } else {
    err = cudaFuncSetAttribute(wavenet_gen_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wavenet_gen_kernel<false><<<1, threads, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* wavenet_gen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
