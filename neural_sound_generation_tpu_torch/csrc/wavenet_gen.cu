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
// zero (causal zero padding). The noise is drawn by the caller (gumbel
// (T, n_mix), uniform (T,)), where the TPU kernel drew it with pltpu.prng_*.
//
// The order of every sum (the plain version in ops/cuda/wavenet_gen.py,
// _matvec and _layer, repeats it): a product's rows are cut into 16 slices
// of rows/16 consecutive rows (rows padded with zeros to a multiple of 16);
// each slice is summed row by row from zero with fmaf (a bf16 x bf16 product
// is exact in f32, so the fma rounds once, as the plain version's add does);
// the 16 slice sums are added by halving (slice s + slice s + 8, then + 4,
// + 2, + 1). A z column is ((tap part + h part) + b_dil) + condz, the tap
// part being the product of [tap_0 | ... | tap_{K-2}] and the h part that
// of h, each a product of its own. The skip sum adds the layers in order,
// from zero.
//
// What bounds it on an H100. At the production configuration (24 layers,
// R 128, G 256, S 128, C 80, out 30) a step does 3.7 M multiply-adds on 7.3
// MB of bf16 weights: 7.4 ns at the bf16 tensor-core rate. The floor is the
// serial chain: 2 L dependent batch-1 products per step (h @ W_cur, then
// gated @ W_res), each behind the previous one's result. The first design
// (commit ebae962) ran the loop in one 512-thread block that streamed all 7.3 MB from L2 every
// step behind some 150 block barriers: 236 us a sample. This design:
//
//   * One cluster of NC = 16 CTAs (a non-portable size) holds the chain's
//     weights in shared memory for the whole launch.
//     CTA c owns 1/NC of the columns of every product: G/(2 NC) gate pairs
//     (both halves of each pair, so the gate is local), R/NC columns of h,
//     S/NC skip columns, S/NC columns of the head's first product. Its
//     slices of W_cur, W_res, W_skip, the head and the biases are copied
//     once per launch into shared memory by bulk copies (cp.async.bulk), in
//     a lane-ordered layout (ops/cuda/wavenet_gen.py kernel_weights) so that
//     each warp-wide load is 512 contiguous bytes. At the production
//     configuration with 16 CTAs that is 212,448 B a CTA, all layers
//     resident (220,624 B of shared memory with the buffers); a shape whose
//     slices do not fit keeps the rest in device memory and reads it from
//     L2 through the same generic pointers.
//   * All-gathers through DSMEM replace block barriers. After its gate each
//     CTA writes its gated values into every peer's exchange buffer with
//     st.async (16 bytes a store, mbarrier::complete_tx on the peer's
//     barrier) and waits on its own barrier; the same for the new h, the
//     head's input and o1: 2 L + 1 exchanges a step (the last layer's h is
//     not needed). Each CTA arms its own barrier (arrive.expect_tx) right
//     after it sends, so a peer's bytes may land first (the tx-count goes
//     below zero; the phase cannot complete before the local arrive).
//     Exchanges rotate over kXBufs buffers and barriers, waited by phase
//     parity: a peer can send exchange e + 1 only after it has our part of
//     e, so no buffer is written while it is read. Every CTA computes the
//     logits from the gathered o1 with the whole of w_post2 and draws the
//     same sample from the same noise: no broadcast. No atomics; the order
//     of every sum is fixed, so the output is bit-identical run to run.
//   * Roles. Warp 0 of each CTA runs the chain: the ring store, h @ W_cur,
//     the gate, the exchanges, gated @ [W_res | W_skip] (res columns in
//     lanes 0-15, skip columns in lanes 16-31 of the same pass), the head
//     and the sample. Warps 1-3, each on a scheduler of its own, compute
//     what is off the chain, one step ahead: the tap part of z for step
//     t + 1 and layer l (its
//     ring rows are known once the chain has stored layer l's input of
//     step t) and condz for step t + 1, streaming W_tap and W_cdot from L2,
//     into a double-buffered smem array that the chain reads after an
//     mbarrier (one per layer each way: ring stored, parts ready).
//   * The ring of past layer inputs is private to each CTA (NC copies of
//     (L, RD, R) bf16 in device memory, L2-resident): every CTA holds the
//     whole h after its all-gather, so it stores it itself and no ordering
//     between CTAs is needed; the chain warp stores, and its mbarrier arrive
//     (release) orders the stores before the helpers' loads.
//   * The products are batch-1 GEMVs of 2-4 K multiply-adds a CTA, run on
//     the CUDA cores from shared memory by one warp: lane s of each half-warp
//     sums one row slice of 8 columns, then the halves reduce with shuffles.
//     Tensor cores are not the lever here: a wgmma tile has M = 64 rows and
//     would waste 63 of them on one input row, and the time goes to the
//     chain's latency (loads, reductions, exchanges), not to arithmetic.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6): about 42 us
// a generated sample at T 4096 against the first design's 236; the exchanges
// alone, the gate and the head (products skipped) take 28 us of it, some
// 0.45 us an all-gather of 16 CTAs. Polled flag words in place of the
// mbarrier, one mbarrier per source, and remote stores with a release
// arrive were all slower.
//
// kProducts and kHelpers select variants for attribution
// (scripts/torch_wavenet_gen_check.py): the exchanges alone (products
// skipped: timing only), and the off-chain parts computed on the chain.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;      // warp 0 the chain, warps 1-3 the helpers
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = 16;        // row slices of every product (a half-warp)
constexpr int kPassRow = 512;      // bytes of one row of a pass: 32 lanes x 16 B
constexpr int kXBufs = 4;          // exchange buffers (and barriers), in turn
constexpr int kLoadChunk = 32768;  // bytes per bulk copy of the resident weights
constexpr int kSmemLimit = 232448; // dynamic shared memory a CTA may use
constexpr bool kProducts = true;   // false: exchanges only (timing variant)
constexpr bool kHelpers = true;    // false: taps and condz on the chain
constexpr float kLogScaleMin = static_cast<float>(-32.23619130191664);
constexpr float kULo = static_cast<float>(1e-5);
constexpr float kUHi = static_cast<float>(1.0 - 1e-5);

constexpr int kErrLayout = -1;     // the shape has no layout (see make_layout)
constexpr int kErrMismatch = -2;   // the caller's layout differs from the kernel's

struct Params {
  const uint8_t* res;         // (NC, RB) each CTA's resident blob
  const uint8_t* stream;      // (NC, SB) each CTA's streamed blob
  const __nv_bfloat16* c_up;  // (T, C)
  const int* dil;             // (L,)
  const float* gumbel;        // (T, n_mix), sampling only
  const float* uniform;       // (T,), sampling only
  const float* x_teacher;     // (T,), teacher only
  __nv_bfloat16* ring;        // (NC, L, RD, R), zero on entry
  float* out;                 // (T,) samples or (T, OUT) logits
  int T, L, K, R, G2, S, C, OUT, OUTP, RD;
};

// The per-CTA layout, a function of the shape and the cluster size; the
// same formulas as kernel_layout in ops/cuda/wavenet_gen.py. Offsets in
// bytes. A "pass" is one warp's product of rows x 16 columns: lanes 0-15 one
// chunk of 8 columns, lanes 16-31 another; its weights are rps rows of 32
// lanes x 16 B (vector i of lane l at [i * 32 + l], rows (l % 16) * rps + i).
struct Layout {
  int nc, g8, r8, s8, z;          // columns a CTA owns; z = 2 * g8
  int npz, nprs, np1, np2;        // passes: z, res|skip, post1, post2
  int rps_r, rps_g, rps_s, rps_t, rps_c, cp;
  // the resident blob: biases, head, then per layer [W_cur | W_res|W_skip]
  int o_bdil, o_bres, o_bskip, o_bp1, o_bp2, o_wfirst, o_bfirst, o_wp1, o_wp2, o_layer0;
  int wcur_bytes, layer_bytes, rb;
  // the streamed blob: per layer [W_tap | W_cdot]
  int tap_bytes, slayer_bytes, sb;
  // shared memory: the resident prefix, then the buffers
  int res, b_pre, xw, b_xbuf, b_h0, b_mine, b_skacc, b_logits, b_score, b_bars, smem;
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

int make_layout(int L, int K, int R, int G2, int S, int C, int OUTP, int nc, Layout* y) {
  if (nc < 1 || L < 1 || K < 2 || C < 1 || OUTP < 8 || R % (8 * nc) || G2 % (8 * nc) ||
      S % (8 * nc) || OUTP % 8)
    return kErrLayout;
  y->nc = nc;
  y->g8 = G2 / nc;
  y->r8 = R / nc;
  y->s8 = S / nc;
  y->z = 2 * y->g8;
  y->npz = y->g8 / 8;
  y->nprs = (y->r8 > y->s8 ? y->r8 : y->s8) / 8;
  y->np1 = (y->s8 / 8 + 1) / 2;
  y->np2 = (OUTP / 8 + 1) / 2;
  y->cp = (C + 15) / 16 * 16;
  y->rps_r = R / kSlices;
  y->rps_g = G2 / kSlices;
  y->rps_s = S / kSlices;
  y->rps_t = (K - 1) * R / kSlices;
  y->rps_c = y->cp / kSlices;
  int off = 0;
  auto take = [&off](int n) {
    const int o = off;
    off += round16(n);
    return o;
  };
  y->o_bdil = take(4 * L * y->z);
  y->o_bres = take(4 * L * 8 * y->nprs);
  y->o_bskip = take(4 * 8 * y->nprs);
  y->o_bp1 = take(4 * 16 * y->np1);
  y->o_bp2 = take(4 * 16 * y->np2);
  y->o_wfirst = take(4 * R);
  y->o_bfirst = take(4 * R);
  y->o_wp1 = take(y->np1 * y->rps_s * kPassRow);
  y->o_wp2 = take(y->np2 * y->rps_s * kPassRow);
  y->o_layer0 = off;
  y->wcur_bytes = y->npz * y->rps_r * kPassRow;
  y->layer_bytes = y->wcur_bytes + y->nprs * y->rps_g * kPassRow;
  y->rb = off + L * y->layer_bytes;
  y->tap_bytes = y->npz * y->rps_t * kPassRow;
  y->slayer_bytes = y->tap_bytes + y->npz * y->rps_c * kPassRow;
  y->sb = L * y->slayer_bytes;
  int buf = 0;
  auto btake = [&buf](int n) {
    const int o = buf;
    buf += round16(n);
    return o;
  };
  const int xw = G2 > R ? (G2 > S ? G2 : S) : (R > S ? R : S);
  int mw = y->npz > y->nprs ? y->npz : y->nprs;
  if (2 * y->np1 > mw) mw = 2 * y->np1;
  y->xw = xw;
  y->b_pre = btake(4 * 2 * 2 * L * y->z);
  y->b_xbuf = btake(2 * kXBufs * xw);
  y->b_h0 = btake(2 * R);
  y->b_mine = btake(2 * 8 * mw);
  y->b_skacc = btake(4 * 8 * y->nprs);
  y->b_logits = btake(4 * 16 * y->np2);
  y->b_score = btake(4 * 16 * y->np2);
  y->b_bars = btake(8 * (kXBufs + 2 * L + 1));
  const int budget = kSmemLimit - buf;
  if (budget < 0) return kErrLayout;
  // the resident prefix: whole sections (biases, w_post1, w_post2, layer 0,
  // layer 1, ...) while they fit
  int res = 0;
  const int ends[3] = {y->o_wp1, y->o_wp2, y->o_layer0};
  for (int i = 0; i < 3; ++i)
    if (ends[i] <= budget) res = ends[i];
  if (res == y->o_layer0)
    for (int l = 1; l <= L && y->o_layer0 + l * y->layer_bytes <= budget; ++l)
      res = y->o_layer0 + l * y->layer_bytes;
  y->res = res;
  y->smem = res + buf;
  return 0;
}

// ---- shared memory, mbarriers, DSMEM ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of `parity` to complete (acquire at CTA scope).
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

// The same, acquiring at cluster scope: peers' stores completed the phase.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
        "r"(smem_addr(bar))
      : "memory");
}

// The address of the same shared-memory location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_async16(uint32_t raddr, const uint4& v, uint32_t rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(raddr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rbar)
      : "memory");
}

__device__ __forceinline__ uint4 xrow8(const __nv_bfloat16* x, int r) {
  return *reinterpret_cast<const uint4*>(x + r);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// ---- arithmetic ------------------------------------------------------------

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void fma8(float (&acc)[8], float x, const uint4& w) {
  acc[0] = fmaf(x, lo_bf16(w.x), acc[0]);
  acc[1] = fmaf(x, hi_bf16(w.x), acc[1]);
  acc[2] = fmaf(x, lo_bf16(w.y), acc[2]);
  acc[3] = fmaf(x, hi_bf16(w.y), acc[3]);
  acc[4] = fmaf(x, lo_bf16(w.z), acc[4]);
  acc[5] = fmaf(x, hi_bf16(w.z), acc[5]);
  acc[6] = fmaf(x, lo_bf16(w.w), acc[6]);
  acc[7] = fmaf(x, hi_bf16(w.w), acc[7]);
}

// The 16 slice sums of a lane's 8 columns added by halving within its
// half-warp (slice s + slice s + 8, then + 4, + 2, + 1), as a reduce-scatter:
// lanes 2j and 2j + 1 of each half end with column j of their chunk.
__device__ __forceinline__ float reduce16(const float (&a)[8], int lane) {
  const bool b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float v4[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = b3 ? a[k] : a[k + 4];
    const float keep = b3 ? a[k + 4] : a[k];
    v4[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
  float v2[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = b2 ? v4[k] : v4[k + 2];
    const float keep = b2 ? v4[k + 2] : v4[k];
    v2[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 4));
  }
  const float send = b1 ? v2[0] : v2[1];
  const float keep = b1 ? v2[1] : v2[0];
  const float v1 = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 2));
  return __fadd_rn(v1, __shfl_xor_sync(0xffffffffu, v1, 1));
}

// One pass (the whole warp): lane slice s = lane % 16 sums rows [s * rps,
// (s + 1) * rps) of its chunk from zero, rps a multiple of 8; xrow8(r) gives
// the 8 bf16 inputs of rows r .. r + 7. Returns column (lane % 16) / 2.
template <typename X>
__device__ __forceinline__ float pass8(const uint4* w, int rps, int lane, X xrow8) {
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int r0 = (lane & 15) * rps;
  for (int i8 = 0; i8 < rps; i8 += 8) {
    const uint4 xx = xrow8(r0 + i8);
    const uint4* wi = w + i8 * 32 + lane;
    fma8(acc, lo_bf16(xx.x), wi[0]);
    fma8(acc, hi_bf16(xx.x), wi[32]);
    fma8(acc, lo_bf16(xx.y), wi[64]);
    fma8(acc, hi_bf16(xx.y), wi[96]);
    fma8(acc, lo_bf16(xx.z), wi[128]);
    fma8(acc, hi_bf16(xx.z), wi[160]);
    fma8(acc, lo_bf16(xx.w), wi[192]);
    fma8(acc, hi_bf16(xx.w), wi[224]);
  }
  return reduce16(acc, lane);
}

// The same with one input row at a time, rows past n reading zero (the
// conditioning, C padded to a multiple of 16).
__device__ __forceinline__ float pass1(const uint4* w, int rps, int lane,
                                       const __nv_bfloat16* x, int n) {
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int r0 = (lane & 15) * rps;
  for (int i = 0; i < rps; ++i) {
    const int r = r0 + i;
    fma8(acc, r < n ? __bfloat162float(x[r]) : 0.f, w[i * 32 + lane]);
  }
  return reduce16(acc, lane);
}

__device__ __forceinline__ float embed(float x, float w, float b) {
  return round_bf16(__fadd_rn(__fmul_rn(x, w), b));
}

__device__ __forceinline__ __nv_bfloat16 gate(float a, float b) {
  const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-b)));
  return __float2bfloat16_rn(__fmul_rn(tanhf(a), sig));
}

// ---- the kernel ------------------------------------------------------------

struct Smem {
  const uint8_t* base;  // the resident prefix of this CTA's blob
  const uint8_t* gres;  // the same blob in device memory
  const uint8_t* gstr;  // this CTA's streamed blob
  float* pre;           // [tap, condz][t % 2][L][z]
  __nv_bfloat16* xbuf;  // [kXBufs][xw] gathered vectors
  __nv_bfloat16* h0;    // (R,) layer 0's input
  __nv_bfloat16* mine;  // this CTA's part of the next exchange
  float* skacc;         // this CTA's skip columns
  float* logits;
  float* score;
  uint64_t* xbar;       // [kXBufs]
  uint64_t* ring_bar;   // [L] layer l's input is in the ring
  uint64_t* pre_bar;    // [L] layer l's tap part and condz are in `pre`
  int res;

  // A section of the blob: in shared memory if it lies in the resident
  // prefix, else in device memory (L2).
  __device__ __forceinline__ const void* at(int off, int bytes) const {
    return off + bytes <= res ? static_cast<const void*>(base + off)
                              : static_cast<const void*>(gres + off);
  }
};

// The tap part and condz of step t, layer l, for this CTA's z columns, by
// one warp, into pre[.][t % 2][l].
__device__ __forceinline__ void pre_item(const Params& p, const Layout& y, const Smem& m, int c,
                                         int t, int l, int lane) {
  const int R = p.R, RD = p.RD, K = p.K;
  const int d = p.dil[l];
  const __nv_bfloat16* ring_l = p.ring + static_cast<size_t>(c * p.L + l) * RD * R;
  const uint8_t* wl = m.gstr + static_cast<size_t>(l) * y.slayer_bytes;
  const __nv_bfloat16* crow = p.c_up + static_cast<size_t>(t) * p.C;
  float* ptap = m.pre + ((t & 1) * p.L + l) * y.z;
  float* pcz = m.pre + ((2 + (t & 1)) * p.L + l) * y.z;
  for (int q = 0; q < y.npz; ++q) {
    const uint4* wt = reinterpret_cast<const uint4*>(wl + q * y.rps_t * kPassRow);
    const uint4* wc = reinterpret_cast<const uint4*>(wl + y.tap_bytes + q * y.rps_c * kPassRow);
    float tv = 0.f, cv = 0.f;
    if (kProducts) {
      tv = pass8(wt, y.rps_t, lane, [&](int r) {
        const int j = r / R;
        int sl = (t - d * (K - 1 - j)) % RD;
        if (sl < 0) sl += RD;
        return *reinterpret_cast<const uint4*>(ring_l + static_cast<size_t>(sl) * R + (r - j * R));
      });
      cv = pass1(wc, y.rps_c, lane, crow, p.C);
    }
    if (!(lane & 1)) {
      const int col = q * 16 + (lane >> 4) * 8 + ((lane & 15) >> 1);
      ptap[col] = tv;
      pcz[col] = cv;
    }
  }
}

__device__ __forceinline__ void helpers(const Params& p, const Layout& y, const Smem& m, int c,
                                        int hw, int nh, int lane) {
  for (int t = 0; t < p.T; ++t) {
    for (int l = hw; l < p.L; l += nh) {
      if (t > 0) mbar_wait(&m.ring_bar[l], (t - 1) & 1);
      pre_item(p, y, m, c, t, l, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&m.pre_bar[l]);
    }
  }
}

template <bool kTeacher>
__device__ __forceinline__ void chain(const Params& p, const Layout& y, const Smem& m, int c,
                                      int lane) {
  const int L = p.L, R = p.R, RD = p.RD, NC = y.nc;
  const int n_mix = p.OUT / 3;
  const float* bdil = static_cast<const float*>(m.at(y.o_bdil, 4 * L * y.z));
  const float* bres = static_cast<const float*>(m.at(y.o_bres, 4 * L * 8 * y.nprs));
  const float* bskip = static_cast<const float*>(m.at(y.o_bskip, 4 * 8 * y.nprs));
  const float* bp1 = static_cast<const float*>(m.at(y.o_bp1, 4 * 16 * y.np1));
  const float* bp2 = static_cast<const float*>(m.at(y.o_bp2, 4 * 16 * y.np2));
  const float* wfirst = static_cast<const float*>(m.at(y.o_wfirst, 4 * R));
  const float* bfirst = static_cast<const float*>(m.at(y.o_bfirst, 4 * R));
  const uint4* wp1 = static_cast<const uint4*>(m.at(y.o_wp1, y.np1 * y.rps_s * kPassRow));
  const uint4* wp2 = static_cast<const uint4*>(m.at(y.o_wp2, y.np2 * y.rps_s * kPassRow));
  const int half = lane >> 4, j = (lane & 15) >> 1;
  const bool even = !(lane & 1);

  // lane d < NC sends to CTA d: its exchange buffers and barriers
  uint32_t rx = 0, rb = 0;
  if (lane < NC) {
    rx = map_rank(smem_addr(m.xbuf), lane);
    rb = map_rank(smem_addr(m.xbar), lane);
  }
  uint32_t e = 0;  // exchanges so far
  // All-gather: every CTA's w8 values (in its `mine`) into xbuf[e % kXBufs]
  // of every CTA, at offset rank * w8. Returns the gathered vector.
  auto exchange = [&](int w8) -> const __nv_bfloat16* {
    const int slot = static_cast<int>(e % kXBufs);
    __syncwarp();
    if (lane < NC) {
      const uint32_t dst = rx + 2 * (slot * y.xw + c * w8), bar = rb + 8 * slot;
      for (int q = 0; q < w8; q += 8)
        st_async16(dst + 2 * q, *reinterpret_cast<const uint4*>(m.mine + q), bar);
    }
    // armed after this CTA's own sends: a part may land first (the tx-count
    // goes below zero), the phase cannot complete before this arrive
    if (lane == 0) mbar_expect_tx(&m.xbar[slot], static_cast<uint32_t>(2 * NC * w8));
    mbar_wait_cluster(&m.xbar[slot], (e / kXBufs) & 1);
    __syncwarp();  // the senders' reads of `mine` before any lane writes it again
    ++e;
    return m.xbuf + slot * y.xw;
  };
  auto xvec = [](const __nv_bfloat16* x) { return [x](int r) { return xrow8(x, r); }; };
  // layer 0's input, bf16(x * w_first + b_first), a pair a lane at a time
  auto embed_h0 = [&](float x) {
    for (int pr = lane; pr < R / 2; pr += 32)
      reinterpret_cast<uint32_t*>(m.h0)[pr] =
          pack_bf16(embed(x, wfirst[2 * pr], bfirst[2 * pr]),
                    embed(x, wfirst[2 * pr + 1], bfirst[2 * pr + 1]));
  };

  embed_h0(kTeacher ? p.x_teacher[0] : 0.f);
  for (int t = 0; t < p.T; ++t) {
    // this step's noise (or the next input), used at its end
    float g0 = 0.f, g1 = 0.f, u = 0.f, xnext = 0.f;
    if (kTeacher) {
      if (t + 1 < p.T) xnext = p.x_teacher[t + 1];
    } else {
      if (lane < n_mix) g0 = p.gumbel[static_cast<size_t>(t) * n_mix + lane];
      if (lane + 32 < n_mix) g1 = p.gumbel[static_cast<size_t>(t) * n_mix + lane + 32];
      u = p.uniform[t];
    }
    for (int i = lane; i < 8 * y.nprs; i += 32) m.skacc[i] = 0.f;
    const int slot = t % RD;
    const __nv_bfloat16* hin = m.h0;
    for (int l = 0; l < L; ++l) {
      __syncwarp();
      if (!kHelpers) pre_item(p, y, m, c, t, l, lane);
      const uint8_t* wl = static_cast<const uint8_t*>(m.at(y.o_layer0 + l * y.layer_bytes,
                                                           y.layer_bytes));
      const uint4* wcur = reinterpret_cast<const uint4*>(wl);
      const uint4* wrs = reinterpret_cast<const uint4*>(wl + y.wcur_bytes);
      // the ring takes this layer's input
      if (lane < kSlices) {
        __nv_bfloat16* dst = p.ring + (static_cast<size_t>((c * L + l) * RD + slot) * R);
        for (int r = lane * y.rps_r; r < (lane + 1) * y.rps_r; r += 8)
          *reinterpret_cast<uint4*>(dst + r) = xrow8(hin, r);
      }
      if (kHelpers) mbar_wait(&m.pre_bar[l], t & 1);
      const float* ptap = m.pre + ((t & 1) * L + l) * y.z;
      const float* pcz = m.pre + ((2 + (t & 1)) * L + l) * y.z;
      // z = ((tap + h @ W_cur) + b_dil) + condz, then the gate
      for (int q = 0; q < y.npz; ++q) {
        const float hp = kProducts ? pass8(wcur + q * y.rps_r * 32, y.rps_r, lane, xvec(hin)) : 0.f;
        const int col = q * 16 + half * 8 + j;
        const float z = __fadd_rn(
            __fadd_rn(__fadd_rn(ptap[col], hp), bdil[l * y.z + col]), pcz[col]);
        const float zb = __shfl_xor_sync(0xffffffffu, z, 16);
        if (lane < 16 && even) m.mine[q * 8 + j] = gate(z, zb);
      }
      __syncwarp();
      if (kHelpers && lane == 0) mbar_arrive(&m.ring_bar[l]);  // after the ring stores
      const __nv_bfloat16* g = exchange(y.g8);
      // [res | skip] = gated @ [W_res | W_skip]: res in lanes 0-15, skip in 16-31
      const bool last = l == L - 1;
      for (int q = 0; q < y.nprs; ++q) {
        const float v = kProducts ? pass8(wrs + q * y.rps_g * 32, y.rps_g, lane, xvec(g)) : 0.f;
        const int col = q * 8 + j;
        if (!even) continue;
        if (half == 0) {
          if (!last && col < y.r8) {
            const float hprev = __bfloat162float(hin[c * y.r8 + col]);
            m.mine[col] = __float2bfloat16_rn(
                __fadd_rn(__fadd_rn(hprev, v), bres[l * 8 * y.nprs + col]));
          }
        } else if (col < y.s8) {
          m.skacc[col] = __fadd_rn(m.skacc[col], v);
        }
      }
      if (!last) hin = exchange(y.r8);
    }

    // the head: gather bf16(relu(skips + b_skip)), this CTA's o1 columns,
    // gather o1, then every CTA the logits
    __syncwarp();
    for (int i = lane; i < y.s8; i += 32)
      m.mine[i] = __float2bfloat16_rn(fmaxf(__fadd_rn(m.skacc[i], bskip[i]), 0.f));
    const __nv_bfloat16* hs = exchange(y.s8);
    for (int q = 0; q < y.np1; ++q) {
      const float v = pass8(wp1 + q * y.rps_s * 32, y.rps_s, lane, xvec(hs));
      const int col = (2 * q + half) * 8 + j;
      if (even && col < y.s8)
        m.mine[col] = __float2bfloat16_rn(fmaxf(__fadd_rn(v, bp1[col]), 0.f));
    }
    const __nv_bfloat16* o1 = exchange(y.s8);
    for (int q = 0; q < y.np2; ++q) {
      const float v = pass8(wp2 + q * y.rps_s * 32, y.rps_s, lane, xvec(o1));
      const int col = (2 * q + half) * 8 + j;
      if (even && col < p.OUTP) m.logits[col] = __fadd_rn(v, bp2[col]);
    }
    __syncwarp();
    float x;
    if (kTeacher) {
      if (c == 0)
        for (int k = lane; k < p.OUT; k += 32)
          p.out[static_cast<size_t>(t) * p.OUT + k] = m.logits[k];
      x = xnext;
    } else {
      if (lane < n_mix) m.score[lane] = __fadd_rn(m.logits[lane], g0);
      if (lane + 32 < n_mix) m.score[lane + 32] = __fadd_rn(m.logits[lane + 32], g1);
      __syncwarp();
      x = 0.f;
      if (lane == 0) {
        int best = 0;
        float best_s = m.score[0];
        for (int k = 1; k < n_mix; ++k) {
          const float s = m.score[k];
          if (s > best_s) {
            best_s = s;
            best = k;
          }
        }
        const float mean = m.logits[n_mix + best];
        const float ls = fmaxf(m.logits[2 * n_mix + best], kLogScaleMin);
        const float uc = fminf(fmaxf(u, kULo), kUHi);
        const float noise = __fsub_rn(logf(uc), log1pf(-uc));
        x = fminf(fmaxf(__fadd_rn(mean, __fmul_rn(expf(ls), noise)), -1.f), 1.f);
        if (c == 0) p.out[t] = x;
      }
      x = __shfl_sync(0xffffffffu, x, 0);
    }
    embed_h0(x);
  }
}

template <bool kTeacher>
__global__ void __launch_bounds__(kThreads, 1) wavenet_gen_kernel(const Params p, const Layout y) {
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* buf = smem + y.res;
  Smem m;
  m.base = smem;
  m.gres = p.res + static_cast<size_t>(c) * y.rb;
  m.gstr = p.stream + static_cast<size_t>(c) * y.sb;
  m.pre = reinterpret_cast<float*>(buf + y.b_pre);
  m.xbuf = reinterpret_cast<__nv_bfloat16*>(buf + y.b_xbuf);
  m.h0 = reinterpret_cast<__nv_bfloat16*>(buf + y.b_h0);
  m.mine = reinterpret_cast<__nv_bfloat16*>(buf + y.b_mine);
  m.skacc = reinterpret_cast<float*>(buf + y.b_skacc);
  m.logits = reinterpret_cast<float*>(buf + y.b_logits);
  m.score = reinterpret_cast<float*>(buf + y.b_score);
  m.xbar = reinterpret_cast<uint64_t*>(buf + y.b_bars);
  m.ring_bar = m.xbar + kXBufs;
  m.pre_bar = m.ring_bar + p.L;
  uint64_t* load_bar = m.pre_bar + p.L;
  m.res = y.res;

  if (tid == 0) {
    for (int i = 0; i < kXBufs; ++i) mbar_init(&m.xbar[i], 1);
    for (int l = 0; l < p.L; ++l) {
      mbar_init(&m.ring_bar[l], 1);
      mbar_init(&m.pre_bar[l], 1);
    }
    mbar_init(load_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (y.res > 0) {
      mbar_expect_tx(load_bar, static_cast<uint32_t>(y.res));
      for (int o = 0; o < y.res; o += kLoadChunk)
        bulk_load(smem + o, m.gres + o, static_cast<uint32_t>(min(kLoadChunk, y.res - o)),
                  load_bar);
    }
  }
  cluster.sync();  // every CTA's barriers are initialised before a peer signals one
  if (y.res > 0) mbar_wait(load_bar, 0);

  if (warp == 0)
    chain<kTeacher>(p, y, m, c, lane);
  else if (kHelpers)
    helpers(p, y, m, c, warp - 1, kWarps - 1, lane);
  cluster.sync();  // no CTA leaves while a peer may still write into it
}

cudaError_t prepare(const void* kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t config(const Layout& y, cudaLaunchAttribute* attr, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = y.nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(y.nc);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = y.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// The launch for this shape and cluster size: info = [shared memory per
// CTA, resident bytes per CTA, resident blob bytes per CTA, streamed blob
// bytes per CTA, threads per CTA, registers per thread, spilled bytes per
// thread (local memory), cudaOccupancyMaxActiveClusters]. Returns 0, a
// cudaError_t or kErrLayout.
int wavenet_gen_plan(int L, int K, int R, int G2, int S, int C, int OUTP, int nc, int teacher,
                     int* info) {
  Layout y;
  if (make_layout(L, K, R, G2, S, C, OUTP, nc, &y)) return kErrLayout;
  const void* kernel = teacher ? reinterpret_cast<const void*>(wavenet_gen_kernel<true>)
                               : reinterpret_cast<const void*>(wavenet_gen_kernel<false>);
  cudaError_t err = prepare(kernel, y.smem);
  cudaFuncAttributes attr = {};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int clusters = 0;
  if (err == cudaSuccess) {
    cudaLaunchAttribute a[1];
    const cudaLaunchConfig_t cfg = config(y, a, nullptr);
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
      clusters = 0;
      cudaGetLastError();  // a cluster that does not fit is reported as 0, not as an error
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = y.smem;
  info[1] = y.res;
  info[2] = y.rb;
  info[3] = y.sb;
  info[4] = kThreads;
  info[5] = attr.numRegs;
  info[6] = static_cast<int>(attr.localSizeBytes);
  info[7] = clusters;
  return 0;
}

// Launches one cluster of nc CTAs on `stream`; returns 0, a cudaError_t,
// kErrLayout or kErrMismatch (smem is the caller's shared memory per CTA,
// which must equal the kernel's). The caller guarantees contiguous tensors
// on the current device laid out by kernel_weights for this nc, T >= 1 and
// a zeroed ring.
int wavenet_gen_launch(const void* res, const void* stream_blob, const void* c_up, const int* dil,
                       const float* gumbel, const float* uniform, const float* x_teacher,
                       void* ring, float* out, int T, int L, int K, int R, int G2, int S, int C,
                       int OUT, int OUTP, int RD, int nc, int smem, int teacher, void* stream) {
  Layout y;
  if (make_layout(L, K, R, G2, S, C, OUTP, nc, &y)) return kErrLayout;
  if (smem != y.smem) return kErrMismatch;
  Params p;
  p.res = static_cast<const uint8_t*>(res);
  p.stream = static_cast<const uint8_t*>(stream_blob);
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
  p.G2 = G2;
  p.S = S;
  p.C = C;
  p.OUT = OUT;
  p.OUTP = OUTP;
  p.RD = RD;
  const void* kernel = teacher ? reinterpret_cast<const void*>(wavenet_gen_kernel<true>)
                               : reinterpret_cast<const void*>(wavenet_gen_kernel<false>);
  cudaError_t err = prepare(kernel, y.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute a[1];
  const cudaLaunchConfig_t cfg = config(y, a, static_cast<cudaStream_t>(stream));
  err = teacher ? cudaLaunchKernelEx(&cfg, wavenet_gen_kernel<true>, p, y)
                : cudaLaunchKernelEx(&cfg, wavenet_gen_kernel<false>, p, y);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* wavenet_gen_error_string(int code) {
  switch (code) {
    case kErrLayout:
      return "the shape has no layout for this cluster size";
    case kErrMismatch:
      return "the caller's shared-memory layout differs from the kernel's";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
