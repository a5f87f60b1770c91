// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// that emits O and lse = m + log(l).
//
// Replaces the TPU kernel `_fwd_kernel` (distributed_pytorch_tpu/ops/
// flash_attention.py:166-232, launched by `_flash_fwd` through
// pl.pallas_call at :272). Same function, same masking contract:
//   * padded keys (col >= s_k) never count;
//   * causal: col > row + (s_k - s_q) + diag_offset - causal_offset is
//     masked (causal_offset 1 masks the diagonal too);
//   * window: col <= row + (s_k - s_q) + diag_offset - window is masked;
//   * whole k-tiles outside the causal/window frontier are skipped (the
//     range below is `_frontier_ok` solved for ik);
//   * GQA: q head hi reads kv head hi / (h / h_kv), no replication;
//   * a row that saw no visible key is NaN; its lse is the _MASK
//     sentinel (the TPU kernel's value for it too).
// Softmax statistics m, l and the accumulator are float32; p is rounded
// to the input type before the p.v product (the TPU kernel's
// `p.astype(v.dtype)`), and masked logits take the finite _MASK
// sentinel so a fully masked tile never makes NaN in the rescale.
//
// Two designs, picked by dtype in the C entry (not a fallback):
//
// bfloat16 -- flash_fwd_kernel_sm90: one warpgroup (128 threads) per
// (q-tile of 64 rows, b*h), looping over its k-tiles of kBK keys (the TPU
// grid's sequential axis). Thread 0 loads the q tile once and the k/v
// tiles into a ring of kStages stages with TMA (4-D descriptors over the
// tensors' own strides, 128B swizzle, zero fill past the sequence), each
// stage completed on an mbarrier; the next tiles are in flight while the
// warpgroup computes. S = q.k^T is a wgmma with both operands in shared
// memory; masking and the online softmax run on the f32 accumulator in
// registers (a row's four lanes reduce with two shuffles, exp2 with the
// scale folded in; only tiles that cross the causal/window/padding edge
// evaluate the mask per element); p is rounded to bf16 in registers and
// is the register A operand of O += p.v, where v is read MN-major
// straight from its [key][d] tile. The products are pipelined one tile
// deep: the softmax of tile t runs while the tensor cores finish p.v of
// tile t - 1. O is staged through shared memory for coalesced stores.
// What bounds it on the H100: at the serving and training shapes (S =
// 1024 - 2048, D = 64, causal) attention does ~S/2 FLOP per byte of
// q/k/v/o, far above the card's ~295 FLOP/byte bf16 ridge, so the bound is
// the tensor cores (989 TFLOP/s); this design reaches them with wgmma and
// hides the loads behind TMA, but keeps one warpgroup per block (no
// producer warp, no second consumer warpgroup): several blocks per SM
// overlap each other's products and softmax.
//
// float32 -- flash_fwd_kernel: the scalar design, kept so f32 stays exact
// float32 arithmetic (tensor cores would round the products to TF32).
// One block of 256 per (q-tile of 64 rows, b*h); each thread owns a 4 x 4
// micro-tile of the 64 x 64 logits and a 4 x D/16 slice of the output
// accumulator, fed from float32 tiles in shared memory; row max and row
// sum are reduced over the 16 lanes of a half-warp with shuffles. Bounded
// by the SM's FMA and shared-memory rates (67 TFLOP/s f32 peak).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kTX = 16;          // threads across a tile's columns
constexpr int kTY = 16;          // threads across a tile's rows
constexpr int kThreads = kTX * kTY;
constexpr int kRM = kBQ / kTY;   // rows per thread
constexpr int kCN = kBK / kTX;   // logit columns per thread
// -0.7 * FLT_MAX, the TPU kernel's _MASK
constexpr float kMask = (float)(-0.7 * 3.40282346638528859812e+38);

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int h, h_kv, s_q, s_k, n_q;
  float scale;
  int causal, window, causal_offset, diag_offset;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ long long floor_div(long long a,
                                                        long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int kDC = D / kTX;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                       // kBQ x (D + 1)
  float* ks = qs + kBQ * (D + 1);         // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);         // kBK x D
  float* ps = vs + kBK * D;               // kBQ x kBK

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int iq = p.n_q - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int hk = hi / (p.h / p.h_kv);
  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  const int q0 = iq * kBQ;
  const long long off = (long long)p.s_k - p.s_q + p.diag_offset;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, gr = q0 + r;
    qs[r * (D + 1) + c] = gr < p.s_q ? to_f(q[gr * p.q_ss + c]) : 0.f;
  }

  // k-tiles that intersect the visible band of this q-tile
  long long t_lo = 0, t_hi = (p.s_k + kBK - 1) / kBK - 1;
  if (p.causal) {
    const long long last = floor_div(q0 + kBQ - 1 + off, kBK);
    t_hi = last < t_hi ? last : t_hi;
    if (p.window > 0) {
      const long long first = floor_div(q0 + off - p.window + 1, kBK);
      t_lo = first > 0 ? first : 0;
    }
  }

  float m[kRM], l[kRM], acc[kRM][kDC];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;
  }

  for (long long t = t_lo; t <= t_hi; ++t) {
    const int k0 = (int)t * kBK;
    __syncthreads();  // q loaded / the previous tile fully consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, gr = k0 + r;
      const bool in = gr < p.s_k;
      ks[r * (D + 1) + c] = in ? to_f(k[gr * p.k_ss + c]) : 0.f;
      vs[r * D + c] = in ? to_f(v[gr * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[kRM][kCN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRM], kv[kCN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) qv[i] = qs[(ty * kRM + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCN; ++j) kv[j] = ks[(tx + kTX * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kCN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const long long row = q0 + ty * kRM + i;
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const long long col = k0 + tx + kTX * j;
        bool masked = col >= p.s_k;
        if (p.causal) masked = masked || col > row + off - p.causal_offset;
        if (p.window > 0) masked = masked || col <= row + off - p.window;
        s[i][j] = masked ? kMask : s[i][j] * p.scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const float pj = expf(s[i][j] - m_new);
        rs += pj;
        ps[(ty * kRM + i) * kBK + tx + kTX * j] = to_f(from_f<T>(pj));
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) pv[i] = ps[(ty * kRM + i) * kBK + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) {
        const float vv = vs[c * D + tx + kTX * j];
#pragma unroll
        for (int i = 0; i < kRM; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* o = static_cast<T*>(p.o) + (long long)bh * p.s_q * D;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = q0 + ty * kRM + i;
    if (row >= p.s_q) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const bool no_logit = m[i] == kMask;
#pragma unroll
    for (int j = 0; j < kDC; ++j)
      o[(long long)row * D + tx + kTX * j] =
          from_f<T>(no_logit ? __int_as_float(0x7fc00000) : acc[i][j] / l_safe);
    if (tx == 0) p.lse[(long long)bh * p.s_q + row] = m[i] + logf(l_safe);
  }
}

// ---- bfloat16: wgmma + TMA ------------------------------------------

// Tile shape of the bf16 kernel, from an H100 sweep
// (`python -m distributed_pytorch_tpu_torch.ops.flash_tile_sweep`, which
// rebuilds this file with -D overrides of these two).
#ifndef DPX_SM90_FWD_BK
#define DPX_SM90_FWD_BK 64       // keys per k-tile at head size 64
#endif
#ifndef DPX_SM90_FWD_STAGES
#define DPX_SM90_FWD_STAGES 3    // k/v ring depth
#endif
constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kStages = DPX_SM90_FWD_STAGES;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Sm90Layout {
  static constexpr int kBK = D == 64 ? DPX_SM90_FWD_BK : 64;
  static constexpr int kQBytes = kBQ * D * 2;    // q tile (later: O staging)
  static constexpr int kKVBytes = kBK * D * 2;   // one k or one v tile
  static constexpr int kBytes = kQBytes + kStages * 2 * kKVBytes;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const Params p) {
  using L = Sm90Layout<D>;
  constexpr int kBK = L::kBK;    // this kernel's k-tile, not the scalar one
  constexpr int kAtoms = D / sm90::kAtomCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_kv[kStages];
  uint8_t* qs = sm90::align_1024(smem_raw);
  uint8_t* kv = qs + L::kQBytes;   // stage s: k at s * 2 * kKVBytes, then v

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int iq = p.n_q - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int hk = hi / (p.h / p.h_kv);
  const int q0 = iq * kBQ;
  const long long off = (long long)p.s_k - p.s_q + p.diag_offset;

  // k-tiles that intersect the visible band of this q-tile
  long long t_lo = 0, t_hi = (p.s_k + kBK - 1) / kBK - 1;
  if (p.causal) {
    const long long last = floor_div(q0 + kBQ - 1 + off, kBK);
    t_hi = last < t_hi ? last : t_hi;
    if (p.window > 0) {
      const long long first = floor_div(q0 + off - p.window + 1, kBK);
      t_lo = first > 0 ? first : 0;
    }
  }
  const int n_t = t_hi >= t_lo ? (int)(t_hi - t_lo + 1) : 0;

  auto load_kv = [&](int it) {
    const int s = it % kStages;
    uint8_t* ks = kv + s * 2 * L::kKVBytes;
    uint8_t* vs = ks + L::kKVBytes;
    const int k0 = (int)(t_lo + it) * kBK;
    sm90::mbar_expect_tx(&bar_kv[s], 2 * L::kKVBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      sm90::tma_load_4d(ks + a * kBK * sm90::kLineBytes, &tm_k, &bar_kv[s],
                        a * sm90::kAtomCols, k0, hk, bi);
      sm90::tma_load_4d(vs + a * kBK * sm90::kLineBytes, &tm_v, &bar_kv[s],
                        a * sm90::kAtomCols, k0, hk, bi);
    }
  };

  if (tid == 0) {
    sm90::mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&bar_kv[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar_q, L::kQBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      sm90::tma_load_4d(qs + a * kBQ * sm90::kLineBytes, &tm_q, &bar_q,
                        a * sm90::kAtomCols, q0, hi, bi);
    for (int it = 0; it < kStages && it < n_t; ++it) load_kv(it);
  }

  // this thread's rows of the 64-row tile: r_lo and r_lo + 8
  const int r_lo = 16 * warp + lane / 4;
  const int c_q = 2 * (lane % 4);
  const float scale2 = p.scale * kLog2e;   // logits in log2 units
  const int off32 = (int)off;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[kBK / 2];
  uint32_t pa[kBK / 16][4];

  // S = q . k^T of the tile in stage s into sc (one commit group)
  auto issue_s = [&](int s) {
    const uint8_t* ks = kv + s * 2 * L::kKVBytes;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<0>(sc, sm90::desc_kmajor(qs, kBQ, kk),
                        sm90::desc_kmajor(ks, kBK, kk), 1);
    sm90::wgmma_commit();
  };
  // O += p . v with p the bf16 fragments pa and v in stage s
  auto issue_pv = [&](int s) {
    const uint8_t* vs = kv + s * 2 * L::kKVBytes + L::kKVBytes;
    sm90::fence_regs(o);
    sm90::fence_regs(pa);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      sm90::wgmma_rs<1>(o, pa[kk], sm90::desc_mnmajor(vs, kBK, kk), 1);
    sm90::wgmma_commit();
  };
  // mask and scale sc (tile `it`), fold it into m and l, leave p in sc;
  // returns the rescale factors of the accumulator rows in alpha
  auto softmax = [&](int it, float (&alpha)[2]) {
    const int k0 = (int)(t_lo + it) * kBK;
    // only tiles that cross an edge pay for the per-element mask
    const bool edge =
        k0 + kBK > p.s_k ||
        (p.causal && k0 + kBK - 1 > q0 + off32 - p.causal_offset) ||
        (p.window > 0 && k0 <= q0 + kBQ - 1 + off32 - p.window);
    float mx[2] = {m[0], m[1]};
    if (edge) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int row = q0 + r_lo + 8 * ((i % 4) / 2);
        const int col = k0 + 8 * (i / 4) + c_q + (i % 2);
        bool masked = col >= p.s_k;
        if (p.causal) masked = masked || col > row + off32 - p.causal_offset;
        if (p.window > 0) masked = masked || col <= row + off32 - p.window;
        sc[i] = masked ? kMask : sc[i] * scale2;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] *= scale2;
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int rh = (i % 4) / 2;
      mx[rh] = fmaxf(mx[rh], sc[i]);
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 1));
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 2));
      alpha[rh] = exp2f(m[rh] - mx[rh]);
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int rh = (i % 4) / 2;
      sc[i] = exp2f(sc[i] - mx[rh]);
      rs[rh] += sc[i];
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      rs[rh] += __shfl_xor_sync(0xffffffffu, rs[rh], 1);
      rs[rh] += __shfl_xor_sync(0xffffffffu, rs[rh], 2);
      l[rh] = alpha[rh] * l[rh] + rs[rh];
      m[rh] = mx[rh];
    }
  };
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i % 4) / 2];
    sm90::acc_to_a<kBK>(sc, pa);
  };

  // Software pipeline: while the softmax of tile it runs on the CUDA
  // cores, the tensor cores finish O += p.v of tile it - 1.
  sm90::mbar_wait(&bar_q, 0);
  if (n_t > 0) {
    float alpha[2];
    sm90::mbar_wait(&bar_kv[0], 0);
    issue_s(0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    softmax(0, alpha);
    rescale_and_pack(alpha);
  }
  for (int it = 1; it < n_t; ++it) {
    const int s = it % kStages;
    float alpha[2];
    sm90::mbar_wait(&bar_kv[s], (it / kStages) & 1);
    issue_s(s);
    issue_pv((it - 1) % kStages);
    sm90::wgmma_wait<1>();   // S of tile it (p.v of it - 1 may still run)
    sm90::fence_regs(sc);
    softmax(it, alpha);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(pa);
    rescale_and_pack(alpha);
    // tile it - 1's stage is free: refill it kStages tiles ahead
    if (it - 1 + kStages < n_t) {
      __syncthreads();
      if (tid == 0) load_kv(it - 1 + kStages);
    }
  }
  if (n_t > 0) {
    issue_pv((n_t - 1) % kStages);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
  }

  // epilogue: O = acc / l in bf16 through shared memory (the q tile's
  // space, free once every product has completed), lse = m + log l
  __syncthreads();
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(qs);
  float l_safe[2];
  bool no_logit[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    l_safe[rh] = l[rh] == 0.f ? 1.f : l[rh];
    no_logit[rh] = m[rh] == kMask;
  }
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = r_lo + 8 * rh;
      const float x0 = no_logit[rh] ? nan : o[4 * j + 2 * rh] / l_safe[rh];
      const float x1 =
          no_logit[rh] ? nan : o[4 * j + 2 * rh + 1] / l_safe[rh];
      *reinterpret_cast<__nv_bfloat162*>(
          os + row * D + ((j ^ (row & 7)) * 8) + c_q) =
          __floats2bfloat162_rn(x0, x1);
    }
  __syncthreads();
  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(p.o) + (long long)bh * p.s_q * D;
  for (int idx = tid; idx < kBQ * D / 8; idx += kWgThreads) {
    const int row = idx / (D / 8), ch = idx % (D / 8);
    if (q0 + row >= p.s_q) continue;
    *reinterpret_cast<int4*>(out + (long long)(q0 + row) * D + ch * 8) =
        *reinterpret_cast<const int4*>(os + row * D + ((ch ^ (row & 7)) * 8));
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = q0 + r_lo + 8 * rh;
      if (row < p.s_q)
        p.lse[(long long)bh * p.s_q + row] =
            no_logit[rh] ? kMask : m[rh] * kLn2 + logf(l_safe[rh]);
    }
  }
}

template <int D>
int launch_sm90(const Params& p, int b, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = sm90_host::tmap_bf16(&tm_q, p.q, D, p.s_q, p.h, b, p.q_ss, p.q_sh,
                                p.q_sb, kBQ);
  if (rc == 0)
    rc = sm90_host::tmap_bf16(&tm_k, p.k, D, p.s_k, p.h_kv, b, p.k_ss,
                              p.k_sh, p.k_sb, Sm90Layout<D>::kBK);
  if (rc == 0)
    rc = sm90_host::tmap_bf16(&tm_v, p.v, D, p.s_k, p.h_kv, b, p.v_ss,
                              p.v_sh, p.v_sb, Sm90Layout<D>::kBK);
  if (rc != 0) return rc;
  const int smem = Sm90Layout<D>::kBytes + 1024;  // + 1024-byte alignment
  // the shared-memory opt-in is set once per device, not per launch
  static unsigned long long opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(opted_in >> dev & 1ull)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel_sm90<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted_in |= 1ull << dev;
  }
  flash_fwd_kernel_sm90<D><<<dim3(p.n_q, b * p.h), kWgThreads, smem,
                             stream>>>(tm_q, tm_k, tm_v, p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kBK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T, D><<<dim3(p.n_q, bh), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes. dtype: 0 float32 (scalar kernel), 1 bfloat16
// (wgmma + TMA kernel). window <= 0 means no window. Strides are in
// elements; the last axis of q, k and v is contiguous, o is contiguous
// (B, H, Sq, D), lse contiguous (B, H, Sq). For bfloat16 the base of q, k
// and v is 16-byte aligned and every other stride a multiple of 8 (TMA).
// Returns the cudaGetLastError() code of the launch (0 on success), -1
// for a dtype / head size this kernel does not take, -2 / -3 when the
// libcuda offers no TMA encoder / the encoder refuses a descriptor.
extern "C" int dpx_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    int b, int h, int h_kv, int s_q, int s_k, int d, int dtype,
    float scale, int causal, int window, int causal_offset,
    int diag_offset, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.h = h; p.h_kv = h_kv; p.s_q = s_q; p.s_k = s_k;
  p.n_q = (s_q + kBQ - 1) / kBQ;
  p.scale = scale; p.causal = causal; p.window = window;
  p.causal_offset = causal_offset; p.diag_offset = diag_offset;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = b * h;
  if (dtype == 0 && d == 64) return launch<float, 64>(p, bh, st);
  if (dtype == 0 && d == 128) return launch<float, 128>(p, bh, st);
  if (dtype == 1 && d == 64) return launch_sm90<64>(p, b, st);
  if (dtype == 1 && d == 128) return launch_sm90<128>(p, b, st);
  return -1;
}
