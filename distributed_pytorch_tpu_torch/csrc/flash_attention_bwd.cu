// Flash-attention backward for Hopper (sm_90a): the dK/dV kernel and the
// dQ kernel, FlashAttention-2's split of the backward.
//
// Replaces the TPU kernels `_bwd_dkv_kernel` (distributed_pytorch_tpu/ops/
// flash_attention.py:326-368, pl.pallas_call at :456) and `_bwd_dq_kernel`
// (:371-406, pl.pallas_call at :479), both launched by `_flash_bwd`
// (:409-504). Same function, same masking contract as the forward kernel
// (csrc/flash_attention_fwd.cu) plus padded query rows:
//   * p = exp(s * scale - lse) is recomputed per tile and forced to exact
//     zeros where masked: padded keys, padded q rows, the causal future
//     (col > row + (s_k - s_q) + diag_offset - causal_offset) and the
//     window's lower edge (col <= row + (s_k - s_q) + diag_offset - window);
//   * ds = p * (dp - delta) * scale with dp = dO . v^T and delta the
//     per-row sum_d dO * O (minus the lse cotangent), computed on the host;
//   * dV += p^T . dO, dK += ds^T . q, dQ += ds . k, all accumulated in
//     float32; p and ds are rounded to the input type before their
//     products, as the TPU kernels do (`p.astype(do.dtype)`,
//     `ds.astype(q.dtype)`);
//   * whole tiles outside the causal/window band are skipped: the dQ
//     kernel walks the forward's k-tile range, the dK/dV kernel the q-tile
//     range of the same `_frontier_ok` solved for the q-tile index.
// lse and delta are (B, H, Sq) float32 rows with row stride `ld`.
//
// dK/dV: one block per (k-tile of 64 keys, b * h_kv). It loops over the g
// query heads of its kv group and their q-tiles itself (the TPU grid's
// sequential axis), so the GQA group sum happens in its float32 registers
// and dK/dV are written once as (B, Hkv, Sk, D): no per-q-head partials,
// no atomics, deterministic. Two designs, picked by dtype in the C entry:
//   * bfloat16 -- flash_bwd_dkv_kernel_sm90, FlashAttention-3's form with
//     keys as the rows: one warpgroup (128 threads); thread 0 loads the k
//     and v tiles once and each q-tile's q, dO, lse and delta into a ring
//     of kStages stages with TMA (completed on mbarriers), the next tiles
//     in flight while the warpgroup computes. S^T = k.q^T and dP^T =
//     v.dO^T are wgmma products from shared memory; p^T and ds^T are
//     formed on the f32 accumulators in registers, rounded to bf16 there
//     and used as the register A operand of dV += p^T.dO and dK += ds^T.q,
//     whose B operands (dO, q) are read MN-major from the same tiles.
//     The next q-tile's S^T and dP^T are issued right behind dV/dK, so
//     p^T is formed while the tensor cores finish dP^T; only tiles that
//     cross the causal/window/padding edge evaluate the mask per element.
//     What bounds it on the H100: 8 D FLOPs per visible (query, key) pair
//     against ~4 bytes per pair, compute-bound at the tensor cores' 989
//     TFLOP/s; one warpgroup per block runs its elementwise work between
//     the products (several blocks per SM overlap each other).
//   * float32 -- flash_bwd_dkv_kernel: the scalar design, exact f32.
// dQ: one block per (q-tile of 64 rows, b * h), heaviest causal tiles
// first, looping over the forward's k-tile range (the TPU grid's
// sequential axis and its dq scratch); GQA reads kv head hi / (h / h_kv);
// dQ is written once, no atomics, deterministic. Two designs, by dtype:
//   * bfloat16 -- flash_bwd_dq_kernel_sm90, the forward's structure with
//     the dK/dV kernel's recompute: one warpgroup; thread 0 loads q, dO,
//     lse and delta once and the k/v tiles into a ring of kDqStages
//     stages with TMA. S = q.k^T and dP = dO.v^T are wgmma products from
//     shared memory; each thread owns two q rows of the accumulator, so
//     lse and delta are four registers loaded once; p and ds are formed
//     on the f32 accumulators, ds rounded to bf16 in registers as the A
//     operand of dQ += ds.k, whose B operand k is read MN-major from the
//     tile S read K-major. The next k-tile's S and dP are issued right
//     behind dQ; only tiles that cross an edge evaluate the mask per
//     element. Bound on the H100: 6 D FLOPs per visible (query, key)
//     pair, compute-bound at the tensor cores like dK/dV.
//   * float32 -- flash_bwd_dq_kernel: the scalar design, exact f32.
// The scalar kernels use 256 threads, each owning a 4 x 4 micro-tile of a
// 64 x 64 logits tile (rows 4*ty .. 4*ty+3, cols tx + 16*j) and a 4 x D/16
// slice of its accumulator, fed from float32 tiles in shared memory (67
// TFLOP/s f32 peak, bounded in practice by the shared-memory loads: ~2
// FMA per load). Every output element is summed by one thread in a fixed
// order, so every kernel here is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // keys per tile
constexpr int kTX = 16;          // threads across a tile's columns
constexpr int kTY = 16;          // threads across a tile's rows
constexpr int kThreads = kTX * kTY;
constexpr int kRM = kBQ / kTY;   // rows per thread
constexpr int kCN = kBK / kTX;   // logit columns per thread
constexpr int kLP = kBK + 1;     // padded row of a p / ds tile in smem
// -0.7 * FLT_MAX, the TPU kernel's _MASK
constexpr float kMask = (float)(-0.7 * 3.40282346638528859812e+38);

static_assert(kBQ == kBK, "the accumulator layouts assume square tiles");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, H, Sq), row stride ld
  const float* delta;   // (B, H, Sq), row stride ld
  void* dq;             // (B, H, Sq, D) contiguous
  void* dk;             // (B, Hkv, Sk, D) contiguous
  void* dv;             // (B, Hkv, Sk, D) contiguous
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  int h, h_kv, s_q, s_k, n_q, n_k, ld;
  float scale;
  int causal, window, causal_offset, diag_offset;
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to T and widened back: the TPU kernels' `.astype(dtype)`
// before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__host__ __device__ __forceinline__ long long floor_div(long long a,
                                                        long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// rows [r0, r0 + 64) of a (S, D) slice with row stride `ss` into a
// 64 x (D + 1) float32 tile; rows at or past `limit` read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int limit) {
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, gr = r0 + r;
    dst[r * (D + 1) + c] = gr < limit ? to_f(src[gr * ss + c]) : 0.f;
  }
}

// acc[i][j] = sum_d a[4*ty + i][d] * b[tx + 16*j][d] over 64 x (D + 1)
// tiles: q . k^T or dO . v^T for this thread's micro-tile
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int tx, int ty,
                                         float (&acc)[kRM][kCN]) {
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kCN; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[kRM], bv[kCN];
#pragma unroll
    for (int i = 0; i < kRM; ++i) av[i] = a[(ty * kRM + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kCN; ++j) bv[j] = b[(tx + kTX * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool masked_at(const Params& p, long long row,
                                          long long col, long long off) {
  bool m = col >= p.s_k || row >= p.s_q;
  if (p.causal) m = m || col > row + off - p.causal_offset;
  if (p.window > 0) m = m || col <= row + off - p.window;
  return m;
}

// p and ds of this thread's micro-tile from the raw q.k^T (s) and dO.v^T
// (dp) products; stores p (rounded, when ps != nullptr) and ds (rounded)
// into their 64 x kLP smem tiles
template <typename T>
__device__ __forceinline__ void p_and_ds(
    const Params& p, const float (&s)[kRM][kCN], const float (&dp)[kRM][kCN],
    const float* lse_s, const float* delta_s, int q0, int k0, long long off,
    int tx, int ty, float* ps, float* dss) {
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = ty * kRM + i;
    const long long row = q0 + r;
    const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
    for (int j = 0; j < kCN; ++j) {
      const int c = tx + kTX * j;
      const bool m = masked_at(p, row, (long long)k0 + c, off);
      const float pij = m ? 0.f : expf(s[i][j] * p.scale - lse);
      const float ds = pij * (dp[i][j] - delta) * p.scale;
      if (ps != nullptr) ps[r * kLP + c] = round_to<T>(pij);
      dss[r * kLP + c] = round_to<T>(ds);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int kDC = D / kTX;   // accumulator columns per thread
  constexpr int kLD = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;                  // kBK x kLD
  float* vs = ks + kBK * kLD;        // kBK x kLD
  float* qs = vs + kBK * kLD;        // kBQ x kLD
  float* dos = qs + kBQ * kLD;       // kBQ x kLD
  float* ps = dos + kBQ * kLD;       // kBQ x kLP, [q row][key]
  float* dss = ps + kBQ * kLP;       // kBQ x kLP
  float* lse_s = dss + kBQ * kLP;    // kBQ
  float* delta_s = lse_s + kBQ;      // kBQ

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int ik = blockIdx.x;         // low k-tiles see the most q-tiles
  const int bhk = blockIdx.y;
  const int bi = bhk / p.h_kv;
  const int hk = bhk % p.h_kv;
  const int g = p.h / p.h_kv;
  const int k0 = ik * kBK;
  const long long off = (long long)p.s_k - p.s_q + p.diag_offset;

  load_tile<T, D>(ks, static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh,
                  p.k_ss, k0, p.s_k);
  load_tile<T, D>(vs, static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh,
                  p.v_ss, k0, p.s_k);

  // q-tiles whose rows see any key of this tile (the forward's frontier
  // solved for the q-tile index)
  long long t_lo = 0, t_hi = p.n_q - 1;
  if (p.causal) {
    const long long first = floor_div((long long)k0 - off, kBQ);
    t_lo = first > 0 ? first : 0;
    if (p.window > 0) {
      const long long last =
          floor_div((long long)k0 + kBK + p.window - off - 2, kBQ);
      t_hi = last < t_hi ? last : t_hi;
    }
  }

  // dK / dV of keys 4*ty + i, columns tx + 16*j
  float dk[kRM][kDC], dv[kRM][kDC];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int hg = 0; hg < g; ++hg) {
    const int hi = hk * g + hg;
    const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + bi * p.do_sb +
                    hi * p.do_sh;
    const long long row_base = ((long long)bi * p.h + hi) * p.ld;
    for (long long t = t_lo; t <= t_hi; ++t) {
      const int q0 = (int)t * kBQ;
      __syncthreads();  // k/v loaded / the previous q-tile fully consumed
      load_tile<T, D>(qs, q, p.q_ss, q0, p.s_q);
      load_tile<T, D>(dos, dout, p.do_ss, q0, p.s_q);
      if (tid < kBQ) {
        const int row = q0 + tid;
        lse_s[tid] = row < p.s_q ? p.lse[row_base + row] : 0.f;
        delta_s[tid] = row < p.s_q ? p.delta[row_base + row] : 0.f;
      }
      __syncthreads();

      float s[kRM][kCN], dp[kRM][kCN];
      tile_dot<D>(qs, ks, tx, ty, s);
      tile_dot<D>(dos, vs, tx, ty, dp);
      p_and_ds<T>(p, s, dp, lse_s, delta_s, q0, k0, off, tx, ty, ps, dss);
      __syncthreads();

      // dV += p^T . dO and dK += ds^T . q over this tile's q rows
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float pv[kRM], dsv[kRM];
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          pv[i] = ps[r * kLP + ty * kRM + i];
          dsv[i] = dss[r * kLP + ty * kRM + i];
        }
#pragma unroll
        for (int j = 0; j < kDC; ++j) {
          const float dov = dos[r * kLD + tx + kTX * j];
          const float qv = qs[r * kLD + tx + kTX * j];
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            dv[i][j] = fmaf(pv[i], dov, dv[i][j]);
            dk[i][j] = fmaf(dsv[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk) + (long long)bhk * p.s_k * D;
  T* dv_out = static_cast<T*>(p.dv) + (long long)bhk * p.s_k * D;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int key = k0 + ty * kRM + i;
    if (key >= p.s_k) continue;
#pragma unroll
    for (int j = 0; j < kDC; ++j) {
      dk_out[(long long)key * D + tx + kTX * j] = from_f<T>(dk[i][j]);
      dv_out[(long long)key * D + tx + kTX * j] = from_f<T>(dv[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  constexpr int kDC = D / kTX;
  constexpr int kLD = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                  // kBQ x kLD
  float* dos = qs + kBQ * kLD;       // kBQ x kLD
  float* ks = dos + kBQ * kLD;       // kBK x kLD
  float* vs = ks + kBK * kLD;        // kBK x kLD
  float* dss = vs + kBK * kLD;       // kBQ x kLP
  float* lse_s = dss + kBQ * kLP;    // kBQ
  float* delta_s = lse_s + kBQ;      // kBQ

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int iq = p.n_q - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int hk = hi / (p.h / p.h_kv);
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  const int q0 = iq * kBQ;
  const long long off = (long long)p.s_k - p.s_q + p.diag_offset;
  const long long row_base = (long long)bh * p.ld;

  load_tile<T, D>(qs, static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh,
                  p.q_ss, q0, p.s_q);
  load_tile<T, D>(dos,
                  static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh,
                  p.do_ss, q0, p.s_q);
  if (tid < kBQ) {
    const int row = q0 + tid;
    lse_s[tid] = row < p.s_q ? p.lse[row_base + row] : 0.f;
    delta_s[tid] = row < p.s_q ? p.delta[row_base + row] : 0.f;
  }

  // the forward's k-tile range for this q-tile
  long long t_lo = 0, t_hi = p.n_k - 1;
  if (p.causal) {
    const long long last = floor_div(q0 + kBQ - 1 + off, kBK);
    t_hi = last < t_hi ? last : t_hi;
    if (p.window > 0) {
      const long long first = floor_div(q0 + off - p.window + 1, kBK);
      t_lo = first > 0 ? first : 0;
    }
  }

  float dq[kRM][kDC];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) dq[i][j] = 0.f;

  for (long long t = t_lo; t <= t_hi; ++t) {
    const int k0 = (int)t * kBK;
    __syncthreads();  // q/dO loaded / the previous k-tile fully consumed
    load_tile<T, D>(ks, k, p.k_ss, k0, p.s_k);
    load_tile<T, D>(vs, v, p.v_ss, k0, p.s_k);
    __syncthreads();

    float s[kRM][kCN], dp[kRM][kCN];
    tile_dot<D>(qs, ks, tx, ty, s);
    tile_dot<D>(dos, vs, tx, ty, dp);
    p_and_ds<T>(p, s, dp, lse_s, delta_s, q0, k0, off, tx, ty, nullptr,
                dss);
    __syncthreads();

    // dQ += ds . k over this tile's keys
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dsv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) dsv[i] = dss[(ty * kRM + i) * kLP + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) {
        const float kv = ks[c * kLD + tx + kTX * j];
#pragma unroll
        for (int i = 0; i < kRM; ++i) dq[i][j] = fmaf(dsv[i], kv, dq[i][j]);
      }
    }
  }

  T* dq_out = static_cast<T*>(p.dq) + (long long)bh * p.s_q * D;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = q0 + ty * kRM + i;
    if (row >= p.s_q) continue;
#pragma unroll
    for (int j = 0; j < kDC; ++j)
      dq_out[(long long)row * D + tx + kTX * j] = from_f<T>(dq[i][j]);
  }
}

// ---- bfloat16 dK/dV: wgmma + TMA ------------------------------------

// q-tile ring depth of the bf16 dK/dV kernel, from an H100 sweep
// (`python -m distributed_pytorch_tpu_torch.ops.flash_tile_sweep`)
#ifndef DPX_SM90_DKV_STAGES
#define DPX_SM90_DKV_STAGES 3
#endif
constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kStages = DPX_SM90_DKV_STAGES;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DkvLayout {
  static constexpr int kTile = 64 * D * 2;     // one 64-row bf16 tile
  static constexpr int kRow = 64 * 4;          // one f32 row term
  static constexpr int kStage = 2 * kTile + 4 * kRow;  // q, dO, lse, delta
  static constexpr int kBytes = 2 * kTile + kStages * kStage;  // + k, v
  static constexpr uint32_t kStageTx = 2 * kTile + 2 * kRow;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_lse,
                          const __grid_constant__ CUtensorMap tm_delta,
                          const Params p) {
  using L = DkvLayout<D>;
  constexpr int kAtoms = D / sm90::kAtomCols;
  static_assert(kBQ == 64 && kBK == 64, "one warpgroup: 64-row tiles");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t bar_q[kStages];
  uint8_t* ks = sm90::align_1024(smem_raw);   // later: dK staging
  uint8_t* vs = ks + L::kTile;                // later: dV staging
  uint8_t* ring = vs + L::kTile;  // stage s: q, dO, lse, delta

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ik = blockIdx.x;
  const int bhk = blockIdx.y;
  const int bi = bhk / p.h_kv;
  const int hk = bhk % p.h_kv;
  const int g = p.h / p.h_kv;
  const int k0 = ik * kBK;
  const long long off = (long long)p.s_k - p.s_q + p.diag_offset;

  // q-tiles whose rows see any key of this tile (the forward's frontier
  // solved for the q-tile index)
  long long t_lo = 0, t_hi = p.n_q - 1;
  if (p.causal) {
    const long long first = floor_div((long long)k0 - off, kBQ);
    t_lo = first > 0 ? first : 0;
    if (p.window > 0) {
      const long long last =
          floor_div((long long)k0 + kBK + p.window - off - 2, kBQ);
      t_hi = last < t_hi ? last : t_hi;
    }
  }
  const int n_t = t_hi >= t_lo ? (int)(t_hi - t_lo + 1) : 0;
  const int n_it = g * n_t;   // (q head of the group, q-tile) pairs

  auto load_q = [&](int it) {
    const int s = it % kStages;
    uint8_t* st = ring + s * L::kStage;
    const int hi = hk * g + it / n_t;
    const int q0 = (int)(t_lo + it % n_t) * kBQ;
    sm90::mbar_expect_tx(&bar_q[s], L::kStageTx);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      sm90::tma_load_4d(st + a * kBQ * sm90::kLineBytes, &tm_q, &bar_q[s],
                        a * sm90::kAtomCols, q0, hi, bi);
      sm90::tma_load_4d(st + L::kTile + a * kBQ * sm90::kLineBytes, &tm_do,
                        &bar_q[s], a * sm90::kAtomCols, q0, hi, bi);
    }
    sm90::tma_load_3d(st + 2 * L::kTile, &tm_lse, &bar_q[s], q0, hi, bi);
    sm90::tma_load_3d(st + 2 * L::kTile + 2 * L::kRow, &tm_delta, &bar_q[s],
                      q0, hi, bi);
  };

  if (tid == 0) {
    sm90::mbar_init(&bar_kv, 1);
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&bar_q[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar_kv, 2 * L::kTile);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      sm90::tma_load_4d(ks + a * kBK * sm90::kLineBytes, &tm_k, &bar_kv,
                        a * sm90::kAtomCols, k0, hk, bi);
      sm90::tma_load_4d(vs + a * kBK * sm90::kLineBytes, &tm_v, &bar_kv,
                        a * sm90::kAtomCols, k0, hk, bi);
    }
    for (int it = 0; it < kStages && it < n_it; ++it) load_q(it);
  }

  // this thread's keys (accumulator rows) r_lo and r_lo + 8, and its
  // q-row columns c_q + 8 j (+ 1)
  const int r_lo = 16 * warp + lane / 4;
  const int c_q = 2 * (lane % 4);
  const float scale2 = p.scale * kLog2e;
  const int off32 = (int)off;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float st[kBQ / 2], dpt[kBQ / 2];
  uint32_t pa[kBQ / 16][4], dsa[kBQ / 16][4];

  auto stage = [&](int it) { return ring + (it % kStages) * L::kStage; };
  // S^T = k . q^T and dP^T = v . dO^T of q-iteration `it` (keys x q
  // rows), one commit group each
  auto issue_s_dp = [&](int it) {
    const uint8_t* qs = stage(it);
    const uint8_t* dos = qs + L::kTile;
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) st[i] = dpt[i] = 0.f;
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<0>(st, sm90::desc_kmajor(ks, kBK, kk),
                        sm90::desc_kmajor(qs, kBQ, kk), 1);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<0>(dpt, sm90::desc_kmajor(vs, kBK, kk),
                        sm90::desc_kmajor(dos, kBQ, kk), 1);
    sm90::wgmma_commit();
  };

  // Software pipeline: S^T and dP^T of q-iteration it + 1 are issued
  // right behind dV/dK of iteration it, so p^T of it + 1 is formed while
  // the tensor cores finish dP^T.
  sm90::mbar_wait(&bar_kv, 0);
  if (n_it > 0) {
    sm90::mbar_wait(&bar_q[0], 0);
    issue_s_dp(0);
  }
  for (int it = 0; it < n_it; ++it) {
    const uint8_t* qs = stage(it);
    const uint8_t* dos = qs + L::kTile;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * L::kTile);
    const float* delta_s = lse_s + 2 * (L::kRow / 4);
    const int q0 = (int)(t_lo + it % n_t) * kBQ;
    // only tiles that cross an edge pay for the per-element mask
    const bool edge =
        k0 + kBK > p.s_k || q0 + kBQ > p.s_q ||
        (p.causal && k0 + kBK - 1 > q0 + off32 - p.causal_offset) ||
        (p.window > 0 && k0 <= q0 + kBQ - 1 + off32 - p.window);

    sm90::wgmma_wait<1>();   // S^T of it (and dV/dK of it - 1) done
    sm90::fence_regs(st);
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    // q-iteration it - 1's stage is free: refill it kStages ahead
    if (it >= 1 && it - 1 + kStages < n_it) {
      __syncthreads();
      if (tid == 0) load_q(it - 1 + kStages);
    }

    // p^T = exp(s * scale - lse), exact zeros where masked
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) {
      const int c = 8 * (i / 4) + c_q + (i % 2);
      st[i] = exp2f(fmaf(st[i], scale2, -lse_s[c] * kLog2e));
    }
    if (edge) {
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) {
        const int row = q0 + 8 * (i / 4) + c_q + (i % 2);   // query row
        const int col = k0 + r_lo + 8 * ((i % 4) / 2);      // key
        bool masked = col >= p.s_k || row >= p.s_q;
        if (p.causal) masked = masked || col > row + off32 - p.causal_offset;
        if (p.window > 0) masked = masked || col <= row + off32 - p.window;
        st[i] = masked ? 0.f : st[i];
      }
    }
    sm90::acc_to_a<kBQ>(st, pa);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dpt);

    // ds^T = p^T (dP^T - delta) scale
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) {
      const int c = 8 * (i / 4) + c_q + (i % 2);
      dpt[i] = st[i] * (dpt[i] - delta_s[c]) * p.scale;
    }
    sm90::acc_to_a<kBQ>(dpt, dsa);

    // dV += p^T . dO and dK += ds^T . q (one commit group)
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::fence_regs(pa);
    sm90::fence_regs(dsa);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      sm90::wgmma_rs<1>(dv, pa[kk], sm90::desc_mnmajor(dos, kBQ, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      sm90::wgmma_rs<1>(dk, dsa[kk], sm90::desc_mnmajor(qs, kBQ, kk), 1);
    sm90::wgmma_commit();

    if (it + 1 < n_it) {
      sm90::mbar_wait(&bar_q[(it + 1) % kStages], ((it + 1) / kStages) & 1);
      issue_s_dp(it + 1);
    } else {
      sm90::wgmma_wait<0>();
    }
    sm90::fence_regs(pa);
    sm90::fence_regs(dsa);
  }
  sm90::fence_regs(dv);
  sm90::fence_regs(dk);

  // epilogue: dK, dV in bf16 through shared memory (the k and v tiles'
  // space, free once every product has completed), coalesced stores
  __syncthreads();
  __nv_bfloat16* dks = reinterpret_cast<__nv_bfloat16*>(ks);
  __nv_bfloat16* dvs = reinterpret_cast<__nv_bfloat16*>(vs);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = r_lo + 8 * rh;
      const int at = row * D + ((j ^ (row & 7)) * 8) + c_q;
      *reinterpret_cast<__nv_bfloat162*>(dks + at) = __floats2bfloat162_rn(
          dk[4 * j + 2 * rh], dk[4 * j + 2 * rh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvs + at) = __floats2bfloat162_rn(
          dv[4 * j + 2 * rh], dv[4 * j + 2 * rh + 1]);
    }
  __syncthreads();
  const long long base = ((long long)bhk * p.s_k + k0) * D;
  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.dk) + base;
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.dv) + base;
  for (int idx = tid; idx < kBK * D / 8; idx += kWgThreads) {
    const int row = idx / (D / 8), ch = idx % (D / 8);
    if (k0 + row >= p.s_k) continue;
    const int at = row * D + ((ch ^ (row & 7)) * 8);
    *reinterpret_cast<int4*>(dk_out + row * D + ch * 8) =
        *reinterpret_cast<const int4*>(dks + at);
    *reinterpret_cast<int4*>(dv_out + row * D + ch * 8) =
        *reinterpret_cast<const int4*>(dvs + at);
  }
}

// ---- bfloat16 dQ: wgmma + TMA ----------------------------------------

// k/v ring depth of the bf16 dQ kernel, from an H100 sweep
// (`python -m distributed_pytorch_tpu_torch.ops.flash_tile_sweep`)
#ifndef DPX_SM90_DQ_STAGES
#define DPX_SM90_DQ_STAGES 3
#endif
constexpr int kDqStages = DPX_SM90_DQ_STAGES;

template <int D>
struct DqLayout {
  static constexpr int kTile = 64 * D * 2;     // one 64-row bf16 tile
  static constexpr int kRow = 64 * 4;          // one f32 row term
  // q, dO, then lse and delta in a 1024-byte slot, so the ring's tiles
  // keep the 1024-byte alignment of the 128B swizzle
  static constexpr int kQ = 2 * kTile + 1024;
  static constexpr int kStage = 2 * kTile;     // k, v
  static constexpr int kBytes = kQ + kDqStages * kStage;
  static constexpr uint32_t kQTx = 2 * kTile + 2 * kRow;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_lse,
                         const __grid_constant__ CUtensorMap tm_delta,
                         const Params p) {
  using L = DqLayout<D>;
  constexpr int kAtoms = D / sm90::kAtomCols;
  static_assert(kBQ == 64 && kBK == 64, "one warpgroup: 64-row tiles");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_kv[kDqStages];
  uint8_t* qs = sm90::align_1024(smem_raw);   // later: dQ staging
  uint8_t* dos = qs + L::kTile;
  uint8_t* rows = dos + L::kTile;             // lse, then delta
  uint8_t* ring = qs + L::kQ;                 // stage s: k, then v

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int iq = p.n_q - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int hk = hi / (p.h / p.h_kv);
  const int q0 = iq * kBQ;
  const long long off = (long long)p.s_k - p.s_q + p.diag_offset;

  // the forward's k-tile range for this q-tile
  long long t_lo = 0, t_hi = p.n_k - 1;
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
    const int s = it % kDqStages;
    uint8_t* ks = ring + s * L::kStage;
    uint8_t* vs = ks + L::kTile;
    const int k0 = (int)(t_lo + it) * kBK;
    sm90::mbar_expect_tx(&bar_kv[s], 2 * L::kTile);
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
    for (int s = 0; s < kDqStages; ++s) sm90::mbar_init(&bar_kv[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar_q, L::kQTx);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      sm90::tma_load_4d(qs + a * kBQ * sm90::kLineBytes, &tm_q, &bar_q,
                        a * sm90::kAtomCols, q0, hi, bi);
      sm90::tma_load_4d(dos + a * kBQ * sm90::kLineBytes, &tm_do, &bar_q,
                        a * sm90::kAtomCols, q0, hi, bi);
    }
    sm90::tma_load_3d(rows, &tm_lse, &bar_q, q0, hi, bi);
    sm90::tma_load_3d(rows + L::kRow, &tm_delta, &bar_q, q0, hi, bi);
    for (int it = 0; it < kDqStages && it < n_t; ++it) load_kv(it);
  }

  // this thread's q rows (accumulator rows) r_lo and r_lo + 8, and its
  // key columns c_q + 8 j (+ 1)
  const int r_lo = 16 * warp + lane / 4;
  const int c_q = 2 * (lane % 4);
  const float scale2 = p.scale * kLog2e;   // logits in log2 units
  const int off32 = (int)off;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[kBK / 2], dp[kBK / 2];
  uint32_t dsa[kBK / 16][4];

  auto stage = [&](int it) { return ring + (it % kDqStages) * L::kStage; };
  // S = q . k^T and dP = dO . v^T of k-iteration `it` (q rows x keys),
  // one commit group each
  auto issue_s_dp = [&](int it) {
    const uint8_t* ks = stage(it);
    const uint8_t* vs = ks + L::kTile;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = dp[i] = 0.f;
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<0>(sc, sm90::desc_kmajor(qs, kBQ, kk),
                        sm90::desc_kmajor(ks, kBK, kk), 1);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<0>(dp, sm90::desc_kmajor(dos, kBQ, kk),
                        sm90::desc_kmajor(vs, kBK, kk), 1);
    sm90::wgmma_commit();
  };

  sm90::mbar_wait(&bar_q, 0);
  // lse (in log2 units, negated) and delta of this thread's two rows:
  // zeros past s_q (TMA's fill), where every element is masked
  float nlse2[2], dlt[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    nlse2[rh] = -reinterpret_cast<const float*>(rows)[r_lo + 8 * rh] * kLog2e;
    dlt[rh] = reinterpret_cast<const float*>(rows + L::kRow)[r_lo + 8 * rh];
  }

  // Software pipeline: S and dP of k-iteration it + 1 are issued right
  // behind dQ of iteration it, so p of it + 1 is formed while the tensor
  // cores finish dP and dQ.
  if (n_t > 0) {
    sm90::mbar_wait(&bar_kv[0], 0);
    issue_s_dp(0);
  }
  for (int it = 0; it < n_t; ++it) {
    const uint8_t* ks = stage(it);
    const int k0 = (int)(t_lo + it) * kBK;
    // only tiles that cross an edge pay for the per-element mask; a row
    // with no visible key (lse = _MASK, exp2 overflows to inf) lies on
    // one, and so do the zero-filled rows past s_q (p = 1 unmasked)
    const bool edge =
        k0 + kBK > p.s_k || q0 + kBQ > p.s_q ||
        (p.causal && k0 + kBK - 1 > q0 + off32 - p.causal_offset) ||
        (p.window > 0 && k0 <= q0 + kBQ - 1 + off32 - p.window);

    sm90::wgmma_wait<1>();   // S of it (and dQ of it - 1) done
    sm90::fence_regs(sc);
    sm90::fence_regs(dq);
    // k-iteration it - 1's stage is free (its dQ product has completed):
    // refill it kDqStages ahead
    if (it >= 1 && it - 1 + kDqStages < n_t) {
      __syncthreads();
      if (tid == 0) load_kv(it - 1 + kDqStages);
    }

    // p = exp(s * scale - lse), exact zeros where masked
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      sc[i] = exp2f(fmaf(sc[i], scale2, nlse2[(i % 4) / 2]));
    if (edge) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int row = q0 + r_lo + 8 * ((i % 4) / 2);    // query row
        const int col = k0 + 8 * (i / 4) + c_q + (i % 2);  // key
        bool masked = col >= p.s_k || row >= p.s_q;
        if (p.causal) masked = masked || col > row + off32 - p.causal_offset;
        if (p.window > 0) masked = masked || col <= row + off32 - p.window;
        sc[i] = masked ? 0.f : sc[i];
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);

    // ds = p (dP - delta) scale, rounded to bf16 as the A operand
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      dp[i] = sc[i] * (dp[i] - dlt[(i % 4) / 2]) * p.scale;
    sm90::acc_to_a<kBK>(dp, dsa);

    // dQ += ds . k, k read MN-major from the tile S read K-major (one
    // commit group)
    sm90::fence_regs(dq);
    sm90::fence_regs(dsa);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      sm90::wgmma_rs<1>(dq, dsa[kk], sm90::desc_mnmajor(ks, kBK, kk), 1);
    sm90::wgmma_commit();

    if (it + 1 < n_t) {
      sm90::mbar_wait(&bar_kv[(it + 1) % kDqStages],
                      ((it + 1) / kDqStages) & 1);
      issue_s_dp(it + 1);
    } else {
      sm90::wgmma_wait<0>();
    }
    sm90::fence_regs(dsa);
  }
  sm90::fence_regs(dq);

  // epilogue: dQ in bf16 through shared memory (the q tile's space, free
  // once every product has completed), coalesced stores of the rows
  // before s_q
  __syncthreads();
  __nv_bfloat16* dqs = reinterpret_cast<__nv_bfloat16*>(qs);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = r_lo + 8 * rh;
      *reinterpret_cast<__nv_bfloat162*>(
          dqs + row * D + ((j ^ (row & 7)) * 8) + c_q) =
          __floats2bfloat162_rn(dq[4 * j + 2 * rh], dq[4 * j + 2 * rh + 1]);
    }
  __syncthreads();
  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(p.dq) + ((long long)bh * p.s_q + q0) * D;
  for (int idx = tid; idx < kBQ * D / 8; idx += kWgThreads) {
    const int row = idx / (D / 8), ch = idx % (D / 8);
    if (q0 + row >= p.s_q) continue;
    *reinterpret_cast<int4*>(out + (long long)row * D + ch * 8) =
        *reinterpret_cast<const int4*>(dqs + row * D + ((ch ^ (row & 7)) * 8));
  }
}

// The TMA descriptors of one bf16 backward launch: both kernels read the
// same six tensors, q and dO in 64-row boxes, k and v in k-tile boxes.
struct BwdMaps {
  CUtensorMap q, k, v, dout, lse, delta;
};

int encode_bwd_maps(const Params& p, int b, int d, BwdMaps* m) {
  int rc = sm90_host::tmap_bf16(&m->q, p.q, d, p.s_q, p.h, b, p.q_ss,
                                p.q_sh, p.q_sb, kBQ);
  if (rc == 0)
    rc = sm90_host::tmap_bf16(&m->k, p.k, d, p.s_k, p.h_kv, b, p.k_ss,
                              p.k_sh, p.k_sb, kBK);
  if (rc == 0)
    rc = sm90_host::tmap_bf16(&m->v, p.v, d, p.s_k, p.h_kv, b, p.v_ss,
                              p.v_sh, p.v_sb, kBK);
  if (rc == 0)
    rc = sm90_host::tmap_bf16(&m->dout, p.dout, d, p.s_q, p.h, b, p.do_ss,
                              p.do_sh, p.do_sb, kBQ);
  if (rc == 0)
    rc = sm90_host::tmap_rows_f32(&m->lse, p.lse, p.s_q, p.h, b, p.ld, kBQ);
  if (rc == 0)
    rc = sm90_host::tmap_rows_f32(&m->delta, p.delta, p.s_q, p.h, b, p.ld,
                                  kBQ);
  return rc;
}

// Raise `kernel`'s dynamic shared-memory cap to `smem` once per device
// (`opted_in` holds one bit per device), not per launch.
int opt_in_smem(const void* kernel, int smem, unsigned long long* opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && (*opted_in >> dev & 1ull)) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) *opted_in |= 1ull << dev;
  return 0;
}

template <int D>
int launch_dkv_sm90(const Params& p, int b, cudaStream_t stream) {
  BwdMaps m;
  int rc = encode_bwd_maps(p, b, D, &m);
  if (rc != 0) return rc;
  const int smem = DkvLayout<D>::kBytes + 1024;  // + 1024-byte alignment
  static unsigned long long opted_in = 0;
  rc = opt_in_smem((const void*)flash_bwd_dkv_kernel_sm90<D>, smem,
                   &opted_in);
  if (rc != 0) return rc;
  flash_bwd_dkv_kernel_sm90<D><<<dim3(p.n_k, b * p.h_kv), kWgThreads, smem,
                                 stream>>>(m.q, m.k, m.v, m.dout, m.lse,
                                           m.delta, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_sm90(const Params& p, int b, cudaStream_t stream) {
  BwdMaps m;
  int rc = encode_bwd_maps(p, b, D, &m);
  if (rc != 0) return rc;
  const int smem = DqLayout<D>::kBytes + 1024;   // + 1024-byte alignment
  static unsigned long long opted_in = 0;
  rc = opt_in_smem((const void*)flash_bwd_dq_kernel_sm90<D>, smem,
                   &opted_in);
  if (rc != 0) return rc;
  flash_bwd_dq_kernel_sm90<D><<<dim3(p.n_q, b * p.h), kWgThreads, smem,
                                stream>>>(m.q, m.k, m.v, m.dout, m.lse,
                                          m.delta, p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * kBK * (D + 1) + 2 * kBQ * kLP +
                                       2 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T, D>
      <<<dim3(p.n_k, b * p.h_kv), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * kBK * (D + 1) + kBQ * kLP +
                                       2 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, D>
      <<<dim3(p.n_q, b * p.h), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, const long long* strides,
                   int h, int h_kv, int s_q, int s_k, int ld, float scale,
                   int causal, int window, int causal_offset,
                   int diag_offset) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.do_sb = strides[9]; p.do_sh = strides[10]; p.do_ss = strides[11];
  p.h = h; p.h_kv = h_kv; p.s_q = s_q; p.s_k = s_k;
  p.n_q = (s_q + kBQ - 1) / kBQ;
  p.n_k = (s_k + kBK - 1) / kBK;
  p.ld = ld;
  p.scale = scale; p.causal = causal; p.window = window;
  p.causal_offset = causal_offset; p.diag_offset = diag_offset;
  return p;
}

}  // namespace

// C entries bound with ctypes. dtype: 0 float32, 1 bfloat16 (q, k, v and
// dO share it). window <= 0 means no window. `strides` holds 12 element
// strides: batch, head and sequence of q, k, v and dO in that order; the
// last axis of each is contiguous. lse and delta are (B, H, Sq) float32
// with row stride `ld`; dq is written contiguous (B, H, Sq, D), dk and dv
// contiguous (B, Hkv, Sk, D), all in the input type. For the bfloat16
// kernels (TMA) every base is 16-byte aligned, every bf16 stride but
// the last a multiple of 8 and `ld` a multiple of 4. Each returns the
// cudaGetLastError() code of its launch (0 on success), -1 for a dtype /
// head size these kernels do not take, -2 / -3 when libcuda offers no TMA
// encoder / the encoder refuses a descriptor.
extern "C" int dpx_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const long long* strides, int b, int h, int h_kv, int s_q, int s_k, int d,
    int ld, int dtype, float scale, int causal, int window, int causal_offset,
    int diag_offset, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv,
                               strides, h, h_kv, s_q, s_k, ld, scale,
                               causal, window, causal_offset, diag_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch_dkv<float, 64>(p, b, st);
  if (dtype == 0 && d == 128) return launch_dkv<float, 128>(p, b, st);
  if (dtype == 1 && d == 64) return launch_dkv_sm90<64>(p, b, st);
  if (dtype == 1 && d == 128) return launch_dkv_sm90<128>(p, b, st);
  return -1;
}

extern "C" int dpx_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    const long long* strides, int b, int h, int h_kv, int s_q, int s_k, int d,
    int ld, int dtype, float scale, int causal, int window, int causal_offset,
    int diag_offset, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr,
                               nullptr, strides, h, h_kv, s_q, s_k, ld,
                               scale, causal, window, causal_offset,
                               diag_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch_dq<float, 64>(p, b, st);
  if (dtype == 0 && d == 128) return launch_dq<float, 128>(p, b, st);
  if (dtype == 1 && d == 64) return launch_dq_sm90<64>(p, b, st);
  if (dtype == 1 && d == 128) return launch_dq_sm90<128>(p, b, st);
  return -1;
}
