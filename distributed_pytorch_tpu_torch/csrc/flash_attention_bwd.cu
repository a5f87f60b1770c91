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
//
// Threads: 256 per block, each owning a 4 x 4 micro-tile of a 64 x 64
// logits tile (rows 4*ty .. 4*ty+3, cols tx + 16*j) and a 4 x D/16 slice
// of its accumulator, fed from float32 tiles in shared memory, as in the
// forward kernel.
//   * dK/dV: one block per (k-tile of 64 keys, b * h_kv). It loads its k
//     and v tiles once and loops over the g query heads of its kv group
//     and their q-tiles itself (the TPU grid's sequential axis), so the
//     GQA group sum happens in its float32 registers and dK/dV are written
//     once as (B, Hkv, Sk, D): no per-q-head partials, no atomics.
//   * dQ: one block per (q-tile of 64 rows, b * h), looping over k-tiles.
// Both are deterministic: every output element is summed by one thread in
// a fixed order.
//
// What bounds it on the H100: at the training shape (S = 1024, D = 64,
// causal) the backward does 14 * D FLOPs per visible (query, key) pair
// against ~4 bytes of traffic per pair per kernel, so it is compute-bound
// (~0.046 ms at the 989 TFLOP/s bf16 dense peak for B = 8, H = 12). This
// first version does its five products with scalar float32 FMA from
// shared memory (67 TFLOP/s f32 peak, bounded in practice by the
// shared-memory loads: ~2 FMA per load with the 4 x 4 micro-tile), not on
// the tensor cores. wgmma with TMA-fed tiles is the follow-up, shared with
// the forward kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  const float* lse;     // (B, H, Sq) contiguous
  const float* delta;   // (B, H, Sq) contiguous
  void* dq;             // (B, H, Sq, D) contiguous
  void* dk;             // (B, Hkv, Sk, D) contiguous
  void* dv;             // (B, Hkv, Sk, D) contiguous
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  int h, h_kv, s_q, s_k, n_q, n_k;
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
    const long long row_base = ((long long)bi * p.h + hi) * p.s_q;
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
  const long long row_base = (long long)bh * p.s_q;

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

  T* dq_out = static_cast<T*>(p.dq) + row_base * D;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = q0 + ty * kRM + i;
    if (row >= p.s_q) continue;
#pragma unroll
    for (int j = 0; j < kDC; ++j)
      dq_out[(long long)row * D + tx + kTX * j] = from_f<T>(dq[i][j]);
  }
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
                   int h, int h_kv, int s_q, int s_k, float scale, int causal,
                   int window, int causal_offset, int diag_offset) {
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
  p.scale = scale; p.causal = causal; p.window = window;
  p.causal_offset = causal_offset; p.diag_offset = diag_offset;
  return p;
}

}  // namespace

// C entries bound with ctypes. dtype: 0 float32, 1 bfloat16 (q, k, v and
// dO share it). window <= 0 means no window. `strides` holds 12 element
// strides: batch, head and sequence of q, k, v and dO in that order; the
// last axis of each is contiguous. lse and delta are contiguous (B, H, Sq)
// float32; dq is written contiguous (B, H, Sq, D), dk and dv contiguous
// (B, Hkv, Sk, D), all in the input type. Each returns the
// cudaGetLastError() code of its launch (0 on success), or -1 for a dtype
// / head size these kernels do not take.
extern "C" int dpx_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const long long* strides, int b, int h, int h_kv, int s_q, int s_k, int d,
    int dtype, float scale, int causal, int window, int causal_offset,
    int diag_offset, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv,
                               strides, h, h_kv, s_q, s_k, scale, causal,
                               window, causal_offset, diag_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch_dkv<float, 64>(p, b, st);
  if (dtype == 0 && d == 128) return launch_dkv<float, 128>(p, b, st);
  if (dtype == 1 && d == 64) return launch_dkv<__nv_bfloat16, 64>(p, b, st);
  if (dtype == 1 && d == 128) return launch_dkv<__nv_bfloat16, 128>(p, b, st);
  return -1;
}

extern "C" int dpx_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    const long long* strides, int b, int h, int h_kv, int s_q, int s_k, int d,
    int dtype, float scale, int causal, int window, int causal_offset,
    int diag_offset, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr,
                               nullptr, strides, h, h_kv, s_q, s_k, scale,
                               causal, window, causal_offset, diag_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch_dq<float, 64>(p, b, st);
  if (dtype == 0 && d == 128) return launch_dq<float, 128>(p, b, st);
  if (dtype == 1 && d == 64) return launch_dq<__nv_bfloat16, 64>(p, b, st);
  if (dtype == 1 && d == 128) return launch_dq<__nv_bfloat16, 128>(p, b, st);
  return -1;
}
