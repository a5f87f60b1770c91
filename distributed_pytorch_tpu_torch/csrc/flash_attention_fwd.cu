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
// Threads: one block of 256 per (q-tile of 64 rows, b*h). The block
// walks its k-tiles in a loop, which takes the place of the TPU grid's
// sequential "arbitrary" axis, so no cross-block reduction or atomic is
// needed. Each thread owns a 4 x 4 micro-tile of the 64 x 64 logits
// (rows 4*ty .. 4*ty+3, cols tx + 16*j) and a 4 x D/16 slice of the
// output accumulator in registers; row max and row sum are reduced over
// the 16 lanes of a half-warp with shuffles.
//
// What bounds it on the H100: at the serving shapes (S = 1024 - 2048,
// D = 64) attention is compute-bound (~S/2 FLOP per byte of q/k/v/o for
// causal, far above the card's ~295 FLOP/byte bf16 ridge). This first
// kernel does both products with scalar float32 FMA from shared memory
// (tiles are widened to float32 when loaded), so it is bounded by the
// SM's FMA and shared-memory rates (67 TFLOP/s f32 peak), not by the
// tensor cores' 989 TFLOP/s: the 4 x 4 register micro-tile halves the
// shared-memory loads per FMA compared with one row per thread, and
// heavy causal tiles are scheduled first. Moving both products to
// wgmma with TMA-fed tiles is the follow-up that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// C entry bound with ctypes. dtype: 0 float32, 1 bfloat16. window <= 0
// means no window. Strides are in elements; the last axis of q, k and v
// is contiguous, o is contiguous (B, H, Sq, D), lse contiguous (B, H, Sq).
// Returns the cudaGetLastError() code of the launch (0 on success), or
// -1 for a dtype / head size this kernel does not take.
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
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(p, bh, st);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(p, bh, st);
  return -1;
}
