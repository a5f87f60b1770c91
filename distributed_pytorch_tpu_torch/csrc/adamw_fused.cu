// Fused AdamW for Hopper (sm_90a): one pass over every parameter of a
// list of tensors, in one launch.
//
// Replaces no TPU kernel: the JAX package's `adamw` (distributed_pytorch_tpu/
// optim/__init__.py) is jnp arithmetic that XLA fuses into one pass. The
// port's `adamw` ran it as a chain of sixteen `torch._foreach_*` ops, each
// a pass over the float32 state with its temporaries in device memory:
// 156 bytes a float32 parameter. Here each element reads p, g, mu and nu
// once and writes p, mu and nu once: 28 bytes a float32 parameter.
//
// Arithmetic: the chain's, in its order, every product, sum, quotient and
// root rounded to float32 on its own as the chain's op rounds it (the _rn
// intrinsics: no contraction into an FMA, IEEE division and square root),
// so the kernel gives the `_foreach` path's bits on the card:
//   mu  = mu*b1 + g*(1-b1)
//   nu  = nu*b2 + (g*g)*(1-b2)
//   pf  = p*(1 - lr*wd)
//   upd = ((mu*rc1)*lr) / (sqrt(nu*rc2) + eps)
//   p   = pf - upd, rounded to the parameter's dtype (nearest even).
// rc1 and rc2 are the float32 reciprocals of the bias corrections c1 and
// c2: torch's CUDA division of a tensor by a Python scalar, the chain's
// mu/c1 and nu/c2 among them, is a product with that reciprocal. The
// constants arrive as float32, rounded on the host as the `_foreach` ops
// round their Python scalars. p and g are float32 or bfloat16 (read in
// their dtype, computed in float32); mu and nu are always float32.
//
// What bounds it on the H100: ~10 flops per 28 bytes, far below the card's
// ridge, so HBM bandwidth (3.35 TB/s). The design moves each byte once at
// full width: every tensor is cut into work items of kChunk elements, and
// a persistent grid (as many blocks as fit on the SMs at once) walks the
// items of the whole list in order, so hundreds of small tensors (biases,
// LayerNorm scales) cost no launch of their own. A block's threads read
// 4 consecutive elements each with one 16-byte load (8 for bfloat16) where
// all four of the tensor's pointers allow it, one element at a time
// otherwise and in a tensor's last partial group. The table of tensors
// travels in the kernel's parameters (up to kMaxTensors a launch; CUDA
// 12.1+ gives a kernel 32 KB of them): nothing is copied to the device
// beforehand and the gradients' addresses are read anew on every call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;       // threads per block
constexpr int kChunk = 8192;        // elements per work item
constexpr int kMaxTensors = 640;    // tensors per launch

static_assert(kChunk % (4 * kThreads) == 0, "an item is whole vectors");

struct Hyper {
  float b1, omb1;     // b1, 1 - b1
  float b2, omb2;     // b2, 1 - b2
  float decay;        // 1 - lr * weight_decay
  float lr;
  float rc1, rc2;     // 1 / c1, 1 / c2
  float eps;
};

struct Params {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  float* mu[kMaxTensors];
  float* nu[kMaxTensors];
  long long n[kMaxTensors];
  int item0[kMaxTensors + 1];  // each tensor's first item; then the total
  int n_tensors;
  Hyper h;
};

static_assert(sizeof(Params) <= 32764, "the kernel parameter space");

__device__ __forceinline__ float load1(const float* s) { return *s; }
__device__ __forceinline__ float load1(const __nv_bfloat16* s) {
  return __bfloat162float(*s);
}
__device__ __forceinline__ void store1(float* d, float v) { *d = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* d, float v) {
  *d = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load4(const float* s, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(s);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* s, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(s);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* d, const float (&v)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* d, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const uint32_t*>(&lo);
  x.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(d) = x;
}

// One element's update, in the `_foreach` chain's order and roundings.
__device__ __forceinline__ void adamw(float& p, float g, float& mu, float& nu,
                                      const Hyper& h) {
  mu = __fadd_rn(__fmul_rn(mu, h.b1), __fmul_rn(g, h.omb1));
  nu = __fadd_rn(__fmul_rn(nu, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  const float pf = __fmul_rn(p, h.decay);
  const float upd = __fmul_rn(__fmul_rn(mu, h.rc1), h.lr);
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, h.rc2)), h.eps);
  p = __fsub_rn(pf, __fdiv_rn(upd, den));
}

template <typename P, typename G>
__device__ __forceinline__ void update_one(P* p, const G* g, float* mu,
                                           float* nu, long long i,
                                           const Hyper& h) {
  float pv = load1(p + i), m = mu[i], v = nu[i];
  adamw(pv, load1(g + i), m, v, h);
  mu[i] = m; nu[i] = v;
  store1(p + i, pv);
}

template <typename T>
__device__ __forceinline__ bool aligned4(const T* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % (4 * sizeof(T)) == 0;
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
dpx_adamw_multi_tensor_apply_kernel(const __grid_constant__ Params prm) {
  const Hyper h = prm.h;
  const int items = prm.item0[prm.n_tensors];
  int t = 0;
  // a block's items ascend, so its tensor index only moves forward
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    while (prm.item0[t + 1] <= item) ++t;
    P* __restrict__ p = static_cast<P*>(prm.p[t]);
    const G* __restrict__ g = static_cast<const G*>(prm.g[t]);
    float* __restrict__ mu = prm.mu[t];
    float* __restrict__ nu = prm.nu[t];
    const long long n = prm.n[t];
    const long long start = (long long)(item - prm.item0[t]) * kChunk;
    const long long end = start + kChunk < n ? start + kChunk : n;
    long long tail = start;
    if (aligned4(p) && aligned4(g) && aligned4(mu) && aligned4(nu)) {
      tail = start + ((end - start) & ~3LL);
      for (long long i = start + 4 * threadIdx.x; i < tail;
           i += 4 * kThreads) {
        float pv[4], gv[4], m[4], v[4];
        load4(p + i, pv); load4(g + i, gv);
        load4(mu + i, m); load4(nu + i, v);
#pragma unroll
        for (int k = 0; k < 4; ++k) adamw(pv[k], gv[k], m[k], v[k], h);
        store4(mu + i, m); store4(nu + i, v);
        store4(p + i, pv);
      }
    }
    for (long long i = tail + threadIdx.x; i < end; i += kThreads)
      update_one(p, g, mu, nu, i, h);
  }
}

template <typename P, typename G>
int launch_all(const long long* table, int n_tensors, const Hyper& h,
               cudaStream_t stream, int* launches) {
  const auto kernel = dpx_adamw_multi_tensor_apply_kernel<P, G>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long max_grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  Params prm;  // the launch copies it into the kernel's parameters
  for (int first = 0; first < n_tensors; first += kMaxTensors) {
    const int count = n_tensors - first < kMaxTensors ? n_tensors - first
                                                       : kMaxTensors;
    long long items = 0;
    for (int j = 0; j < count; ++j) {
      const long long* row = table + 5 * (first + j);
      prm.p[j] = reinterpret_cast<void*>(row[0]);
      prm.g[j] = reinterpret_cast<const void*>(row[1]);
      prm.mu[j] = reinterpret_cast<float*>(row[2]);
      prm.nu[j] = reinterpret_cast<float*>(row[3]);
      prm.n[j] = row[4];
      prm.item0[j] = (int)items;
      items += (row[4] + kChunk - 1) / kChunk;
      if (items > 0x7fffffffLL) return -2;
    }
    prm.item0[count] = (int)items;
    prm.n_tensors = count;
    prm.h = h;
    if (items == 0) continue;
    const int grid = (int)(items < max_grid ? items : max_grid);
    kernel<<<grid, kThreads, 0, stream>>>(prm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return 0;
}

}  // namespace

// One AdamW step over `n_tensors` tensors on `stream`. `table` holds five
// 64-bit numbers a tensor: the addresses of p, g, mu and nu and the element
// count (contiguous tensors of one device; the caller leaves out empty
// ones). `p_dtype` / `g_dtype`: 0 float32, 1 bfloat16. The launches made
// (one per kMaxTensors tensors) are written to `launches`. Returns 0, the
// cudaGetLastError() code of a failed query or launch, -1 for a dtype this
// kernel does not take, -2 when a launch would hold more than 2^31 items.
extern "C" int dpx_adamw_multi_tensor_apply(
    const long long* table, int n_tensors, int p_dtype, int g_dtype,
    float b1, float omb1, float b2, float omb2, float decay, float lr,
    float rc1, float rc2, float eps, void* stream, int* launches) {
  const Hyper h{b1, omb1, b2, omb2, decay, lr, rc1, rc2, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  if (p_dtype == 0 && g_dtype == 0)
    return launch_all<float, float>(table, n_tensors, h, st, launches);
  if (p_dtype == 0 && g_dtype == 1)
    return launch_all<float, __nv_bfloat16>(table, n_tensors, h, st,
                                            launches);
  if (p_dtype == 1 && g_dtype == 0)
    return launch_all<__nv_bfloat16, float>(table, n_tensors, h, st,
                                            launches);
  if (p_dtype == 1 && g_dtype == 1)
    return launch_all<__nv_bfloat16, __nv_bfloat16>(table, n_tensors, h, st,
                                                    launches);
  return -1;
}
