// Fused SCAFFOLD corrected step for Hopper (sm_90a):
//
//     out = y - eta * (g + corr)        corr = c - c_i
//
// Replaces the TPU kernel src/repro/kernels/scaffold_update/kernel.py:
// scaffold_update_2d (body _update_kernel), reached through
// ops.scaffold_update_packed once per dtype group per local step.
//
// Bound on the H100: bytes. Each element is read three times (y, g, corr)
// and written once, with 3 flops, so the kernel is ~0.4 flop/byte, three
// orders below the ridge; the least time is
// (bytes(y) + bytes(g) + bytes(corr) + bytes(out)) / 3.35 TB/s.
//
// Design against that bound:
//  * One launch covers a whole dtype group of the parameter tree, with no
//    packed copy: the launch carries a table of leaf pointers and sizes
//    by value (multi-tensor style), blockIdx.y picks the leaf and
//    blockIdx.x strides over it. The TPU path concatenated every leaf into
//    fresh buffers, four extra param-sized copies per step.
//  * 16-byte vector loads and stores (8 elements a thread for every
//    dtype: one 16 B access for bf16, two for fp32), a grid-stride
//    loop, and a scalar tail for the ragged end. A leaf whose pointers are
//    not 16 B aligned takes the scalar loop.
//  * fp32 arithmetic with round-to-nearest intrinsics, so nvcc does not
//    contract into an FMA and each operation rounds as the plain PyTorch
//    version does; one rounding to y's dtype at the store.
//  * out may alias y (the trainer updates its working copy in place):
//    every element is read and written by the same thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;  // 64 * 40 B of leaf table per launch
constexpr int kThreads = 256;
constexpr int kVec = 8;

struct Leaf {
  const void* y;
  const void* g;
  const void* c;
  void* out;
  long long n;
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int aligned[kMaxLeaves];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive elements <-> float[8], 16 bytes per access
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = to_f(e[j]);
}
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* v) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec; ++j) e[j] = from_f<T>(v[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}
template <>
__device__ __forceinline__ void store8<float>(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float step(float y, float g, float c, float eta) {
  return __fsub_rn(y, __fmul_rn(eta, __fadd_rn(g, c)));
}

template <typename TY, typename TG, typename TC>
__global__ void __launch_bounds__(kThreads)
scaffold_update_kernel(const __grid_constant__ LeafTable table, float eta) {
  const Leaf L = table.leaf[blockIdx.y];
  const TY* y = static_cast<const TY*>(L.y);
  const TG* g = static_cast<const TG*>(L.g);
  const TC* c = static_cast<const TC*>(L.c);
  TY* out = static_cast<TY*>(L.out);
  const long long n = L.n;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (table.aligned[blockIdx.y]) {
    const long long nvec = n / kVec;
    for (long long i = tid; i < nvec; i += stride) {
      float a[kVec], b[kVec], d[kVec];
      load8(y + i * kVec, a);
      load8(g + i * kVec, b);
      load8(c + i * kVec, d);
#pragma unroll
      for (int j = 0; j < kVec; ++j) a[j] = step(a[j], b[j], d[j], eta);
      store8(out + i * kVec, a);
    }
    done = nvec * kVec;
  }
  for (long long i = done + tid; i < n; i += stride) {
    out[i] = from_f<TY>(step(to_f(y[i]), to_f(g[i]), to_f(c[i]), eta));
  }
}

template <typename TY, typename TG, typename TC>
void launch(const LeafTable& t, int n_leaves, long long max_n, float eta,
            cudaStream_t stream) {
  long long want = (max_n + (long long)kThreads * kVec - 1) / ((long long)kThreads * kVec);
  int blocks = (int)(want < 1 ? 1 : (want > 1056 ? 1056 : want));  // 132 SMs x 8
  dim3 grid(blocks, n_leaves);
  scaffold_update_kernel<TY, TG, TC><<<grid, kThreads, 0, stream>>>(t, eta);
}

template <typename TY, typename TG>
void dispatch_c(int tc, const LeafTable& t, int n, long long m, float eta,
                cudaStream_t s) {
  switch (tc) {
    case 0: launch<TY, TG, float>(t, n, m, eta, s); break;
    default: launch<TY, TG, __nv_bfloat16>(t, n, m, eta, s); break;
  }
}

template <typename TY>
void dispatch_g(int tg, int tc, const LeafTable& t, int n, long long m,
                float eta, cudaStream_t s) {
  switch (tg) {
    case 0: dispatch_c<TY, float>(tc, t, n, m, eta, s); break;
    default: dispatch_c<TY, __nv_bfloat16>(tc, t, n, m, eta, s); break;
  }
}

}  // namespace

// One launch over a dtype group of n_leaves leaves. Dtype codes: 0 fp32,
// 1 bf16. y, g, c, out: arrays of n_leaves device pointers; n:
// array of n_leaves element counts. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments it refuses).
extern "C" int scaffold_update_group(int ty, int tg, int tc, int n_leaves,
                                     const void* y, const void* g,
                                     const void* c, const void* out,
                                     const void* n, float eta,
                                     void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || ty < 0 || ty > 1 || tg < 0 ||
      tg > 1 || tc < 0 || tc > 1)
    return (int)cudaErrorInvalidValue;
  const void* const* py = static_cast<const void* const*>(y);
  const void* const* pg = static_cast<const void* const*>(g);
  const void* const* pc = static_cast<const void* const*>(c);
  void* const* po = static_cast<void* const*>(const_cast<void*>(out));
  const long long* pn = static_cast<const long long*>(n);
  LeafTable t;
  long long max_n = 0;
  for (int i = 0; i < n_leaves; ++i) {
    t.leaf[i] = Leaf{py[i], pg[i], pc[i], po[i], pn[i]};
    uintptr_t bits = (uintptr_t)py[i] | (uintptr_t)pg[i] |
                     (uintptr_t)pc[i] | (uintptr_t)po[i];
    t.aligned[i] = (bits % 16) == 0;
    if (pn[i] > max_n) max_n = pn[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ty) {
    case 0: dispatch_g<float>(tg, tc, t, n_leaves, max_n, eta, s); break;
    default: dispatch_g<__nv_bfloat16>(tg, tc, t, n_leaves, max_n, eta, s); break;
  }
  return (int)cudaGetLastError();
}
