// Fused SCAFFOLD local steps for Hopper (sm_90a), one pass over a dtype
// group of the parameter tree:
//
//   B1, the corrected step      out = y - eta * (g + corr)    corr = c - c_i
//   B2, the heavy-ball step     m'  = beta * m + (g + corr)
//                               out = y - eta * m'
//
// Replaces the TPU kernels src/repro/kernels/scaffold_update/kernel.py:
// scaffold_update_2d (body _update_kernel), reached through
// ops.scaffold_update_packed once per dtype group per local step, and
// scaffold_momentum_update_2d (body _momentum_kernel), reached through
// ops.scaffold_momentum_update_packed by the momentum local solver.
//
// Bound on the H100: bytes. B1 reads y, g and corr and writes out, with 3
// flops an element; B2 also reads and writes the fp32 slot m (16 B an
// element at bf16 y/g/corr), with 5 flops. Both are ~0.3-0.4 flop/byte,
// three orders below the ridge; the least time is the bytes of every
// operand read once and every output written once over 3.35 TB/s.
//
// Design against that bound:
//  * One launch covers a whole dtype group of the parameter tree, with no
//    packed copy: the launch carries a table of up to 256 leaf pointers
//    and sizes by value (multi-tensor style; 15 KB of parameters, past the
//    old 4 KB limit, as CUDA 12.1 allows up to 32 KB from Volta on),
//    blockIdx.y picks the leaf and blockIdx.x strides over it. The TPU path concatenated every leaf into
//    fresh buffers, four (B2: six) extra param-sized copies per step.
//  * 16-byte vector loads and stores (8 elements a thread for every
//    dtype: one 16 B access for bf16, two for fp32), a grid-stride
//    loop, and a scalar tail for the ragged end. A leaf whose pointers are
//    not 16 B aligned takes the scalar loop.
//  * fp32 arithmetic with round-to-nearest intrinsics, so nvcc does not
//    contract into an FMA and each operation rounds as the plain PyTorch
//    version does; one rounding to y's dtype at the store.
//  * out may alias y and m_out may alias m (the trainer updates the
//    client's working copy and its slot in place): every element is read
//    and written by the same thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 256;  // 256 * 56 B + 256 * 4 B of leaf table per launch
constexpr int kThreads = 256;
constexpr int kVec = 8;

struct Leaf {
  const void* y;
  const void* g;
  const void* c;
  const float* m;  // B2 only: the fp32 heavy-ball slot
  void* out;
  float* m_out;    // B2 only
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

// One element. B1: y - eta*(g + c). B2: m <- beta*m + (g + c), then
// y - eta*m. Each operation rounds, as the plain version's do.
template <bool kMom>
__device__ __forceinline__ float step(float y, float g, float c, float& m,
                                      float eta, float beta) {
  const float gc = __fadd_rn(g, c);
  if (kMom) {
    m = __fadd_rn(__fmul_rn(beta, m), gc);
    return __fsub_rn(y, __fmul_rn(eta, m));
  }
  return __fsub_rn(y, __fmul_rn(eta, gc));
}

template <bool kMom, typename TY, typename TG, typename TC>
__global__ void __launch_bounds__(kThreads)
scaffold_update_kernel(const __grid_constant__ LeafTable table, float eta,
                       float beta) {
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
      float a[kVec], b[kVec], d[kVec], m[kVec];
      load8(y + i * kVec, a);
      load8(g + i * kVec, b);
      load8(c + i * kVec, d);
      if (kMom) load8(L.m + i * kVec, m);
#pragma unroll
      for (int j = 0; j < kVec; ++j) a[j] = step<kMom>(a[j], b[j], d[j], m[j], eta, beta);
      store8(out + i * kVec, a);
      if (kMom) store8(L.m_out + i * kVec, m);
    }
    done = nvec * kVec;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float m = kMom ? L.m[i] : 0.f;
    out[i] = from_f<TY>(step<kMom>(to_f(y[i]), to_f(g[i]), to_f(c[i]), m, eta, beta));
    if (kMom) L.m_out[i] = m;
  }
}

template <typename T> struct Tag { using type = T; };

// f(Tag<float>{}) for dtype code 0, f(Tag<__nv_bfloat16>{}) for 1
template <typename F> void with_dtype(int code, F f) {
  if (code == 0) f(Tag<float>{});
  else f(Tag<__nv_bfloat16>{});
}

}  // namespace

// One launch over a dtype group of n_leaves leaves. Dtype codes: 0 fp32,
// 1 bf16. y, g, c, out: arrays of n_leaves device pointers; n: array of
// n_leaves element counts. m and m_out: arrays of n_leaves fp32 slot
// pointers for the heavy-ball step (B2), or both null for the corrected
// step (B1; beta unused). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it refuses).
extern "C" int scaffold_update_group(int ty, int tg, int tc, int n_leaves,
                                     const void* y, const void* g,
                                     const void* c, const void* m,
                                     const void* out, const void* m_out,
                                     const void* n, float eta, float beta,
                                     void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || ty < 0 || ty > 1 || tg < 0 ||
      tg > 1 || tc < 0 || tc > 1 || (m == nullptr) != (m_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool mom = m != nullptr;
  const void* const* py = static_cast<const void* const*>(y);
  const void* const* pg = static_cast<const void* const*>(g);
  const void* const* pc = static_cast<const void* const*>(c);
  const float* const* pm = static_cast<const float* const*>(m);
  void* const* po = static_cast<void* const*>(const_cast<void*>(out));
  float* const* pmo = static_cast<float* const*>(const_cast<void*>(m_out));
  const long long* pn = static_cast<const long long*>(n);
  LeafTable t;
  long long max_n = 0;
  for (int i = 0; i < n_leaves; ++i) {
    t.leaf[i] = Leaf{py[i], pg[i], pc[i], mom ? pm[i] : nullptr, po[i],
                     mom ? pmo[i] : nullptr, pn[i]};
    uintptr_t bits = (uintptr_t)py[i] | (uintptr_t)pg[i] |
                     (uintptr_t)pc[i] | (uintptr_t)po[i];
    if (mom) bits |= (uintptr_t)pm[i] | (uintptr_t)pmo[i];
    t.aligned[i] = (bits % 16) == 0;
    if (pn[i] > max_n) max_n = pn[i];
  }
  const long long want = (max_n + (long long)kThreads * kVec - 1) /
                         ((long long)kThreads * kVec);
  const int blocks = (int)(want < 1 ? 1 : (want > 1056 ? 1056 : want));  // 132 SMs x 8
  const dim3 grid(blocks, n_leaves);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_dtype(ty, [&](auto y_tag) {
    with_dtype(tg, [&](auto g_tag) {
      with_dtype(tc, [&](auto c_tag) {
        using TY = typename decltype(y_tag)::type;
        using TG = typename decltype(g_tag)::type;
        using TC = typename decltype(c_tag)::type;
        if (mom)
          scaffold_update_kernel<true, TY, TG, TC><<<grid, kThreads, 0, s>>>(t, eta, beta);
        else
          scaffold_update_kernel<false, TY, TG, TC><<<grid, kThreads, 0, s>>>(t, eta, beta);
      });
    });
  });
  return (int)cudaGetLastError();
}
