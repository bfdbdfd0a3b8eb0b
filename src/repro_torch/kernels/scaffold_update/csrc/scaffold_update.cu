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
// operand read once and every output written once over 3.35 TB/s. On the
// paper's own trees (the EMNIST MLP's 216,894 fp32 in 4 leaves, the
// quadratics' one 1024 leaf) that is ~1 us or less, under the launch
// itself: there the launch, the grid and one DRAM round trip are the cost.
//
// Design against both:
//  * One launch covers a whole dtype group of the parameter tree, with no
//    packed copy: the launch carries a table of the group's leaf pointers,
//    sizes and chunk offsets by value (__grid_constant__, no device-side
//    table, so no host-to-device copy and the launch stays capturable by
//    a CUDA graph). The table is sized to the group: 4 leaves or 256 (a
//    4-leaf B1 group passes 184 B, not 15 KB).
//  * A flat grid over the group's elements: each leaf is cut into chunks
//    of kChunk elements (a multiple of 8, so an aligned leaf's chunks stay
//    16 B aligned), numbered across the group by a prefix array the host
//    plans once per tree (ops.update_plan). Block b walks chunks b,
//    b + grid, ...; the grid is min(chunks, one wave of the card), so no
//    block is launched without work and a 62-element leaf costs one chunk.
//    A zero-element leaf has no chunk.
//  * Every thread issues the 16-byte loads of kUnroll vectors of 8
//    elements of every operand before its first arithmetic (two accesses
//    for an fp32 vector, one for bf16), then computes and stores them; a
//    scalar tail takes the last < 8 elements of a leaf. A leaf whose
//    pointers are not all 16 B aligned takes the scalar loop.
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

constexpr int kThreads = 128;
constexpr int kVec = 8;     // elements a vector
constexpr int kUnroll = 2;  // vectors a thread loads per operand per chunk
constexpr int kChunk = kThreads * kVec * kUnroll;  // elements a chunk

// y, g, c, out; B2 also m, m_out (fp32)
template <bool kMom> struct Roles { static constexpr int n = kMom ? 6 : 4; };

template <int Cap, bool kMom>
struct LeafTable {
  void* ptr[Roles<kMom>::n][Cap];
  long long n[Cap];
  int first[Cap + 1];  // leaf i owns chunks [first[i], first[i + 1])
  unsigned char aligned[Cap];
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

template <int Cap, bool kMom, typename TY, typename TG, typename TC>
__global__ void __launch_bounds__(kThreads)
scaffold_update_kernel(const __grid_constant__ LeafTable<Cap, kMom> t,
                       int chunks, float eta, float beta) {
  int leaf = 0;
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    while (ch >= t.first[leaf + 1]) ++leaf;  // chunks rise, so leaves do
    const TY* y = static_cast<const TY*>(t.ptr[0][leaf]);
    const TG* g = static_cast<const TG*>(t.ptr[1][leaf]);
    const TC* c = static_cast<const TC*>(t.ptr[2][leaf]);
    TY* out = static_cast<TY*>(t.ptr[3][leaf]);
    const float* m = kMom ? static_cast<const float*>(t.ptr[4][leaf]) : nullptr;
    float* m_out = kMom ? static_cast<float*>(t.ptr[5][leaf]) : nullptr;
    const long long lo = (long long)(ch - t.first[leaf]) * kChunk;
    const long long hi = t.n[leaf] < lo + kChunk ? t.n[leaf] : lo + kChunk;
    long long done = lo;
    if (t.aligned[leaf]) {
      const int nvec = (int)((hi - lo) / kVec);
      float a[kUnroll][kVec], b[kUnroll][kVec], d[kUnroll][kVec],
          s[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = threadIdx.x + u * kThreads;
        if (v < nvec) {
          const long long e = lo + (long long)v * kVec;
          load8(y + e, a[u]);
          load8(g + e, b[u]);
          load8(c + e, d[u]);
          if (kMom) load8(m + e, s[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = threadIdx.x + u * kThreads;
        if (v < nvec) {
          const long long e = lo + (long long)v * kVec;
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            a[u][j] = step<kMom>(a[u][j], b[u][j], d[u][j], s[u][j], eta, beta);
          store8(out + e, a[u]);
          if (kMom) store8(m_out + e, s[u]);
        }
      }
      done = lo + (long long)nvec * kVec;
    }
    for (long long i = done + threadIdx.x; i < hi; i += kThreads) {
      float mi = kMom ? m[i] : 0.f;
      out[i] = from_f<TY>(step<kMom>(to_f(y[i]), to_f(g[i]), to_f(c[i]), mi,
                                     eta, beta));
      if (kMom) m_out[i] = mi;
    }
  }
}

// the launch with nothing in it: the same table and grid, no work
template <int Cap, bool kMom>
__global__ void __launch_bounds__(kThreads)
empty_kernel(const __grid_constant__ LeafTable<Cap, kMom> t) {}

template <typename T> struct Tag { using type = T; };

// f(Tag<float>{}) for dtype code 0, f(Tag<__nv_bfloat16>{}) for 1
template <typename F> void with_dtype(long long code, F f) {
  if (code == 0) f(Tag<float>{});
  else f(Tag<__nv_bfloat16>{});
}

// f(CapTag<C>{}) for table capacity C (ops.CAPACITIES); false for another
template <int C> struct CapTag { static constexpr int value = C; };
template <typename F> bool with_capacity(long long cap, F f) {
  switch (cap) {
    case 4: f(CapTag<4>{}); return true;
    case 256: f(CapTag<256>{}); return true;
  }
  return false;
}

// The kernel for dtype codes (ty, tg, tc) and a table of capacity Cap
template <int Cap, bool kMom>
const void* kernel_for(long long ty, long long tg, long long tc) {
  const void* k = nullptr;
  with_dtype(ty, [&](auto y_tag) {
    with_dtype(tg, [&](auto g_tag) {
      with_dtype(tc, [&](auto c_tag) {
        k = reinterpret_cast<const void*>(
            scaffold_update_kernel<Cap, kMom, typename decltype(y_tag)::type,
                                   typename decltype(g_tag)::type,
                                   typename decltype(c_tag)::type>);
      });
    });
  });
  return k;
}

// Fill a table from the plan's sizes and chunk prefix and the pointers,
// and launch; cudaErrorInvalidValue, with no launch, if the prefix is not
// the one ops.update_plan gives for these sizes.
template <int Cap, bool kMom>
int launch_group(long long ty, long long tg, long long tc, int n_leaves,
                 int grid, const long long* sizes, const long long* first,
                 const void* const* ptrs, float eta, float beta,
                 cudaStream_t s) {
  LeafTable<Cap, kMom> t;
  if (first[0] != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_leaves; ++i) {
    if (sizes[i] < 0 ||
        first[i + 1] - first[i] != (sizes[i] + kChunk - 1) / kChunk)
      return (int)cudaErrorInvalidValue;
    uintptr_t bits = 0;
    for (int r = 0; r < Roles<kMom>::n; ++r) {
      t.ptr[r][i] = const_cast<void*>(ptrs[r * n_leaves + i]);
      bits |= (uintptr_t)ptrs[r * n_leaves + i];
    }
    t.n[i] = sizes[i];
    t.first[i] = (int)first[i];
    t.aligned[i] = (bits % 16) == 0;
  }
  t.first[n_leaves] = (int)first[n_leaves];
  const int chunks = (int)first[n_leaves];
  with_dtype(ty, [&](auto y_tag) {
    with_dtype(tg, [&](auto g_tag) {
      with_dtype(tc, [&](auto c_tag) {
        using TY = typename decltype(y_tag)::type;
        using TG = typename decltype(g_tag)::type;
        using TC = typename decltype(c_tag)::type;
        scaffold_update_kernel<Cap, kMom, TY, TG, TC><<<grid, kThreads, 0, s>>>(
            t, chunks, eta, beta);
      });
    });
  });
  return (int)cudaGetLastError();
}

}  // namespace

// Elements a chunk, for the host's plan to check against.
extern "C" int scaffold_update_chunk() { return kChunk; }

// Blocks of one SM the kernel for dtype codes (ty, tg, tc), momentum flag
// and a table of capacity cap can hold at once (the plan's wave is this
// times the SM count), or a negative CUDA error code.
extern "C" int scaffold_update_blocks_per_sm(int ty, int tg, int tc, int mom,
                                             int cap) {
  const void* k = nullptr;
  if (ty < 0 || ty > 1 || tg < 0 || tg > 1 || tc < 0 || tc > 1 || mom < 0 ||
      mom > 1 || !with_capacity(cap, [&](auto c) {
        constexpr int C = decltype(c)::value;
        k = mom ? kernel_for<C, true>(ty, tg, tc)
                : kernel_for<C, false>(ty, tg, tc);
      }))
    return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

// One launch over a dtype group. plan: the int64 array the wrapper builds
// from ops.update_plan, [ty, tg, tc, mom, n_leaves, cap, grid,
// size[n_leaves], first[n_leaves + 1]] (dtype codes 0 fp32, 1 bf16; cap
// the table's capacity; first the prefix of the leaves' chunk counts).
// ptrs: n_leaves device pointers a role, roles y, g, c, out and, for the
// heavy-ball step (B2, mom 1), the fp32 slot m and m_out. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it refuses; 0 and no launch for a
// group with no element, whose grid is 0).
extern "C" int scaffold_update_group(const long long* plan,
                                     const void* const* ptrs, float eta,
                                     float beta, void* stream) {
  const long long ty = plan[0], tg = plan[1], tc = plan[2], mom = plan[3];
  const long long n_leaves = plan[4], cap = plan[5], grid = plan[6];
  if (n_leaves < 1 || n_leaves > cap || ty < 0 || ty > 1 || tg < 0 ||
      tg > 1 || tc < 0 || tc > 1 || mom < 0 || mom > 1 ||
      !with_capacity(cap, [](auto) {}))
    return (int)cudaErrorInvalidValue;
  const long long* sizes = plan + 7;
  const long long* first = sizes + n_leaves;
  const long long chunks = first[n_leaves];
  if (grid < 0 || grid > chunks || (grid == 0) != (chunks == 0) ||
      chunks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (grid == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  with_capacity(cap, [&](auto c) {
    constexpr int C = decltype(c)::value;
    err = mom ? launch_group<C, true>(ty, tg, tc, (int)n_leaves, (int)grid,
                                      sizes, first, ptrs, eta, beta, s)
              : launch_group<C, false>(ty, tg, tc, (int)n_leaves, (int)grid,
                                       sizes, first, ptrs, eta, beta, s);
  });
  return err;
}

// The empty kernel with a table of capacity cap (B2's with mom 1) on grid
// blocks: the floor of one launch, not a B1/B2 launch.
extern "C" int scaffold_update_floor(int cap, int mom, int grid,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mom < 0 || mom > 1 || grid < 1 || !with_capacity(cap, [&](auto c) {
        constexpr int C = decltype(c)::value;
        if (mom) empty_kernel<C, true><<<grid, kThreads, 0, s>>>(LeafTable<C, true>{});
        else empty_kernel<C, false><<<grid, kThreads, 0, s>>>(LeafTable<C, false>{});
      }))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
