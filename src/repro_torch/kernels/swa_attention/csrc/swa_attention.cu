// Sliding-window causal attention for Hopper (sm_90a), the forward pass of
// the "W" layers of gemma3-style models (B5):
//
//   o = softmax(mask(q k^T / sqrt(D))) v,   mask: 0 <= q_pos - k_pos < W
//
// q is (B, S, Hq, D), k and v are (B, S, Hkv, D), read by strides with the
// head dim contiguous (the model layout: no transposed copies); query head
// h reads kv head h / (Hq / Hkv), so kv is never repeated in memory.
// Scores, the running max and sum and the accumulator are fp32; the output
// is rounded to q's dtype once, at the end.
//
// Replaces the TPU kernel src/repro/kernels/swa_attention/kernel.py:
// swa_attention_bhsd (body _swa_kernel), whose grid walks only the kv
// blocks inside each q block's band, so the work is O(S*W), not O(S^2).
//
// Bound on the H100: operations. At gemma3-1b's shape (S 2048, W 512,
// 4 query heads of D 256 over one kv head) the band holds ~0.92M (q, k)
// pairs a head at 4*D flops each, 3.8 GFLOP against 10.5 MB of q, k, v
// and o: ~360 flop/byte, past the bf16 ridge (~295).
//
// Design, a simple kernel that is right first (tensor cores, wgmma and TMA
// are later work):
//  * One block of 256 threads per (q tile of 64 rows, query head, batch).
//    On the TPU the sequential innermost grid axis carried (m, l, acc)
//    across kv blocks in scratch; here a loop inside the block walks the
//    band's kv tiles of 64 keys, [max(0, q0 - W + 1), q0 + 63].
//  * The Q tile and one K-or-V tile live in shared memory as fp32, rows
//    padded to D + 1 floats so that the strided reads below hit distinct
//    banks. At D 256 that is 2 x 64 x 257 x 4 B plus the 64 x 65 score
//    tile: 149 KB, above the 48 KB default, so every launch first raises
//    the kernel's dynamic shared memory limit.
//  * Scores: a 4 x 4 micro-tile a thread (rows ty + 16i, keys tx + 16j),
//    CUDA-core FMAs over D. The masked scores go to shared memory as -inf.
//  * Online softmax, 4 threads a row: tile max by shuffles, p = exp(s - m)
//    (0 where masked), the rescale alpha = exp(m_old - m_new) and the
//    running sum l kept per row in shared memory. The V tile is staged into
//    the K tile's buffer meanwhile.
//  * acc = alpha * acc + P V, a thread's 4 rows x D/16 columns in
//    registers (64 floats at D 256); o = acc / max(l, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a kv tile
constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kLP = kBK + 1;   // row stride of the score tile (floats)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// element strides of one tensor over (batch, sequence, head); head dim 1
struct Strides {
  long long b, s, h;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (D + 1) + kBQ * kLP + 3 * kBQ);
}

// rows [row0, row0 + 64) of one head of x into smem (fp32, row stride D+1);
// rows at or past S are zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x,
                                      long long row_stride, int row0, int S) {
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < S ? to_f(x[(long long)row * row_stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
swa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, Strides sq,
               Strides sk, Strides sv, Strides so, int S, int n_rep,
               int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int CPT = D / 16;  // output columns a thread
  extern __shared__ float smem[];
  float* sQ = smem;             // [kBQ][LD]
  float* sKV = sQ + kBQ * LD;   // [kBK][LD]: the tile's K, then its V
  float* sP = sKV + kBK * LD;   // [kBQ][kLP]: scores, then probabilities
  float* sM = sP + kBQ * kLP;   // [kBQ] running max
  float* sL = sM + kBQ;         // [kBQ] running sum
  float* sA = sL + kBQ;         // [kBQ] this tile's rescale factor

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / n_rep;
  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + hk * sk.h;
  const T* vh = v + b * sv.b + hk * sv.h;

  stage<T, D>(sQ, qh, sq.s, q0, S);
  if (tid < kBQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  // the band's kv tiles: keys [max(0, q0 - W + 1), min(q0 + 63, S - 1)]
  const int t_lo = max(0, q0 - window + 1) / kBK;
  const int t_hi = min(q0 + kBQ - 1, S - 1) / kBK;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's P V is done with sKV and sP
    stage<T, D>(sKV, kh, sk.s, k0, S);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sKV[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, kk = tx + 16 * j;
        const int rel = (q0 + r) - (k0 + kk);
        const bool keep = rel >= 0 && rel < window && k0 + kk < S;
        sP[r * kLP + kk] = keep ? sc[i][j] * scale : -INFINITY;
      }
    __syncthreads();  // every score written, K no longer read

    stage<T, D>(sKV, vh, sv.s, k0, S);
    {
      // online softmax of the tile, 4 threads a row, 16 keys each
      const int r = tid >> 2, part = tid & 3;
      float* pr = sP + r * kLP + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, pr[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float s = pr[j];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        pr[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();  // P, alpha and the V tile ready

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * kLP + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = sKV[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  T* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= S) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    T* orow = oh + (long long)row * so.s;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / l);
  }
}

template <typename T, int D>
int launch(int B, int S, int Hq, int Hkv, int window, const void* q,
           const void* k, const void* v, void* o, const long long* st,
           float scale, cudaStream_t stream) {
  auto kernel = swa_fwd_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, S,
      Hq / Hkv, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, int B, int S, int Hq, int Hkv, int window,
               const void* q, const void* k, const void* v, void* o,
               const long long* st, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(B, S, Hq, Hkv, window, q, k, v, o, st, scale, stream);
    case 64: return launch<T, 64>(B, S, Hq, Hkv, window, q, k, v, o, st, scale, stream);
    case 128: return launch<T, 128>(B, S, Hq, Hkv, window, q, k, v, o, st, scale, stream);
    case 256: return launch<T, 256>(B, S, Hq, Hkv, window, q, k, v, o, st, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (q, k, v and o alike). strides: 12 element strides,
// (batch, sequence, head) of q, k, v and o in that order. Returns the CUDA
// error of the launch (cudaGetLastError), 0 when it was accepted.
extern "C" int swa_attention_fwd(int dtype, int B, int S, int Hq, int Hkv,
                                 int D, int window, const void* q,
                                 const void* k, const void* v, void* o,
                                 const long long* strides, float scale,
                                 void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 || window < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, B, S, Hq, Hkv, window, q, k, v, o, strides, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, B, S, Hq, Hkv, window, q, k, v, o, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
