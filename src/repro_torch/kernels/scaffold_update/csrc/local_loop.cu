// The whole K-step SCAFFOLD local loop on quadratic clients, one launch
// per client, for Hopper (sm_90a). At step k:
//
//     Am = mean_b A[k, b]        bm = mean_b b[k, b]
//     loss[k] = 0.5 * y.(Am y) + bm.y                (pre-update y)
//     g = 0.5 * (Am y + Am^T y) + bm + corr
//     B3 (sgd, sgd_sched):  y <- round_to_dtype(y - eta[k] * g)
//     B4 (heavy ball):      m <- beta * m + g
//                           y <- round_to_dtype(y - eta[k] * m)
//
// Replaces the TPU kernels src/repro/kernels/scaffold_update/megakernel.py:
// scaffold_local_loop_2d (bodies _local_loop_kernel and _grad_terms) and
// scaffold_momentum_local_loop_2d (body _momentum_loop_kernel), whose
// fp32 slot m stays on chip for all K steps and comes back as m_K.
//
// Bound on the H100: bytes. Every step streams its bsz (d, d) matrices
// once and does 2 flops per element read per output (Am y and Am^T y), so
// the least time is K * bsz * d^2 * bytes(A) / 3.35 TB/s; the slot adds
// 8 bytes an element of y, read once and written once.
//
// Design: step k+1 needs all of y_k, and blocks of a grid carry nothing
// from one grid step to the next, so the K loop runs inside one thread
// block. y (as fp32 values of its own dtype), corr and the slot m sit in
// shared memory for all K steps; A_k streams from device memory in
// coalesced row segments. One pass over A_k yields both Am y and Am^T y,
// so the symmetrised matrix is never formed: a warp owns rows i = warp,
// warp+W, ..., its lanes own the columns of a 32*R-wide column tile. Row
// sums (Am y) reduce across lanes and add up tile by tile in a fixed
// order; column sums (Am^T y) stay in registers over the warp's rows and
// reduce across warps in a fixed order through shared memory. No
// atomics, so a run is deterministic. One block is far from the bound at
// d = 1024 (one SM's share of the memory bandwidth); a cluster- or
// grid-wide version is later work. A and b may be broadcast views: the K
// and bsz dimensions take any element stride, the (d, d) and (d,) inner
// blocks are dense.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 4;                 // columns per lane per tile
constexpr int kTile = 32 * kR;        // tile width
constexpr int kU = 4;                 // rows a warp loads at once

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over the block; every thread gets the result. red: kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

template <bool kMom, typename TY, typename TC, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads, 1)
local_loop_kernel(const TY* __restrict__ y0, const TC* __restrict__ corr,
                  const float* __restrict__ m0,
                  const TA* __restrict__ A, long long a_sk, long long a_sb,
                  const TB* __restrict__ b, long long b_sk, long long b_sb,
                  const float* __restrict__ eta, float beta,
                  TY* __restrict__ y_out, float* __restrict__ m_out,
                  float* __restrict__ losses, int K, int bsz, int d) {
  extern __shared__ float smem[];
  float* ys = smem;              // d: current y, fp32 values of TY
  float* cs = ys + d;            // d: corr
  float* u = cs + d;             // d: Am y
  float* v = u + d;              // d: Am^T y
  float* wv = v + d;             // kWarps * kTile: per-warp column sums
  float* red = wv + kWarps * kTile;  // kWarps
  float* ms = red + kWarps;      // d, B4 only: the heavy-ball slot
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_b = 1.0f / (float)bsz;

  for (int j = threadIdx.x; j < d; j += kThreads) {
    ys[j] = to_f(y0[j]);
    cs[j] = corr ? to_f(corr[j]) : 0.f;
    if (kMom) ms[j] = m0[j];
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const TA* Ak = A + (long long)k * a_sk;
    for (int i = threadIdx.x; i < d; i += kThreads) u[i] = 0.f;
    __syncthreads();
    for (int t0 = 0; t0 < d; t0 += kTile) {
      float vacc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) vacc[r] = 0.f;
      // kU rows a warp at a time
      for (int i0 = warp; i0 < d; i0 += kWarps * kU) {
        // batch 0 for every (row, column) first, then the others: the
        // loads of one pass are independent, so all kU*kR are in flight
        // together (a running sum over a runtime-length batch loop would
        // wait out each load's latency in turn)
        float a[kU][kR];
#pragma unroll
        for (int q = 0; q < kU; ++q) {
          const int i = i0 + q * kWarps;
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const int j = t0 + lane + 32 * r;
            a[q][r] = (i < d && j < d) ? to_f(Ak[(long long)i * d + j]) : 0.f;
          }
        }
        for (int bb = 1; bb < bsz; ++bb) {
          const TA* Ab = Ak + (long long)bb * a_sb;
#pragma unroll
          for (int q = 0; q < kU; ++q) {
            const int i = i0 + q * kWarps;
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              const int j = t0 + lane + 32 * r;
              if (i < d && j < d) a[q][r] += to_f(Ab[(long long)i * d + j]);
            }
          }
        }
        if (bsz > 1) {
#pragma unroll
          for (int q = 0; q < kU; ++q)
#pragma unroll
            for (int r = 0; r < kR; ++r) a[q][r] *= inv_b;
        }
#pragma unroll
        for (int q = 0; q < kU; ++q) {
          const int i = i0 + q * kWarps;
          if (i < d) {
            const float yi = ys[i];
            float up = 0.f;
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              const int j = t0 + lane + 32 * r;
              if (j < d) {
                up = fmaf(a[q][r], ys[j], up);
                vacc[r] = fmaf(a[q][r], yi, vacc[r]);
              }
            }
            up = warp_sum(up);
            if (lane == 0) u[i] += up;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) wv[warp * kTile + lane + 32 * r] = vacc[r];
      __syncthreads();
      for (int jj = threadIdx.x; jj < kTile; jj += kThreads) {
        const int j = t0 + jj;
        if (j < d) {
          float s = 0.f;
          for (int w = 0; w < kWarps; ++w) s += wv[w * kTile + jj];
          v[j] = s;
        }
      }
      __syncthreads();
    }
    // loss at the pre-update y, then the corrected step
    const TB* bk = b + (long long)k * b_sk;
    const float e = eta[k];
    float quad = 0.f, lin = 0.f;
    for (int j = threadIdx.x; j < d; j += kThreads) {
      float s = 0.f;
      for (int bb = 0; bb < bsz; ++bb) s += to_f(bk[(long long)bb * b_sb + j]);
      const float bm = bsz == 1 ? s : s * inv_b;
      const float yj = ys[j];
      quad = fmaf(u[j], yj, quad);
      lin = fmaf(bm, yj, lin);
      const float g = 0.5f * (u[j] + v[j]) + bm + cs[j];
      if (kMom) {
        const float mj = beta * ms[j] + g;
        ms[j] = mj;
        ys[j] = to_f(from_f<TY>(yj - e * mj));
      } else {
        ys[j] = to_f(from_f<TY>(yj - e * g));
      }
    }
    quad = block_sum(quad, red);
    lin = block_sum(lin, red);
    if (threadIdx.x == 0) losses[k] = 0.5f * quad + lin;
    __syncthreads();
  }
  for (int j = threadIdx.x; j < d; j += kThreads) {
    y_out[j] = from_f<TY>(ys[j]);
    if (kMom) m_out[j] = ms[j];
  }
}

template <typename T> struct Tag { using type = T; };

// f(Tag<float>{}) for dtype code 0, f(Tag<__nv_bfloat16>{}) for 1
template <typename F> void with_dtype(int code, F f) {
  if (code == 0) f(Tag<float>{});
  else f(Tag<__nv_bfloat16>{});
}

}  // namespace

// Bytes of dynamic shared memory one launch at width d needs; mom != 0
// for the heavy-ball loop (B4), which keeps its slot there too.
extern "C" long long local_loop_smem_bytes(int d, int mom) {
  return (long long)((mom ? 5LL : 4LL) * d + (long long)kWarps * kTile + kWarps) * 4LL;
}

// The K-step loop for one client. Dtype codes: 0 fp32, 1 bf16, for y (and
// y_out), corr, A and b. corr may be null (no correction). m0 and m_out:
// (d,) fp32 slot in and out for the heavy-ball loop (B4), or both null
// (B3; beta unused). a_sk/a_sb and b_sk/b_sb are the element strides of
// the K and bsz dimensions of A (K, bsz, d, d) and b (K, bsz, d). eta:
// (K,) fp32 on the device; losses: (K,) fp32 out. Returns
// cudaGetLastError() after the launch, or the error of the shared-memory
// attribute call that refused the width.
extern "C" int local_loop(int ty, int tc, int ta, int tb, const void* y0,
                          const void* corr, const void* m0, const void* A,
                          long long a_sk, long long a_sb, const void* b,
                          long long b_sk, long long b_sb, const void* eta,
                          float beta, void* y_out, void* m_out, void* losses,
                          int K, int bsz, int d, void* stream) {
  if (ty < 0 || ty > 1 || tc < 0 || tc > 1 || ta < 0 || ta > 1 || tb < 0 ||
      tb > 1 || K < 1 || bsz < 1 || d < 1 ||
      (m0 == nullptr) != (m_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool mom = m0 != nullptr;
  const size_t smem = (size_t)local_loop_smem_bytes(d, mom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  with_dtype(ty, [&](auto y_tag) {
    with_dtype(tc, [&](auto c_tag) {
      with_dtype(ta, [&](auto a_tag) {
        with_dtype(tb, [&](auto b_tag) {
          using TY = typename decltype(y_tag)::type;
          using TC = typename decltype(c_tag)::type;
          using TA = typename decltype(a_tag)::type;
          using TB = typename decltype(b_tag)::type;
          auto kern = mom ? local_loop_kernel<true, TY, TC, TA, TB>
                          : local_loop_kernel<false, TY, TC, TA, TB>;
          err = cudaFuncSetAttribute(
              kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
          if (err != cudaSuccess) return;
          kern<<<1, kThreads, smem, s>>>(
              static_cast<const TY*>(y0), static_cast<const TC*>(corr),
              static_cast<const float*>(m0), static_cast<const TA*>(A), a_sk,
              a_sb, static_cast<const TB*>(b), b_sk, b_sb,
              static_cast<const float*>(eta), beta, static_cast<TY*>(y_out),
              static_cast<float*>(m_out), static_cast<float*>(losses), K, bsz,
              d);
        });
      });
    });
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
