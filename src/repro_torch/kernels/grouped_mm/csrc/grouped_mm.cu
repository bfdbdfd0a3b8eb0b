// Grouped matrix product for Hopper (sm_90a), fp32: the ragged product of
// the routed experts (lax.ragged_dot in the JAX package's
// models/layers.py moe_block_ragged, which is XLA, not a Pallas kernel).
//
//   forward   out[m, :] = a[m, :] @ b[g(m)]        a (M, K), b (G, K, N)
//   weights   db[g]     = a[seg g]^T @ d[seg g]    a (M, K), d (M, N)
//
// The rows of a come sorted by group; ends (G,) int32, on the device, holds
// each group's cumulative end row, so group g owns rows [ends[g-1], ends[g])
// and may be empty. A row's group is found on the device by a binary search
// over ends: nothing is read back to the host, so a decode step that runs
// this kernel makes no host sync (torch._grouped_mm's fp32 path on CUDA
// copies the offsets to the host). Rows at or past ends[G-1] give zeros.
// The input gradient a' = d @ b[g]^T is the forward with b's last two
// strides swapped.
//
// Every operand is read by element strides, out is written contiguous.
// Each output element is one thread's fp32 sum in index order, so a result
// is the same from run to run (no atomics, no split sums).
//
// Layout: 16 x 16 threads a block, one output element a thread.
//  * forward: the block's 16 rows of a and 16 columns of the reduction go
//    through shared memory in steps of 16; b is read from global memory by
//    each row's group (the rows of a tile may belong to two groups), 16
//    threads of a row reading 16 consecutive columns.
//  * weights: one block a (16 x 16 tile of db[g], g); the group's rows go
//    through shared memory 16 at a time, for a and for d.
// This is the simple kernel that is right; the main path's bf16 product
// runs torch._grouped_mm (CUTLASS grouped GEMM on the tensor cores), and
// this one carries the fp32 models only.
#include <cuda_runtime.h>

namespace {

constexpr int T = 16;

__device__ __forceinline__ int group_of(const int* ends, int G, int m) {
  int lo = 0, hi = G;  // first g with ends[g] > m, G when none
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (ends[mid] > m) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__global__ void grouped_fwd(int M, int K, int N, int G,
                            const float* __restrict__ a, long long sam,
                            long long sak, const float* __restrict__ b,
                            long long sbg, long long sbk, long long sbn,
                            const int* __restrict__ ends,
                            float* __restrict__ out) {
  __shared__ float as[T][T + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m = blockIdx.y * T + ty, n = blockIdx.x * T + tx;
  const int g = m < M ? group_of(ends, G, m) : G;
  const float* bg = b + (g < G ? g : 0) * sbg;
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += T) {
    const int ka = k0 + tx;
    as[ty][tx] = (m < M && ka < K) ? a[m * sam + ka * sak] : 0.f;
    __syncthreads();
    if (g < G && n < N) {
      const int kmax = min(T, K - k0);
      for (int kk = 0; kk < kmax; ++kk)
        acc += as[ty][kk] * bg[(k0 + kk) * sbk + n * sbn];
    }
    __syncthreads();
  }
  if (m < M && n < N) out[(long long)m * N + n] = g < G ? acc : 0.f;
}

__global__ void grouped_wgrad(int M, int K, int N, int G,
                              const float* __restrict__ a, long long sam,
                              long long sak, const float* __restrict__ d,
                              long long sdm, long long sdn,
                              const int* __restrict__ ends,
                              float* __restrict__ out) {
  __shared__ float as[T][T + 1];  // [row][k]
  __shared__ float ds[T][T + 1];  // [row][n]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int g = blockIdx.z;
  const int k = blockIdx.y * T + ty, n = blockIdx.x * T + tx;
  const int lo = g ? ends[g - 1] : 0, hi = min(ends[g], M);
  float acc = 0.f;
  for (int r0 = lo; r0 < hi; r0 += T) {
    const int ra = r0 + ty;  // this thread loads row ra: a's k column tx
    const int kl = blockIdx.y * T + tx;
    as[ty][tx] = (ra < hi && kl < K) ? a[ra * sam + kl * sak] : 0.f;
    ds[ty][tx] = (ra < hi && n < N) ? d[ra * sdm + n * sdn] : 0.f;
    __syncthreads();
    const int rmax = min(T, hi - r0);
    for (int rr = 0; rr < rmax; ++rr) acc += as[rr][ty] * ds[rr][tx];
    __syncthreads();
  }
  if (k < K && n < N) out[((long long)g * K + k) * N + n] = acc;
}

}  // namespace

// out (M, N) contiguous fp32. strides in elements. Returns the CUDA error
// of the launch (cudaGetLastError), 0 when it was accepted.
extern "C" int grouped_mm_fwd(int M, int K, int N, int G, const float* a,
                              long long sam, long long sak, const float* b,
                              long long sbg, long long sbk, long long sbn,
                              const int* ends, float* out, void* stream) {
  if (M < 0 || K < 0 || N < 0 || G < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  dim3 block(T, T), grid((N + T - 1) / T, (M + T - 1) / T);
  grouped_fwd<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      M, K, N, G, a, sam, sak, b, sbg, sbk, sbn, ends, out);
  return (int)cudaGetLastError();
}

// out (G, K, N) contiguous fp32: out[g] = a[rows of g]^T @ d[rows of g].
extern "C" int grouped_mm_wgrad(int M, int K, int N, int G, const float* a,
                                long long sam, long long sak, const float* d,
                                long long sdm, long long sdn, const int* ends,
                                float* out, void* stream) {
  if (M < 0 || K < 0 || N < 0 || G < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  if (K == 0 || N == 0) return 0;
  dim3 block(T, T), grid((N + T - 1) / T, (K + T - 1) / T, G);
  grouped_wgrad<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      M, K, N, G, a, sam, sak, d, sdm, sdn, ends, out);
  return (int)cudaGetLastError();
}
