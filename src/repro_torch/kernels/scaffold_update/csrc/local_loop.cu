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
// scaffold_momentum_local_loop_2d (body _momentum_loop_kernel). They run
// a sequential grid=(K,) on one core and keep the packed y and the fp32
// slot m in VMEM from one step to the next.
//
// Bound on the H100: bytes. Each distinct A_k is read once (bsz d^2
// elements) and takes 2 flops an element an output (Am y and Am^T y), so
// the least time is (distinct A_k) * bsz * d^2 * bytes(A) / 3.35 TB/s:
// ~12.5 us at d 1024, K 10 in fp32 with a fresh A_k a step, ~1.3 us when
// A is one broadcast matrix (the trainer's view). What bounds this design
// is its K grid barriers: step k+1 needs all of y_k.
//
// Design: a cooperative grid over the card. G persistent blocks (at most
// one an SM, all co-resident: a cudaLaunchKernelEx launch with the
// cooperative attribute, which a stream capture records as a cooperative
// graph node, so a CUDA graph can replay it)
// each own R consecutive entries I_b of y and hold both slabs that give
// their entries of g alone:
//     row slab     Am[I_b, :]   ->  (Am y)_I
//     column slab  Am[:, I_b]   ->  (Am^T y)_I   (stored transposed)
// so no partial sum crosses blocks and a step needs one grid barrier. In
// a step a block reads y_k (d fp32 values of y's dtype, from L2) out of
// the double-buffered scratch ybuf[2][d], forms its 2R dot products (a
// warp a slab row, lanes over columns, shuffle-reduced in a fixed
// order), updates y_I (and the heavy-ball slot m_I, which stays in the
// owner's shared memory for all K steps as the TPU kernel keeps it in
// VMEM), writes y_I to ybuf[(k+1)&1] and its partial loss
// 0.5 y_I.u_I + bm_I.y_I to partials[k][b], and crosses the barrier.
// After the last step block 0 sums partials[k][0..G-1] in block order.
// No atomics, so two runs are bitwise equal.
//
// Slabs are resident when A is the same at every step (K stride 0, as in
// the trainer's broadcast view, or K == 1) and fit: loaded once as
// mean_b A in fp32, so a step reads only y. Otherwise they stream: each
// step loads them in column chunks. (Asking L2 for A_{k+1} during step k,
// which needs no y, was tried and made the fresh layout slower.) fp32
// slabs of one matrix a step go straight to shared memory through
// cp.async, every element of a thread in flight at once; a batch mean or
// bf16 goes through registers, 16 or 8 elements a thread at once. The
// plan (G, R, chunk, resident, shared memory) is made by the Python
// wrapper (megakernel.local_loop_plan) and checked here. A and b may be
// broadcast views: the K and bsz dimensions take any element stride, the
// (d, d) and (d,) inner blocks are dense.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// slab elements a thread loads at once through registers: 16 fp32, 8 bf16
// (12 and 16 spill a few bytes there under the 128 registers a thread of
// 512 may hold)
template <typename TA> constexpr int kU = sizeof(TA) == 4 ? 16 : 8;
constexpr int kPad = 4;  // floats of padding after each slab row

struct Plan {
  int rows;      // R: entries of y a block owns (the last block may own fewer)
  int chunk;     // slab columns a chunk (d when resident)
  int resident;  // slabs loaded once, before step 0
};

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

// Floats of dynamic shared memory: the two slabs (R rows of chunk + kPad),
// the y chunk, and 6 R for the row sums (2 R), y_I, corr_I, m_I and bm_I.
__host__ __device__ inline long long smem_floats(int rows, int chunk) {
  return 2LL * rows * (chunk + kPad) + chunk + 6LL * rows;
}

// One slab's columns [j0, j0 + cn) into shared memory as mean_b in fp32:
// the row slab (kCol false) holds A[i0 + r][j0 + jj] at dst[r][jj], the
// column slab A[j0 + jj][i0 + r] at dst[r][jj]. Consecutive threads read
// consecutive addresses (along a row, or along the n columns of I).
// fp32 A with one matrix a step (the trainer's case) is copied straight
// into shared memory by cp.async, which holds no register, so all of a
// thread's elements are in flight at once; the caller waits for them
// (async_wait) before its next __syncthreads. Otherwise kU elements a
// thread are in flight together, batch 0 first, and summed in registers.
// Offsets are taken from the chunk's corner and fit 32 bits (the host
// entry checks n * d and cn * d).
template <bool kCol, typename TA>
__device__ __forceinline__ void load_slab(float* dst, const TA* __restrict__ Ak,
                                          long long a_sb, int bsz, float inv_b,
                                          int d, int i0, int n, int j0, int cn,
                                          int stride) {
  const int total = n * cn;
  const TA* corner = Ak + (kCol ? (long long)j0 * d + i0 : (long long)i0 * d + j0);
  if constexpr (sizeof(TA) == 4) {
    if (bsz == 1) {
      for (int e = threadIdx.x; e < total; e += kThreads) {
        const int jj = kCol ? e / n : e % cn;
        const int r = kCol ? e - jj * n : e / cn;
        const unsigned to =
            static_cast<unsigned>(__cvta_generic_to_shared(dst + r * stride + jj));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
                     "l"(corner + (kCol ? jj * d + r : r * d + jj)));
      }
      return;
    }
  }
  constexpr int U = kU<TA>;
  for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * U) {
    int off[U], at[U];
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads;
      int r, jj;
      if (kCol) {
        jj = e / n;
        r = e - jj * n;
      } else {
        r = e / cn;
        jj = e - r * cn;
      }
      const bool ok = e < total;
      off[u] = !ok ? -1 : kCol ? jj * d + r : r * d + jj;
      at[u] = r * stride + jj;
      v[u] = ok ? to_f(corner[off[u]]) : 0.f;
    }
    for (int bb = 1; bb < bsz; ++bb) {
      const TA* Ab = corner + (long long)bb * a_sb;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (off[u] >= 0) v[u] += to_f(Ab[off[u]]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (off[u] >= 0) dst[at[u]] = bsz > 1 ? v[u] * inv_b : v[u];
  }
}

// Wait for this thread's cp.async copies (none outstanding: a no-op).
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool kMom, typename TY, typename TC, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads, 1)
grid_loop_kernel(const TY* __restrict__ y0, const TC* __restrict__ corr,
                 const float* __restrict__ m0, const TA* __restrict__ A,
                 long long a_sk, long long a_sb, const TB* __restrict__ b,
                 long long b_sk, long long b_sb, const float* __restrict__ eta,
                 float beta, TY* __restrict__ y_out, float* __restrict__ m_out,
                 float* __restrict__ losses, float* ybuf, float* partials,
                 int K, int bsz, int d, Plan p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int R = p.rows, stride = p.chunk + kPad;
  float* srow = smem;                          // R x stride: Am[I, chunk]
  float* scol = srow + (long long)R * stride;  // R x stride: Am[chunk, I]^T
  float* ysc = scol + (long long)R * stride;   // chunk: y_k[chunk]
  float* acc = ysc + p.chunk;                  // 2R: (Am y)_I, (Am^T y)_I
  float* yown = acc + 2 * R;                   // R: y_I
  float* cown = yown + R;                      // R: corr_I
  float* mown = cown + R;                      // R: m_I (B4)
  float* bown = mown + R;                      // R: bm_I of this step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x;
  const int i0 = blockIdx.x * R;
  const int n = min(R, d - i0);  // >= 1: the plan gives every block an entry
  const float inv_b = 1.0f / (float)bsz;

  for (int r = threadIdx.x; r < n; r += kThreads) {
    yown[r] = to_f(y0[i0 + r]);
    cown[r] = corr ? to_f(corr[i0 + r]) : 0.f;
    mown[r] = kMom ? m0[i0 + r] : 0.f;
  }
  if (p.resident) {
    load_slab<false>(srow, A, a_sb, bsz, inv_b, d, i0, n, 0, d, stride);
    load_slab<true>(scol, A, a_sb, bsz, inv_b, d, i0, n, 0, d, stride);
  }

  for (int k = 0; k < K; ++k) {
    const TA* Ak = A + (long long)k * a_sk;
    const float* ycur = ybuf + (long long)(k & 1) * d;
    // this step's eta and bm_I, loaded now so that they arrive with y_k
    const float e = warp == 0 ? eta[k] : 0.f;
    const TB* bk = b + (long long)k * b_sk;
    for (int r = threadIdx.x; r < n; r += kThreads) {
      float s = to_f(bk[i0 + r]);
      for (int bb = 1; bb < bsz; ++bb) s += to_f(bk[(long long)bb * b_sb + i0 + r]);
      bown[r] = bsz == 1 ? s : s * inv_b;
    }
    for (int j0 = 0; j0 < d; j0 += p.chunk) {
      const int cn = min(p.chunk, d - j0);
      if (!p.resident) {
        load_slab<false>(srow, Ak, a_sb, bsz, inv_b, d, i0, n, j0, cn, stride);
        load_slab<true>(scol, Ak, a_sb, bsz, inv_b, d, i0, n, j0, cn, stride);
      }
      // y_k was written by the other blocks: read it from L2, not L1
      for (int jj = threadIdx.x; jj < cn; jj += kThreads)
        ysc[jj] = k == 0 ? to_f(y0[j0 + jj]) : __ldcg(ycur + j0 + jj);
      async_wait();
      __syncthreads();
      for (int q = warp; q < 2 * n; q += kWarps) {
        const float* row = q < n ? srow + (long long)q * stride
                                 : scol + (long long)(q - n) * stride;
        float s0 = 0.f, s1 = 0.f;
        int jj = lane;
        for (; jj + 32 < cn; jj += 64) {
          s0 = fmaf(row[jj], ysc[jj], s0);
          s1 = fmaf(row[jj + 32], ysc[jj + 32], s1);
        }
        if (jj < cn) s0 = fmaf(row[jj], ysc[jj], s0);
        const float s = warp_sum(s0 + s1);
        if (lane == 0) acc[q] = j0 == 0 ? s : acc[q] + s;
      }
      __syncthreads();
    }
    // warp 0: the loss at the pre-update y_I, the step, y_I out
    if (warp == 0) {
      float* ynext = ybuf + (long long)((k + 1) & 1) * d;
      float part = 0.f;
      for (int r = lane; r < n; r += 32) {
        const int i = i0 + r;
        const float bm = bown[r];
        const float u = acc[r], v = acc[n + r], yi = yown[r];
        part += fmaf(0.5f * u, yi, bm * yi);
        const float g = 0.5f * (u + v) + bm + cown[r];
        float step = g;
        if (kMom) {
          step = beta * mown[r] + g;
          mown[r] = step;
        }
        const float yn = to_f(from_f<TY>(yi - e * step));
        yown[r] = yn;
        ynext[i] = yn;
      }
      part = warp_sum(part);
      if (lane == 0) partials[(long long)k * G + blockIdx.x] = part;
    }
    grid.sync();  // also a block barrier and a memory fence
  }
  for (int r = threadIdx.x; r < n; r += kThreads) {
    y_out[i0 + r] = from_f<TY>(yown[r]);
    if (kMom) m_out[i0 + r] = mown[r];
  }
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < K; k += kThreads) {
      float s = 0.f;
      for (int c = 0; c < G; ++c) s += __ldcg(partials + (long long)k * G + c);
      losses[k] = s;
    }
  }
}

// The design's floor: K grid barriers and nothing else.
__global__ void __launch_bounds__(kThreads, 1) barrier_kernel(int K) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < K; ++k) grid.sync();
}

// local_loop's and local_loop_barrier_floor's return for a grid that
// cannot be co-resident (CUDA's own error codes are all >= 0).
constexpr int kNotCoResident = -1;

// What a device has been told about each kernel: the largest dynamic
// shared memory it was allowed (the attribute only caps a launch's own
// request, so it is raised, never lowered), and for each shared memory
// size the blocks of it the card holds at once.
struct SmemLimit {
  int dev;
  const void* kern;
  size_t smem;
};
struct Capacity {
  int dev;
  const void* kern;
  size_t smem;
  long long blocks;
};
std::mutex prepared_mutex;
std::vector<SmemLimit> limits;
std::vector<Capacity> capacities;

// Allow the kernel `smem` bytes of dynamic shared memory and check that
// `blocks` of it fit on the card at once (a cooperative launch needs all
// of them co-resident). The attribute and the occupancy query run at the
// first launch that needs them only, so a launch that a CUDA graph
// captures after a warm-up makes neither call. Returns a CUDA error code
// or kNotCoResident.
int prepare(const void* kern, size_t smem, int blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(prepared_mutex);
  SmemLimit* limit = nullptr;
  for (SmemLimit& l : limits)
    if (l.dev == dev && l.kern == kern) limit = &l;
  if (limit == nullptr || limit->smem < smem) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (limit == nullptr) limits.push_back({dev, kern, smem});
    else limit->smem = smem;
  }
  for (const Capacity& c : capacities)
    if (c.dev == dev && c.kern == kern && c.smem == smem)
      return c.blocks < blocks ? kNotCoResident : 0;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  capacities.push_back({dev, kern, smem, (long long)per_sm * sms});
  return (long long)per_sm * sms < blocks ? kNotCoResident : 0;
}

// One cooperative launch of `grid` blocks of kThreads, through
// cudaLaunchKernelEx with the cooperative attribute.
cudaError_t launch_cooperative(const void* kern, int grid, size_t smem,
                               void** args, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kern, args);
}

template <typename T> struct Tag { using type = T; };

// f(Tag<float>{}) for dtype code 0, f(Tag<__nv_bfloat16>{}) for 1
template <typename F> void with_dtype(int code, F f) {
  if (code == 0) f(Tag<float>{});
  else f(Tag<__nv_bfloat16>{});
}

}  // namespace

// The K-step loop for one client on a cooperative grid of `grid` blocks.
// Dtype codes: 0 fp32, 1 bf16, for y (and y_out), corr, A and b. corr may
// be null (no correction). m0 and m_out: (d,) fp32 slot in and out for
// the heavy-ball loop (B4), or both null (B3; beta unused). a_sk/a_sb and
// b_sk/b_sb are the element strides of the K and bsz dimensions of A
// (K, bsz, d, d) and b (K, bsz, d). eta: (K,) fp32 on the device; losses:
// (K,) fp32 out. ybuf: (2, d) fp32 and partials: (K, grid) fp32 scratch.
// rows, chunk, resident and smem are the wrapper's plan; an
// inconsistent plan returns cudaErrorInvalidValue, a grid that cannot be
// co-resident kNotCoResident (-1). Otherwise returns cudaGetLastError()
// after the launch.
extern "C" int local_loop(int ty, int tc, int ta, int tb, const void* y0,
                          const void* corr, const void* m0, const void* A,
                          long long a_sk, long long a_sb, const void* b,
                          long long b_sk, long long b_sb, const void* eta,
                          float beta, void* y_out, void* m_out, void* losses,
                          void* ybuf, void* partials, int K, int bsz, int d,
                          int grid, int rows, int chunk, int resident,
                          long long smem, void* stream) {
  if (ty < 0 || ty > 1 || tc < 0 || tc > 1 || ta < 0 || ta > 1 || tb < 0 ||
      tb > 1 || K < 1 || bsz < 1 || d < 1 ||
      (m0 == nullptr) != (m_out == nullptr) || grid < 1 || rows < 1 ||
      (long long)(grid - 1) * rows >= d || (long long)grid * rows < d ||
      chunk < 1 || chunk > d || (resident && chunk != d) ||
      (long long)rows * d > 0x7fffffffLL || (long long)chunk * d > 0x7fffffffLL ||
      smem != 4LL * smem_floats(rows, chunk))
    return (int)cudaErrorInvalidValue;
  const bool mom = m0 != nullptr;
  const Plan plan{rows, chunk, resident ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  with_dtype(ty, [&](auto y_tag) {
    with_dtype(tc, [&](auto c_tag) {
      with_dtype(ta, [&](auto a_tag) {
        with_dtype(tb, [&](auto b_tag) {
          using TY = typename decltype(y_tag)::type;
          using TC = typename decltype(c_tag)::type;
          using TA = typename decltype(a_tag)::type;
          using TB = typename decltype(b_tag)::type;
          auto kern = mom ? grid_loop_kernel<true, TY, TC, TA, TB>
                          : grid_loop_kernel<false, TY, TC, TA, TB>;
          err = prepare(reinterpret_cast<const void*>(kern), (size_t)smem,
                        grid);
          if (err != 0) return;
          const TY* a_y0 = static_cast<const TY*>(y0);
          const TC* a_corr = static_cast<const TC*>(corr);
          const float* a_m0 = static_cast<const float*>(m0);
          const TA* a_A = static_cast<const TA*>(A);
          const TB* a_b = static_cast<const TB*>(b);
          const float* a_eta = static_cast<const float*>(eta);
          TY* a_yout = static_cast<TY*>(y_out);
          float* a_mout = static_cast<float*>(m_out);
          float* a_losses = static_cast<float*>(losses);
          float* a_ybuf = static_cast<float*>(ybuf);
          float* a_part = static_cast<float*>(partials);
          void* args[] = {&a_y0,   &a_corr, &a_m0,    &a_A,     &a_sk,
                          &a_sb,   &a_b,    &b_sk,    &b_sb,    &a_eta,
                          &beta,   &a_yout, &a_mout,  &a_losses, &a_ybuf,
                          &a_part, &K,      &bsz,     &d,       const_cast<Plan*>(&plan)};
          err = (int)launch_cooperative(reinterpret_cast<const void*>(kern),
                                        grid, (size_t)smem, args, s);
        });
      });
    });
  });
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// K grid barriers on a cooperative grid of `grid` blocks with smem bytes
// of dynamic shared memory, and nothing else: the design's floor, timed
// beside the loop by chip_smoke.py. Returns as local_loop does.
extern "C" int local_loop_barrier_floor(int grid, int K, long long smem,
                                        void* stream) {
  if (grid < 1 || K < 0 || smem < 0) return (int)cudaErrorInvalidValue;
  const void* kern = reinterpret_cast<const void*>(barrier_kernel);
  const int err = prepare(kern, (size_t)smem, grid);
  if (err != 0) return err;
  void* args[] = {&K};
  const cudaError_t launch = launch_cooperative(
      kern, grid, (size_t)smem, args, static_cast<cudaStream_t>(stream));
  if (launch != cudaSuccess) return (int)launch;
  return (int)cudaGetLastError();
}
