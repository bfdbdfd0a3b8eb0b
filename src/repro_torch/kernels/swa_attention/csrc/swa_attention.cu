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
// and o: ~360 flop/byte, past the bf16 ridge (~295). So the products
// belong on the tensor cores.
//
// bf16 (the model's dtype, the main path): swa_fwd_wgmma, one warpgroup of
// 128 threads per (q tile of 64 rows, query head, batch).
//  * Grid. 64-row tiles, one query head a block: gemma3-1b at batch 1 gives
//    32 q tiles x 4 heads = 128 blocks, one wave on 132 SMs. Packing the 4
//    heads that share a kv head into one block would feed four heads from
//    one K/V tile but leave 32 blocks, a quarter of the card; the heads'
//    shared K/V (1 MB a kv head) is reread from L2 instead.
//  * Copies. TMA brings Q once and the band's K and V tiles of 64 keys
//    through a ring of 2 stages, each completing on its own mbarrier, so
//    the next tile's copy is in flight while the current one is
//    multiplied; thread 0 refills a stage once the warpgroup is done with
//    it. The tensor maps are (D, H, S, B) over the model layout, boxes of
//    64 rows by 128 bytes of the head dim (64 bytes at D 32) with the
//    matching shared-memory swizzle, built on the host per call through
//    cudaGetDriverEntryPoint (the library links against the runtime only).
//    Rows past S arrive as zeros.
//  * S = Q K^T: D/16 wgmma m64n64k16, bf16 in, fp32 out, Q and K both
//    K-major in shared memory (D is contiguous in both).
//  * Online softmax in registers: a thread holds 2 rows x 16 keys of S;
//    row max and sum across the 4 threads of a row by shuffles. Masked
//    scores are -inf, p = exp(s - m) with m taken as 0 while a row has
//    seen no key (so p = 0 and the rescale alpha = 0, never the TPU
//    kernel's -1e30). Only the band's edge tiles (and tiles past S) test
//    each element; the tiles wholly inside the band take no mask.
//  * O += P V keeps the fp32 probabilities, as the reference does: p is
//    split in registers into p_hi = bf16(p) and p_lo = bf16(p - p_hi)
//    (|p - p_hi - p_lo| <= 2^-18 p, the size of fp32 summation noise), and
//    two wgmma m64nDk16 per 16 keys, P_hi V and P_lo V, add into the same
//    fp32 accumulator: P from registers in the accumulator's own layout,
//    V from shared memory MN-major (the instruction transposes it). A
//    plain bf16 P would compute another function (some 40 bf16 ulp off the
//    reference), the dense sliding path's. The row sum l is taken from the
//    fp32 p.
//  * Registers: O is D/2 floats a thread (128 at D 256), S 32, P_hi and
//    P_lo 16 each; 128 threads and one block an SM leave every thread up
//    to 255 registers, so no producer warp or setmaxnreg is needed for the
//    accumulator to stay out of local memory (-Xptxas -v reports spills).
//
// fp32 (off the main path; the card checks of the op at fp32) is not
// redesigned: swa_fwd_simt is the first port's CUDA-core body, a dispatch
// on dtype. One block of 256 threads per (q tile, head, batch); the Q tile
// and one K-or-V tile in shared memory as fp32 rows padded to D + 1
// floats, a 4 x 4 score micro-tile a thread, the online softmax through a
// shared score tile, and acc = alpha * acc + P V on CUDA cores.
#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows a block
constexpr int kBK = 64;  // keys a kv tile

// element strides of one tensor over (batch, sequence, head); head dim 1
struct Strides {
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kLP = kBK + 1;       // row stride of the score tile (floats)

template <int D>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * (2 * kBQ * (D + 1) + kBQ * kLP + 3 * kBQ);
}

// rows [row0, row0 + 64) of one head of x into smem (row stride D+1);
// rows at or past S are zeros
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ x,
                                      long long row_stride, int row0, int S) {
  for (int i = threadIdx.x; i < kBQ * D; i += kSimtThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < S ? x[(long long)row * row_stride + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
swa_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, Strides sq,
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
  const float* qh = q + b * sq.b + h * sq.h;
  const float* kh = k + b * sk.b + hk * sk.h;
  const float* vh = v + b * sv.b + hk * sv.h;

  stage<D>(sQ, qh, sq.s, q0, S);
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
    stage<D>(sKV, kh, sk.s, k0, S);
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

    stage<D>(sKV, vh, sv.s, k0, S);
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

  float* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= S) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    float* orow = oh + (long long)row * so.s;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = acc[i][c] / l;
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // K/V ring

// shared-memory tile geometry of head dim D: rows of 64 (Q) or of the kv
// tile's 64 keys, cut into column chunks of SW bytes, each chunk a TMA box
// of 64 rows x SW bytes stored with the SW-byte swizzle
template <int D>
struct Geo {
  static constexpr int SW = 2 * D < 128 ? 2 * D : 128;  // swizzle bytes
  static constexpr int BOX_COLS = SW / 2;               // bf16 a box row
  static constexpr int CHUNKS = D / BOX_COLS;
  static constexpr int BOX_BYTES = kBQ * SW;
  static constexpr int TILE_BYTES = kBQ * D * 2;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;
  // dynamic shared memory: Q, K and V tiles (each stage a K and a V
  // tile), the barriers, and room to align the tiles to 1024 bytes
  static constexpr int SMEM = TILE_BYTES * (1 + 2 * kStages) + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map (D, H, S, B) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// rows [row0, row0 + 64) of one head, every column chunk, onto one barrier
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int head,
                                          int batch) {
  mbar_expect_tx(bar, Geo<D>::TILE_BYTES);
#pragma unroll
  for (int c = 0; c < Geo<D>::CHUNKS; ++c)
    tma_load(dst + c * Geo<D>::BOX_BYTES, map, bar, c * Geo<D>::BOX_COLS, head,
             row0, batch);
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (layout << 62);
}

// Q or K tile, K-major (D contiguous), the 16 columns [16 kk, 16 kk + 16):
// 8-row groups SW * 8 bytes apart
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int kk) {
  using G = Geo<D>;
  const int col = 16 * kk;
  return gmma_desc(tile + (col / G::BOX_COLS) * G::BOX_BYTES +
                       (col % G::BOX_COLS) * 2,
                   16, 8 * G::SW, G::LAYOUT);
}

// V tile as the B operand of P V (K = keys, N = D): MN-major, the 16 keys
// [16 kk, 16 kk + 16); 8-key groups SW * 8 bytes apart, column chunks a box
// apart
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(const uint8_t* tile, int kk) {
  using G = Geo<D>;
  return gmma_desc(tile + 16 * kk * G::SW, G::BOX_BYTES, 8 * G::SW, G::LAYOUT);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64nNk16, A (4 registers of bf16 pairs) from registers, B from
// shared memory MN-major (transposed by the instruction)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);

template <> __device__ __forceinline__ void wgmma_rs<32>(
    float (&d)[32 / 2], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(
    float (&d)[64 / 2], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(
    float (&d)[128 / 2], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<256>(
    float (&d)[256 / 2], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keeps the P fragments live (and unmoved) until the wgmma reading them is
// waited for
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
swa_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              __nv_bfloat16* __restrict__ o, Strides so, int S, int n_rep,
              int window, float scale) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles start on 1024-byte boundaries (the 128-byte
  // swizzle's period)
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + G::TILE_BYTES;            // [kStages] tiles
  uint8_t* sV = sK + kStages * G::TILE_BYTES;  // [kStages] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * G::TILE_BYTES);
  uint64_t* k_full = q_full + 1;         // [kStages]
  uint64_t* v_full = k_full + kStages;   // [kStages]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / n_rep;
  // the band's kv tiles: keys [max(0, q0 - W + 1), min(q0 + 63, S - 1)]
  const int t_lo = max(0, q0 - window + 1) / kBK;
  const int t_hi = min(q0 + kBQ - 1, S - 1) / kBK;
  const int n_tiles = t_hi - t_lo + 1;

  if (tid == 0) {
    mbar_init(q_full);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s);
      mbar_init(v_full + s);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_tile<D>(sQ, &tq, q_full, q0, h, b);
    for (int i = 0; i < kStages && i < n_tiles; ++i) {
      load_tile<D>(sK + i * G::TILE_BYTES, &tk, k_full + i, (t_lo + i) * kBK,
                   hk, b);
      load_tile<D>(sV + i * G::TILE_BYTES, &tv, v_full + i, (t_lo + i) * kBK,
                   hk, b);
    }
  }

  // wgmma's accumulator layout: this thread holds rows r0 and r0 + 8 of the
  // tile, and in each group of 8 columns j the two columns 8j + c0, + 1:
  // element 4j + e sits at row r0 + 8 * (e >> 1), column 8j + c0 + (e & 1)
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of each row
  float l[2] = {0.f, 0.f};              // this thread's share of the sums

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (t_lo + i) * kBK;
    const int st = i % kStages;
    const int ph = (i / kStages) & 1;
    const uint8_t* tK = sK + st * G::TILE_BYTES;
    const uint8_t* tV = sV + st * G::TILE_BYTES;

    // s = q k^T, fp32
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    mbar_wait(k_full + st, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<D>(sQ, kk), desc_kmajor<D>(tK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= scale;
    // the band's edge tiles and the tile past S test each pair
    const bool inside = k0 + kBK - 1 <= q0 && q0 + kBQ - 1 - k0 < window &&
                        k0 + kBK <= S;
    if (!inside) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = k0 + 8 * (e >> 2) + c0 + (e & 1);
        const int rel = q0 + r0 + 8 * ((e >> 1) & 1) - key;
        if (rel < 0 || rel >= window || key >= S) s[e] = -INFINITY;
      }
    }

    // online softmax: the tile's row max across the row's 4 threads
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row that has seen no key yet keeps p = 0 and alpha = 0
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = expf(m[r] - base[r]);
      m[r] = mx[r];
    }

    // p in fp32, split into bf16 p_hi + p_lo; the A fragment of keys
    // [16 kk, 16 kk + 16) is elements 8 kk .. 8 kk + 7 of s, in pairs
    uint32_t p_hi[16], p_lo[16];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = (e >> 1) & 1;
      const float p0 = expf(s[e] - base[r]);
      const float p1 = expf(s[e + 1] - base[r]);
      sum[r] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[e / 2] = bf16x2_bits(hi);
      p_lo[e / 2] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int i2 = 0; i2 < D / 2; ++i2) acc[i2] *= alpha[(i2 >> 1) & 1];

    // acc += p_hi v + p_lo v
    mbar_wait(v_full + st, ph);
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = desc_mnmajor<D>(tV, kk);
      const uint32_t a_hi[4] = {p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2],
                                p_hi[4 * kk + 3]};
      const uint32_t a_lo[4] = {p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                                p_lo[4 * kk + 3]};
      wgmma_rs<D>(acc, a_hi, dv);
      wgmma_rs<D>(acc, a_lo, dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);

    __syncthreads();  // the warpgroup is done with this stage: refill it
    if (tid == 0 && i + kStages < n_tiles) {
      const int k_next = (t_lo + i + kStages) * kBK;
      load_tile<D>(sK + st * G::TILE_BYTES, &tk, k_full + st, k_next, hk, b);
      load_tile<D>(sV + st * G::TILE_BYTES, &tv, v_full + st, k_next, hk, b);
    }
  }

  __nv_bfloat16* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    const int row = q0 + r0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = oh + (long long)row * so.s + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the driver's cuTensorMapEncodeTiled, found through the runtime so that the
// library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the (D, H, S, B) tensor map of one bf16 tensor in the model layout; st:
// its element strides (batch, sequence, head). TMA wants a 16-byte-aligned
// base and strides that are multiples of 16 bytes (the wrapper checks
// both); a box is BOX_COLS of the head dim x 1 head x 64 rows.
template <int D>
bool make_map(CUtensorMap* map, const void* base, int S, int H, int B,
              const long long* st) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Geo<D>::BOX_COLS, 1, (cuuint32_t)kBQ,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Geo<D>::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(int B, int S, int Hq, int Hkv, int window, const void* q,
                 const void* k, const void* v, void* o, const long long* st,
                 float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, q, S, Hq, B, st) ||
      !make_map<D>(&tk, k, S, Hkv, B, st + 3) ||
      !make_map<D>(&tv, v, S, Hkv, B, st + 6))
    return (int)cudaErrorInvalidValue;
  auto kernel = swa_fwd_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, Geo<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o),
      Strides{st[9], st[10], st[11]}, S, Hq / Hkv, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_simt(int B, int S, int Hq, int Hkv, int window, const void* q,
                const void* k, const void* v, void* o, const long long* st,
                float scale, cudaStream_t stream) {
  auto kernel = swa_fwd_simt<D>;
  constexpr size_t smem = simt_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kSimtThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, S,
      Hq / Hkv, window, scale);
  return (int)cudaGetLastError();
}

// dtype 0 (fp32) takes the CUDA-core kernel, 1 (bf16) the wgmma kernel
template <int D>
int launch(int dtype, int B, int S, int Hq, int Hkv, int window,
           const void* q, const void* k, const void* v, void* o,
           const long long* st, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_simt<D>(B, S, Hq, Hkv, window, q, k, v, o, st, scale, stream);
  if (dtype == 1)
    return launch_wgmma<D>(B, S, Hq, Hkv, window, q, k, v, o, st, scale,
                           stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dynamic shared memory of one block of the dtype's kernel at head dim D
// (bytes; 0 for a combination the kernel does not take)
extern "C" int swa_attention_smem_bytes(int dtype, int D) {
  switch (D) {
    case 32: return dtype == 0 ? (int)simt_smem_bytes<32>() : Geo<32>::SMEM;
    case 64: return dtype == 0 ? (int)simt_smem_bytes<64>() : Geo<64>::SMEM;
    case 128: return dtype == 0 ? (int)simt_smem_bytes<128>() : Geo<128>::SMEM;
    case 256: return dtype == 0 ? (int)simt_smem_bytes<256>() : Geo<256>::SMEM;
    default: return 0;
  }
}

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
  switch (D) {
    case 32: return launch<32>(dtype, B, S, Hq, Hkv, window, q, k, v, o, strides, scale, s);
    case 64: return launch<64>(dtype, B, S, Hq, Hkv, window, q, k, v, o, strides, scale, s);
    case 128: return launch<128>(dtype, B, S, Hq, Hkv, window, q, k, v, o, strides, scale, s);
    case 256: return launch<256>(dtype, B, S, Hq, Hkv, window, q, k, v, o, strides, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
