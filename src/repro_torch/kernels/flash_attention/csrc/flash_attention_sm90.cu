// Causal / sliding-window GQA self-attention (forward) in bf16 on Hopper's
// tensor cores (sm_90a: wgmma).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention
// (same function, not the same blocking) for bf16 inputs; fp32 inputs go to
// the CUDA-core kernel in flash_attention.cu (the wrapper routes by dtype):
//
//   q (B,Sq,Nq,H); k, v (B,Skv,Nkv,H) bf16; G = Nq/Nkv query heads per kv
//   head; query row i sits at position i, kv row j at position j (the
//   implicit iota of the Pallas kernel and its ref); (i, j) is valid iff
//   (not causal or i - j >= 0) and (window <= 0 or i - j < window)
//   out[b,i,hq] = softmax_j(q[b,i,hq] . k[b,j,hq/G] * H^-0.5 over valid j)
//                 @ v[b,:,hq/G]
//   fp32 scores and online softmax; the output in bf16.  A row with no valid
//   j gets 0, as the Pallas kernel writes; causal self-attention never has
//   one.  P is rounded to bf16 before P.V (the A operand of the tensor-core
//   product), as the JAX package's plain model path rounds it; the fp32
//   row sums are taken before that rounding.  The card test's bf16
//   tolerance (2e-2 against the fp32 plain result cast to bf16) covers it:
//   tests/test_torch_flash_attention.py holds the rounded plain version to
//   the fp32 one on the CPU, and this kernel to the rounded plain version
//   (its tile-wise online softmax) on the card within 2 bf16 ulps + 1e-3.
//
// Bound on an H100 SXM: the operations.  4*H FLOP per valid (q row, kv row,
// query head) pair: at Hymba's prefill (B=1, S=2048, 25/5 heads, H=64,
// window 1024) 10.07 GFLOP, 10.2 us at the 989 TFLOP/s bf16 tensor-core
// peak, against 15.7 MB of q, k, v and output, 4.7 us at 3.35 TB/s.  The
// exps (one per valid pair and head, 78.6 M there) take about 2.5 us on the
// SFUs (16 per clock per SM at 1.98 GHz).  On CUDA cores in fp32 the same
// product would take at least 150 us (67 TFLOP/s): the tensor cores are the
// only way near the bound.
//
// Design.  One block is one warpgroup (128 threads) and owns a 64-row query
// tile of one (query head, batch row); the longest query tiles are
// scheduled first.
//   - Shared memory holds the Q tile for the block's life and a two-stage
//     ring of 64-row K and V tiles, each written in the 128-byte swizzled
//     layout that the wgmma descriptors name: rows of 64 bf16 (128 bytes),
//     the 16-byte chunk c of row r at chunk c ^ (r % 8), a head width of 128
//     as two such 64-column sub-tiles.  An H below the template width (64
//     or 128) is zero-filled in shared memory, never padded in memory.
//   - Loads are cp.async.cg 16-byte copies (zero-fill past Skv and past H);
//     the next K/V tile is in flight while this tile's two products and its
//     softmax run.  Rows whose H*2 bytes are not a multiple of 16, or
//     pointers not 16-byte aligned, load synchronously into the same
//     layout.  TMA is not used: rows of (B,S,N,H) are strided by N*H, which
//     the copies take as they come.
//   - S = Q K^T: wgmma.mma_async m64n64k16, bf16 in, fp32 out, both
//     operands from shared memory (K-major, no transpose), H/16 steps.
//   - Softmax on the accumulator registers: each thread holds 2 rows x 16
//     columns of S; row max and row sum over the 4 threads of a row with two
//     shuffles (the sum only once, at the end); exp2 with scale*log2(e)
//     folded into one FMA.  The mask is applied only on tiles that the
//     causal diagonal, the window's edge or Skv cuts.
//   - O += P V: P goes to bf16 in registers and is the A operand of a
//     register-sourced wgmma m64nHk16 (RS form); V comes from shared memory
//     MN-major (the transpose bit for B).  O stays in fp32 registers.
//   - The KV loop runs only over the tiles the causal and window band
//     reaches from the query tile (the Pallas kernel's pl.when skip).  The
//     G query heads of a kv head read K and V from L2 (Hymba's K/V is 2.6
//     MB against 50 MB of L2).
// No atomics: the result is reproducible bit for bit run to run.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/flash_attention/flash_attention.py).
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <atomic>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;                   // one warpgroup
constexpr int kBQ = 64;                         // query rows per block
constexpr int kBK = 64;                         // kv rows per tile
constexpr int kStages = 2;                      // K/V ring depth
constexpr int kSub = 64 * 128;                  // bytes of a 64x64 sub-tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kDefaultSmem = 48 * 1024;

// Shared memory of one block at head width kHD (64 or 128): Q, then the K
// ring, then the V ring, each tile kHD/64 swizzled sub-tiles, from a
// 1024-byte aligned base (the swizzle pattern repeats every 1024 bytes).
template <int kHD>
struct Smem {
  static constexpr int kTile = kBQ * kHD * 2;
  static constexpr size_t kBytes = (size_t)kTile * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (8 columns) of row r in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * kSub + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async, st.shared) visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0+64) at head `head` of one batch row of a (S, NH, H) bf16
// tensor into the swizzled tile at `dst`: zero past `s` and past `h`.
// kVec: h*2 is a multiple of 16 and the base 16-byte aligned, so rows go by
// cp.async in 16-byte chunks; else element by element, synchronously.
template <int kHD, bool kVec>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ base,
                                          int r0, int s, int nh, int head,
                                          int h, uint32_t dst,
                                          uint8_t* dst_ptr) {
  constexpr int kChunks = kHD / 8;
  if constexpr (kVec) {
#pragma unroll
    for (int it = 0; it < kBQ * kChunks / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = r0 + r < s && c * 8 < h;
      const bf16* src =
          ok ? base + ((size_t)(r0 + r) * nh + head) * h + c * 8 : base;
      cp_async16(dst + swz(r, c), src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBQ * kHD; i += kThreads) {
      const int r = i / kHD, d = i % kHD;
      const bf16 val = (r0 + r < s && d < h)
                           ? base[((size_t)(r0 + r) * nh + head) * h + d]
                           : __float2bfloat16(0.f);
      *reinterpret_cast<bf16*>(dst_ptr + swz(r, d >> 3) + (d & 7) * 2) = val;
    }
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving register reads or writes across the
// asynchronous products
template <int M>
__device__ __forceinline__ void fence_regs(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D32(i)                                                        \
  D4(i), D4(i + 4), D4(i + 8), D4(i + 12), D4(i + 16), D4(i + 20),    \
      D4(i + 24), D4(i + 28)

// d (64x64 fp32) = A (64x16, K-major smem) . B (16x64, K-major smem)
// [+ d when accumulate]
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64x64 fp32) += A (64x16 bf16, registers) . B (16x64, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64x128 fp32) += A (64x16 bf16, registers) . B (16x128, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, "
      "p, 1, 1, 1;\n}\n"
      : D32(0), D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D32
#undef D4

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int kHD, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int sq, int skv, int nq, int nkv,
                int h, int causal, int window, float scale_log2,
                bf16* __restrict__ out) {
  using L = Smem<kHD>;
  constexpr int kO = kHD / 2;                   // O accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t qs = base;
  const uint32_t ks0 = base + L::kTile;
  const uint32_t vs0 = base + L::kTile * (1 + kStages);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;     // the longest rows first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (nq / nkv);
  const int q0 = qt * kBQ;

  // the kv tiles the band can reach from query rows q0 .. q_last
  const int q_last = min(q0 + kBQ, sq) - 1;
  int k_hi = skv - 1;
  if (causal) k_hi = min(k_hi, q_last);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kBK;
  const int n_tiles = k_hi >= k_lo ? k_hi / kBK - t_lo + 1 : 0;

  const bf16* qb = q + (size_t)b * sq * nq * h;
  const bf16* kb = k + (size_t)b * skv * nkv * h;
  const bf16* vb = v + (size_t)b * skv * nkv * h;

  load_tile<kHD, kVec>(qb, q0, sq, nq, hq, h, qs, base_ptr);
  if (n_tiles > 0) {
    load_tile<kHD, kVec>(kb, t_lo * kBK, skv, nkv, hk, h, ks0,
                         base_ptr + L::kTile);
    load_tile<kHD, kVec>(vb, t_lo * kBK, skv, nkv, hk, h, vs0,
                         base_ptr + L::kTile * (1 + kStages));
  }
  cp_async_commit();

  // this thread's accumulator rows: r0 and r0 + 8 of the tile; its columns
  // in each 8-column block: 2 * (lane % 4) and the next
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float o[kO], s[32];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const int k0 = (t_lo + j) * kBK;
    __syncthreads();            // the stage refilled below is consumed
    if (j + 1 < n_tiles) {
      const int nst = (j + 1) % kStages;
      load_tile<kHD, kVec>(kb, k0 + kBK, skv, nkv, hk, h,
                           ks0 + nst * L::kTile,
                           base_ptr + L::kTile * (1 + nst));
      load_tile<kHD, kVec>(vb, k0 + kBK, skv, nkv, hk, h,
                           vs0 + nst * L::kTile,
                           base_ptr + L::kTile * (1 + kStages + nst));
    }
    cp_async_commit();
    cp_async_wait<1>();         // this tile (and Q) has landed
    fence_async_shared();
    __syncthreads();

    // S = Q K^T over kHD/16 steps of 16 dims
    const uint32_t ks = ks0 + st * L::kTile;
    wg_fence();
    fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSub + (kk % 4) * 32;
      wgmma_ss_n64(s, wg_desc(qs + off, 16, 1024), wg_desc(ks + off, 16, 1024),
                   kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // mask the tiles the diagonal, the window's edge or Skv cuts
    const bool edge = (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window) ||
                      k0 + kBK > skv;
    if (edge) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * i + c0 + (e & 1);
          const int rel = q0 + r0 + 8 * (e >> 1) - kp;
          const bool ok = kp < skv &&
                          (!causal || rel >= 0) &&
                          (window <= 0 || rel < window);
          if (!ok) s[4 * i + e] = -INFINITY;
        }
    }

    // online softmax in the log2 domain, two rows per thread
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float mu[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;   // a row masked so far
      corr[r] = ex2(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], scale_log2, -mu[r]));
      l[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] *= corr[(i >> 1) & 1];

    // P to bf16 A fragments: k-step kk holds S columns 16kk .. 16kk+15
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V over 4 steps of 16 kv rows
    const uint32_t vs = vs0 + st * L::kTile;
    wg_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pa[kk]);
      const uint64_t db = wg_desc(vs + kk * 16 * 128, kSub, 1024);
      if constexpr (kHD == 64)
        wgmma_rs_n64(o, pa[kk], db);
      else
        wgmma_rs_n128(o, pa[kk], db);
    }
    wg_commit();
    wg_wait0();
    fence_regs(o);
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = sum > 0.f ? 1.f / sum : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + r0 + 8 * r;
    if (qp >= sq) continue;
    bf16* orow = out + (((size_t)b * sq + qp) * nq + hq) * h;
#pragma unroll
    for (int i = 0; i < kHD / 8; ++i) {
      const int col = 8 * i + c0;
      const float v0 = o[4 * i + 2 * r] * inv[r];
      const float v1 = o[4 * i + 2 * r + 1] * inv[r];
      if constexpr (kVec) {
        if (col < h)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < h) orow[col] = __float2bfloat16(v0);
        if (col + 1 < h) orow[col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int kHD, bool kVec>
int launch(const void* q, const void* k, const void* v, int b, int sq,
           int skv, int nq, int nkv, int h, int causal, int window,
           float scale, void* out, cudaStream_t stream) {
  // more than 48 KB of dynamic shared memory needs the opt-in, once per
  // kernel and device
  static std::atomic<unsigned long long> allowed{0};
  const size_t smem = Smem<kHD>::kBytes;
  if (smem > kDefaultSmem) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(allowed.load() & bit)) {
      e = cudaFuncSetAttribute(flash_tc_kernel<kHD, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      allowed.fetch_or(bit);
    }
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, nq, b);
  flash_tc_kernel<kHD, kVec><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), sq, skv, nq, nkv, h, causal, window,
      scale * kLog2e, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

template <int kHD>
int launch_vec(const void* q, const void* k, const void* v, int b, int sq,
               int skv, int nq, int nkv, int h, int causal, int window,
               float scale, void* out, cudaStream_t stream) {
  const bool vec = h % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch<kHD, true>(q, k, v, b, sq, skv, nq, nkv, h, causal,
                                 window, scale, out, stream)
             : launch<kHD, false>(q, k, v, b, sq, skv, nq, nkv, h, causal,
                                  window, scale, out, stream);
}

}  // namespace

extern "C" {

// q (b,sq,nq,h), k/v (b,skv,nkv,h) and out (b,sq,nq,h) contiguous bf16;
// nq a multiple of nkv; 1 <= h <= 128.  Returns cudaGetLastError() after
// the launch.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              int b, int sq, int skv, int nq, int nkv, int h,
                              int causal, int window, float scale, void* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 64)
    return launch_vec<64>(q, k, v, b, sq, skv, nq, nkv, h, causal, window,
                          scale, out, s);
  return launch_vec<128>(q, k, v, b, sq, skv, nq, nkv, h, causal, window,
                         scale, out, s);
}

const char* flash_attention_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
