// Single-token GQA decode attention over a positional slot cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention/decode_attention.py::decode_attention
// (same function, not the same blocking):
//
//   q (B,Nq,H); k, v (B,Sc,Nkv,H); cache_pos (B,Sc) int32; positions (B,)
//   slot s of row b is valid iff  pos >= 0,  cur - pos >= 0  and, when
//   window > 0,  cur - pos < window   (pos = cache_pos[b,s], cur = positions[b])
//   out[b, kvh*G + g] = softmax_s(q . k[b,s,kvh] * H^-0.5 over valid s) @ v
//   with G = Nq/Nkv query heads per kv head, fp32 scores, softmax and sums,
//   fp32 or bf16 inputs, the output in q's dtype.
//
// A row with no valid slot gets 0, as the Pallas kernel writes (its l is
// clamped to 1e-30 and p zeroed); the plain version (ref.py) gives the
// mean of v there.  The serving path never meets such a row: the slot just
// written is always valid.  Empty slots may hold anything, NaN included:
// their K and V rows are never read (the copy zero-fills them).
//
// Bound on an H100 SXM: the bytes.  The K and V rows of the valid slots
// must be read once (2*valid*Nkv*H elements), cache_pos once, against
// 4*Nq*H FLOP per valid slot, about G/esize FLOP per byte, far below the
// card's ~20 fp32 (~295 bf16) FLOP per byte.  At Llama's serving shape
// (B=8, Sc=1024 all valid, 32/8 heads, H=64, bf16) that is 16.8 MB, about
// 5 us at 3.35 TB/s.
//
// Design: one launch, a thread block cluster per (batch row, kv head, group
// of up to 8 query heads); block `split` of the cluster owns the 64-slot
// tiles split, split+splits, ... of the cache (interleaved, so a cache
// filled only at its front still spreads over every block).
//   - Each of the block's 4 warps owns one 16-slot quarter of each tile
//     and works alone until the merge: it reads the quarter's 16 cache_pos
//     entries first, keeps a list of the quarters with at least one valid
//     slot and a 16-bit mask of their valid slots, and copies K and V only
//     for those.  A quarter with no valid slot adds exactly nothing to the
//     online softmax (its scores are all -inf, so the correction is 1 and
//     the sum 0), so skipping it changes no bit of the result.
//   - The K/V rows go into a per-warp ring of 1-4 stages by cp.async (16
//     bytes a copy, zero-filled for invalid slots), in the input dtype,
//     rows padded by 16 bytes so that ldmatrix and 16-byte loads of 8
//     consecutive rows hit distinct banks.  The next quarters' copies are
//     in flight while this one is scored; a warp waits for its own copies
//     and orders them with __syncwarp, never with a block barrier.
//   - bf16 runs on the tensor cores with slots as the M dimension:
//     S^T = K . q^T by mma.sync m16n8k16 (A = the K quarter by ldmatrix,
//     B = q in registers for the kernel's life, N = 8 query heads), the
//     online softmax on the accumulator registers (exp2, scale*log2(e)
//     folded), P rounded to bf16 against the running max (the row sums
//     taken before the rounding) and moved to the B-operand layout by
//     movmatrix.trans, then out^T += V^T . P^T by mma.sync (A = V by
//     ldmatrix.trans).
//   - fp32 stays on the CUDA cores (TF32 would break the 2e-5 tolerance):
//     one lane per (slot, half of the heads), K rows and q (broadcast) read
//     as float4; P.V with one lane per output dim and the weights read as
//     float4 broadcasts.
//   - Merge: the 4 warps' (m, l, acc) in warp order in shared memory, then
//     the cluster's blocks' partials in split order, with log-sum-exp
//     weights: each block writes to block r's shared memory (distributed
//     shared memory) its (m, l) and its acc over share r of the outputs,
//     and after one cluster barrier block r merges share r from its own
//     shared memory and writes it.  No scratch in device
//     memory and no second launch; no atomics, so the result is
//     reproducible bit for bit run to run.
// Launched with cudaLaunchKernelEx (cluster size = splits: at most 8, the
// portable size, or 16 when the groups are too few to fill the card), which
// a CUDA graph captures.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/decode_attention/decode_attention.py).
// Nothing here allocates or synchronises.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <atomic>
#include <cfloat>
#include <stddef.h>
#include <stdint.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 16;                  // slots per warp quarter (mma M)
constexpr int kTile = kWarps * kSub;      // slots per block tile
constexpr int kHeads = 8;                 // query heads per block (mma N)
constexpr int kListCap = 128;             // quarters listed per round
constexpr int kMaxStages = 4;
constexpr int kMaxCluster = 16;            // 8 portable; 16 opted in
constexpr float kNegInf = -0.7f * FLT_MAX;  // ref.py's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory at head width HD (32, 64, 128 or 256; H <= HD): per warp a
// ring of `stages` (K quarter, V quarter) pairs, rows of HD elements plus
// 16 bytes; the warps' quarter lists; the block's merged partial; what the
// cluster's blocks send this block to merge; for fp32 also q and each
// warp's weights.  A warp's own partial (m, l, acc) takes the place of its
// ring once its copies are done.
template <typename T, int HD>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kRS = HD + 16 / (int)sizeof(T);  // row stride
  static constexpr size_t kStage = (size_t)2 * kSub * kRS * sizeof(T);
  static constexpr size_t kWeights = (size_t)(kHeads * kSub + kHeads) * 4;
  static constexpr size_t kPartial = (size_t)(2 * kHeads + kHeads * HD) * 4;
  // the shares the cluster's blocks send this one: every split's (m, l),
  // then its slice of every split's acc
  static constexpr size_t kRecv =
      (size_t)(2 * kHeads * kMaxCluster + kHeads * HD + kMaxCluster) * 4;
  static_assert(kPartial <= kStage, "a warp's partial must fit its ring");
  static_assert((kMaxCluster + 1) * kHeads * 4 <= kStage,
                "the split weights must fit warp 0's ring");
  __host__ __device__ static size_t ring(int stages) {
    return kStage * stages;
  }
  __host__ __device__ static size_t lists(int stages) {
    return kWarps * ring(stages);
  }
  __host__ __device__ static size_t block(int stages) {
    return lists(stages) + (size_t)kWarps * kListCap * sizeof(uint2);
  }
  __host__ __device__ static size_t recv(int stages) {
    return block(stages) + kPartial;
  }
  __host__ __device__ static size_t qs(int stages) {
    return recv(stages) + kRecv;
  }
  __host__ __device__ static size_t weights(int stages) {
    return qs(stages) + (kF32 ? (size_t)kHeads * HD * 4 : 0);
  }
  __host__ __device__ static size_t bytes(int stages) {
    return weights(stages) + (kF32 ? kWarps * kWeights : 0);
  }
};

__device__ __forceinline__ bool slot_ok(int pos, int cur, int window) {
  const int rel = cur - pos;
  return pos >= 0 && rel >= 0 && (window <= 0 || rel < window);
}

// 2^x by the SFU (ex2.approx: about 2 ulp); 2^(-huge) is 0
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// wait until at most n (0..kMaxStages-1) groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the 8x8 bf16 matrix whose row lane/4 holds columns 2*(lane%4) and
// 2*(lane%4)+1 in `x`, transposed, in the same layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  const __nv_bfloat162 p = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int HD, bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ cache_pos,
                   const int* __restrict__ positions, int sc, int nq, int nkv,
                   int h, int window, int stages, float scale_log2,
                   T* __restrict__ out) {
  using L = Layout<T, HD>;
  constexpr int kRS = L::kRS;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // this block has started: the wait before the first write to another
  // block's shared memory pairs with it
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int nsplit = gridDim.x, split = blockIdx.x;  // cluster (nsplit,1,1)
  const int b = blockIdx.z / nkv, kvh = blockIdx.z % nkv;
  const int g_all = nq / nkv;
  const int gn = min(kHeads, g_all - (int)blockIdx.y * kHeads);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cur = positions[b];
  const size_t qrow0 =
      (size_t)b * nq + (size_t)kvh * g_all + (size_t)blockIdx.y * kHeads;
  const size_t row_stride = (size_t)nkv * h;        // elements between slots
  const T* kb = k + ((size_t)b * sc * nkv + kvh) * h;
  const T* vb = v + ((size_t)b * sc * nkv + kvh) * h;
  const int* pb = cache_pos + (size_t)b * sc;

  unsigned char* ring = smem + warp * L::ring(stages);
  uint2* list = reinterpret_cast<uint2*>(smem + L::lists(stages)) +
                warp * kListCap;
  float* bpart = reinterpret_cast<float*>(smem + L::block(stages));
  float* recv = reinterpret_cast<float*>(smem + L::recv(stages));
  float* qs = reinterpret_cast<float*>(smem + L::qs(stages));         // fp32
  float* ws = reinterpret_cast<float*>(smem + L::weights(stages)) +
              warp * (kHeads * kSub + kHeads);                          // fp32

  // Columns H..HD of the K rows meet q's zero padding: they must hold 0,
  // not whatever the shared memory held (0 * NaN is NaN).  The copies never
  // write them.
  if (h < HD) {
    uint4* r4 = reinterpret_cast<uint4*>(ring);
    for (int i = lane; i < (int)(L::ring(stages) / 16); i += 32)
      r4[i] = make_uint4(0, 0, 0, 0);
  }

  // q: bf16 as the mma's B fragments in registers, fp32 in shared memory
  uint32_t qf[HD / 16][2];
  if constexpr (L::kF32) {
    for (int i = threadIdx.x; i < kHeads * HD; i += kThreads) {
      const int g = i / HD, d = i - g * HD;
      qs[i] = (g < gn && d < h) ? to_f32(q[(qrow0 + g) * h + d]) : 0.f;
    }
  } else {
    const int g = lane >> 2, d0 = 2 * (lane & 3);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = kk * 16 + half * 8 + d0;
        const T* qr = q + (qrow0 + g) * h;
        const T zero = __float2bfloat16(0.f);
        qf[kk][half] = pack_bf16((g < gn && d < h) ? qr[d] : zero,
                                 (g < gn && d + 1 < h) ? qr[d + 1] : zero);
      }
  }
  __syncthreads();

  // online-softmax state (log2 domain).  bf16: this lane's heads
  // 2*(lane%4) and +1 (l summed over the lane's slots only until the end),
  // out^T fragments o[mt] = rows mt*16 + lane/4 (+8), the same two heads.
  // fp32: heads lane/16 + 2j (j < 4), acc[g][i] for dim lane + 32i.
  constexpr int kM = L::kF32 ? 4 : 2;
  constexpr int kAcc = L::kF32 ? kHeads * (HD / 32) : (HD / 16) * 4;
  float m[kM], l[kM], acc[kAcc];
#pragma unroll
  for (int j = 0; j < kM; ++j) { m[j] = kNegInf; l[j] = 0.f; }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int ntiles = (sc + kTile - 1) / kTile;
  const int nsub = ntiles > split ? (ntiles - split + nsplit - 1) / nsplit : 0;

  // the quarter `j` of this warp: slots (split + j*nsplit)*64 + warp*16 ..
  auto issue = [&](uint2 e, int stage) {
    const int slot0 = (split + (int)e.x * nsplit) * kTile + warp * kSub;
    const unsigned mask = e.y;
    T* kst = reinterpret_cast<T*>(ring + stage * L::kStage);
    T* vst = kst + kSub * kRS;
    if constexpr (kVec) {
      // lane takes chunks lane, lane+32, ... of the K rows then the V rows;
      // its (row, chunk) steps by a constant, no division in the loop
      constexpr int E = 16 / sizeof(T);
      const int nch = h / E;                   // 16-byte chunks per row
      const int dr = 32 / nch, dc = 32 - dr * nch;
      const T* kq = kb + (size_t)slot0 * row_stride;
      const T* vq = vb + (size_t)slot0 * row_stride;
      int r = lane / nch, c = lane - r * nch;
      for (int i = lane; i < 2 * kSub * nch; i += 32) {
        const bool kv = r >= kSub;
        const int rr = kv ? r - kSub : r;
        const bool ok = (mask >> rr) & 1u;
        const T* src = (kv ? vq : kq) + (ok ? rr * row_stride + c * E : 0);
        cp_async16(smem_addr((kv ? vst : kst) + rr * kRS + c * E), src,
                   ok ? 16 : 0);
        c += dc;
        r += dr;
        if (c >= nch) {
          c -= nch;
          ++r;
        }
      }
    } else {
      for (int i = lane; i < 2 * kSub * h; i += 32) {
        const int kv = i >= kSub * h;
        const int rem = i - kv * kSub * h;
        const int r = rem / h, d = rem - r * h;
        const bool ok = (mask >> r) & 1u;
        const T* src = kv ? vb : kb;
        (kv ? vst : kst)[r * kRS + d] =
            ok ? src[(size_t)(slot0 + r) * row_stride + d] : T(0.f);
      }
    }
  };

  auto compute = [&](int stage, unsigned mask) {
    const T* kst = reinterpret_cast<const T*>(ring + stage * L::kStage);
    const T* vst = kst + kSub * kRS;
    if constexpr (!L::kF32) {
      const int i8 = lane >> 3, r8 = lane & 7;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        if (kk * 16 >= h) break;
        uint32_t a[4];
        ldsm_x4(a, smem_addr(kst + (r8 + (i8 & 1) * 8) * kRS + kk * 16 +
                             (i8 >> 1) * 8));
        mma_bf16(c, a, qf[kk][0], qf[kk][1]);
      }
      const int r0 = lane >> 2;
      const bool v0 = (mask >> r0) & 1u, v1 = (mask >> (r0 + 8)) & 1u;
      const float s0 = v0 ? c[0] * scale_log2 : kNegInf;
      const float s1 = v0 ? c[1] * scale_log2 : kNegInf;
      const float s2 = v1 ? c[2] * scale_log2 : kNegInf;
      const float s3 = v1 ? c[3] * scale_log2 : kNegInf;
      float mx0 = fmaxf(s0, s2), mx1 = fmaxf(s1, s3);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
      const float corr0 = exp2_fast(m[0] - mn0), corr1 = exp2_fast(m[1] - mn1);
      const float p0 = v0 ? exp2_fast(s0 - mn0) : 0.f;
      const float p1 = v0 ? exp2_fast(s1 - mn1) : 0.f;
      const float p2 = v1 ? exp2_fast(s2 - mn0) : 0.f;
      const float p3 = v1 ? exp2_fast(s3 - mn1) : 0.f;
      l[0] = l[0] * corr0 + (p0 + p2);
      l[1] = l[1] * corr1 + (p1 + p3);
      m[0] = mn0;
      m[1] = mn1;
      // P^T as the B fragment: heads lane/4, slots 2*(lane%4) (+8)
      const uint32_t pb0 = movmatrix_trans(pack_bf16(p0, p1));
      const uint32_t pb1 = movmatrix_trans(pack_bf16(p2, p3));
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt) {
        if (mt * 16 >= h) break;
        float* o = acc + 4 * mt;
        o[0] *= corr0;
        o[1] *= corr1;
        o[2] *= corr0;
        o[3] *= corr1;
        uint32_t a[4];
        ldsm_x4_trans(a, smem_addr(vst + (r8 + (i8 >> 1) * 8) * kRS +
                                   mt * 16 + (i8 & 1) * 8));
        float d4[4] = {o[0], o[1], o[2], o[3]};
        mma_bf16(d4, a, pb0, pb1);
        o[0] = d4[0];
        o[1] = d4[1];
        o[2] = d4[2];
        o[3] = d4[3];
      }
    } else {
      const int s = lane & 15, hh = lane >> 4;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* kr = reinterpret_cast<const float4*>(kst + s * kRS);
#pragma unroll 4
      for (int c = 0; c < HD / 4; ++c) {
        if (c * 4 >= h) break;
        const float4 k4 = kr[c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 q4 =
              reinterpret_cast<const float4*>(qs + (hh + 2 * j) * HD)[c];
          dot[j] = fmaf(q4.x, k4.x, dot[j]);
          dot[j] = fmaf(q4.y, k4.y, dot[j]);
          dot[j] = fmaf(q4.z, k4.z, dot[j]);
          dot[j] = fmaf(q4.w, k4.w, dot[j]);
        }
      }
      const bool ok = (mask >> s) & 1u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = ok ? dot[j] * scale_log2 : kNegInf;
        float mx = sv;
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float mn = fmaxf(m[j], mx);
        const float corr = exp2_fast(m[j] - mn);
        const float p = ok ? exp2_fast(sv - mn) : 0.f;
        float sum = p;
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          sum += __shfl_xor_sync(kFull, sum, off);
        l[j] = l[j] * corr + sum;
        m[j] = mn;
        ws[(hh + 2 * j) * kSub + s] = p;
        if (s == 0) ws[kHeads * kSub + hh + 2 * j] = corr;
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        const float corr = ws[kHeads * kSub + g];
#pragma unroll
        for (int i = 0; i < HD / 32; ++i) acc[g * (HD / 32) + i] *= corr;
      }
#pragma unroll
      for (int s4 = 0; s4 < kSub / 4; ++s4) {
        float vv[4][HD / 32];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int i = 0; i < HD / 32; ++i) {
            const int d = lane + 32 * i;
            vv[t][i] = d < h ? vst[(s4 * 4 + t) * kRS + d] : 0.f;
          }
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          const float4 p4 = reinterpret_cast<const float4*>(ws + g * kSub)[s4];
#pragma unroll
          for (int i = 0; i < HD / 32; ++i) {
            float a = acc[g * (HD / 32) + i];
            a = fmaf(p4.x, vv[0][i], a);
            a = fmaf(p4.y, vv[1][i], a);
            a = fmaf(p4.z, vv[2][i], a);
            a = fmaf(p4.w, vv[3][i], a);
            acc[g * (HD / 32) + i] = a;
          }
        }
      }
    }
  };

  // rounds of up to kListCap quarters: list the non-empty ones, then walk
  // them through the ring
  for (int r0 = 0; r0 < nsub; r0 += kListCap) {
    const int rn = min(kListCap, nsub - r0);
    int cnt = 0;
    for (int j0 = 0; j0 < rn; j0 += 32) {
      const int j = r0 + j0 + lane;
      unsigned mask = 0;
      if (j0 + lane < rn) {
        const int slot0 = (split + j * nsplit) * kTile + warp * kSub;
        int pos[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i)
          pos[i] = slot0 + i < sc ? pb[slot0 + i] : -1;
#pragma unroll
        for (int i = 0; i < kSub; ++i)
          mask |= (unsigned)slot_ok(pos[i], cur, window) << i;
      }
      const unsigned nz = __ballot_sync(kFull, mask != 0);
      if (mask)
        list[cnt + __popc(nz & ((1u << lane) - 1u))] =
            make_uint2((unsigned)j, mask);
      cnt += __popc(nz);
    }
    __syncwarp();
    for (int i = 0; i < stages - 1; ++i) {
      if (i < cnt) issue(list[i], i);
      cp_async_commit();
    }
    for (int i = 0; i < cnt; ++i) {
      const int nxt = i + stages - 1;
      if (nxt < cnt) issue(list[nxt], nxt % stages);
      cp_async_commit();
      cp_async_wait(stages - 1);       // quarter i has landed
      __syncwarp();
      compute(i % stages, list[i].y);
      __syncwarp();                    // its stage may be refilled
    }
  }
  cp_async_wait(0);
  __syncwarp();

  // this warp's partial over its ring: m[8], l[8], acc[8][HD]
  float* wp = reinterpret_cast<float*>(ring);
  if constexpr (!L::kF32) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[j] += __shfl_xor_sync(kFull, l[j], off);
    if (lane < 4) {
      wp[2 * lane] = m[0];
      wp[2 * lane + 1] = m[1];
      wp[kHeads + 2 * lane] = l[0];
      wp[kHeads + 2 * lane + 1] = l[1];
    }
    float* wa = wp + 2 * kHeads;
    const int g = 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < HD / 16; ++mt) {
      const int d = mt * 16 + (lane >> 2);
      wa[g * HD + d] = acc[4 * mt];
      wa[(g + 1) * HD + d] = acc[4 * mt + 1];
      wa[g * HD + d + 8] = acc[4 * mt + 2];
      wa[(g + 1) * HD + d + 8] = acc[4 * mt + 3];
    }
  } else {
    if ((lane & 15) == 0)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wp[(lane >> 4) + 2 * j] = m[j];
        wp[kHeads + (lane >> 4) + 2 * j] = l[j];
      }
    float* wa = wp + 2 * kHeads;
#pragma unroll
    for (int g = 0; g < kHeads; ++g)
#pragma unroll
      for (int i = 0; i < HD / 32; ++i)
        wa[g * HD + lane + 32 * i] = acc[g * (HD / 32) + i];
  }
  __syncthreads();

  // the block's partial: the warps' merged in warp order with weights
  // exp2(m_w - M) per head (each thread computes its head's four)
  const float* wpart[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    wpart[w] = reinterpret_cast<const float*>(smem + w * L::ring(stages));
  auto warp_weights = [&](int g, float (&wt)[kWarps]) {
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wpart[w][g]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wt[w] = exp2_fast(wpart[w][g] - mb);
    return mb;
  };
  if (threadIdx.x < kHeads) {
    const int g = threadIdx.x;
    float wt[kWarps];
    bpart[g] = warp_weights(g, wt);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += wpart[w][kHeads + g] * wt[w];
    bpart[kHeads + g] = sum;
  }
  for (int i = threadIdx.x; i < kHeads * HD; i += kThreads) {
    float wt[kWarps];
    warp_weights(i / HD, wt);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += wpart[w][2 * kHeads + i] * wt[w];
    bpart[2 * kHeads + i] = sum;
  }
  __syncthreads();

  // the output: the blocks' partials merged in split order, in one
  // exchange through distributed shared memory.  Block r owns the share
  // [r*S, (r+1)*S) of the (head, dim) outputs: every block sends it its
  // (m, l) of all heads and its acc over that share; after one cluster
  // barrier each block merges its share from its own shared memory.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int share = (kHeads * HD + nsplit - 1) / nsplit;
  float* recv_acc = recv + 2 * kHeads * kMaxCluster;
  if (threadIdx.x < 2 * kHeads)
    for (int r = 0; r < nsplit; ++r)
      cluster.map_shared_rank(recv, r)[split * 2 * kHeads + threadIdx.x] =
          bpart[threadIdx.x];
  for (int i = threadIdx.x; i < kHeads * HD; i += kThreads) {
    const int r = i / share;
    cluster.map_shared_rank(recv_acc, r)[split * share + i - r * share] =
        bpart[2 * kHeads + i];
  }
  cluster.sync();

  // the split weights exp2(m_i - M) and the total l of each head (over
  // warp 0's ring, free now)
  float* wts = reinterpret_cast<float*>(smem);
  float* ltot = wts + kMaxCluster * kHeads;       // kHeads
  if (threadIdx.x < kHeads) {
    const int g = threadIdx.x;
    float mo = kNegInf;
    for (int i = 0; i < nsplit; ++i)
      mo = fmaxf(mo, recv[i * 2 * kHeads + g]);
    float lo = 0.f;
    for (int i = 0; i < nsplit; ++i) {
      const float w = exp2_fast(recv[i * 2 * kHeads + g] - mo);
      wts[i * kHeads + g] = w;
      lo += recv[i * 2 * kHeads + kHeads + g] * w;
    }
    ltot[g] = fmaxf(lo, 1e-30f);
  }
  __syncthreads();
  const int i_end = min((split + 1) * share, kHeads * HD);
  for (int i = split * share + threadIdx.x; i < i_end; i += kThreads) {
    const int g = i / HD, d = i - g * HD;
    if (g >= gn || d >= h) continue;
    float o = 0.f;
    for (int s2 = 0; s2 < nsplit; ++s2)
      o += recv_acc[s2 * share + i - split * share] * wts[s2 * kHeads + g];
    store(out + (qrow0 + g) * h + d, o / ltot[g]);
  }
}

template <typename T, int HD>
size_t smem_bytes(int stages) {
  return Layout<T, HD>::bytes(stages);
}

template <typename T>
size_t smem_for(int h, int stages) {
  if (h <= 32) return smem_bytes<T, 32>(stages);
  if (h <= 64) return smem_bytes<T, 64>(stages);
  if (h <= 128) return smem_bytes<T, 128>(stages);
  return smem_bytes<T, 256>(stages);
}

template <typename T, int HD, bool kVec>
int launch(const void* q, const void* k, const void* v, const int* cache_pos,
           const int* positions, int b, int sc, int nq, int nkv, int h,
           int window, int nsplit, int stages, float scale, void* out,
           cudaStream_t stream) {
  auto kern = decode_attn_kernel<T, HD, kVec>;
  // the opt-in to more than 48 KB of dynamic shared memory, once per
  // kernel and device (set to the most a block may have)
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(allowed.load() & bit)) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem - (int)fa.sharedSizeBytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    allowed.fetch_or(bit);
  }
  const int nhg = (nq / nkv + kHeads - 1) / kHeads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, nhg, b * nkv);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<T, HD>(stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                         static_cast<const T*>(k), static_cast<const T*>(v),
                         cache_pos, positions, sc, nq, nkv, h, window, stages,
                         scale * kLog2e, static_cast<T*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_vec(const void* q, const void* k, const void* v,
               const int* cache_pos, const int* positions, int b, int sc,
               int nq, int nkv, int h, int window, int nsplit, int stages,
               float scale, void* out, cudaStream_t stream) {
  const bool vec = (h * (int)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return vec ? launch<T, HD, true>(q, k, v, cache_pos, positions, b, sc, nq,
                                   nkv, h, window, nsplit, stages, scale, out,
                                   stream)
             : launch<T, HD, false>(q, k, v, cache_pos, positions, b, sc, nq,
                                    nkv, h, window, nsplit, stages, scale, out,
                                    stream);
}

template <typename T>
int launch_h(const void* q, const void* k, const void* v,
             const int* cache_pos, const int* positions, int b, int sc,
             int nq, int nkv, int h, int window, int nsplit, int stages,
             float scale, void* out, cudaStream_t stream) {
  if (nsplit < 1 || nsplit > kMaxCluster || stages < 1 ||
      stages > kMaxStages || h < 1 || h > 256 ||
      smem_for<T>(h, stages) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
#define DECODE_LAUNCH(HD)                                                     \
  launch_vec<T, HD>(q, k, v, cache_pos, positions, b, sc, nq, nkv, h, window, \
                    nsplit, stages, scale, out, stream)
  if (h <= 32) return DECODE_LAUNCH(32);
  if (h <= 64) return DECODE_LAUNCH(64);
  if (h <= 128) return DECODE_LAUNCH(128);
  return DECODE_LAUNCH(256);
#undef DECODE_LAUNCH
}

}  // namespace

extern "C" {

// Shared memory of one block at head dim h (<= 256), dtype (is_bf16) and
// ring depth `stages`.
size_t decode_attention_smem_bytes(int h, int is_bf16, int stages) {
  return is_bf16 ? smem_for<bf16>(h, stages) : smem_for<float>(h, stages);
}

// q (b,nq,h), k/v (b,sc,nkv,h) contiguous, of one dtype (is_bf16 picks
// bf16 on the tensor cores, else fp32 on the CUDA cores); cache_pos (b,sc)
// and positions (b,) int32; nsplit: blocks per cluster (1..16), each taking
// every nsplit-th 64-slot tile; stages: the per-warp copy ring's depth
// (1..4); out (b,nq,h) in q's dtype.  Returns the launch's CUDA error.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* cache_pos, const void* positions,
                            int b, int sc, int nq, int nkv, int h, int window,
                            int nsplit, int stages, int is_bf16, float scale,
                            void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cp = static_cast<const int*>(cache_pos);
  const int* ps = static_cast<const int*>(positions);
  if (is_bf16)
    return launch_h<bf16>(q, k, v, cp, ps, b, sc, nq, nkv, h, window, nsplit,
                          stages, scale, out, s);
  return launch_h<float>(q, k, v, cp, ps, b, sc, nq, nkv, h, window, nsplit,
                         stages, scale, out, s);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
