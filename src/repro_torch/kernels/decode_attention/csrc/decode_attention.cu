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
// their scores are selected away and their V is stored as 0.
//
// Bound on an H100 SXM: the bytes.  K and V are read once (2*B*Sc*Nkv*H
// elements), against 4*B*Nq*Sc*H FLOP, about G/esize FLOP per byte, far
// below the card's ~20 fp32 FLOP per byte.  At the serving shape (B=8,
// Sc=1024, 32/8 heads, H=64, bf16) that is 16.8 MB, about 5 us at
// 3.35 TB/s.
//
// Design (simple and right first): split-KV flash-decoding in two launches
// on the caller's stream.
//   1. split_kernel, grid (B*Nkv, splits), 128 threads.  The TPU kernel
//      walks the cache in a sequential grid dimension; here the cache
//      splits into `chunk`-slot pieces that run in parallel, enough of them
//      for about four blocks on each of the 132 SMs (the wrapper's plan).
//      A block loads one 64-slot tile of K and V of its (b, kv head) into
//      shared memory once (16-byte loads when the rows allow), converted
//      to fp32, and serves all G query heads from it: scores (one thread
//      per (head, slot), K rows padded to H+1 floats so the column reads
//      hit distinct banks), an online-softmax update of the running (m, l)
//      per head (one warp per head), then acc = acc*corr + p @ V (one
//      thread per (head, dim)).  It writes its unnormalised acc and its
//      (m, l) per query head.
//   2. combine_kernel, one block per (b, query head): merges the splits'
//      partials with log-sum-exp weights in split order and divides by l.
// No atomics, so the result is reproducible bit for bit run to run.  The
// ragged end of the cache (Sc not a multiple of the tile or the chunk) is
// masked in the kernel, never padded.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/decode_attention/decode_attention.py).
// Nothing here allocates or synchronises: the caller passes the partials'
// scratch (B*Nq*splits*2 and B*Nq*splits*H floats).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;                       // cache slots per smem tile
constexpr float kNegInf = -0.7f * FLT_MAX;      // ref.py's NEG_INF
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ bool slot_ok(int pos, int cur, int window) {
  const int rel = cur - pos;
  return pos >= 0 && rel >= 0 && (window <= 0 || rel < window);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// floats of shared memory before the int validity flags
size_t smem_floats(int g, int h) {
  return (size_t)2 * g * h          // q, acc
         + (size_t)kTile * (h + 1)  // K tile, rows padded
         + (size_t)kTile * h        // V tile
         + (size_t)g * kTile        // scores / probabilities
         + (size_t)3 * g;           // m, l, the tile's correction
}

size_t smem_bytes(int g, int h) {
  return sizeof(float) * smem_floats(g, h) + sizeof(int) * kTile;
}

// kVec: every K/V row starts on a 16-byte boundary and holds whole 16-byte
// vectors, so a tile loads as uint4.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ cache_pos,
             const int* __restrict__ positions, int sc, int nq, int nkv,
             int h, int window, int chunk, float scale,
             float* __restrict__ part_ml, float* __restrict__ part_acc) {
  extern __shared__ float smem[];
  const int g = nq / nkv;
  const int hp = h + 1;
  float* qs = smem;                 // g*h
  float* acc = qs + g * h;          // g*h, thread-owned entries
  float* ks = acc + g * h;          // kTile*hp
  float* vs = ks + kTile * hp;      // kTile*h
  float* ps = vs + kTile * h;       // g*kTile
  float* ms = ps + g * kTile;       // g
  float* ls = ms + g;               // g
  float* cs = ls + g;               // g
  int* valid = reinterpret_cast<int*>(cs + g);   // kTile

  const int b = blockIdx.x / nkv, kvh = blockIdx.x % nkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int s_begin = split * chunk;
  const int s_end = min(sc, s_begin + chunk);
  const int cur = positions[b];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t row0 = (size_t)b * nq + (size_t)kvh * g;  // first query row

  const T* qb = q + row0 * h;
  for (int i = tid; i < g * h; i += blockDim.x) {
    qs[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += blockDim.x) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }

  const size_t row_stride = (size_t)nkv * h;   // elements between slots
  const T* kb = k + ((size_t)b * sc * nkv + kvh) * h;
  const T* vb = v + ((size_t)b * sc * nkv + kvh) * h;
  const int* pb = cache_pos + (size_t)b * sc;

  for (int t0 = s_begin; t0 < s_end; t0 += kTile) {
    const int tn = min(kTile, s_end - t0);
    __syncthreads();  // the previous tile is consumed; the init is visible
    for (int i = tid; i < tn; i += blockDim.x)
      valid[i] = slot_ok(pb[t0 + i], cur, window);
    if constexpr (kVec) {
      constexpr int V = 16 / sizeof(T);
      const int hv = h / V;
      for (int i = tid; i < tn * hv; i += blockDim.x) {
        const int s = i / hv, d = (i - s * hv) * V;
        const size_t off = (size_t)(t0 + s) * row_stride + d;
        const bool ok = slot_ok(pb[t0 + s], cur, window);
        const uint4 kr = *reinterpret_cast<const uint4*>(kb + off);
        const uint4 vr = *reinterpret_cast<const uint4*>(vb + off);
        const T* ke = reinterpret_cast<const T*>(&kr);
        const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          ks[s * hp + d + j] = to_f32(ke[j]);
          vs[s * h + d + j] = ok ? to_f32(ve[j]) : 0.f;
        }
      }
    } else {
      for (int i = tid; i < tn * h; i += blockDim.x) {
        const int s = i / h, d = i - s * h;
        const size_t off = (size_t)(t0 + s) * row_stride + d;
        const bool ok = slot_ok(pb[t0 + s], cur, window);
        ks[s * hp + d] = to_f32(kb[off]);
        vs[s * h + d] = ok ? to_f32(vb[off]) : 0.f;
      }
    }
    __syncthreads();

    // scores: one thread per (head, slot)
    for (int i = tid; i < g * kTile; i += blockDim.x) {
      const int gi = i / kTile, s = i - gi * kTile;
      float sv = kNegInf;
      if (s < tn && valid[s]) {
        const float* qr = qs + gi * h;
        const float* kr = ks + s * hp;
        float dot = 0.f;
        for (int d = 0; d < h; ++d) dot = fmaf(qr[d], kr[d], dot);
        sv = dot * scale;
      }
      ps[i] = sv;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int gi = warp; gi < g; gi += nwarps) {
      float* pr = ps + gi * kTile;
      float mx = kNegInf;
      for (int s = lane; s < tn; s += 32) mx = fmaxf(mx, pr[s]);
      mx = warp_max(mx);
      const float m_old = ms[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int s = lane; s < tn; s += 32) {
        const float p = valid[s] ? expf(pr[s] - m_new) : 0.f;
        pr[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[gi] = corr;
        ls[gi] = ls[gi] * corr + sum;
        ms[gi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc*corr + p @ V: one thread per (head, dim)
    for (int i = tid; i < g * h; i += blockDim.x) {
      const int gi = i / h, d = i - gi * h;
      const float* pr = ps + gi * kTile;
      float a = acc[i] * cs[gi];
      for (int s = 0; s < tn; ++s) a = fmaf(pr[s], vs[s * h + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < g * h; i += blockDim.x) {
    const int gi = i / h, d = i - gi * h;
    part_acc[((row0 + gi) * nsplit + split) * h + d] = acc[i];
  }
  for (int gi = tid; gi < g; gi += blockDim.x) {
    float* ml = part_ml + ((row0 + gi) * nsplit + split) * 2;
    ml[0] = ms[gi];
    ml[1] = ls[gi];
  }
}

// One block per (b, query head): out = sum_i acc_i e^(m_i - M) / L with
// M = max_i m_i and L = sum_i l_i e^(m_i - M), summed in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part_ml,
               const float* __restrict__ part_acc, int nsplit, int h,
               T* __restrict__ out) {
  const size_t row = blockIdx.x;
  const float* ml = part_ml + row * nsplit * 2;
  float m = kNegInf;
  for (int i = 0; i < nsplit; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f;
  for (int i = 0; i < nsplit; ++i) l += ml[2 * i + 1] * expf(ml[2 * i] - m);
  l = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < h; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < nsplit; ++i)
      a = fmaf(part_acc[(row * nsplit + i) * h + d], expf(ml[2 * i] - m), a);
    store(out + row * h + d, a / l);
  }
}

template <typename T, bool kVec>
int launch_split(const void* q, const void* k, const void* v,
                 const int* cache_pos, const int* positions, int b, int sc,
                 int nq, int nkv, int h, int window, int chunk, float scale,
                 float* part_ml, float* part_acc, cudaStream_t stream) {
  const size_t smem = smem_bytes(nq / nkv, h);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nsplit = (sc + chunk - 1) / chunk;
  const dim3 grid(b * nkv, nsplit);
  split_kernel<T, kVec><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cache_pos, positions, sc, nq, nkv, h, window,
      chunk, scale, part_ml, part_acc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_all(const void* q, const void* k, const void* v,
               const int* cache_pos, const int* positions, int b, int sc,
               int nq, int nkv, int h, int window, int chunk, float scale,
               float* part_ml, float* part_acc, void* out,
               cudaStream_t stream) {
  const bool vec = (h * (int)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int err =
      vec ? launch_split<T, true>(q, k, v, cache_pos, positions, b, sc, nq,
                                  nkv, h, window, chunk, scale, part_ml,
                                  part_acc, stream)
          : launch_split<T, false>(q, k, v, cache_pos, positions, b, sc, nq,
                                   nkv, h, window, chunk, scale, part_ml,
                                   part_acc, stream);
  if (err != 0) return err;
  const int nsplit = (sc + chunk - 1) / chunk;
  combine_kernel<T><<<b * nq, kThreads, 0, stream>>>(
      part_ml, part_acc, nsplit, h, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one split block needs for G query heads per kv head and
// head dim H.
size_t decode_attention_smem_bytes(int g, int h) { return smem_bytes(g, h); }

// q (b,nq,h), k/v (b,sc,nkv,h) contiguous, of one dtype (is_bf16 picks
// bf16, else fp32); cache_pos (b,sc) and positions (b,) int32; chunk: cache
// slots per split, a multiple of 64; part_ml (b*nq*splits*2) and part_acc
// (b*nq*splits*h) fp32 scratch, splits = ceil(sc/chunk); out (b,nq,h) in
// q's dtype.  Returns cudaGetLastError() after the launches.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* cache_pos, const void* positions,
                            int b, int sc, int nq, int nkv, int h,
                            int window, int chunk, int is_bf16, float scale,
                            void* part_ml, void* part_acc, void* out,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cp = static_cast<const int*>(cache_pos);
  const int* ps = static_cast<const int*>(positions);
  float* ml = static_cast<float*>(part_ml);
  float* pa = static_cast<float*>(part_acc);
  if (is_bf16)
    return launch_all<__nv_bfloat16>(q, k, v, cp, ps, b, sc, nq, nkv, h,
                                     window, chunk, scale, ml, pa, out, s);
  return launch_all<float>(q, k, v, cp, ps, b, sc, nq, nkv, h, window, chunk,
                           scale, ml, pa, out, s);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
