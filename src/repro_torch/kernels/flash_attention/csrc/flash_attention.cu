// Causal / sliding-window GQA self-attention (forward) in fp32 on the CUDA
// cores of Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention
// (same function, not the same blocking) for fp32 inputs; bf16 inputs, which
// every model path gives, go to the tensor-core kernel in
// flash_attention_sm90.cu (the wrapper routes by dtype).  TF32 tensor cores
// would keep about three decimal digits, against the fp32 tolerance of 2e-5
// that the parity tests with the JAX package hold.
//
//   q (B,Sq,Nq,H); k, v (B,Skv,Nkv,H) fp32; G = Nq/Nkv query heads per kv
//   head; query row i sits at position i, kv row j at position j (the
//   implicit iota of the Pallas kernel and its ref); (i, j) is valid iff
//   (not causal or i - j >= 0) and (window <= 0 or i - j < window)
//   out[b,i,hq] = softmax_j(q[b,i,hq] . k[b,j,hq/G] * H^-0.5 over valid j)
//                 @ v[b,:,hq/G]
//   fp32 scores, online softmax and P.V sums.  A row with no valid j gets
//   0, as the Pallas kernel writes (its l is clamped to 1e-30); causal
//   self-attention never has one.
//
// Bound on an H100 SXM: the operations, at the fp32 CUDA-core peak of 67
// TFLOP/s: 4*H FLOP per valid (q row, kv row, query head) pair, against q,
// k, v and the output read or written once.
//
// Design.  One block of 256 threads per (64-row query tile, query head,
// batch row).
//   - The Q tile is loaded once into shared memory; 64-row K and V tiles of
//     the head's kv head follow one at a time (16-byte global loads when the
//     rows allow).
//   - The KV loop runs only over the tiles the causal and window band can
//     reach from the query tile; this takes the place of the Pallas
//     kernel's pl.when skip over fully masked blocks.
//   - Scores: each thread owns a 4x4 register tile (rows ty+16i, columns
//     tx+16j), read as float4s from rows padded to H+4 floats so that the
//     column reads spread over the banks.
//   - Online softmax in fp32, in registers: the 16 threads of a row reduce
//     its max and sum with shuffles; the running (m, l) are kept per row,
//     as the Pallas kernel keeps them in VMEM scratch.  Probabilities go to
//     shared memory for the P.V product, which each thread accumulates for
//     its 4 rows and H/16 contiguous output dims in registers.
//   - The ragged ends (Sq, Skv not multiples of 64, H below the template's
//     width) are masked in the kernel, never padded in memory.
//   - The longest query tiles are scheduled first.
// No atomics: the result is reproducible bit for bit run to run.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/flash_attention/flash_attention.py).
// Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <atomic>
#include <cfloat>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                         // query rows per block
constexpr int kBK = 64;                         // kv rows per tile
constexpr float kNegInf = -0.7f * FLT_MAX;      // ref.py's NEG_INF
constexpr size_t kDefaultSmem = 48 * 1024;


// Shared-memory layout for head dims up to kHD (32, 64 or 128).
template <int kHD>
struct Layout {
  static constexpr int kStride = kHD + 4;       // Q and K rows (16-byte aligned)
  static constexpr int kPStride = kBK + 4;      // probability rows
  static constexpr int kDPT = kHD / 16;         // output dims per thread
  static constexpr size_t kFloats = (size_t)kBQ * kStride   // Q
                                    + (size_t)kBK * kStride   // K
                                    + (size_t)kBK * kHD       // V
                                    + (size_t)kBQ * kPStride;  // P
};

// Rows [r0, r0+64) at head `head` of one batch row of a (S, NH, H) tensor,
// into a row-major fp32 tile with row stride `stride`: zero past `s` and
// past `h`.  kVec: H holds whole 16-byte vectors and the base is 16-byte
// aligned, so rows load as uint4.
template <int kHD, bool kVec>
__device__ __forceinline__ void load_tile(const float* __restrict__ base,
                                          int r0, int s, int nh, int head,
                                          int h, float* dst, int stride) {
  if constexpr (kVec) {
    constexpr int V = 4;
    constexpr int kVecs = kHD / V;
    for (int i = threadIdx.x; i < 64 * kVecs; i += kThreads) {
      const int r = i / kVecs, d = (i - r * kVecs) * V;
      float vals[V];
      if (r0 + r < s && d < h) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            base + ((size_t)(r0 + r) * nh + head) * h + d);
        const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) vals[j] = e[j];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) vals[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) dst[r * stride + d + j] = vals[j];
    }
  } else {
    for (int i = threadIdx.x; i < 64 * kHD; i += kThreads) {
      const int r = i / kHD, d = i - r * kHD;
      dst[r * stride + d] =
          (r0 + r < s && d < h)
              ? base[((size_t)(r0 + r) * nh + head) * h + d]
              : 0.f;
    }
  }
}

// kDPT consecutive floats from shared memory (16- or 8-byte aligned).
template <int kDPT>
__device__ __forceinline__ void load_dims(const float* p, float (&v)[kDPT]) {
  if constexpr (kDPT % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kDPT; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kDPT; k += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + k);
      v[k] = t.x; v[k + 1] = t.y;
    }
  }
}

// Max and sum over the 16 threads of a row (lanes that share ty).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int kHD, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, int sq, int skv, int nq, int nkv,
             int h, int causal, int window, float scale,
             float* __restrict__ out) {
  using L = Layout<kHD>;
  constexpr int kDPT = L::kDPT;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // kBQ x kStride
  float* ks = qs + kBQ * L::kStride;             // kBK x kStride
  float* vs = ks + kBK * L::kStride;             // kBK x kHD
  float* ps = vs + kBK * kHD;                    // kBQ x kPStride

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;     // the longest rows first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (nq / nkv);
  const int q0 = qt * kBQ;

  load_tile<kHD, kVec>(q + (size_t)b * sq * nq * h, q0, sq, nq, hq, h, qs,
                          L::kStride);

  float m[4], l[4], acc[4][kDPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPT; ++c) acc[i][c] = 0.f;
  }

  // the kv rows the band can reach from query rows q0 .. q_last
  const int q_last = min(q0 + kBQ, sq) - 1;
  int k_hi = skv - 1;
  if (causal) k_hi = min(k_hi, q_last);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const float* kb = k + (size_t)b * skv * nkv * h;
  const float* vb = v + (size_t)b * skv * nkv * h;

  for (int k0 = (k_lo / kBK) * kBK; k0 <= k_hi; k0 += kBK) {
    __syncthreads();   // the previous tile is consumed; Q is visible
    load_tile<kHD, kVec>(kb, k0, skv, nkv, hk, h, ks, L::kStride);
    load_tile<kHD, kVec>(vb, k0, skv, nkv, hk, h, vs, kHD);
    __syncthreads();

    // scores: rows ty+16i, columns tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qs + (ty + 16 * i) * L::kStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            ks + (tx + 16 * j) * L::kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // mask and online softmax, one row at a time
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      unsigned ok = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const int rel = qp - kp;
        const bool valid = qp < sq && kp < skv && (!causal || rel >= 0) &&
                           (window <= 0 || rel < window);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        ok |= (unsigned)valid << j;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ((ok >> j) & 1u) ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * L::kPStride + tx + 16 * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P @ V: rows ty+16i, dims tx*kDPT ..
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            ps + (ty + 16 * i) * L::kPStride + c);
      float vv[4][kDPT];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        load_dims<kDPT>(vs + (c + cc) * kHD + tx * kDPT, vv[cc]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < kDPT; ++e) {
          float a = acc[i][e];
          a = fmaf(pv[i].x, vv[0][e], a);
          a = fmaf(pv[i].y, vv[1][e], a);
          a = fmaf(pv[i].z, vv[2][e], a);
          a = fmaf(pv[i].w, vv[3][e], a);
          acc[i][e] = a;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* orow = out + (((size_t)b * sq + qp) * nq + hq) * h;
#pragma unroll
    for (int e = 0; e < kDPT; ++e) {
      const int d = tx * kDPT + e;
      if (d < h) orow[d] = acc[i][e] / li;
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
  const size_t smem = Layout<kHD>::kFloats * sizeof(float);
  if (smem > kDefaultSmem) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(allowed.load() & bit)) {
      e = cudaFuncSetAttribute(flash_kernel<kHD, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      allowed.fetch_or(bit);
    }
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, nq, b);
  flash_kernel<kHD, kVec><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), sq, skv, nq, nkv, h, causal, window, scale,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <int kHD>
int launch_vec(const void* q, const void* k, const void* v, int b, int sq,
               int skv, int nq, int nkv, int h, int causal, int window,
               float scale, void* out, cudaStream_t stream) {
  const bool vec = h % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return vec ? launch<kHD, true>(q, k, v, b, sq, skv, nq, nkv, h, causal,
                                 window, scale, out, stream)
             : launch<kHD, false>(q, k, v, b, sq, skv, nq, nkv, h, causal,
                                  window, scale, out, stream);
}

int launch_width(const void* q, const void* k, const void* v, int b, int sq,
                 int skv, int nq, int nkv, int h, int causal, int window,
                 float scale, void* out, cudaStream_t stream) {
  if (h <= 32)
    return launch_vec<32>(q, k, v, b, sq, skv, nq, nkv, h, causal, window,
                          scale, out, stream);
  if (h <= 64)
    return launch_vec<64>(q, k, v, b, sq, skv, nq, nkv, h, causal, window,
                          scale, out, stream);
  return launch_vec<128>(q, k, v, b, sq, skv, nq, nkv, h, causal, window,
                         scale, out, stream);
}

}  // namespace

extern "C" {

// q (b,sq,nq,h), k/v (b,skv,nkv,h) and out (b,sq,nq,h) contiguous fp32; nq
// a multiple of nkv; 1 <= h <= 128.  Returns cudaGetLastError() after the
// launch.
int flash_attention_launch(const void* q, const void* k, const void* v, int b,
                           int sq, int skv, int nq, int nkv, int h,
                           int causal, int window, float scale, void* out,
                           void* stream) {
  return launch_width(q, k, v, b, sq, skv, nq, nkv, h, causal, window, scale,
                      out, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
