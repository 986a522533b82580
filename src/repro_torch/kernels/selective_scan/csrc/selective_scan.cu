// Mamba-1 selective scan (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/selective_scan/selective_scan.py::selective_scan
// (same function, not the same blocking):
//
//   x (B,S,Di) and B, C (B,S,N) in T (fp32 or bf16); dt (B,S,Di), A (Di,N),
//   D (Di,) and the optional start state h0 (B,Di,N) in fp32
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      per (b, d, n)
//   y_t = sum_n h_t[n] * C_t[n] + D * x_t                  y (B,S,Di) in T
//   h_end = h_S (B,Di,N) in fp32
//
// Bound on an H100 SXM: the bytes.  Each (b, t, d) reads x and dt and
// writes y once: at Hymba's refill (B=1, S=2048, Di=3200, N=16, bf16 x)
// 52.7 MB, 15.7 us at 3.35 TB/s; at its wave (B=8, S=512) 106.8 MB, 31.9
// us.  Beside it the floor of the exps, one per (b, t, d, n) on the SFUs
// (16 per clock per SM, 132 SMs at 1.98 GHz): 105 M, about 25 us, at the
// refill and 210 M, about 50 us, at the wave.  The chunked runs below
// compute each exp twice: that doubling is a cost of the two-pass design,
// not of the function.
//
// Design.
//   - One thread owns one channel d and kS <= 8 of its states (one thread
//     per channel for N <= 8, two for N = 16, four for N = 32): twice the
//     warps of one thread per channel, which the few channels of a batch
//     row need to hide the exps' latency, for one shuffle per step (16
//     states in one thread ran slower at Hymba's shapes; PERF.md).  Its
//     h[n] and A[n] * log2(e) live in registers; exp is one ex2 per (t, n).
//   - The block stages 16-step windows of dt and x (its channels, coalesced
//     across consecutive d) and of the B and C rows by cp.async 16-byte
//     copies into shared memory, two stages: the next window is in flight
//     while this one computes.  B and C are widened to fp32 once per window
//     for the whole block.  Per step a thread reads its own dt_t and x_t and
//     reads B_t and C_t as float4 broadcasts (every lane the same address).
//     Staging dt and x too, rather than loading them per thread, keeps the
//     address arithmetic out of the per-step loop.  Rows of Di that are not
//     whole 16-byte chunks, or bases not 16-byte aligned, stage element by
//     element instead.
//   - y_t = sum_n h[n] C_t[n] + D x_t is summed in registers, in four
//     partial sums so that its chain stays short, and stored straight to y
//     (1-2 shuffles where a channel is split, off the recurrence's chain).
//     No shared-memory write per step, no second pass over partials.
//   - A full window of a block inside Di is one basic block: past a ragged
//     window's end only, steps are masked, so that the compiler schedules
//     across the window's steps.
//   - Sequence-parallel chunks, when B * Di alone cannot fill the card (the
//     rule is selective_scan.py::chunk_len: one chunk when B * Di * threads
//     per channel >= 32768, else chunks of a multiple of 16 steps enough
//     for about 65536 threads).  With L chunks of `chunk` steps:
//       1. (local, chunks 0 .. L-2) each block scans its chunk from h = 0
//          and writes the chunk-end state and its decay, the running product
//          of the same exp values the recurrence uses (not exp(A * sum dt)),
//          to the scratch buffers the wrapper allocates;
//       2. (final, chunks 0 .. L-1) each block walks the earlier chunks'
//          (decay, state) in order from h0 to its true start state (the
//          carry pass), scans its chunk again from there, writes y and, in
//          the last chunk, h_end.
//     One chunk (L = 1) is the final pass alone, starting from h0: one
//     kernel family and one rule, not two routes.
// The ragged ends (S not a multiple of the window or the chunk, Di not of
// the channels per block, N below kS) are masked in the kernel.  No
// atomics: the result is reproducible bit for bit run to run.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/selective_scan/selective_scan.py).
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 16;            // timesteps per staging window
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0.f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Shared memory of one block for its window of kT steps, two stages: dt and
// x of the block's kCh channels, the raw B and C rows as copied, and B and
// C widened to fp32.
template <typename T, int kNP, int kCh>
struct Smem {
  // the raw B (or C) rows of a window are one contiguous run of at most
  // kT*kNP elements, copied as the 16-byte aligned chunks that cover it
  static constexpr int kRawBytes = kT * kNP * (int)sizeof(T) + 16;
  float dt[2][kT][kCh];
  T x[2][kT][kCh];
  uint8_t raw[2][2][kRawBytes];                 // [stage][B | C]
  float b[2][kT][kNP];
  float c[2][kT][kNP];
};

// Stage the window of steps [t0, t0+tn) of batch row `row0 / s` into stage
// `st`.  dt and x: kVec (rows of whole 16-byte chunks, 16-byte aligned) by
// cp.async, coalesced across consecutive d and zero past Di; else element
// by element, synchronously.  B and C by cp.async from the 16-byte boundary
// at or before the run's start, reading only up to its end; returns where
// the runs start in raw (B | C << 8, in elements).
template <typename T, int kNP, int kCh, bool kVec, bool kWithC>
__device__ __forceinline__ int stage(Smem<T, kNP, kCh>& sm, int st,
                                     const float* __restrict__ dt,
                                     const T* __restrict__ x,
                                     const T* __restrict__ bm,
                                     const T* __restrict__ cm, size_t row0,
                                     int t0, int tn, int d0, int di, int n) {
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int kDt = kCh / 4;                          // chunks per row
    constexpr int kX = kCh * (int)sizeof(T) / 16;
#pragma unroll
    for (int i = tid; i < kT * kDt; i += kThreads) {
      const int t = i / kDt, dd = d0 + (i % kDt) * 4;
      const bool ok = t < tn && dd < di;
      cp_async16(&sm.dt[st][t][dd - d0],
                 ok ? dt + (row0 + t0 + t) * di + dd : dt, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = tid; i < kT * kX; i += kThreads) {
      constexpr int kE = 16 / (int)sizeof(T);
      const int t = i / kX, dd = d0 + (i % kX) * kE;
      const bool ok = t < tn && dd < di;
      cp_async16(&sm.x[st][t][dd - d0],
                 ok ? x + (row0 + t0 + t) * di + dd : x, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kT * kCh; i += kThreads) {
      const int t = i / kCh, dd = d0 + i % kCh;
      const bool ok = t < tn && dd < di;
      const size_t o = (row0 + t0 + t) * di + dd;
      sm.dt[st][t][i % kCh] = ok ? dt[o] : 0.f;
      sm.x[st][t][i % kCh] = ok ? x[o] : zero<T>();
    }
  }
  const size_t first = (row0 + t0) * n;
  const int bytes = tn * n * (int)sizeof(T);
  int offs = 0;
#pragma unroll
  for (int m = 0; m < (kWithC ? 2 : 1); ++m) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>((m ? cm : bm) + first);
    const uintptr_t al = lo & ~uintptr_t(15);
    const int end = (int)(lo - al) + bytes;
    for (int i = tid; i < Smem<T, kNP, kCh>::kRawBytes / 16; i += kThreads) {
      const int nb = min(16, max(0, end - 16 * i));
      cp_async16(&sm.raw[st][m][16 * i],
                 reinterpret_cast<const void*>(nb ? al + 16 * i : al), nb);
    }
    offs |= (int)((lo - al) / sizeof(T)) << (8 * m);
  }
  return offs;
}

// kS states per thread, kSplit threads per channel (kS * kSplit >= N);
// kLocal: pass 1 (from h = 0, writes the chunk's decay and end state),
// else the final pass (carry, rescan, y and h_end); kVec: see stage().
template <typename T, int kS, int kSplit, bool kLocal, bool kVec>
__global__ void __launch_bounds__(kThreads)
scan_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, const float* __restrict__ dskip,
                  const float* __restrict__ h0, int s, int di, int n,
                  int chunk, float* __restrict__ decay,
                  float* __restrict__ hloc, T* __restrict__ y,
                  float* __restrict__ h_end) {
  constexpr int kNP = kS * kSplit;               // padded states per channel
  constexpr int kCh = kThreads / kSplit;         // channels per block
  __shared__ __align__(16) Smem<T, kNP, kCh> sm;

  const int tid = threadIdx.x;
  const int part = tid % kSplit, ch = tid / kSplit;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + ch;
  const bool live = d < di;
  const bool writes = live && part == 0;
  const int b = blockIdx.y, c = blockIdx.z, bsz = gridDim.y;
  const int c0 = c * chunk, c1 = min(s, c0 + chunk);
  const int n0 = part * kS;
  const size_t row0 = (size_t)b * s;

  float a2[kS], h[kS], dec[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const bool ok = live && n0 + j < n;
    a2[j] = ok ? a[(size_t)d * n + n0 + j] * kLog2e : 0.f;
    h[j] = 0.f;
    dec[j] = 1.f;
  }
  if constexpr (!kLocal) {
    // the carry: h0, then each earlier chunk's (decay, end state) in order
#pragma unroll
    for (int j = 0; j < kS; ++j)
      if (live && n0 + j < n && h0 != nullptr)
        h[j] = h0[((size_t)b * di + d) * n + n0 + j];
    if (live)
      for (int cc = 0; cc < c; ++cc) {
        const size_t o = (((size_t)cc * bsz + b) * di + d) * n + n0;
#pragma unroll
        for (int j = 0; j < kS; ++j)
          if (n0 + j < n) h[j] = fmaf(decay[o + j], h[j], hloc[o + j]);
      }
  }
  const float dsk = kLocal || !live ? 0.f : dskip[d];

  int offs = stage<T, kNP, kCh, kVec, !kLocal>(sm, 0, dt, x, bm, cm, row0,
                                                c0, min(kT, c1 - c0), d0, di,
                                                n);
  cp_async_commit();

  int w = 0;
  for (int t0 = c0; t0 < c1; t0 += kT, ++w) {
    const int tn = min(kT, c1 - t0);
    const int st = w & 1;
    cp_async_wait0();          // this window has landed
    __syncthreads();           // ... for all, and the other stage is free
    int noffs = 0;
    if (t0 + kT < c1)
      noffs = stage<T, kNP, kCh, kVec, !kLocal>(sm, st ^ 1, dt, x, bm, cm,
                                                row0, t0 + kT,
                                                min(kT, c1 - t0 - kT), d0,
                                                di, n);
    cp_async_commit();
    {                          // widen B and C to fp32, zero past tn and N
      const T* rb = reinterpret_cast<const T*>(sm.raw[st][0]) + (offs & 255);
      const T* rc = reinterpret_cast<const T*>(sm.raw[st][1]) + (offs >> 8);
      for (int i = tid; i < kT * kNP; i += kThreads) {
        const int t = i / kNP, j = i % kNP;
        const bool ok = t < tn && j < n;
        sm.b[st][t][j] = ok ? to_f32(rb[t * n + j]) : 0.f;
        if constexpr (!kLocal)
          sm.c[st][t][j] = ok ? to_f32(rc[t * n + j]) : 0.f;
      }
    }
    __syncthreads();
    offs = noffs;

    // the recurrence over the window.  A full window of a block inside Di
    // runs as one basic block, unmasked, so that the steps' exps and
    // products interleave; there every thread stores y (the threads of a
    // channel hold the same sum and store the same value).
    T* yp = y + (row0 + t0) * di + d;
    auto steps = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        if (!kFull && t >= tn) break;
        const float dtv = sm.dt[st][t][ch];
        const float xv = to_f32(sm.x[st][t][ch]);
        const float dx = dtv * xv;
        const float4* bq = reinterpret_cast<const float4*>(&sm.b[st][t][n0]);
        const float4* cq = reinterpret_cast<const float4*>(&sm.c[st][t][n0]);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < kS / 4; ++q) {
          const float4 bb = bq[q];
          const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
          float cv[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (!kLocal) {
            const float4 cc = cq[q];
            cv[0] = cc.x; cv[1] = cc.y; cv[2] = cc.z; cv[3] = cc.w;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * q + e;
            const float da = ex2(dtv * a2[j]);
            h[j] = fmaf(da, h[j], dx * bv[e]);
            if constexpr (kLocal)
              dec[j] *= da;
            else
              acc[e] = fmaf(h[j], cv[e], acc[e]);
          }
        }
        if constexpr (!kLocal) {
          float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
          for (int m = 1; m < kSplit; m <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, m);
          if (kFull || writes) store(yp + (size_t)t * di, sum + dsk * xv);
        }
      }
    };
    if (tn == kT && d0 + kCh <= di)
      steps(std::true_type{});
    else
      steps(std::false_type{});
  }

#pragma unroll
  for (int j = 0; j < kS; ++j) {
    if (!live || n0 + j >= n) continue;
    if constexpr (kLocal) {
      const size_t o = (((size_t)c * bsz + b) * di + d) * n + n0 + j;
      decay[o] = dec[j];
      hloc[o] = h[j];
    } else if (c == (int)gridDim.z - 1) {
      h_end[((size_t)b * di + d) * n + n0 + j] = h[j];
    }
  }
}

template <typename T, int kS, int kSplit, bool kVec>
int launch(const T* x, const float* dt, const float* a, const T* bm,
           const T* cm, const float* dskip, const float* h0, int bsz, int s,
           int di, int n, int chunk, float* decay, float* hloc, T* y,
           float* h_end, cudaStream_t stream) {
  constexpr int kCh = kThreads / kSplit;
  const int chunks = (s + chunk - 1) / chunk;
  const int gx = (di + kCh - 1) / kCh;
  if (chunks > 1) {
    scan_chunk_kernel<T, kS, kSplit, true, kVec>
        <<<dim3(gx, bsz, chunks - 1), kThreads, 0, stream>>>(
            x, dt, a, bm, cm, dskip, h0, s, di, n, chunk, decay, hloc, y,
            h_end);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  scan_chunk_kernel<T, kS, kSplit, false, kVec>
      <<<dim3(gx, bsz, chunks), kThreads, 0, stream>>>(
          x, dt, a, bm, cm, dskip, h0, s, di, n, chunk, decay, hloc, y,
          h_end);
  return (int)cudaGetLastError();
}

template <typename T, int kS, int kSplit>
int launch_vec(const T* x, const float* dt, const float* a, const T* bm,
               const T* cm, const float* dskip, const float* h0, int bsz,
               int s, int di, int n, int chunk, float* decay, float* hloc,
               T* y, float* h_end, cudaStream_t stream) {
  // dt and x rows of whole 16-byte chunks from 16-byte aligned bases
  const bool vec = di % (16 / (int)sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dt) % 16 == 0;
  return vec ? launch<T, kS, kSplit, true>(x, dt, a, bm, cm, dskip, h0, bsz,
                                           s, di, n, chunk, decay, hloc, y,
                                           h_end, stream)
             : launch<T, kS, kSplit, false>(x, dt, a, bm, cm, dskip, h0, bsz,
                                            s, di, n, chunk, decay, hloc, y,
                                            h_end, stream);
}

template <typename T>
int launch_states(const void* x, const float* dt, const float* a,
                  const void* bm, const void* cm, const float* dskip,
                  const float* h0, int bsz, int s, int di, int n, int chunk,
                  float* decay, float* hloc, void* y, float* h_end,
                  cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  T* yt = static_cast<T*>(y);
  if (n <= 4)
    return launch_vec<T, 4, 1>(xt, dt, a, bt, ct, dskip, h0, bsz, s, di, n,
                           chunk, decay, hloc, yt, h_end, st);
  if (n <= 8)
    return launch_vec<T, 8, 1>(xt, dt, a, bt, ct, dskip, h0, bsz, s, di, n,
                           chunk, decay, hloc, yt, h_end, st);
  if (n <= 16)
    return launch_vec<T, 8, 2>(xt, dt, a, bt, ct, dskip, h0, bsz, s, di, n,
                           chunk, decay, hloc, yt, h_end, st);
  return launch_vec<T, 8, 4>(xt, dt, a, bt, ct, dskip, h0, bsz, s, di, n, chunk,
                         decay, hloc, yt, h_end, st);
}

}  // namespace

extern "C" {

// x (bsz,s,di), b/c (bsz,s,n) and y (bsz,s,di) contiguous in one dtype
// (is_bf16 picks bf16, else fp32); dt (bsz,s,di), a (di,n), dskip (di,),
// h0 (bsz,di,n) or null, and h_end (bsz,di,n) contiguous fp32; 1 <= n <=
// 32.  chunk (>= 1) is the steps per sequence chunk; with L = ceil(s /
// chunk) > 1 chunks, decay and hloc are fp32 scratch of (L-1)*bsz*di*n
// each (else unused).  Returns cudaGetLastError() after the launches.
int selective_scan_launch(const void* x, const void* dt, const void* a,
                          const void* bm, const void* cm, const void* dskip,
                          const void* h0, int bsz, int s, int di, int n,
                          int chunk, int is_bf16, void* decay, void* hloc,
                          void* y, void* h_end, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(dskip);
  const float* hf = static_cast<const float*>(h0);
  float* dec = static_cast<float*>(decay);
  float* hl = static_cast<float*>(hloc);
  float* he = static_cast<float*>(h_end);
  if (is_bf16)
    return launch_states<__nv_bfloat16>(x, dtf, af, bm, cm, df, hf, bsz, s,
                                        di, n, chunk, dec, hl, y, he, st);
  return launch_states<float>(x, dtf, af, bm, cm, df, hf, bsz, s, di, n,
                              chunk, dec, hl, y, he, st);
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
