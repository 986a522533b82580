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
// writes y once; the arithmetic, about 7 fp32 operations and one exp per
// (b, t, d, n), is at the Hymba prefill shape (B=1, S=2048, Di=3200, N=16,
// bf16 x) 0.73 GFLOP, 11 us at 67 TFLOP/s, against 52.7 MB of inputs and
// outputs, 15.7 us at 3.35 TB/s.
//
// Design (simple and right first).  The TPU kernel carries the state in
// VMEM across a sequential chunk grid; Hopper blocks run in no order, so a
// loop over the sequence inside the block takes the place of that grid
// dimension and the state never leaves registers.
//   - One lane per (b, d, n): kLanes lanes (a power of two >= N, at most
//     32) hold one channel's state, one float each, so a block of 128
//     threads serves 128/kLanes channels (8 at N=16).  At B=1 and Di=3200
//     that is 51,200 threads in 400 blocks, enough for the 132 SMs; one
//     thread per channel would be 3,200.
//   - x and dt of the block's channels, and the B and C rows, are staged
//     through shared memory kChunk timesteps at a time, converted to fp32
//     as they come.
//   - The sequential loop does only the recurrence: each lane writes its
//     h_t[n] * C_t[n] to shared memory.  The sum over n, plus D*x_t, runs
//     after the loop over the whole chunk, one thread per (t, channel),
//     and goes straight to y along rows.  A shuffle-reduce over n inside
//     the loop would add a dependent chain of log2(kLanes) shuffles to
//     every step, which the few warps per SM (about 12 at B=1) cannot
//     hide.  Rows of the partials are padded by one float per channel so
//     that both the writes and the sums hit distinct banks.
// The ragged ends (S not a multiple of kChunk, Di not of the channels per
// block, N below kLanes) are masked in the kernel.  No atomics: the result
// is reproducible bit for bit run to run.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/selective_scan/selective_scan.py).
// Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;        // timesteps staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int kLanes>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a, const T* __restrict__ bm,
            const T* __restrict__ cm, const float* __restrict__ dskip,
            const float* __restrict__ h0, int s, int di, int n,
            T* __restrict__ y, float* __restrict__ h_end) {
  constexpr int kCh = kThreads / kLanes;        // channels per block
  constexpr int kRow = kCh * (kLanes + 1);      // padded partials per step
  __shared__ float xs[kChunk][kCh];
  __shared__ float dts[kChunk][kCh];
  __shared__ float bs[kChunk][kLanes];
  __shared__ float cs[kChunk][kLanes];
  __shared__ float ps[kChunk][kRow];             // h_t[n] * C_t[n]

  const int tid = threadIdx.x;
  const int ln = tid % kLanes, ch = tid / kLanes;
  const int slot = ch * (kLanes + 1) + ln;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + ch;
  const bool live = d < di && ln < n;
  const float av = live ? a[(size_t)d * n + ln] : 0.f;
  float h = (live && h0 != nullptr) ? h0[((size_t)b * di + d) * n + ln] : 0.f;

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int tn = min(kChunk, s - t0);
    __syncthreads();   // the previous chunk's partials are summed
    for (int i = tid; i < tn * kCh; i += kThreads) {
      const int t = i / kCh, c = i - t * kCh, dd = d0 + c;
      const size_t off = ((size_t)b * s + t0 + t) * di + dd;
      const bool ok = dd < di;
      xs[t][c] = ok ? to_f32(x[off]) : 0.f;
      dts[t][c] = ok ? dt[off] : 0.f;
    }
    for (int i = tid; i < tn * kLanes; i += kThreads) {
      const int t = i / kLanes, j = i - t * kLanes;
      const size_t off = ((size_t)b * s + t0 + t) * n + j;
      const bool ok = j < n;
      bs[t][j] = ok ? to_f32(bm[off]) : 0.f;
      cs[t][j] = ok ? to_f32(cm[off]) : 0.f;
    }
    __syncthreads();

    // the recurrence; idle lanes (n >= N, or a channel past Di) have A = 0
    // and B = 0 or dt = 0, so h stays 0 and adds nothing to y
#pragma unroll 8
    for (int t = 0; t < tn; ++t) {
      const float dtv = dts[t][ch];
      h = expf(dtv * av) * h + (dtv * xs[t][ch]) * bs[t][ln];
      ps[t][slot] = h * cs[t][ln];
    }
    __syncthreads();

    // y_t = sum_n h_t[n] C_t[n] + D x_t, one thread per (t, channel)
    for (int i = tid; i < tn * kCh; i += kThreads) {
      const int t = i / kCh, c = i - t * kCh, dd = d0 + c;
      if (dd >= di) continue;
      const float* pr = &ps[t][c * (kLanes + 1)];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) sum += pr[j];
      store(y + ((size_t)b * s + t0 + t) * di + dd,
            sum + xs[t][c] * dskip[dd]);
    }
  }
  if (live) h_end[((size_t)b * di + d) * n + ln] = h;
}

template <typename T, int kLanes>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, const float* dskip, const float* h0, int bsz,
           int s, int di, int n, void* y, float* h_end,
           cudaStream_t stream) {
  constexpr int kCh = kThreads / kLanes;
  const dim3 grid((di + kCh - 1) / kCh, bsz);
  scan_kernel<T, kLanes><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), dskip, h0, s, di, n, static_cast<T*>(y),
      h_end);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lanes(const void* x, const float* dt, const float* a,
                 const void* bm, const void* cm, const float* dskip,
                 const float* h0, int bsz, int s, int di, int n, void* y,
                 float* h_end, cudaStream_t stream) {
  if (n <= 4)
    return launch<T, 4>(x, dt, a, bm, cm, dskip, h0, bsz, s, di, n, y, h_end,
                        stream);
  if (n <= 8)
    return launch<T, 8>(x, dt, a, bm, cm, dskip, h0, bsz, s, di, n, y, h_end,
                        stream);
  if (n <= 16)
    return launch<T, 16>(x, dt, a, bm, cm, dskip, h0, bsz, s, di, n, y,
                         h_end, stream);
  return launch<T, 32>(x, dt, a, bm, cm, dskip, h0, bsz, s, di, n, y, h_end,
                       stream);
}

}  // namespace

extern "C" {

// x (bsz,s,di), b/c (bsz,s,n) and y (bsz,s,di) contiguous in one dtype
// (is_bf16 picks bf16, else fp32); dt (bsz,s,di), a (di,n), dskip (di,),
// h0 (bsz,di,n) or null, and h_end (bsz,di,n) contiguous fp32; 1 <= n <= 32.
// Returns cudaGetLastError() after the launch.
int selective_scan_launch(const void* x, const void* dt, const void* a,
                          const void* bm, const void* cm, const void* dskip,
                          const void* h0, int bsz, int s, int di, int n,
                          int is_bf16, void* y, void* h_end, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(dskip);
  const float* hf = static_cast<const float*>(h0);
  float* he = static_cast<float*>(h_end);
  if (is_bf16)
    return launch_lanes<__nv_bfloat16>(x, dtf, af, bm, cm, df, hf, bsz, s, di,
                                       n, y, he, st);
  return launch_lanes<float>(x, dtf, af, bm, cm, df, hf, bsz, s, di, n, y, he,
                             st);
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
