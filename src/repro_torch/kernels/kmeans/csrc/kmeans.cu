// Fused KMeans assignment + partial centroid sums for Hopper (sm_90a), in
// one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/kmeans/kmeans.py::kmeans_assign
// (same function, not the same blocking):
//
//   points x (N,D), centroids c (K,D), fp32 or bf16
//   d2[n,k]  = |x_n|^2 - 2 x_n.c_k + |c_k|^2      (the matmul form of ref.py)
//   idx[n]   = argmin_k d2[n,k]                   (first index wins on ties)
//   sums     = one_hot(idx)^T x   (K,D) fp32
//   counts   = column sums of one_hot  (K,) fp32
//   sse      = sum_n d2[n, idx[n]]  () fp32
//
// Bound on an H100 SXM: the dot products are 2*N*K*D fp32 FLOP at 67 TFLOP/s
// (CUDA cores; D=8 is too thin for tensor cores, and TF32 would change
// assignments), the bytes are the N*D points read once at 3.35 TB/s.  At
// the paper's shapes (N*K = 5e7, D=8) the FLOP side bounds: about 12 us
// for a whole Lloyd iteration, 1.5 us for one 125k-point partition.
//
// Design: one cooperative launch of a persistent grid (one or two blocks per
// SM, all resident at once; the wrapper's plan, kmeans.py::plan) whose
// phases are split by grid barriers on an integer counter.
//   1. Assign.  The blocks walk the work items (a tile of points and one
//      K-chunk) in grid-stride order.  A tile is P rows of 256 points, or,
//      where the 256-point rows cannot give every SM one, of 32 points for
//      which the 8 warps take 8 sub-chunks of the chunk; a thread takes
//      one point of each row, x in registers (the next item's points load
//      during this one's arithmetic).  P = 2 (at D 4 or 8 with 256-point
//      rows, where the plan finds the work no worse balanced) lets each
//      centroid read from shared memory feed two points.  The chunk's
//      centroids sit in shared memory with |c|^2, loaded (16-byte loads,
//      many in flight) once per block when its items share a chunk, and
//      are read as 16-byte broadcasts.  Four centroids per step give 4*P
//      independent FMA chains, and a running (min d2, argmin) with a
//      strict '<' in increasing k keeps the first index on ties; the
//      sub-chunks merge in increasing k.  fp32 throughout.
//   2. Block partials (mode 0: K*(D+1) fits a block's shared memory beside
//      the centroids; the paper's scenarios i and ii).  K is never split.
//      As it walks, each block adds its points into (K, D+1) partials in
//      shared memory: the points of a warp that chose one centroid add in
//      lane order, one round per rank among them, each warp into its own
//      partial, merged in warp order at the end.  After one grid barrier
//      each block sums a slice of the outputs over the blocks' partials in
//      block order (in up to 16 contiguous ranges of blocks, the ranges'
//      sums added in order).
//   3. By points (mode 1: large K, the paper's scenario iii).  K is split
//      into chunks that fit shared memory, and into more when the points
//      alone cannot give every SM an item; each item writes its points'
//      (min, argmin) over its chunk.  Barrier; each point's chunks merge in
//      increasing chunk order (the first index wins again) into idx.
//      Barrier; block b owns centroids [b*kr, (b+1)*kr), scans every
//      point's idx and adds the points that chose one of its centroids
//      into per-warp partials in point order (warps merged in order): its
//      sums and counts are final, with no reduction across blocks.  The
//      work then grows with N per block but not with K*(D+1) per block.
// The SSE: per-thread running sums, a butterfly in each warp, the warps in
// order, the blocks in order.  No floating-point atomics, so sums, counts
// and sse are reproducible bit for bit from run to run on one card.  The
// ragged tail of N is masked, never padded.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/kmeans/kmeans.py).  Nothing here
// allocates or synchronises: the caller passes the workspace
// (kmeans_assign_workspace_floats) and two zeroed counters that no launch
// in flight on another stream shares; the launch leaves them at zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <atomic>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemFloats = 56 * 1024;     // dynamic shared memory, at most
constexpr int kFixedFloats = 8 * kThreads + kWarps;   // merge buffers, sums
constexpr unsigned kFull = 0xffffffffu;
// a grid barrier that waits longer than this traps instead of hanging
constexpr unsigned long long kBarrierNs = 2000000000ull;

struct Args {
  int n, k, d;
  int mode;      // 0: block partials; 1: by points
  int sub;       // sub-chunks per tile: 1, or kWarps (rows of 32 points)
  int nkc;       // K-chunks (mode 0: 1)
  int kchunk;    // centroids per chunk
  int rows;      // points per thread in the assign phase: 1, or 2 (D 4, 8)
  int rstep;     // mode 1: centroids per pass of the final scan
  float* ws;     // workspace
  unsigned* ctr; // two counters: arrivals, departures
  float* sums;
  float* counts;
  float* sse;
};

__host__ __device__ inline long long vals_len(int k, int d) {
  return (long long)k * (d + 1) + 1;   // (K, D+1) sums and counts, the SSE
}

// floats of dynamic shared memory
__host__ __device__ inline long long smem_floats(const Args& a) {
  const long long p1 = (long long)a.kchunk * (a.d + 1) + kFixedFloats;
  if (a.mode == 0)
    return p1 + (a.sub == 1 ? kWarps : 1) * vals_len(a.k, a.d);
  const long long p3 = (long long)kWarps * a.rstep * (a.d + 1);
  return p1 > p3 ? p1 : p3;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (x2 - 2*dot) + c2 with ref.py's two roundings: 2*dot is exact, so the
// fma rounds x2 - 2*dot once, as the subtraction would
__device__ __forceinline__ float dist2(float x2, float dot, float c2) {
  return __fadd_rn(__fmaf_rn(-2.0f, dot, x2), c2);
}

__device__ __forceinline__ float warp_sum(float s) {   // a fixed butterfly
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every block arrives, then waits until `target` arrivals are counted: the
// writes of every block before the barrier are visible after it (read them
// with __ldcg).  All blocks are resident (a cooperative launch), so no
// block waits for one that cannot start.
__device__ void grid_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    const unsigned long long t0 = global_ns();
    while (ld_acquire(ctr) < target) {
      if (global_ns() - t0 > kBarrierNs) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
}

// After the last barrier: the last block out sets both counters back to 0
// (every block has stopped reading them when it counts its departure).
__device__ __forceinline__ void grid_leave(unsigned* ctr) {
  if (threadIdx.x == 0 && atomicAdd(ctr + 1, 1u) == gridDim.x - 1) {
    ctr[0] = 0u;
    ctr[1] = 0u;
  }
}

// the point's coordinates, converted to fp32 (zeros when not live)
template <typename T, int DT>
__device__ __forceinline__ void load_x(const T* __restrict__ x, int p,
                                       bool live, float (&v)[DT]) {
  const T* xp = x + (size_t)(live ? p : 0) * DT;
#pragma unroll
  for (int j = 0; j < DT; ++j) v[j] = live ? to_f32(__ldg(xp + j)) : 0.f;
}

// (min d2, argmin) of each of the thread's P points over centroids
// kbase..kbase+tk-1, which sit in cs (tk x d) with their squared norms in
// c2s.  DT > 0: D == DT, x in registers; DT == 0: any D (P == 1), x re-read
// from global memory (L1-resident).
template <typename T, int DT, int P>
__device__ __forceinline__ void scan_tile(
    const float (&xr)[P][DT > 0 ? DT : 1], const T* xp, int d,
    const float (&x2)[P], const float* cs, const float* c2s, int tk,
    int kbase, float (&best)[P], int (&best_k)[P]) {
  int kk = 0;
  if constexpr (DT > 0) {
    // the rows as 16-byte broadcast loads (cs is 16-byte aligned, DT a
    // multiple of 4), four centroids a step: 4*P independent FMA chains
    for (; kk + 4 <= tk; kk += 4) {
      const float4* cr = reinterpret_cast<const float4*>(cs + kk * DT);
      float t[P][4];
#pragma unroll
      for (int u = 0; u < P; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) t[u][i] = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < DT / 4; ++j4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cr[i * (DT / 4) + j4];
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const float a0 = xr[u][4 * j4], a1 = xr[u][4 * j4 + 1];
          const float a2 = xr[u][4 * j4 + 2], a3 = xr[u][4 * j4 + 3];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float acc = fmaf(a0, cv[i].x, t[u][i]);
            acc = fmaf(a1, cv[i].y, acc);
            acc = fmaf(a2, cv[i].z, acc);
            t[u][i] = fmaf(a3, cv[i].w, acc);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < P; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = dist2(x2[u], t[u][i], c2s[kk + i]);
          if (e < best[u]) { best[u] = e; best_k[u] = kbase + kk + i; }
        }
    }
  }
  for (; kk < tk; ++kk) {
    const float* cr = cs + kk * d;
#pragma unroll
    for (int u = 0; u < P; ++u) {
      float dot = 0.f;
      if constexpr (DT > 0) {
#pragma unroll
        for (int j = 0; j < DT; ++j) dot = fmaf(xr[u][j], cr[j], dot);
      } else {
        for (int j = 0; j < d; ++j) dot = fmaf(to_f32(xp[j]), cr[j], dot);
      }
      const float e = dist2(x2[u], dot, c2s[kk]);
      if (e < best[u]) { best[u] = e; best_k[u] = kbase + kk; }
    }
  }
}

// 16 bytes of centroids (4 fp32 or 8 bf16) as fp32 into dst
__device__ __forceinline__ void put16(float* dst, uint4 v, const float*) {
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void put16(float* dst, uint4 v,
                                      const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 e = __bfloat1622float2(h[2]), f = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(e.x, e.y, f.x, f.y);
}

// centroids k0..k0+tk-1 into cs, their squared norms into c2s.  16-byte
// loads, eight in flight per thread, where the chunk is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ c, int k0,
                                          int tk, int d, float* cs,
                                          float* c2s) {
  constexpr int E = 16 / sizeof(T);              // elements per 16 bytes
  constexpr int U = 8;
  const T* src = c + (size_t)k0 * d;
  const int total = tk * d;
  int done = 0;
  if (reinterpret_cast<size_t>(src) % 16 == 0) {
    const int nv = total / E;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int base = threadIdx.x; base < nv; base += U * kThreads) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * kThreads < nv) v[u] = __ldg(s4 + base + u * kThreads);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * kThreads < nv)
          put16(cs + (size_t)(base + u * kThreads) * E, v[u], c);
    }
    done = nv * E;
  }
  for (int i = done + threadIdx.x; i < total; i += kThreads)
    cs[i] = to_f32(src[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < tk; i += kThreads) {
    float s = 0.f;
    for (int j = 0; j < d; ++j)
      s = __fadd_rn(s, __fmul_rn(cs[i * d + j], cs[i * d + j]));
    c2s[i] = s;
  }
  __syncthreads();
}

// The warp's points that chose centroid lk (>= 0; -1: none) add into
// part[lk] in lane order, one round per rank among the lanes of a centroid.
template <typename T, int DT>
__device__ __forceinline__ void add_rounds(int lk,
                                           const float (&xv)[DT > 0 ? DT : 1],
                                           const T* xp, int d, float* part,
                                           int lane) {
  const unsigned grp = __match_any_sync(kFull, lk);
  const int rk = __popc(grp & ((1u << lane) - 1u));
  for (int r = 0; __any_sync(kFull, lk >= 0 && rk == r); ++r) {
    if (lk >= 0 && rk == r) {
      float* dst = part + (size_t)lk * (d + 1);
      if constexpr (DT > 0) {
#pragma unroll
        for (int j = 0; j < DT; ++j) dst[j] += xv[j];
      } else {
        for (int j = 0; j < d; ++j) dst[j] += to_f32(xp[j]);
      }
      dst[d] += 1.f;
    }
    __syncwarp();
  }
}

// output o of the (K, D+1) sums-and-counts layout, the SSE last
__device__ __forceinline__ void put_output(const Args& a, long long o,
                                           float v) {
  if (o == vals_len(a.k, a.d) - 1) {
    *a.sse = v;
    return;
  }
  const int kc = (int)(o / (a.d + 1));
  const int j = (int)(o - (long long)kc * (a.d + 1));
  if (j < a.d)
    a.sums[(size_t)kc * a.d + j] = v;
  else
    a.counts[kc] = v;
}

template <typename T, int DT, int P>
__global__ void __launch_bounds__(kThreads, 2)
kmeans_fused_kernel(const T* __restrict__ x, const T* __restrict__ c,
                    Args a) {
  extern __shared__ __align__(16) float smem[];
  const int G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n, k = a.k, d = a.d, sub = a.sub, nkc = a.nkc;
  const int kchunk = a.kchunk;
  constexpr int DX = DT > 0 ? DT : 1;
  const int tp = kThreads / sub;                 // points per row of a tile
  const int pl = tid % tp, si = tid / tp;        // point, sub-chunk
  const bool lead = si == 0;                     // holds the merged result
  const int acting = tp / 32;                    // warps of leads
  const int items = (n + P * tp - 1) / (P * tp) * nkc;
  const long long vlen = vals_len(k, d);

  float* cs = smem;                              // kchunk * d
  float* c2s = cs + (size_t)kchunk * d;          // kchunk
  float* sb = c2s + kchunk;                      // 2 * P * kThreads
  int* sidx = reinterpret_cast<int*>(sb + 2 * P * kThreads);  // the same
  float* wsum = reinterpret_cast<float*>(sidx + 2 * P * kThreads);  // kWarps
  float* parts = wsum + kWarps;                  // mode 0 partials
  const int nparts = sub == 1 ? kWarps : 1;
  float* wpart = parts + (sub == 1 ? (size_t)warp * vlen : 0);
  float* bd = a.ws;                              // mode 1: (nkc, n) mins
  int* bk = reinterpret_cast<int*>(bd + (size_t)nkc * n);     // argmins
  int* idx = bk + (size_t)nkc * n;               // (n,) merged
  float* ssep = reinterpret_cast<float*>(idx + n);            // (G,)

  if (a.mode == 0)
    for (long long i = tid; i < nparts * vlen; i += kThreads) parts[i] = 0.f;

  // -- 1. assign -------------------------------------------------------
  // item it: chunk it % nkc of the tile it / nkc, whose P rows of tp
  // points are this thread's points u*tp + pl
  auto point_of = [&](int it, int u) {
    return it / nkc * P * tp + u * tp + pl;
  };
  float xr[P][DX], xn[P][DX];
  if constexpr (DT > 0) {
    if (b < items)
#pragma unroll
      for (int u = 0; u < P; ++u)
        load_x<T, DT>(x, point_of(b, u), point_of(b, u) < n, xr[u]);
  }
  float sse_t = 0.f;
  int loaded = -1, par = 0;
  for (int it = b; it < items; it += G, par ^= 1) {
    const int ch = it % nkc;
    const int k0 = ch * kchunk, kend = min(k, k0 + kchunk), kn = kend - k0;
    if (ch != loaded) {
      __syncthreads();                           // the old chunk is read
      load_tile(c, k0, kn, d, cs, c2s);
      loaded = ch;
    }
    bool live[P];
#pragma unroll
    for (int u = 0; u < P; ++u) live[u] = point_of(it, u) < n;
    const T* xp = x + (size_t)(live[0] ? point_of(it, 0) : 0) * d;
    float x2[P];
#pragma unroll
    for (int u = 0; u < P; ++u) x2[u] = 0.f;
    if constexpr (DT > 0) {
      if (it + G < items)                        // in flight meanwhile
#pragma unroll
        for (int u = 0; u < P; ++u)
          load_x<T, DT>(x, point_of(it + G, u), point_of(it + G, u) < n,
                        xn[u]);
#pragma unroll
      for (int u = 0; u < P; ++u)
#pragma unroll
        for (int j = 0; j < DT; ++j)
          x2[u] = __fadd_rn(x2[u], __fmul_rn(xr[u][j], xr[u][j]));
    } else if (live[0]) {
      for (int j = 0; j < d; ++j) {
        const float vj = to_f32(xp[j]);
        x2[0] = __fadd_rn(x2[0], __fmul_rn(vj, vj));
      }
    }
    const int ssub = (kn + sub - 1) / sub;
    const int ks0 = min(kend, k0 + si * ssub), ks1 = min(kend, ks0 + ssub);
    float mb[P];
    int mi[P];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      mb[u] = CUDART_INF_F;
      mi[u] = ks0;
    }
    if (live[0] && ks1 > ks0)
      scan_tile<T, DT, P>(xr, xp, d, x2, cs + (size_t)(ks0 - k0) * d,
                          c2s + (ks0 - k0), ks1 - ks0, ks0, mb, mi);
#pragma unroll
    for (int u = 0; u < P; ++u)
      if (!(live[u] && ks1 > ks0)) mi[u] = -1;
    if (sub > 1) {    // the sub-chunks in increasing k (buffers alternate)
      float* sbp = sb + par * P * kThreads;
      int* sip = sidx + par * P * kThreads;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        sbp[u * kThreads + tid] = mb[u];
        sip[u * kThreads + tid] = mi[u];
      }
      __syncthreads();
      if (lead) {
#pragma unroll
        for (int u = 0; u < P; ++u) {
          mb[u] = CUDART_INF_F;
          mi[u] = -1;
          for (int s2 = 0; s2 < sub; ++s2) {
            const float e = sbp[u * kThreads + s2 * tp + pl];
            const int ek = sip[u * kThreads + s2 * tp + pl];
            if (ek >= 0 && (e < mb[u] || mi[u] < 0)) {
              mb[u] = e;
              mi[u] = ek;
            }
          }
        }
      }
    }
    if (a.mode == 0) {
      if (warp < acting) {                       // warp-uniform
#pragma unroll
        for (int u = 0; u < P; ++u) {
          add_rounds<T, DT>(mi[u], xr[u], xp, d, wpart, lane);
          if (mi[u] >= 0) sse_t += mb[u];
        }
      }
    } else if (lead) {
#pragma unroll
      for (int u = 0; u < P; ++u)
        if (live[u]) {
          bd[(size_t)ch * n + point_of(it, u)] = mb[u];
          bk[(size_t)ch * n + point_of(it, u)] = mi[u];
        }
    }
    if constexpr (DT > 0) {
#pragma unroll
      for (int u = 0; u < P; ++u)
#pragma unroll
        for (int j = 0; j < DT; ++j) xr[u][j] = xn[u][j];
    }
  }

  if (a.mode == 0) {
    // -- 2. the block's partial, then a slice of the outputs -------------
    const float s = warp_sum(sse_t);
    if (lane == 0) wsum[warp] = s;
    __syncthreads();
    float* P = a.ws + (size_t)b * vlen;
    for (long long e = tid; e < vlen - 1; e += kThreads) {
      float v = 0.f;
      for (int w = 0; w < nparts; ++w) v += parts[w * vlen + e];
      P[e] = v;
    }
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < acting; ++w) t += wsum[w];
      P[vlen - 1] = t;
    }
    grid_barrier(a.ctr, G);
    grid_leave(a.ctr);
    float* red = smem;                           // free now
    const long long E = (vlen + G - 1) / G;
    const long long e0 = b * E;
    const int ne = (int)max(0ll, min(E, vlen - e0));
    for (int eb = 0; eb < ne; eb += kThreads) {
      const int m = min(kThreads, ne - eb);
      const int R = min(min(G, kThreads / m), 16);
      const int rg = (G + R - 1) / R;
      const int q = tid / m, e = tid % m;
      if (q < R) {
        const float* col = a.ws + e0 + eb + e;
        const int lo = min(G, q * rg), hi = min(G, lo + rg);
        float v = 0.f;
        for (int b0 = lo; b0 < hi; b0 += 32) {   // 32 loads in flight
          float t[32];
#pragma unroll
          for (int u = 0; u < 32; ++u)
            t[u] = b0 + u < hi ? __ldcg(col + (size_t)(b0 + u) * vlen) : 0.f;
#pragma unroll
          for (int u = 0; u < 32; ++u)
            if (b0 + u < hi) v += t[u];
        }
        red[q * m + e] = v;
      }
      __syncthreads();
      if (tid < m) {
        float tot = 0.f;
        for (int q2 = 0; q2 < R; ++q2) tot += red[q2 * m + tid];
        put_output(a, e0 + eb + tid, tot);
      }
      __syncthreads();
    }
    return;
  }

  // -- 3. by points: each point's chunks merged, then a block's centroids -
  grid_barrier(a.ctr, G);
  float s = 0.f;
  for (int p = b * kThreads + tid; p < n; p += G * kThreads) {
    float mb = CUDART_INF_F;
    int mi = -1;
    for (int ch = 0; ch < nkc; ++ch) {
      const float e = __ldcg(bd + (size_t)ch * n + p);
      const int ek = __ldcg(bk + (size_t)ch * n + p);
      if (ek >= 0 && (e < mb || mi < 0)) {
        mb = e;
        mi = ek;
      }
    }
    idx[p] = mi;
    s += mb;
  }
  s = warp_sum(s);
  if (lane == 0) wsum[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += wsum[w];
    ssep[b] = t;
  }
  grid_barrier(a.ctr, 2u * G);
  grid_leave(a.ctr);
  if (b == 0 && warp == 0) {   // the SSE: lanes over blocks, then a tree
    float v = 0.f;
    for (int bb = lane; bb < G; bb += 32) v += __ldcg(ssep + bb);
    v = warp_sum(v);
    if (lane == 0) *a.sse = v;
  }
  constexpr int U = DT == 0 ? 1 : DT <= 8 ? 4 : DT <= 16 ? 2 : 1;
  const int kr = (k + G - 1) / G;
  const int lo = min(k, b * kr), hi = min(k, lo + kr);
  for (int r0 = lo; r0 < hi; r0 += a.rstep) {
    const int r1 = min(hi, r0 + a.rstep), w = (r1 - r0) * (d + 1);
    for (int i = tid; i < kWarps * w; i += kThreads) smem[i] = 0.f;
    __syncthreads();
    float* wp = smem + (size_t)warp * w;
    // warp `warp` takes the 32-point groups warp, warp+8, ... in order
    for (int base = warp * 32; base < n; base += kThreads * U) {
      int lk[U];
      float xv[U][DT > 0 ? DT : 1];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = base + u * kThreads + lane;
        const int id = p < n ? __ldcg(idx + p) : -1;
        lk[u] = id >= r0 && id < r1 ? id - r0 : -1;
      }
      if constexpr (DT > 0) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          load_x<T, DT>(x, base + u * kThreads + lane, lk[u] >= 0, xv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = base + u * kThreads + lane;
        add_rounds<T, DT>(lk[u], xv[u], x + (size_t)(p < n ? p : 0) * d, d,
                          wp, lane);
      }
    }
    __syncthreads();
    for (int i = tid; i < w; i += kThreads) {
      float v = 0.f;
      for (int w2 = 0; w2 < kWarps; ++w2) v += smem[w2 * w + i];
      put_output(a, (long long)r0 * (d + 1) + i, v);
    }
    __syncthreads();
  }
}

template <typename T, int DT, int P>
int launch_dt(const void* xv, const void* cv, const Args& a, int grid,
              cudaStream_t stream) {
  auto kern = kmeans_fused_kernel<T, DT, P>;
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(allowed.load() & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(float) * kSmemFloats);
    if (e != cudaSuccess) return (int)e;
    allowed.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(float) * (size_t)smem_floats(a);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;   // all blocks resident
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(xv),
                         static_cast<const T*>(cv), a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_all(const void* x, const void* c, const Args& a, int grid,
               cudaStream_t stream) {
  switch (a.d) {
    case 4:
      return a.rows == 2 ? launch_dt<T, 4, 2>(x, c, a, grid, stream)
                         : launch_dt<T, 4, 1>(x, c, a, grid, stream);
    case 8:
      return a.rows == 2 ? launch_dt<T, 8, 2>(x, c, a, grid, stream)
                         : launch_dt<T, 8, 1>(x, c, a, grid, stream);
    case 16: return launch_dt<T, 16, 1>(x, c, a, grid, stream);
    case 32: return launch_dt<T, 32, 1>(x, c, a, grid, stream);
    default: return launch_dt<T, 0, 1>(x, c, a, grid, stream);
  }
}

}  // namespace

extern "C" {

// Floats of the workspace: mode 0, one partial of k*(d+1)+1 floats per
// block; mode 1, the chunks' (min, argmin) per point, the merged argmins
// and one SSE per block.
long long kmeans_assign_workspace_floats(int n, int k, int d, int mode,
                                         int nkc, int grid) {
  if (mode == 0) return (long long)grid * vals_len(k, d);
  return 2ll * nkc * n + n + grid;
}

// points/centroids: contiguous (n,d)/(k,d) of one dtype (is_bf16 picks
// bf16, else fp32); the plan (kmeans.py::plan): mode, sub, rows, nkc
// K-chunks of kchunk centroids, rstep, grid blocks; workspace of
// kmeans_assign_workspace_floats floats; counter: two unsigned ints, 0 on
// entry and 0 again on exit; sums (k,d), counts (k,), sse () fp32.
// Returns the launch's CUDA error.
int kmeans_assign_launch(const void* points, const void* centroids, int n,
                         int k, int d, int is_bf16, int mode, int sub,
                         int rows, int nkc, int kchunk, int rstep, int grid,
                         void* workspace, void* counter, void* sums,
                         void* counts, void* sse, void* stream) {
  Args a;
  a.n = n;
  a.k = k;
  a.d = d;
  a.mode = mode;
  a.sub = sub;
  a.nkc = nkc;
  a.kchunk = kchunk;
  a.rows = rows;
  a.rstep = rstep;
  a.ws = static_cast<float*>(workspace);
  a.ctr = static_cast<unsigned*>(counter);
  a.sums = static_cast<float*>(sums);
  a.counts = static_cast<float*>(counts);
  a.sse = static_cast<float*>(sse);
  if (n < 0 || k < 1 || d < 1 || (mode != 0 && mode != 1) ||
      (sub != 1 && sub != kWarps) || (rows != 1 && rows != 2) ||
      (rows == 2 && d != 4 && d != 8) || nkc < 1 || kchunk < 1 ||
      (long long)(nkc - 1) * kchunk >= k || (long long)nkc * kchunk < k ||
      (mode == 0 && nkc != 1) || (mode == 1 && rstep < 1) || grid < 1 ||
      grid > 65535 ||
      ((long long)n + kThreads / sub - 1) / (kThreads / sub) * nkc >
          0x7fffffffll ||
      smem_floats(a) > kSmemFloats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_all<__nv_bfloat16>(points, centroids, a, grid, s);
  return launch_all<float>(points, centroids, a, grid, s);
}

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
