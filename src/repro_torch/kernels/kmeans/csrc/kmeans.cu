// Fused KMeans assignment + partial centroid sums for Hopper (sm_90a).
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
// Design (simple and right first; three launches on the caller's stream):
//   1. assign_kernel, grid (point blocks, K-chunks): one thread per point,
//      x kept in registers.  The block's K-chunk of centroids streams
//      through shared memory in tiles with |c|^2 precomputed per tile, so
//      any K fits (the paper's scenario iii has K=5000, past the Pallas
//      kernel's K<=4096).  Four centroids per step give four independent
//      FMA chains.  A running (min d2, argmin) with a strict '<' in
//      increasing k keeps the first index on ties, as torch.argmin does.
//      When N is too small to fill the card, K is split into chunks so
//      that about two blocks per SM run; each chunk writes its own
//      (min, argmin) per point.  The ragged tail of N is masked, never
//      padded.
//   2. accumulate_kernel, grid (segments of kSeg points, cluster tiles,
//      dim chunks), kSeg threads: thread i merges point i's chunk results
//      in increasing chunk order (again first index on ties) and stages
//      its argmin and coordinates in shared memory (one round of loads);
//      then each thread owns one cluster, scans the segment in point
//      order and sums the points that chose it.  A per-segment partial
//      with no atomics; the segment's SSE is a fixed-order tree.
//   3. finalize_kernel: 32 outputs per block, lane = output (coalesced
//      reads); warp w sums segments w, w+32, ... and warp 0 adds the 32
//      warp sums in order.
// No atomics anywhere, so sums, counts and sse are reproducible bit for
// bit from run to run on one card.
//
// Built by nvcc into a shared library with a plain C interface and bound
// with ctypes (repro_torch/kernels/kmeans/kmeans.py).  Nothing here
// allocates or synchronises: the caller passes a workspace of
// kmeans_assign_workspace_bytes(n, k, d) bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace {

constexpr int kAssignThreads = 256;
constexpr int kSeg = 256;   // points = threads = clusters per accumulate block
constexpr int kDimChunk = 8;               // dims per accumulate block
constexpr int kFinalizeWarps = 32;
constexpr int kTileFloats = 11 * 1024;     // dynamic smem: K-tile + |c|^2
constexpr int kTargetBlocks = 264;         // ~2 assign blocks per SM
constexpr int kMinChunk = 64;              // centroids per K-chunk, at least
constexpr size_t kAlign = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float dist2(float x2, float dot, float c2) {
  return __fadd_rn(__fsub_rn(x2, 2.0f * dot), c2);
}

// DT > 0: D == DT, x held in registers.  DT == 0: any D, x re-read from
// global memory (L1-resident) for every centroid.
template <typename T, int DT>
__global__ void __launch_bounds__(kAssignThreads)
assign_kernel(const T* __restrict__ x, const T* __restrict__ c, int n, int k,
              int d, int kchunk, int tile_k, float* __restrict__ best_out,
              int* __restrict__ idx_out) {
  extern __shared__ float smem[];
  float* cs = smem;                        // tile_k * d centroid coordinates
  float* c2s = smem + (size_t)tile_k * d;  // tile_k squared norms

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < n;
  const T* xp = x + (size_t)(live ? p : 0) * d;
  const int kb = blockIdx.y * kchunk;
  const int ke = min(k, kb + kchunk);

  float xr[DT > 0 ? DT : 1];
  float x2 = 0.f;
  if constexpr (DT > 0) {
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      xr[j] = live ? to_f32(xp[j]) : 0.f;
      x2 = __fadd_rn(x2, __fmul_rn(xr[j], xr[j]));
    }
  } else if (live) {
    for (int j = 0; j < d; ++j) {
      const float v = to_f32(xp[j]);
      x2 = __fadd_rn(x2, __fmul_rn(v, v));
    }
  }

  float best = CUDART_INF_F;
  int best_k = kb;
  for (int k0 = kb; k0 < ke; k0 += tile_k) {
    const int tk = min(tile_k, ke - k0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < tk * d; i += blockDim.x)
      cs[i] = to_f32(c[(size_t)k0 * d + i]);
    __syncthreads();
    for (int i = threadIdx.x; i < tk; i += blockDim.x) {
      float s = 0.f;
      for (int j = 0; j < d; ++j)
        s = __fadd_rn(s, __fmul_rn(cs[i * d + j], cs[i * d + j]));
      c2s[i] = s;
    }
    __syncthreads();
    if (!live) continue;
    int kk = 0;
    if constexpr (DT > 0) {
      for (; kk + 4 <= tk; kk += 4) {
        const float* cr = cs + kk * DT;
        float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          t0 = fmaf(xr[j], cr[j], t0);
          t1 = fmaf(xr[j], cr[DT + j], t1);
          t2 = fmaf(xr[j], cr[2 * DT + j], t2);
          t3 = fmaf(xr[j], cr[3 * DT + j], t3);
        }
        const float e0 = dist2(x2, t0, c2s[kk]);
        const float e1 = dist2(x2, t1, c2s[kk + 1]);
        const float e2 = dist2(x2, t2, c2s[kk + 2]);
        const float e3 = dist2(x2, t3, c2s[kk + 3]);
        if (e0 < best) { best = e0; best_k = k0 + kk; }
        if (e1 < best) { best = e1; best_k = k0 + kk + 1; }
        if (e2 < best) { best = e2; best_k = k0 + kk + 2; }
        if (e3 < best) { best = e3; best_k = k0 + kk + 3; }
      }
    }
    for (; kk < tk; ++kk) {
      const float* cr = cs + kk * d;
      float dot = 0.f;
      if constexpr (DT > 0) {
#pragma unroll
        for (int j = 0; j < DT; ++j) dot = fmaf(xr[j], cr[j], dot);
      } else {
        for (int j = 0; j < d; ++j) dot = fmaf(to_f32(xp[j]), cr[j], dot);
      }
      const float e = dist2(x2, dot, c2s[kk]);
      if (e < best) { best = e; best_k = k0 + kk; }
    }
  }
  if (live) {
    best_out[(size_t)blockIdx.y * n + p] = best;
    idx_out[(size_t)blockIdx.y * n + p] = best_k;
  }
}

// part[s][kc*(d+1) + j] = sum over the segment's points assigned to kc of
// x[., j]; part[s][kc*(d+1) + d] = their count; part[s][k*(d+1)] = the
// segment's SSE.
template <typename T>
__global__ void accumulate_kernel(const T* __restrict__ x,
                                  const float* __restrict__ best_part,
                                  const int* __restrict__ idx_part, int nkc,
                                  int n, int k, int d,
                                  float* __restrict__ part) {
  __shared__ int sidx[kSeg];
  __shared__ float sbest[kSeg];
  __shared__ float sx[kSeg * kDimChunk];
  const int s = blockIdx.x;
  const int p0 = s * kSeg;
  const int np = min(kSeg, n - p0);
  const int j0 = blockIdx.z * kDimChunk;
  const int dj = min(kDimChunk, d - j0);
  const size_t nout1 = (size_t)k * (d + 1) + 1;

  // blockDim.x == kSeg: thread i stages point i
  {
    const int i = threadIdx.x;
    float b = 0.f;
    int bi = -1;
    float v[kDimChunk];
#pragma unroll
    for (int j = 0; j < kDimChunk; ++j) v[j] = 0.f;
    if (i < np) {
      const T* xp = x + (size_t)(p0 + i) * d + j0;
#pragma unroll
      for (int j = 0; j < kDimChunk; ++j)
        if (j < dj) v[j] = to_f32(xp[j]);
      b = CUDART_INF_F;
      for (int ch = 0; ch < nkc; ++ch) {  // increasing k: first index wins
        const float e = best_part[(size_t)ch * n + p0 + i];
        if (e < b || bi < 0) {
          b = e;
          bi = idx_part[(size_t)ch * n + p0 + i];
        }
      }
    }
    sidx[i] = bi;
    sbest[i] = b;
#pragma unroll
    for (int j = 0; j < kDimChunk; ++j) sx[i * kDimChunk + j] = v[j];
  }
  __syncthreads();

  if (blockIdx.y == 0 && blockIdx.z == 0) {  // the segment's SSE, a tree
    for (int off = kSeg / 2; off > 0; off >>= 1) {
      if (threadIdx.x < off) sbest[threadIdx.x] += sbest[threadIdx.x + off];
      __syncthreads();
    }
    if (threadIdx.x == 0) part[s * nout1 + nout1 - 1] = sbest[0];
  }

  const int kc = blockIdx.y * blockDim.x + threadIdx.x;
  if (kc >= k) return;
  float acc[kDimChunk];
#pragma unroll
  for (int j = 0; j < kDimChunk; ++j) acc[j] = 0.f;
  int cnt = 0;
#pragma unroll 8
  for (int i = 0; i < np; ++i) {
    if (sidx[i] == kc) {
      ++cnt;
#pragma unroll
      for (int j = 0; j < kDimChunk; ++j) acc[j] += sx[i * kDimChunk + j];
    }
  }
  float* out = part + s * nout1 + (size_t)kc * (d + 1);
#pragma unroll
  for (int j = 0; j < kDimChunk; ++j)
    if (j < dj) out[j0 + j] = acc[j];
  if (blockIdx.z == 0) out[d] = (float)cnt;
}

// Block b owns outputs 32b..32b+31 (lane = output); warp w sums segments
// w, w+32, ..., then warp 0 adds the warp sums in order.
__global__ void __launch_bounds__(kFinalizeWarps * 32)
finalize_kernel(const float* __restrict__ part, int nseg, int k, int d,
                float* __restrict__ sums, float* __restrict__ counts,
                float* __restrict__ sse) {
  __shared__ float red[kFinalizeWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nout1 = (long long)k * (d + 1) + 1;
  const long long o = (long long)blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (o < nout1)
    for (int s = warp; s < nseg; s += kFinalizeWarps)
      acc += part[s * nout1 + o];
  red[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || o >= nout1) return;
  float total = 0.f;
  for (int w = 0; w < kFinalizeWarps; ++w) total += red[w][lane];
  if (o == nout1 - 1) {
    *sse = total;
  } else {
    const int kc = (int)(o / (d + 1)), j = (int)(o % (d + 1));
    if (j < d)
      sums[(size_t)kc * d + j] = total;
    else
      counts[kc] = total;
  }
}

struct Plan {
  int nkc = 1;     // K-chunks of the assign pass
  int kchunk = 0;  // centroids per chunk
  int nseg = 0;    // accumulate segments
};

Plan plan(int n, int k) {
  Plan p;
  p.nseg = (n + kSeg - 1) / kSeg;
  const int nb = (n + kAssignThreads - 1) / kAssignThreads;
  if (nb > 0 && nb < kTargetBlocks)
    p.nkc = max(1, min((kTargetBlocks + nb - 1) / nb,
                       (k + kMinChunk - 1) / kMinChunk));
  p.kchunk = (k + p.nkc - 1) / p.nkc;
  p.nkc = (k + p.kchunk - 1) / p.kchunk;  // no empty chunk
  return p;
}

struct Workspace {
  float* best;  // nkc * n
  int* idx;     // nkc * n
  float* part;  // nseg * (k*(d+1) + 1)
};

size_t align_up(size_t v) { return (v + kAlign - 1) / kAlign * kAlign; }

size_t carve(void* base, int n, int k, int d, const Plan& pl,
             Workspace* ws) {
  char* p = static_cast<char*>(base);
  size_t off = 0;
  if (ws) ws->best = reinterpret_cast<float*>(p + off);
  off += align_up(sizeof(float) * (size_t)pl.nkc * n);
  if (ws) ws->idx = reinterpret_cast<int*>(p + off);
  off += align_up(sizeof(int) * (size_t)pl.nkc * n);
  if (ws) ws->part = reinterpret_cast<float*>(p + off);
  off += align_up(sizeof(float) * (size_t)pl.nseg *
                  ((size_t)k * (d + 1) + 1));
  return off;
}

template <typename T, int DT>
void launch_assign_dt(const T* x, const T* c, int n, int k, int d,
                      const Plan& pl, const Workspace& ws,
                      cudaStream_t stream) {
  const int tile_k = min(pl.kchunk, kTileFloats / (d + 1));
  const size_t smem = sizeof(float) * (size_t)tile_k * (d + 1);
  const dim3 grid((n + kAssignThreads - 1) / kAssignThreads, pl.nkc);
  assign_kernel<T, DT><<<grid, kAssignThreads, smem, stream>>>(
      x, c, n, k, d, pl.kchunk, tile_k, ws.best, ws.idx);
}

template <typename T>
void launch_all(const void* xv, const void* cv, int n, int k, int d,
                const Plan& pl, const Workspace& ws, float* sums,
                float* counts, float* sse, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* c = static_cast<const T*>(cv);
  if (n > 0) {
    switch (d) {
      case 4: launch_assign_dt<T, 4>(x, c, n, k, d, pl, ws, stream); break;
      case 8: launch_assign_dt<T, 8>(x, c, n, k, d, pl, ws, stream); break;
      case 16: launch_assign_dt<T, 16>(x, c, n, k, d, pl, ws, stream); break;
      case 32: launch_assign_dt<T, 32>(x, c, n, k, d, pl, ws, stream); break;
      default: launch_assign_dt<T, 0>(x, c, n, k, d, pl, ws, stream);
    }
    const dim3 grid(pl.nseg, (k + kSeg - 1) / kSeg,
                    (d + kDimChunk - 1) / kDimChunk);
    accumulate_kernel<T><<<grid, kSeg, 0, stream>>>(
        x, ws.best, ws.idx, pl.nkc, n, k, d, ws.part);
  }
  const long long nout1 = (long long)k * (d + 1) + 1;
  finalize_kernel<<<(unsigned)((nout1 + 31) / 32), kFinalizeWarps * 32, 0,
                    stream>>>(ws.part, pl.nseg, k, d, sums, counts, sse);
}

}  // namespace

extern "C" {

// Bytes of scratch the launch needs for these sizes.
size_t kmeans_assign_workspace_bytes(int n, int k, int d) {
  return carve(nullptr, n, k, d, plan(n, k), nullptr);
}

// points/centroids: contiguous (n,d)/(k,d) of one dtype (is_bf16 picks
// bf16, else fp32); sums (k,d), counts (k,), sse () fp32; workspace of
// kmeans_assign_workspace_bytes(n,k,d) bytes.  Returns cudaGetLastError().
int kmeans_assign_launch(const void* points, const void* centroids, int n,
                         int k, int d, int is_bf16, void* workspace,
                         void* sums, void* counts, void* sse, void* stream) {
  const Plan pl = plan(n, k);
  Workspace ws;
  carve(workspace, n, k, d, pl, &ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fs = static_cast<float*>(sums);
  float* fc = static_cast<float*>(counts);
  float* fe = static_cast<float*>(sse);
  if (is_bf16)
    launch_all<__nv_bfloat16>(points, centroids, n, k, d, pl, ws, fs, fc, fe,
                              s);
  else
    launch_all<float>(points, centroids, n, k, d, pl, ws, fs, fc, fe, s);
  return static_cast<int>(cudaGetLastError());
}

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
