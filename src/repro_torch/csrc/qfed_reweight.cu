// Fused q-FedAvg reweighting for Hopper (sm_90a), written by hand in CUDA
// C++.
//
// Replaces: repro/kernels/qfed_reweight/qfed_reweight.py::
// qfed_reweight_call, the Pallas TPU kernel (its body is _kernel,
// qfed_reweight.py:26).
//
// q-FedAvg (Li et al., ICLR 2019) turns client k's pseudo-gradient dw_k
// into delta_k = F_k^q dw_k and needs ||dw_k||^2 for its h_k. With dw
// viewed as (C, D) rows (D = P * F) and fq = F^q (C,):
//
//   delta[c,i] = dw[c,i] * fq[c]          (one rounding: bitwise the plain
//                                          version)
//   ssq[c]     = sum over i of dw[c,i]^2  (fp32)
//
// The whole call is this one launch: the norms are reduced here, where
// the TPU kernel writes per-block partials for a sum outside it. ops.py
// forms fq and h_k.
//
// What bounds it: bytes. It reads dw once and writes delta once, 8 B per
// coordinate: at the reference's bench shape (C = 16, P = 1024, F = 256)
// 33.6 MB, or 10 us at 3.35 TB/s; at the host loop's (C = 10, P = 36)
// 0.74 MB, far below a launch. Three operations per coordinate.
//
// Design. Each client's row is split over a thread-block cluster of K
// CTAs (K in {1, 2, 4, 8}, the binding's plan, from D alone: 1 where one
// CTA takes the row in one step, as at the host loop's D = 9,216), clients
// on grid.x (C * K CTAs, no limit of 65,535). A CTA streams its contiguous
// part of the row in 16-byte units where D % 4 == 0 and both rows are
// aligned (else a float at a time), each thread issuing its kUnroll loads
// before the first multiply, with 32-bit indices within a row (a part
// longer than 2^30 units is walked in segments). Each thread keeps a
// private fp32 sum of squares; the CTA sums them in a fixed order
// (shuffles within a warp, then warp 0 over the warps), and the CTAs of a
// cluster store their sums into rank 0's shared memory (distributed
// shared memory), which adds them in rank order after a cluster barrier
// and writes ssq[c]. No scratch, no counters, no float atomics: two calls
// on the same inputs give the same bits. The order depends on D, the
// unit width and the plan, not on C, so a vmap over scenarios, folded
// into the clients (C -> S * C), gives each row the bits of its single
// call: one launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnroll = 4;                // units a thread has in flight
constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr long long kSegment = 1LL << 30; // units a 32-bit walk covers

__device__ __forceinline__ float4 scale(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}
__device__ __forceinline__ float scale(float v, float s) { return v * s; }

__device__ __forceinline__ float add_squares(float4 v, float acc) {
  acc += v.x * v.x;
  acc += v.y * v.y;
  acc += v.z * v.z;
  return acc + v.w * v.w;
}
__device__ __forceinline__ float add_squares(float v, float acc) {
  return acc + v * v;
}

// The cluster barrier in two halves: a relaxed arrive at the start, so
// that the wait before the first store into another CTA's shared memory
// (which needs every CTA of the cluster to have started) costs nothing.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Sum of v over the CTA in a fixed order: shuffles within each warp, then
// warp 0 over the warp partials. The result is valid in thread 0.
// blockDim.x must be a multiple of 32 and at most 1024.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < n_warps ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// delta = in * s over n units, with each thread's kUnroll loads issued
// before its first multiply; returns acc plus the thread's squares.
template <typename Unit>
__device__ __forceinline__ float stream_part(const Unit* __restrict__ in,
                                             Unit* __restrict__ out, int n,
                                             float s, float acc) {
  const int step = blockDim.x;
  for (int base = threadIdx.x; base < n; base += kUnroll * step) {
    Unit v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u * step < n) v[u] = in[base + u * step];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * step < n) {
        out[base + u * step] = scale(v[u], s);
        acc = add_squares(v[u], acc);
      }
    }
  }
  return acc;
}

template <typename Unit>
__global__ void __launch_bounds__(1024)
    qfed_reweight_kernel(const float* __restrict__ dw,
                         const float* __restrict__ fq,
                         float* __restrict__ delta, float* __restrict__ ssq,
                         long long D, int K) {
  __shared__ float red[32];
  __shared__ float parts[kMaxCluster];
  if (K > 1) cluster_arrive_relaxed();
  const int rank = K > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int shift = __ffs(K) - 1;          // K is a power of two: no
  const size_t c = blockIdx.x >> shift;    // division before the loads
  constexpr int W = sizeof(Unit) / sizeof(float);
  const long long n = D / W;
  const long long lo = (n * rank) >> shift;
  const long long len = ((n * (rank + 1)) >> shift) - lo;
  const Unit* in = reinterpret_cast<const Unit*>(dw + c * D) + lo;
  Unit* out = reinterpret_cast<Unit*>(delta + c * D) + lo;
  const float s = fq[c];
  float acc = 0.f;
  for (long long a = 0; a < len; a += kSegment)
    acc = stream_part<Unit>(in + a, out + a, (int)min(kSegment, len - a), s,
                            acc);
  acc = block_sum(acc, red);
  if (K == 1) {
    if (threadIdx.x == 0) ssq[c] = acc;
    return;
  }
  cluster_wait();
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *cluster.map_shared_rank(parts + rank, 0) = acc;
  cluster.sync();  // the stores land before rank 0 reads them
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.f;
    for (int r = 0; r < K; ++r) total += parts[r];
    ssq[c] = total;
  }
}

}  // namespace

extern "C" {

// Launches the reweighting on `stream` with the binding's plan: C * K
// CTAs of `threads` threads, clusters of K = `cluster` CTAs a client,
// 16-byte units when `vec` (D % 4 == 0, dw and delta 16-byte aligned).
// Writes delta (C, D) and ssq (C,); D may be 0 (ssq = 0). Returns the
// first CUDA error, or cudaGetLastError() after the launch.
int qfed_reweight_launch(const void* dw, const void* fq, void* delta,
                         void* ssq, int C, long long D, int vec, int cluster,
                         int threads, int device, void* stream) {
  if (C < 1 || D < 0 || (vec && D % 4) || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) || threads < 32 ||
      threads > 1024 || threads % 32 ||
      (long long)C * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const float* x = static_cast<const float*>(dw);
  const float* f = static_cast<const float*>(fq);
  float* d = static_cast<float*>(delta);
  float* out = static_cast<float*>(ssq);
  err = vec ? cudaLaunchKernelEx(&cfg, qfed_reweight_kernel<float4>, x, f,
                                 d, out, D, cluster)
            : cudaLaunchKernelEx(&cfg, qfed_reweight_kernel<float>, x, f, d,
                                 out, D, cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* qfed_reweight_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
