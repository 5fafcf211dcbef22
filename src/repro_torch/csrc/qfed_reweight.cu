// Fused q-FedAvg reweighting for Hopper (sm_90a), written by hand in CUDA
// C++.
//
// Replaces: repro/kernels/qfed_reweight/qfed_reweight.py::
// qfed_reweight_call, the Pallas TPU kernel (its body is _kernel,
// qfed_reweight.py:26).
//
// q-FedAvg (Li et al., ICLR 2019) turns client k's pseudo-gradient dw_k
// into delta_k = F_k^q dw_k and needs ||dw_k||^2 for its h_k. With dw
// viewed as (C, P, F) packets and fq = F^q (C,), for packet block g of
// rows [g*PB, min((g+1)*PB, P)):
//
//   delta[c,p,f] = dw[c,p,f] * fq[c]               (one rounding: bitwise
//                                                   the plain version)
//   ssq[c,g]     = sum over the block of dw[c,p,f]^2
//
// The wrapper sums ssq over g in torch, as the reference sums its (C, G)
// partials outside its pallas_call; ops.py forms fq and h_k.
//
// What bounds it: bytes. It reads dw once and writes delta once, 8 B per
// coordinate: at the reference's bench shape (C = 16, P = 1024, F = 256)
// 33.6 MB, or 10 us at 3.35 TB/s; at the host loop's (C = 10, P = 36)
// 0.74 MB. Three operations per coordinate.
//
// Design: one CTA per (packet block, client); the block's PB * F floats
// are contiguous, so the CTA's threads stride over them with coalesced
// loads and stores, each keeping a private fp32 partial, and the CTA sums
// the partials in a fixed order (shuffles within each warp, then warp 0).
// The TPU kernel carries nothing across its grid either: each step writes
// its own (C, 1) partial. No float atomics, so every run gives the same
// bits. A vmap over scenarios folds them into the clients (C -> S * C):
// one launch.

#include <cuda_runtime.h>

namespace {

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

__global__ void qfed_reweight_kernel(const float* __restrict__ dw,
                                     const float* __restrict__ fq,
                                     float* __restrict__ delta,
                                     float* __restrict__ ssq, int P, int F,
                                     int rows, int G) {
  __shared__ float red[32];
  const int g = blockIdx.x;
  const int c = blockIdx.y;
  const int p0 = g * rows;
  const int p1 = min(p0 + rows, P);
  const size_t base = ((size_t)c * P + p0) * F;
  const long long n = (long long)(p1 - p0) * F;
  const float s = fq[c];
  float acc = 0.f;
  for (long long j = threadIdx.x; j < n; j += blockDim.x) {
    const float v = dw[base + j];
    delta[base + j] = v * s;
    acc += v * v;
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) ssq[(size_t)c * G + g] = acc;
}

}  // namespace

extern "C" {

// Launches the reweighting on `stream`: one 256-thread CTA per (block of
// `rows` packets, client), G = ceil(P / rows) blocks a client. Returns
// cudaGetLastError() after the launch.
int qfed_reweight_launch(const void* dw, const void* fq, void* delta,
                         void* ssq, int C, int P, int F, int rows, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = (P + rows - 1) / rows;
  const dim3 grid(G, C);
  qfed_reweight_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dw), static_cast<const float*>(fq),
      static_cast<float*>(delta), static_cast<float*>(ssq), P, F, rows, G);
  return (int)cudaGetLastError();
}

const char* qfed_reweight_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
