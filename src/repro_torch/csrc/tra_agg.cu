// TRA debiased masked aggregation for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// Replaces: repro/kernels/tra_agg/tra_agg.py::tra_agg_call, the Pallas TPU
// kernel (its body is _kernel, tra_agg.py:32), and its batching under
// vmap.
//
// For C client uploads viewed as (C, P, F) packets, delivery masks m
// (C, P) and client weights w (C,):
//
//   num[p,f] = sum_c m[c,p] w[c] x[c,p,f]         (c in index order)
//   den[p]   = sum_c m[c,p] w[c]
//   out[p,f] = num[p,f] / max(den[p], eps)
//
// which is the per_coord_count estimator. The other debias modes pre-scale
// x and replace m by ones before the call (kernels/tra_agg/ops.py), as the
// reference's ops.py does. max keeps a NaN, as torch.clamp and jnp.maximum
// do; the division is a true division.
//
// What bounds it: bytes. It reads x once (4 B per coordinate per client),
// the masks and weights, and writes the (P, F) aggregate: at the host
// loop's shape (C = 10, P = 36, F = 256) 406,984 B, or 0.12 us at
// 3.35 TB/s; at the reference's bench shape (C = 16, P = 1024, F = 256)
// 17.9 MB, or 5.3 us. Two operations per coordinate per client.
//
// Design: one thread per output coordinate (p, f) and the loop over C
// inside the thread, in index order, with fp32 accumulators for num and
// den. The TPU kernel reduces a (C, BP, F) tile in VMEM; here a warp reads
// 32 neighbouring floats of one client's row per step, so every load is
// coalesced, and no shared memory, synchronisation or float atomics are
// needed: every run gives the same bits. den is recomputed by each thread
// of the row from the cached (C,) mask column and weights.
//
// Scenario batching: under vmap the operands carry a leading S.
// blockIdx.y is the scenario; each thread offsets its pointers to its
// scenario and then does exactly what a single launch's thread does, so
// one batched launch is bitwise S single launches.

#include <cuda_runtime.h>

namespace {

__global__ void tra_agg_kernel(const float* __restrict__ x,
                               const float* __restrict__ m,
                               const float* __restrict__ w,
                               float* __restrict__ out, int C, int P, int F,
                               float eps) {
  const long long PF = (long long)P * F;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PF) return;
  const size_t sc = blockIdx.y;  // scenario
  x += sc * C * PF;
  m += sc * C * P;
  w += sc * C;
  out += sc * PF;
  const int p = (int)(i / F);
  float num = 0.f, den = 0.f;
  for (int c = 0; c < C; ++c) {
    const float wm = m[(size_t)c * P + p] * w[c];
    num += wm * x[(size_t)c * PF + i];
    den += wm;
  }
  out[i] = num / (den < eps ? eps : den);
}

}  // namespace

extern "C" {

// Launches the aggregate of S scenarios on `stream`: S * P * F threads,
// 256 to a block. Returns cudaGetLastError() after the launch.
int tra_agg_launch(const void* x, const void* m, const void* w, void* out,
                   int S, int C, int P, int F, float eps, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long PF = (long long)P * F;
  const dim3 grid((unsigned)((PF + threads - 1) / threads), S);
  tra_agg_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m),
      static_cast<const float*>(w), static_cast<float*>(out), C, P, F, eps);
  return (int)cudaGetLastError();
}

const char* tra_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
