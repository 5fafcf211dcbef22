// Gilbert-Elliott packet-mask generation for Hopper (sm_90a), written by
// hand in CUDA C++.
//
// Replaces: repro/kernels/netsim_mask/netsim_mask.py::netsim_mask_call,
// the Pallas TPU kernel (its body is _kernel, netsim_mask.py:40).
//
// Each row r (one client of one scenario) walks a two-state Markov chain
// along its P packets, transition first and emission second:
//
//   flip      = s ? p_bg[r] : p_gb[r]
//   s         = u_t[r,p] < flip ? 1 - s : s
//   mask[r,p] = u_e[r,p] >= (s ? h_b[r] : h_g[r])      1 = delivered
//
// and writes its final state to s_fin[r]. Only float32 comparisons and
// selects: the result is bitwise the plain version's and the reference's.
//
// What bounds it: bytes. It must read u_t and u_e (8 B per packet) and
// write the mask (4 B per packet); at the sweep's shape (R = 27 * 10 = 270
// rows, P = 36) that is about 0.12 MB, or 0.04 us at 3.35 TB/s, far below
// a launch. The recurrence is sequential in p, so the parallelism is R.
//
// Design: one thread per row with the loop over p inside the thread,
// which replaces the TPU kernel's lockstep walk of a (bc, P) tile on the
// VPU. A thread reads its own row front to back, so each 128-byte line it
// touches serves 32 packets from L1. A sweep folds its scenarios into the
// rows (R = S * C): one launch per round for the whole grid.

#include <cuda_runtime.h>

namespace {

__global__ void netsim_mask_kernel(const float* __restrict__ u_t,
                                   const float* __restrict__ u_e,
                                   const int* __restrict__ s0,
                                   const float* __restrict__ p_gb,
                                   const float* __restrict__ p_bg,
                                   const float* __restrict__ h_g,
                                   const float* __restrict__ h_b,
                                   float* __restrict__ mask,
                                   int* __restrict__ s_fin, int R, int P) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float gb = p_gb[r], bg = p_bg[r], hg = h_g[r], hb = h_b[r];
  int s = s0[r];
  const size_t row = (size_t)r * P;
  for (int p = 0; p < P; ++p) {
    const float flip = s == 1 ? bg : gb;
    if (u_t[row + p] < flip) s = 1 - s;
    const float h = s == 1 ? hb : hg;
    mask[row + p] = u_e[row + p] >= h ? 1.f : 0.f;
  }
  s_fin[r] = s;
}

}  // namespace

extern "C" {

// Launches the mask kernel on `stream`. Returns cudaGetLastError() after
// the launch.
int netsim_mask_launch(const void* u_t, const void* u_e, const void* s0,
                       const void* p_gb, const void* p_bg, const void* h_g,
                       const void* h_b, void* mask, void* s_fin, int R, int P,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  netsim_mask_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u_t), static_cast<const float*>(u_e),
      static_cast<const int*>(s0), static_cast<const float*>(p_gb),
      static_cast<const float*>(p_bg), static_cast<const float*>(h_g),
      static_cast<const float*>(h_b), static_cast<float*>(mask),
      static_cast<int*>(s_fin), R, P);
  return (int)cudaGetLastError();
}

const char* netsim_mask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
