// FEC group-parity repair of packet delivery masks for Hopper (sm_90a),
// written by hand in CUDA C++.
//
// Replaces: repro/kernels/fec_recover/fec_recover.py::fec_recover_call,
// the Pallas TPU kernel (its body is _kernel, fec_recover.py:34).
//
// The FEC recovery policy sends one XOR parity packet per group of G data
// packets. A group that lost exactly one data packet and whose parity
// arrived is repaired: the lost packet is marked delivered. For row r
// (one client of one scenario) and group g, covering packets
// [g*G, min((g+1)*G, P)):
//
//   n_lost = sum over the group of (1 - mask[r,p])       (index order)
//   repair = n_lost == 1 && parity[r,g] > 0.5
//   out[r,p] = repair && mask[r,p] < 0.5 ? 1 : mask[r,p]
//
// Packets past P in the ragged last group count as delivered: the
// reference pads the mask with 1.0, which adds 0 to n_lost, so skipping
// them is the same sum without a padded copy. The masks are 0/1, so the
// sums are exact and the result is bitwise the plain version's and the
// reference's.
//
// What bounds it: bytes. It must read the mask and the parities and write
// the repaired mask, 8 B per packet plus 4 B per group; at the recovery
// grid's shape (R = 6 * 12 = 72 rows, P = 36, G = 8) that is about 22 KB,
// or 0.007 us at 3.35 TB/s, far below a launch.
//
// Design: one thread per (row, group), with the group's G packets in a
// loop inside the thread, in place of the TPU kernel's walk over the
// groups of a (bc, P) tile in VMEM. Groups are independent: no shared
// memory, no atomics, no synchronisation. A sweep folds its scenarios into
// the rows (R = S * C): one launch per round for the whole grid.

#include <cuda_runtime.h>

namespace {

__global__ void fec_recover_kernel(const float* __restrict__ mask,
                                   const float* __restrict__ parity,
                                   float* __restrict__ out, int R, int P,
                                   int gn, int group) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * gn) return;
  const int r = (int)(i / gn);
  const int g = (int)(i % gn);
  const int lo = g * group;
  const int hi = min(lo + group, P);
  const float* m = mask + (size_t)r * P;
  float n_lost = 0.f;
  for (int p = lo; p < hi; ++p) n_lost += 1.f - m[p];
  const bool repair = n_lost == 1.f && parity[i] > 0.5f;
  float* o = out + (size_t)r * P;
  for (int p = lo; p < hi; ++p) {
    const float v = m[p];
    o[p] = repair && v < 0.5f ? 1.f : v;
  }
}

}  // namespace

extern "C" {

// Launches the repair kernel on `stream`. Returns cudaGetLastError() after
// the launch.
int fec_recover_launch(const void* mask, const void* parity, void* out,
                       int R, int P, int gn, int group, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const long long n = (long long)R * gn;
  const int blocks = (int)((n + threads - 1) / threads);
  fec_recover_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mask), static_cast<const float*>(parity),
      static_cast<float*>(out), R, P, gn, group);
  return (int)cudaGetLastError();
}

const char* fec_recover_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
