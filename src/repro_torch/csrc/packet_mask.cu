// Per-packet delivery mask applied to a packetised update, for Hopper
// (sm_90a), written by hand in CUDA C++.
//
// Replaces: repro/kernels/packet_mask/packet_mask.py::packet_mask_call,
// the Pallas TPU kernel (its body is _kernel, packet_mask.py:20).
//
// An update of P packets of F coordinates, viewed as (P, F), and a (P,)
// delivery mask (1 delivered, 0 lost):
//
//   out[p,f] = x[p,f] * m[p]            in x's dtype
//
// The reference multiplies; it does not select. So NaN * 0 is NaN and
// -x * 0 is -0.0, and this kernel multiplies too. For bf16 the mask is
// first rounded to bf16 (the reference's mask.astype(x.dtype)), the
// product is taken in f32 and rounded back to nearest even, which is what
// PyTorch's bf16 multiply does on the card.
//
// What bounds it: bytes. It reads x and the mask once and writes the
// result once: 8 B per f32 coordinate plus 4 B per packet; at the
// reference's bench shape (P = 4096, F = 256, f32) that is 8.4 MB, or
// 2.5 us at 3.35 TB/s. It does one multiply per coordinate.
//
// Design: one thread per element in place of the TPU kernel's (BP, F)
// tiles in VMEM; in f32 with F a multiple of 4, one thread per float4 (a
// 16-byte load and store, neighbouring threads on neighbouring
// addresses). The packet index is the element's row, i / F. A vmap over a
// cohort folds the batch into the rows (R = B * P): one launch. At the
// path's shape (one upload, P = 36, F = 256) the kernel runs at the launch
// floor, about a microsecond, so the host side sets a call's time: the
// launch switches the current device only when it differs, and the
// binding checks in one pass and takes the raw stream handle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void packet_mask_f32(const float* __restrict__ x,
                                const float* __restrict__ m,
                                float* __restrict__ out, long long n, int F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = x[i] * m[i / F];
}

// F4 = F / 4 float4s per packet row
__global__ void packet_mask_f32x4(const float4* __restrict__ x,
                                  const float* __restrict__ m,
                                  float4* __restrict__ out, long long n4,
                                  int F4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float mp = m[i / F4];
  float4 v = x[i];
  v.x *= mp;
  v.y *= mp;
  v.z *= mp;
  v.w *= mp;
  out[i] = v;
}

__global__ void packet_mask_bf16(const __nv_bfloat16* __restrict__ x,
                                 const float* __restrict__ m,
                                 __nv_bfloat16* __restrict__ out, long long n,
                                 int F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float mp = __bfloat162float(__float2bfloat16_rn(m[i / F]));
  out[i] = __float2bfloat16_rn(__bfloat162float(x[i]) * mp);
}

}  // namespace

extern "C" {

// Launches the mask on `stream` over R packet rows of F coordinates.
// `vec4` asks for the float4 path (f32, F % 4 == 0, 16-byte aligned
// pointers; the wrapper checks). Returns cudaGetLastError() after the
// launch.
int packet_mask_launch(const void* x, const void* m, void* out, long long R,
                       int F, int is_bf16, int vec4, int device,
                       void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const long long n = R * F;
  if (is_bf16) {
    const long long blocks = (n + threads - 1) / threads;
    packet_mask_bf16<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), mf,
        static_cast<__nv_bfloat16*>(out), n, F);
  } else if (vec4) {
    const long long n4 = n / 4;
    const long long blocks = (n4 + threads - 1) / threads;
    packet_mask_f32x4<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float4*>(x), mf, static_cast<float4*>(out), n4,
        F / 4);
  } else {
    const long long blocks = (n + threads - 1) / threads;
    packet_mask_f32<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(x), mf, static_cast<float*>(out), n, F);
  }
  return (int)cudaGetLastError();
}

const char* packet_mask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
