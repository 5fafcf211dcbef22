// Fused TRA uplink step for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces: repro/kernels/uplink_fused/uplink_fused.py::uplink_fused_call
// and ::uplink_fused_batched_call, the Pallas TPU megakernel (its body is
// _body, uplink_fused.py:88) and its scenario-batched grid.
//
// For a cohort of C clients whose uploads are viewed as (C, P, F) packets,
// with delivery masks m (C, P), pre-folded debias scales q (C,) and either
// raw weights w (C,) (per_coord_count) or a ready scalar denominator:
//
//   x_eff[c,p,f] = x[c,p,f] + ef[c,p,f]                      EF re-inject
//   agg[p,f]     = sum_c q[c] m[c,p] x_eff[c,p,f] / den[p]    debias aggregate
//   ef_out       = x_eff[c,p,f] * (1 - m[c,p])                EF update
//   ssq[c,p]     = m[c,p] * sum_f x_eff[c,p,f]^2              q-FedAvg norms
//
// den[p] is max(sum_c w[c] m[c,p], eps) for per_coord_count, else the
// scalar max(sum_c w[c], eps) read from device memory. ssq holds per-packet
// partials; the wrapper sums them over p in a fixed order. x and ef may be
// bf16 (the stream dtype): they are upcast on load, everything accumulates
// in fp32, and ef_out is written back in the stream dtype (round to
// nearest even, as torch's .to(bfloat16) does).
//
// What bounds it: bytes. At the main-path shape (C=10, P=36, F=256, f32,
// no EF) the call must read x (368,640 B), m (1,440 B), q and den, and
// write agg (36,864 B) and the ssq partials (1,440 B): about 0.41 MB, or
// 0.12 us at the H100's 3.35 TB/s. Its ~0.4 MFLOP are negligible. A launch
// costs microseconds, so at that shape the kernel is launch-bound.
//
// Design: one CTA per packet row p, threads over f, and a loop over all C
// clients in index order inside the CTA. A CUDA grid runs in no order, so
// the TPU kernel's client-axis accumulation in VMEM scratch (zeroed at
// ci == 0, divided at ci == nc - 1) becomes this in-CTA loop: x and ef are
// read once, ef_out written once, the agg numerator kept in shared memory
// (each entry private to its thread) and the per_coord denominator in a
// register. The per-(c, p) norm partial is a block reduction in a fixed
// order. No float atomics anywhere, so every run gives the same bits.
// Beyond that single pass the design does nothing about the launch cost
// yet: vectorised loads, a split-C second pass for large C and more CTAs
// than P are later work.
//
// Scenario batching: a sweep stacks S scenarios' cohorts as (S, C, P, F)
// with per-scenario masks, scales and denominators. blockIdx.y is the
// scenario; each CTA offsets its pointers to its scenario and then does
// exactly what a single-scenario CTA does, in the same order, so one
// batched launch is bitwise equal to S single launches. A single call is
// the launch with S = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_from_f32(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, size_t i,
                                               float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Sum of v over the CTA in a fixed order: shuffles within each warp, then
// warp 0 over the warp partials. The result is valid in thread 0.
// blockDim.x must be a multiple of 32 and at most 1024.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by warp 0 from the last call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < n_warps ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename T>
__global__ void uplink_fused_kernel(const T* __restrict__ x,
                                    const T* __restrict__ ef,
                                    const float* __restrict__ m,
                                    const float* __restrict__ q,
                                    const float* __restrict__ w_or_den,
                                    float* __restrict__ agg,
                                    T* __restrict__ ef_out,
                                    float* __restrict__ ssq, int C, int P,
                                    int F, int per_coord, float eps) {
  extern __shared__ float smem[];
  float* acc = smem;      // (F,) numerator of this packet row
  float* red = smem + F;  // (32,) block-reduction scratch
  const int p = blockIdx.x;
  const size_t sc = blockIdx.y;  // scenario
  x += sc * C * P * F;
  if (ef != nullptr) {
    ef += sc * C * P * F;
    ef_out += sc * C * P * F;
  }
  m += sc * C * P;
  q += sc * C;
  w_or_den += per_coord ? sc * C : sc;
  agg += sc * P * F;
  if (ssq != nullptr) ssq += sc * C * P;
  for (int f = threadIdx.x; f < F; f += blockDim.x) acc[f] = 0.f;
  float den = 0.f;
  for (int c = 0; c < C; ++c) {
    const float mc = m[(size_t)c * P + p];
    const float wm = mc * q[c];
    if (per_coord) den += mc * w_or_den[c];
    const size_t row = ((size_t)c * P + p) * F;
    float s = 0.f;
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      float xe = load_f32(x, row + f);
      if (ef != nullptr) {
        xe += load_f32(ef, row + f);
        store_from_f32(ef_out, row + f, xe * (1.f - mc));
      }
      acc[f] += xe * wm;
      s += xe * xe;
    }
    if (ssq != nullptr) {
      s = block_sum(s, red);
      if (threadIdx.x == 0) ssq[(size_t)c * P + p] = s * mc;
    }
  }
  // max(den, eps) that keeps a NaN, as torch.clamp does
  const float d = per_coord ? (den < eps ? eps : den) : w_or_den[0];
  for (int f = threadIdx.x; f < F; f += blockDim.x)
    agg[(size_t)p * F + f] = acc[f] / d;
}

}  // namespace

extern "C" {

// Launches the fused uplink step of S scenarios on `stream`, one CTA per
// (packet row, scenario). ef/ef_out are both null or both set; ssq may be
// null. Returns cudaGetLastError() after the launch.
int uplink_fused_launch(const void* x, const void* ef, const void* m,
                        const void* q, const void* w_or_den, void* agg,
                        void* ef_out, void* ssq, int S, int C, int P, int F,
                        int is_bf16, int per_coord, float eps, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = F < 256 ? F : 256;
  const size_t smem = (size_t)(F + 32) * sizeof(float);
  const dim3 grid(P, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* qf = static_cast<const float*>(q);
  const float* wd = static_cast<const float*>(w_or_den);
  float* aggf = static_cast<float*>(agg);
  float* ssqf = static_cast<float*>(ssq);
  if (is_bf16) {
    using T = __nv_bfloat16;
    uplink_fused_kernel<T><<<grid, threads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(ef), mf, qf, wd, aggf,
        static_cast<T*>(ef_out), ssqf, C, P, F, per_coord, eps);
  } else {
    uplink_fused_kernel<float><<<grid, threads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(ef), mf, qf,
        wd, aggf, static_cast<float*>(ef_out), ssqf, C, P, F, per_coord,
        eps);
  }
  return (int)cudaGetLastError();
}

const char* uplink_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
