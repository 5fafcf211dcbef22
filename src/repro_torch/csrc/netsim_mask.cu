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
// and writes its final state to s_fin[r]. States are 0 (GOOD) and 1 (BAD).
//
// The recurrence as a scan. A packet's transition is a map from {GOOD,
// BAD} to {GOOD, BAD}, held in 2 bits: bit s is the state after the
// packet from state s, so bit 0 is u_t < p_gb and bit 1 is !(u_t < p_bg).
// Composing maps is associative, so a segment of `lanes` lanes owns
// consecutive packets of a row (V each, V = 4 with 16-byte loads where
// the rows are aligned) and, a step of lanes * V packets at a time:
//   1. composes its V maps in the lane, then runs an inclusive scan of
//      the lanes' maps by __shfl_up_sync over the segment;
//   2. applies the map of the packets before it to the state carried into
//      the step, which gives each packet's state;
//   3. compares each emission uniform against its state's rate;
//   4. carries the segment's composed map, applied to the carry, to the
//      next step.
// Loads and stores are coalesced, and the parallelism is R x P packets,
// not R rows. The comparisons are the reference's (strict < for the flip,
// >= for delivery), so a NaN uniform neither flips nor delivers, as there,
// and the result is bitwise the plain version's and the reference's.
//
// What bounds it: bytes. It must read u_t and u_e (8 B per packet) and
// write the mask (4 B per packet); at the sweep's shape (R = 27 * 10 = 270
// rows, P = 36) that is about 0.12 MB, far below a launch; at (4096, 1024)
// 50 MB, 0.015 ms at 3.35 TB/s. A sweep folds its scenarios into the rows
// (R = S * C): one launch per round for the whole grid.

#include <cuda_runtime.h>

namespace {

constexpr int kIdentity = 2;        // GOOD -> GOOD, BAD -> BAD

// The composition table: entry (later * 4 + earlier) holds, in 2 bits, the
// map `later` after `earlier`: bit s = bit (bit s of earlier) of later.
constexpr unsigned compose_table() {
  unsigned t = 0;
  for (unsigned b = 0; b < 4; ++b)
    for (unsigned a = 0; a < 4; ++a) {
      const unsigned r0 = (b >> (a & 1u)) & 1u;
      const unsigned r1 = (b >> ((a >> 1) & 1u)) & 1u;
      t |= (r0 | (r1 << 1)) << ((b * 4 + a) * 2);
    }
  return t;
}
constexpr unsigned kCompose = compose_table();

__device__ __forceinline__ int compose(int later, int earlier) {
  return (int)((kCompose >> ((later * 4 + earlier) * 2)) & 3u);
}

__device__ __forceinline__ int apply(int map, int s) {
  return (map >> s) & 1;
}

// One segment of `lanes` lanes (a power of two, at most 32) a row; a CTA
// holds blockDim.x / lanes rows. V = 4 needs P % 4 == 0 and u_t, u_e
// 16-byte aligned (the binding checks); V = 1 takes any P and alignment.
template <int V>
__global__ void netsim_mask_kernel(
    const float* __restrict__ u_t, const float* __restrict__ u_e,
    const int* __restrict__ s0, const float* __restrict__ p_gb,
    const float* __restrict__ p_bg, const float* __restrict__ h_g,
    const float* __restrict__ h_b, float* __restrict__ mask,
    int* __restrict__ s_fin, int R, int P, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const long long r = (long long)blockIdx.x * (blockDim.x / lanes) +
                      threadIdx.x / lanes;
  const bool live = r < R;
  float gb = 0.f, bg = 0.f, hg = 0.f, hb = 0.f;
  int carry = 0;
  if (live) {
    gb = p_gb[r];
    bg = p_bg[r];
    hg = h_g[r];
    hb = h_b[r];
    carry = s0[r] == 1 ? 1 : 0;
  }
  const size_t row = (size_t)r * P;
  const int span = lanes * V;
  // every lane runs every step, so that the shuffles see the whole warp
  for (int base = 0; base < P; base += span) {
    const int p0 = base + lane * V;
    const int nv = live ? max(0, min(V, P - p0)) : 0;
    float ut[V], ue[V];
    if (V == 4 && nv == 4) {
      const float4 a = *reinterpret_cast<const float4*>(u_t + row + p0);
      const float4 b = *reinterpret_cast<const float4*>(u_e + row + p0);
      ut[0] = a.x; ut[1] = a.y; ut[2] = a.z; ut[3] = a.w;
      ue[0] = b.x; ue[1] = b.y; ue[2] = b.z; ue[3] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ut[j] = j < nv ? u_t[row + p0 + j] : 0.f;
        ue[j] = j < nv ? u_e[row + p0 + j] : 0.f;
      }
    }
    int m[V];
    int own = kIdentity;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = j < nv ? (int)(ut[j] < gb) | ((int)!(ut[j] < bg) << 1)
                    : kIdentity;
      own = compose(m[j], own);
    }
    int incl = own;
    for (int off = 1; off < lanes; off <<= 1) {
      const int before = __shfl_up_sync(0xffffffffu, incl, off, lanes);
      if (lane >= off) incl = compose(incl, before);
    }
    int excl = __shfl_up_sync(0xffffffffu, incl, 1, lanes);
    if (lane == 0) excl = kIdentity;
    int s = apply(excl, carry);
    float out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s = apply(m[j], s);
      out[j] = ue[j] >= (s == 1 ? hb : hg) ? 1.f : 0.f;
    }
    if (V == 4 && nv == 4) {
      *reinterpret_cast<float4*>(mask + row + p0) =
          make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (j < nv) mask[row + p0 + j] = out[j];
    }
    carry = apply(__shfl_sync(0xffffffffu, incl, lanes - 1, lanes), carry);
  }
  if (live && lane == 0) s_fin[r] = carry;
}

}  // namespace

extern "C" {

// Launches the mask kernel on `stream`: ceil(R / (threads / lanes)) CTAs
// of `threads` threads, a segment of `lanes` lanes a row, 4 packets a lane
// with 16-byte loads when `vec` (the binding's plan). Returns the first
// CUDA error, or cudaGetLastError() after the launch.
int netsim_mask_launch(const void* u_t, const void* u_e, const void* s0,
                       const void* p_gb, const void* p_bg, const void* h_g,
                       const void* h_b, void* mask, void* s_fin, int R, int P,
                       int lanes, int vec, int threads, int device,
                       void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || threads < 32 ||
      threads > 1024 || threads % 32 || (vec && P % 4))
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = threads / lanes;
  const unsigned blocks = (unsigned)(((long long)R + rows - 1) / rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ut = static_cast<const float*>(u_t);
  const float* ue = static_cast<const float*>(u_e);
  const int* st = static_cast<const int*>(s0);
  const float* gb = static_cast<const float*>(p_gb);
  const float* bg = static_cast<const float*>(p_bg);
  const float* hg = static_cast<const float*>(h_g);
  const float* hb = static_cast<const float*>(h_b);
  float* m = static_cast<float*>(mask);
  int* sf = static_cast<int*>(s_fin);
  if (vec)
    netsim_mask_kernel<4><<<blocks, threads, 0, s>>>(
        ut, ue, st, gb, bg, hg, hb, m, sf, R, P, lanes);
  else
    netsim_mask_kernel<1><<<blocks, threads, 0, s>>>(
        ut, ue, st, gb, bg, hg, hb, m, sf, R, P, lanes);
  return (int)cudaGetLastError();
}

const char* netsim_mask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
