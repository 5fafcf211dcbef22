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
// [g*G, min((g+1)*G, P)), the reference computes
//
//   n_lost = sum over the group of (1 - mask[r,p])
//   repair = n_lost == 1 && parity[r,g] > 0.5
//   out[r,p] = repair && mask[r,p] < 0.5 ? 1 : mask[r,p]
//
// Packets past P in the ragged last group count as delivered.
//
// A count in place of the sum. Lanes own consecutive packets (V each, V =
// 4 with 16-byte loads where P and G are multiples of 4 and the mask is
// aligned), and a group's losses are counted with __ballot_sync and
// __popc over its lanes, a packet counting as lost when !(m >= 0.5). For
// 0/1 masks, the binding's input contract, the count is the reference's
// sum. A NaN counts as lost, and the output is still the reference's,
// whose NaN sum repairs nothing: either the count is 2 or more, or the one
// "lost" packet is the NaN itself, which `m < 0.5` leaves as it is.
//
// Two shapes of work:
//   * G / V <= 32 lanes: a warp step covers floor(32 / (G / V)) whole
//     groups, so that no group straddles two steps; a warp runs U steps of
//     a row with all their loads issued first (U = 2 with 16-byte loads,
//     4 without, 1 where a row has fewer than 4 steps: 8 floats of a lane
//     in flight); the parity is read only for a group whose count is 1,
//     one address for the group's lanes.
//   * wider groups: one warp a group, walking it 32 * V packets a step,
//     adding up the popcounts and writing the mask through; then the lane
//     that held the one loss, if the count is 1, reads the parity once and
//     repairs its packet (its own earlier store, so program order holds).
//
// What bounds it: bytes. It must read the mask and the parities and write
// the repaired mask, 8 B per packet plus 4 B per group; at the recovery
// grid's shape (R = 6 * 12 = 72 rows, P = 36, G = 8) that is about 22 KB,
// far below a launch. A sweep folds its scenarios into the rows (R = S *
// C): one launch per round for the whole grid.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ src, int nv,
                                     float (&v)[V]) {
  if (V == 4 && nv == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = j < nv ? src[j] : 1.f;
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ dst, int nv,
                                      const float (&v)[V]) {
  if (V == 4 && nv == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < nv) dst[j] = v[j];
  }
}

// Groups of at most 32 lanes: `per_step` groups a warp step, U steps a
// warp, ceil(steps_row / U) warps a row.
template <int V, int U>
__global__ void fec_recover_kernel(const float* __restrict__ mask,
                                   const float* __restrict__ parity,
                                   float* __restrict__ out, int R, int P,
                                   int gn, int group, int per_step,
                                   int steps_row) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int warps_row = (steps_row + U - 1) / U;
  const long long r = warp / warps_row;
  if (r >= R) return;                       // the whole warp together
  const int first = (int)(warp % warps_row) * U;
  const int gl = group / V;                 // lanes a group
  const int gi = lane / gl;                 // the lane's group in a step
  const bool in_step = gi < per_step;
  const unsigned gmask =
      !in_step ? 0u
               : (gl == 32 ? kFull : ((1u << gl) - 1u) << (gi * gl));
  const size_t row = (size_t)r * P;
  float v[U][V];
  int nv[U], g[U], p0[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    g[u] = (first + u) * per_step + gi;
    p0[u] = g[u] * group + (lane - gi * gl) * V;
    nv[u] = in_step && g[u] < gn ? max(0, min(V, P - p0[u])) : 0;
    load<V>(mask + row + p0[u], nv[u], v[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int lost = 0;
#pragma unroll
    for (int j = 0; j < V; ++j)
      lost += __popc(__ballot_sync(kFull, j < nv[u] && !(v[u][j] >= 0.5f)) &
                     gmask);
    const bool repair =
        lost == 1 && parity[(size_t)r * gn + g[u]] > 0.5f;
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (repair && v[u][j] < 0.5f) v[u][j] = 1.f;
    store<V>(out + row + p0[u], nv[u], v[u]);
  }
}

// Groups wider than 32 lanes: one warp a group.
template <int V>
__global__ void fec_recover_wide_kernel(const float* __restrict__ mask,
                                        const float* __restrict__ parity,
                                        float* __restrict__ out, int R,
                                        int P, int gn, int group) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long r = warp / gn;
  if (r >= R) return;                       // the whole warp together
  const int g = (int)(warp % gn);
  const int lo = g * group;
  const int hi = min(lo + group, P);
  const size_t row = (size_t)r * P;
  int lost = 0, own = -1;
  float own_v = 0.f;
  for (int base = lo; base < hi; base += 32 * V) {
    const int p0 = base + lane * V;
    const int nv = max(0, min(V, hi - p0));
    float v[V];
    load<V>(mask + row + p0, nv, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool l = j < nv && !(v[j] >= 0.5f);
      lost += __popc(__ballot_sync(kFull, l));
      if (l) {
        own = p0 + j;
        own_v = v[j];
      }
    }
    store<V>(out + row + p0, nv, v);
  }
  if (lost == 1 && own >= 0 && own_v < 0.5f &&
      parity[(size_t)r * gn + g] > 0.5f)
    out[row + own] = 1.f;
}

}  // namespace

extern "C" {

// Launches the repair kernel on `stream` with the binding's plan: V = 4
// packets a lane with 16-byte loads when `vec`; `per_step` groups a warp
// step and `steps` steps a warp (1, or 2 when `vec` and 4 when not), or
// one warp a group when `per_step` is 0; CTAs of `threads` threads.
// Returns the first CUDA error, or cudaGetLastError() after the launch.
int fec_recover_launch(const void* mask, const void* parity, void* out,
                       int R, int P, int gn, int group, int vec,
                       int per_step, int steps, int threads, int device,
                       void* stream) {
  const int V = vec ? 4 : 1;
  if (group < 1 || (vec && (group % 4 || P % 4)) || per_step < 0 ||
      (per_step > 0 && (group / V > 32 || per_step * (group / V) > 32)) ||
      (steps != 1 && steps != (vec ? 2 : 4)) || threads < 32 ||
      threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  long long warps;
  int steps_row = 0;
  if (per_step > 0) {
    steps_row = (gn + per_step - 1) / per_step;
    warps = (long long)R * ((steps_row + steps - 1) / steps);
  } else {
    warps = (long long)R * gn;
  }
  const long long blocks = (warps * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const float* par = static_cast<const float*>(parity);
  float* o = static_cast<float*>(out);
  const dim3 grid((unsigned)blocks);
#define FEC_LAUNCH(VV, UU)                                             \
  fec_recover_kernel<VV, UU><<<grid, threads, 0, s>>>(                 \
      m, par, o, R, P, gn, group, per_step, steps_row)
  if (per_step == 0) {
    if (vec)
      fec_recover_wide_kernel<4><<<grid, threads, 0, s>>>(m, par, o, R, P,
                                                          gn, group);
    else
      fec_recover_wide_kernel<1><<<grid, threads, 0, s>>>(m, par, o, R, P,
                                                          gn, group);
  } else if (vec) {
    if (steps == 2) FEC_LAUNCH(4, 2);
    else FEC_LAUNCH(4, 1);
  } else {
    if (steps == 4) FEC_LAUNCH(1, 4);
    else FEC_LAUNCH(1, 1);
  }
#undef FEC_LAUNCH
  return (int)cudaGetLastError();
}

const char* fec_recover_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
