// Robust uplink aggregation (finite screen, norm clip, trimmed mean) for
// Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces: repro/kernels/robust_agg/robust_agg.py::robust_agg_call and
// ::robust_agg_batched_call, the Pallas TPU kernel (its body is _body,
// robust_agg.py:99, with the trimmed mean _trimmed_extract, :67) and its
// scenario-batched grid.
//
// For a cohort of C clients whose uploads are viewed as (C, P, F) packets,
// with delivery masks m (C, P), per-client scales q (C,) (the debias scale
// with the clip factor folded in by ops.py), the gates `screen` and
// `trim_gate`, and, when trim_k > 0, per-client trim scales g (C,) and the
// weight > 0 validity w_pos (C,):
//
//   x_eff[c,p,f] = x + ef                                    EF re-inject
//   ok[c,p]      = AND_f isfinite(x_eff[c,p,f])              finite screen
//   x_san        = screen && !isfinite(x_eff) ? 0 : x_eff    sanitise
//   m_eff[c,p]   = screen ? m * ok : m                       quarantine
//   agg[p,f]     = sum_c x_san * (m_eff q[c]) / den[p]       debias aggregate
//   agg[p,f]     = trim_gate ? trimmed_mean_c(g[c] x_san) : agg
//   ef_out       = x_san * (1 - m)            EF over channel-lost packets only
//
// den[p] is max(sum_c w[c] m_eff[c,p], eps) for per_coord_count, else the
// ready scalar read from device memory. The trimmed mean runs over the
// clients valid at (c, p), m_eff * w_pos > 0: per coordinate it drops the k
// smallest and k largest values and averages the rest, or falls back to the
// masked mean when n <= 2k.
//
// What bounds it: bytes. At the fault recipe's shape (C=12, P=36, F=256,
// f32, no EF) the call must read x (442,368 B), m, q, g, w_pos and the gates
// and write agg (36,864 B): about 0.48 MB, or 0.14 us at the H100's
// 3.35 TB/s. A launch costs microseconds, so there the kernel is
// launch-bound. The recipe's 9-cell grid moves about 4.3 MB (1.3 us); the
// tiling shape (64, 1024, 256) with EF about 202 MB (60 us). The trim's
// compares, 2k passes over C per output, are far below the fp32 rate.
//
// Design: one CTA per (packet row, scenario), one thread per float of the
// row (blockDim = F), and a loop over all C clients in index order inside
// the CTA, as in uplink_fused.cu. The screen of a packet is an AND over the
// CTA's row: __syncthreads_and. The numerator and the per_coord denominator
// accumulate in registers with the uplink kernel's expressions, so with
// every gate off the aggregate is bitwise uplink_fused's. There is no branch
// on m == 0: NaN * 0 = NaN, as on the TPU, so an undefended NaN upload
// poisons the aggregate as it does in the reference.
//
// The trimmed mean stages each thread's column y[c] = x_san * g[c] in shared
// memory (C*F*4 bytes; a thread reads only its own column, so no barrier is
// needed for it). The reference's pass i takes the minimum (maximum) and
// retires its first occurrence, and a retired slot then reads TRIM_BIG
// (-TRIM_BIG). Retiring first occurrences extracts in (value, index) order,
// so pass i here takes the successor of pass i-1's (value, index) in that
// order, capped at TRIM_BIG from the second pass on, where a retired slot is
// a candidate. That needs no per-client state, whatever C is. Compares are
// plain < / > (fminf / fmaxf would drop a NaN). bot and top sum in
// extraction order; the plain version sums a sorted slice, so the two agree
// to rounding, not bitwise.
//
// Scenario batching: blockIdx.y is the scenario; each CTA offsets to its
// scenario and does a single CTA's work in the same order, so one batched
// launch is bitwise S single launches. No float atomics anywhere: every run
// gives the same bits. Beyond that the design does nothing about the launch
// cost yet: vectorised loads and more CTAs than P are later work.

#include <cuda_runtime.h>

namespace {

constexpr float kTrimBig = 3.0e38f;

__global__ void robust_agg_kernel(
    const float* __restrict__ x, const float* __restrict__ ef,
    const float* __restrict__ m, const float* __restrict__ q,
    const float* __restrict__ g, const float* __restrict__ w_pos,
    const float* __restrict__ w_or_den, const float* __restrict__ screen,
    const float* __restrict__ trim_gate, float* __restrict__ agg,
    float* __restrict__ ef_out, int C, int P, int F, int per_coord,
    int trim_k, float eps) {
  extern __shared__ float smem[];
  float* vld = smem;     // (C,) trim validity of each client's packet p
  float* ys = smem + C;  // (C, F) trim estimates; column f is thread f's
  const int p = blockIdx.x;
  const int f = threadIdx.x;
  const size_t sc = blockIdx.y;  // scenario
  x += sc * C * P * F;
  if (ef != nullptr) {
    ef += sc * C * P * F;
    ef_out += sc * C * P * F;
  }
  m += sc * C * P;
  q += sc * C;
  if (trim_k > 0) {
    g += sc * C;
    w_pos += sc * C;
  }
  w_or_den += per_coord ? sc * C : sc;
  agg += sc * P * F;
  const bool scr = screen[sc] > 0.5f;

  float acc = 0.f;
  float den = 0.f;
  for (int c = 0; c < C; ++c) {
    const float mc = m[(size_t)c * P + p];
    const size_t i = ((size_t)c * P + p) * F + f;
    float xe = x[i];
    if (ef != nullptr) xe += ef[i];
    const bool fin = isfinite(xe);
    const bool ok = __syncthreads_and(fin);
    const float me = scr ? mc * (ok ? 1.f : 0.f) : mc;
    const float xs = (scr && !fin) ? 0.f : xe;
    const float wm = me * q[c];
    if (per_coord) den += me * w_or_den[c];
    acc += xs * wm;
    if (ef != nullptr) ef_out[i] = xs * (1.f - mc);
    if (trim_k > 0) {
      ys[(size_t)c * F + f] = xs * g[c];
      if (f == 0) vld[c] = me * w_pos[c];
    }
  }
  // max(den, eps) that keeps a NaN, as torch.clamp does
  const float d = per_coord ? (den < eps ? eps : den) : w_or_den[0];
  float out = acc / d;

  if (trim_k > 0) {
    __syncthreads();  // vld was written by thread 0
    float n = 0.f;
    float total = 0.f;
    for (int c = 0; c < C; ++c) {
      n += vld[c];
      total += ys[(size_t)c * F + f] * vld[c];
    }
    float bot = 0.f;
    float top = 0.f;
    // the last extracted (value, client) of each side
    float lo_v = -INFINITY, hi_v = INFINITY;
    int lo_c = -1, hi_c = -1;
    for (int pass = 0; pass < trim_k; ++pass) {
      float bv = kTrimBig;
      int bc = -1;
      for (int c = 0; c < C; ++c) {
        const float v = vld[c] > 0.f ? ys[(size_t)c * F + f] : kTrimBig;
        const bool after = v > lo_v || (v == lo_v && c > lo_c);
        if (after && (bc < 0 || v < bv)) {
          bv = v;
          bc = c;
        }
      }
      if (bc >= 0) {
        lo_v = bv;
        lo_c = bc;
      }
      bot += (pass > 0 && !(bv < kTrimBig)) ? kTrimBig : bv;

      bv = -kTrimBig;
      bc = -1;
      for (int c = 0; c < C; ++c) {
        const float v = vld[c] > 0.f ? ys[(size_t)c * F + f] : -kTrimBig;
        const bool after = v < hi_v || (v == hi_v && c > hi_c);
        if (after && (bc < 0 || v > bv)) {
          bv = v;
          bc = c;
        }
      }
      if (bc >= 0) {
        hi_v = bv;
        hi_c = bc;
      }
      top += (pass > 0 && !(bv > -kTrimBig)) ? -kTrimBig : bv;
    }
    const float two_k = 2.f * (float)trim_k;
    const float cnt = n - two_k < 1.f ? 1.f : n - two_k;
    const float trimmed = n > two_k ? (total - top - bot) / cnt
                                    : total / (n < 1.f ? 1.f : n);
    if (trim_gate[sc] > 0.5f) out = trimmed;
  }
  agg[(size_t)p * F + f] = out;
}

}  // namespace

extern "C" {

// Launches the robust aggregation of S scenarios on `stream`, one CTA per
// (packet row, scenario) and one thread per float of the row. ef/ef_out are
// both null or both set; g and w_pos are read only when trim_k > 0. Returns
// the first CUDA error, or cudaGetLastError() after the launch.
int robust_agg_launch(const void* x, const void* ef, const void* m,
                      const void* q, const void* g, const void* w_pos,
                      const void* w_or_den, const void* screen,
                      const void* trim_gate, void* agg, void* ef_out, int S,
                      int C, int P, int F, int per_coord, int trim_k,
                      float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      trim_k > 0 ? (size_t)C * (size_t)(F + 1) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(robust_agg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(P, S);
  robust_agg_kernel<<<grid, F, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ef),
      static_cast<const float*>(m), static_cast<const float*>(q),
      static_cast<const float*>(g), static_cast<const float*>(w_pos),
      static_cast<const float*>(w_or_den), static_cast<const float*>(screen),
      static_cast<const float*>(trim_gate), static_cast<float*>(agg),
      static_cast<float*>(ef_out), C, P, F, per_coord, trim_k, eps);
  return (int)cudaGetLastError();
}

const char* robust_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
