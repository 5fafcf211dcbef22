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
// 3.35 TB/s. A launch costs microseconds, so there the kernel is bound by
// latency: the dependent trips to memory a CTA makes, the instructions it
// fetches once each, and each thread's serial work over the clients. The
// recipe's 9-cell grid moves about 4.3 MB (1.3 us); the tiling shape
// (64, 1024, 256) with EF about 202 MB (60 us), where the loads in flight
// per SM set the rate. The trim's compares, about 4K per client and
// output, are far below the fp32 rate.
//
// Design: one CTA per (packet row, scenario), one thread per float of the
// row: blockDim is F rounded up to whole warps (F <= 1024), and the lanes
// past F copy and compute the row's last float again, which leaves the
// screen's AND as it is, and store nothing. The clients go in chunks of `chunk` (kChunk, or C if
// fewer). For a chunk, each thread first issues an asynchronous copy
// (cp.async) of each of its clients' floats, x and ef, into shared memory,
// and the first threads copy
// the chunk's per-client scalars (m, q, w, g, w_pos) the same way; then it
// waits for its own copies. So the chunk's loads are all in flight at once,
// from a loop that stays rolled: a CTA of this kernel runs for a few
// microseconds and fetches each instruction about once, so code that
// unrolls 16 clients costs more than it saves (probed on the H100). A
// thread reads only its own column of the staged rows, so they need no
// barrier. The screen of a packet is an AND over the CTA's row: each warp
// ORs its per-client "not finite" bits with one __reduce_or_sync and writes
// one word (a bit per client) to shared memory; after ONE __syncthreads
// every thread ORs the words of all warps. The chunk's words and scalars are
// double-buffered, so that one barrier per chunk suffices: a thread writing
// chunk i+2's buffer has passed chunk i+1's barrier, which no thread reaches
// before it is done reading chunk i's. The recipe's C = 12 clients take one
// barrier, not one a client, each waiting on that client's load.
//
// The numerator and the per_coord denominator then accumulate in registers
// client by client in index order, with the uplink kernel's expressions, so
// with every gate off the aggregate is bitwise uplink_fused's. There is no
// branch on m == 0: NaN * 0 = NaN, as on the TPU, so an undefended NaN upload
// poisons the aggregate as it does in the reference.
//
// The trimmed mean runs in the same loop over the clients, in index order,
// in registers: per coordinate it sums n and total and keeps the K smallest
// and the K largest of the clients' values lo(c) = valid ? y : TRIM_BIG and
// hi(c) = valid ? y : -TRIM_BIG (y = x_san * g[c]), each as a sorted list
// into which every client's value is inserted by compare-and-select, no
// branch on the data. K, a template parameter, is trim_k rounded up to a
// power of two (at most 16); slots past trim_k go unread. The reference's
// pass i takes the minimum (maximum), retires its first occurrence, and a
// retired slot then reads TRIM_BIG (-TRIM_BIG): so pass i takes the i-th
// value of the (value, index) order, which is slot i of the list, and any
// value from the second pass on that is not below TRIM_BIG (above
// -TRIM_BIG), or missing, counts as TRIM_BIG (-TRIM_BIG). A NaN is never
// taken (its compares are false), as in the reference; a valid NaN makes
// total, and so the result, NaN in both. bot and top sum
// the slots in pass order; the plain version sums a sorted slice, so the
// two agree to rounding, not bitwise. This takes the reference's k passes
// over C per coordinate down to one, with no shared-memory column and no
// barrier: k passes over a staged column cost 2.4 of 5.1 us at C = 12,
// k = 2 on the H100, the one pass about 0.8.
//
// trim_k > 16 (K = kPass): the reference's k passes themselves. The client
// loop writes each client's trim estimate y into a column (C, F) and its
// validity into (C,), in shared memory beside the chunk's rows where they
// fit the opt-in limit, else in a scratch buffer in device memory that the
// binding allocates (one column per CTA); one barrier after the loop, then
// each thread runs trim_k passes per side over its own column: pass i takes
// the (value, index) successor of pass i-1's extraction, as the reference's
// retirement of first occurrences does, an invalid client reads
// +-TRIM_BIG, a NaN is never taken, and from the second pass on a value not
// below TRIM_BIG (above -TRIM_BIG) counts as TRIM_BIG. n and total sum in
// the client loop as for K > 0, so both paths give the bits of the k-pass
// extraction.
//
// Scenario batching: blockIdx.y is the scenario; each CTA offsets to its
// scenario and does a single CTA's work in the same order, so one batched
// launch is bitwise S single launches. No float atomics anywhere: every run
// gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr float kTrimBig = 3.0e38f;
// The most clients per chunk (one bit each in a warp's screen word). The
// binding's CHUNK follows it.
constexpr int kChunk = 16;
constexpr int kMaxWarps = 32;
constexpr int kMaxDevices = 64;
// The instance of the k-pass extraction over a column (trim_k > 16).
constexpr int kPass = -1;

// Copies 4 bytes from device memory to shared memory without waiting.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Waits until this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K: the trimmed mean's list length (0: no trim; kPass: k passes over a
// column, in shared memory after the chunk's rows or, where `column` is not
// null, in device memory; else trim_k <= K). TAIL: F % 32 != 0, so that the
// CTA has lanes past F (probed on the H100: guarding them cost 0.2-0.4 us
// at the recipe's shape, so whole warps keep the unguarded code).
template <int K, bool TAIL>
__global__ void __launch_bounds__(1024) robust_agg_kernel(
    const float* __restrict__ x, const float* __restrict__ ef,
    const float* __restrict__ m, const float* __restrict__ q,
    const float* __restrict__ g, const float* __restrict__ w_pos,
    const float* __restrict__ w_or_den, const float* __restrict__ screen,
    const float* __restrict__ trim_gate, float* __restrict__ agg,
    float* __restrict__ ef_out, float* __restrict__ column, int C, int P,
    int F, int per_coord, int trim_k, float eps, int chunk) {
  // the chunk's x rows (chunk, F), then its ef rows (chunk, F) with EF;
  // for kPass then the column's validity (C,) and estimates (C, F)
  extern __shared__ float smem[];
  // per chunk, double-buffered: each warp's "not finite" bits (bit j for
  // client c0 + j) and the chunk's per-client scalars
  __shared__ unsigned s_bad[2][kMaxWarps];
  __shared__ float s_m[2][kChunk], s_q[2][kChunk], s_w[2][kChunk];
  __shared__ float s_g[2][kChunk], s_wp[2][kChunk];
  const int p = blockIdx.x;
  const int f = threadIdx.x;
  // the lanes past F copy and compute the row's last float again (in
  // their own shared slots: rows are blockDim apart), which leaves the
  // screen's AND as it is, and store nothing
  const bool lane_on = !TAIL || f < F;
  const int ld = TAIL ? blockDim.x : F;  // a chunk row's stride in smem
  const int lane = f & 31;
  const int warp = f >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t sc = blockIdx.y;  // scenario
  const size_t plane = (size_t)P * F;  // one client's floats
  x += sc * C * plane;
  if (ef != nullptr) {
    ef += sc * C * plane;
    ef_out += sc * C * plane;
  }
  m += sc * C * P;
  q += sc * C;
  if constexpr (K != 0) {
    g += sc * C;
    w_pos += sc * C;
  }
  w_or_den += per_coord ? sc * C : sc;
  agg += sc * plane;
  // the gates and the ready denominator load first, so that their trips
  // to memory overlap the chunk's instead of following the last one
  const bool scr = screen[sc] > 0.5f;
  const bool trg = K != 0 && trim_gate[sc] > 0.5f;
  const float den_ready = per_coord ? 0.f : w_or_den[0];
  // this thread's float in a plane
  const size_t col = (size_t)p * F + (TAIL && !lane_on ? F - 1 : f);
  float* xr = smem + f;  // row j of the chunk: xr[j * ld]
  float* er = smem + (size_t)chunk * ld + f;
  // kPass: the column, validity first
  float* vld = nullptr;
  float* ys = nullptr;
  if constexpr (K == kPass) {
    vld = column != nullptr
              ? column + ((size_t)sc * P + p) * (size_t)C * (F + 1)
              : smem + (size_t)chunk * ld * (ef != nullptr ? 2 : 1);
    ys = vld + C;
  }

  float acc = 0.f;
  float den = 0.f;
  // the trimmed mean's state: n, total, the K smallest lo and K largest hi
  // values
  constexpr int KS = K > 0 ? K : 1;
  float n = 0.f, total = 0.f, lo[KS], hi[KS];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    lo[i] = INFINITY;
    hi[i] = -INFINITY;
  }
  for (int c0 = 0, b = 0; c0 < C; c0 += chunk, b ^= 1) {
    const int nc = C - c0 < chunk ? C - c0 : chunk;
    const float* xg = x + (size_t)c0 * plane + col;
    for (int j = 0; j < nc; ++j)
      cp_async4(xr + (size_t)j * ld, xg + j * plane);
    if (ef != nullptr) {
      const float* eg = ef + (size_t)c0 * plane + col;
      for (int j = 0; j < nc; ++j)
        cp_async4(er + (size_t)j * ld, eg + j * plane);
    }
    if (f < nc) {
      const int c = c0 + f;
      cp_async4(&s_m[b][f], m + (size_t)c * P + p);
      cp_async4(&s_q[b][f], q + c);
      if (per_coord) cp_async4(&s_w[b][f], w_or_den + c);
      if constexpr (K != 0) {
        cp_async4(&s_g[b][f], g + c);
        cp_async4(&s_wp[b][f], w_pos + c);
      }
    }
    cp_async_wait_all();
    unsigned bad = 0u;
    for (int j = 0; j < nc; ++j) {
      float xe = xr[(size_t)j * ld];
      if (ef != nullptr) xe += er[(size_t)j * ld];
      if (!isfinite(xe)) bad |= 1u << j;
    }
    bad = __reduce_or_sync(0xffffffffu, bad);
    if (lane == 0) s_bad[b][warp] = bad;
    __syncthreads();  // the chunk's one barrier
    bad = __reduce_or_sync(0xffffffffu, lane < n_warps ? s_bad[b][lane] : 0u);

    for (int j = 0; j < nc; ++j) {
      const int c = c0 + j;
      float xe = xr[(size_t)j * ld];
      if (ef != nullptr) xe += er[(size_t)j * ld];
      const float mc = s_m[b][j];
      const bool fin = isfinite(xe);
      const bool ok = !((bad >> j) & 1u);
      const float me = scr ? mc * (ok ? 1.f : 0.f) : mc;
      const float xs = (scr && !fin) ? 0.f : xe;
      const float wm = me * s_q[b][j];
      if (per_coord) den += me * s_w[b][j];
      acc += xs * wm;
      if (ef != nullptr && lane_on)
        ef_out[(size_t)c * plane + col] = xs * (1.f - mc);
      if constexpr (K == kPass) {
        const float y = xs * s_g[b][j];
        const float v = me * s_wp[b][j];
        n += v;
        total += y * v;
        if (lane_on) ys[(size_t)c * F + f] = y;
        if (f == 0) vld[c] = v;
      } else if constexpr (K > 0) {
        const float y = xs * s_g[b][j];
        const float v = me * s_wp[b][j];
        n += v;
        total += y * v;
        const float l = v > 0.f ? y : kTrimBig;
        const float h = v > 0.f ? y : -kTrimBig;
        // insert into the sorted lists, by selects (nested, the compiler
        // makes them branches, which diverge); a NaN moves nothing
#pragma unroll
        for (int i = KS - 1; i > 0; --i) {
          const float lt = l < lo[i] ? l : lo[i];
          const float ht = h > hi[i] ? h : hi[i];
          lo[i] = l < lo[i - 1] ? lo[i - 1] : lt;
          hi[i] = h > hi[i - 1] ? hi[i - 1] : ht;
        }
        lo[0] = l < lo[0] ? l : lo[0];
        hi[0] = h > hi[0] ? h : hi[0];
      }
    }
  }
  // max(den, eps) that keeps a NaN, as torch.clamp does
  const float d = per_coord ? (den < eps ? eps : den) : den_ready;
  float out = acc / d;

  if constexpr (K == kPass) {
    __syncthreads();  // vld was written by thread 0
    if (lane_on) {
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
      if (trg) out = trimmed;
    }
  } else if constexpr (K > 0) {
    // pass i's value: slot i; from pass 1 on capped at +-TRIM_BIG, which a
    // missing slot (+-inf) reads too. Where a valid value is NaN the
    // reference takes it in no pass, but total is NaN, and so is the
    // result whatever the slots hold.
    float bot = 0.f;
    float top = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      if (i < trim_k) {
        bot += i == 0 ? lo[0] : (lo[i] < kTrimBig ? lo[i] : kTrimBig);
        top += i == 0 ? hi[0] : (hi[i] > -kTrimBig ? hi[i] : -kTrimBig);
      }
    }
    const float two_k = 2.f * (float)trim_k;
    const float cnt = n - two_k < 1.f ? 1.f : n - two_k;
    const float trimmed = n > two_k ? (total - top - bot) / cnt
                                    : total / (n < 1.f ? 1.f : n);
    if (trg) out = trimmed;
  }
  if (lane_on) agg[col] = out;
}

// The dynamic shared memory each instance (slots 0, 1, 2, 4, 8, 16 and
// kPass, without and with lanes past F) was opted into on each device, so
// that cudaFuncSetAttribute runs once per process, device, instance and
// larger size.
int g_smem_opt[kMaxDevices][7][2];

// The instance for `slots` list slots, with or without lanes past F.
template <int K>
decltype(&robust_agg_kernel<0, false>) instance(bool tail) {
  return tail ? &robust_agg_kernel<K, true> : &robust_agg_kernel<K, false>;
}


}  // namespace

extern "C" {

// Launches the robust aggregation of S scenarios on `stream`, one CTA per
// (packet row, scenario) of `threads` threads (F rounded up to whole warps,
// one a float), the clients in chunks of `chunk` (1..kChunk), with `smem`
// bytes of dynamic shared memory (chunk * threads floats, twice that with
// EF, and with the k-pass column in shared memory C * (F + 1) more) and
// the trim's lists `slots` long (0 without the trim, 1, 2, 4, 8 or 16 >=
// trim_k, or kPass for the k passes over a column: in `column`, S * P * C
// * (F + 1) floats of device memory, where it is not null): the binding's
// plan.
// ef/ef_out are both null or both set; g and w_pos are read only when
// trim_k > 0. Returns the first CUDA error, or cudaGetLastError() after the
// launch.
int robust_agg_launch(const void* x, const void* ef, const void* m,
                      const void* q, const void* g, const void* w_pos,
                      const void* w_or_den, const void* screen,
                      const void* trim_gate, void* agg, void* ef_out,
                      void* column, int S, int C, int P, int F,
                      int per_coord, int trim_k, float eps, int chunk,
                      int slots, int smem, int threads, int device,
                      void* stream) {
  const bool tail = F % 32 != 0;
  decltype(&robust_agg_kernel<0, false>) kernel;
  int row;  // the instance's row in g_smem_opt
  switch (slots) {
    case 0: kernel = instance<0>(tail); row = 0; break;
    case 1: kernel = instance<1>(tail); row = 1; break;
    case 2: kernel = instance<2>(tail); row = 2; break;
    case 4: kernel = instance<4>(tail); row = 3; break;
    case 8: kernel = instance<8>(tail); row = 4; break;
    case 16: kernel = instance<16>(tail); row = 5; break;
    case kPass: kernel = instance<kPass>(tail); row = 6; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if ((slots == 0) != (trim_k == 0) || (slots > 0 && trim_k > slots) ||
      threads < F || threads % 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  int* opted =
      device < kMaxDevices ? &g_smem_opt[device][row][tail] : nullptr;
  if (smem > 48 * 1024 && (opted == nullptr || smem > *opted)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (opted != nullptr) *opted = smem;
  }
  const dim3 grid(P, S);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ef),
      static_cast<const float*>(m), static_cast<const float*>(q),
      static_cast<const float*>(g), static_cast<const float*>(w_pos),
      static_cast<const float*>(w_or_den), static_cast<const float*>(screen),
      static_cast<const float*>(trim_gate), static_cast<float*>(agg),
      static_cast<float*>(ef_out), static_cast<float*>(column), C, P, F,
      per_coord, trim_k, eps, chunk);
  return (int)cudaGetLastError();
}

const char* robust_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
