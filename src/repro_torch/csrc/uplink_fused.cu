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
// scalar max(sum_c w[c], eps) read from device memory. ssq is written as
// per-(packet, tile) partials; the op sums them in a fixed order. x and ef
// may be bf16 (the stream dtype): they are upcast on load, everything
// accumulates in fp32, and ef_out is written back in the stream dtype
// (round to nearest even, as torch's .to(bfloat16) does).
//
// What bounds it: bytes. At the main-path shape (C=10, P=36, F=256, f32,
// no EF) the call must read x (368,640 B), m (1,440 B), q and den, and
// write agg (36,864 B) and the ssq partials (1,440 B): about 0.41 MB, or
// 0.12 us at the H100's 3.35 TB/s. Its ~0.4 MFLOP are negligible. A launch
// costs microseconds, so at that shape the kernel is bound by latency: the
// dependent trips to memory a CTA makes. The tiling shape (64, 1024, 256)
// with EF moves 203 MB (60 us), where the loads in flight per SM set the
// rate.
//
// Design: a CTA per (packet row, tile of the row, scenario); each thread
// owns V consecutive floats of its tile (a tile is V * blockDim floats),
// so F has no bound and any F >= 1 is taken. V is 4 where the grid has
// CTAs enough to fill the card (the bursty grid, the tiling shapes) and 1
// where it has not (the quickstart's 36 rows): there each SM runs one CTA,
// and a thread's serial work, not the memory, sets the time, so a thread
// a float (8 warps) beats 4 floats a thread (2 warps): 3.3 against 4.2 us
// on the H100, and 4.9 against 7.0 us the other way at the bursty grid's
// 972 rows. V sets the norms' sum order, so with ssq the binding picks it
// from one scenario's rows, and a batched launch keeps the bits of its
// single launches.
// The clients go in chunks of `chunk` (at most kChunk). For a chunk each
// thread issues an asynchronous copy (cp.async) of its floats of every
// client's row, x and ef, into shared memory: one 16-byte copy per row (8
// bytes in bf16) where V = 4, F % 4 == 0 and the operands are aligned
// (`vec`), else one per float (a plain load for a bf16 float, which is
// below cp.async's least size); the first threads copy the chunk's
// per-client scalars
// (m, q, w) the same way. It then waits for its own copies. So a chunk's
// loads are all in flight at once, from loops that stay rolled (a CTA
// lives a few microseconds and fetches each instruction about once; the
// robust_agg kernel's probes on the H100 showed unrolled bodies cost more).
// A thread reads back only its own floats, so the rows need no barrier.
// With ssq, each thread sums its floats' squares per client, a warp sums
// the chunk's clients' at once with a transposed butterfly (16 shuffles, 5
// deep, not 5 a client), and one lane writes one word per (client, warp);
// then ONE __syncthreads per chunk makes those words and the scalars
// visible, and thread j sums client j's words over the warps in order. The
// chunk's scalars and words are double-buffered, so that one barrier per
// chunk suffices (a thread writing chunk i+2's buffer has passed chunk
// i+1's barrier, which no thread reaches before it is done reading chunk
// i's).
// The parent kernel took two barriers per client, each waiting on that
// client's load: at C = 10 ten dependent trips, now one.
//
// The numerator and the per_coord denominator accumulate in registers,
// client by client in index order, with the same expressions as before
// (xe = x + ef, acc += xe * wm, den += mc * w), so agg and ef_out are
// bitwise the parent kernel's, and the robust_agg kernel with its gates off
// is bitwise this one. Only the ssq partials' sum order changed (within
// the plain version's rtol 1e-5). No float atomics anywhere: every run
// gives the same bits.
//
// Scenario batching: blockIdx.y is the scenario; each CTA offsets its
// pointers to its scenario and then does exactly what a single-scenario
// CTA does, in the same order, so one batched launch is bitwise equal to S
// single launches. A single call is the launch with S = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// The most clients per chunk; the binding's CHUNK follows it.
constexpr int kChunk = 16;
// The most warps a CTA has (256 threads); the binding's MAX_THREADS.
constexpr int kMaxWarps = 8;
static_assert(kChunk == 16, "the ssq butterfly spreads 16 sums over 32 lanes");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// Stores 4 floats to an aligned address in one instruction.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}
// Reads 4 staged floats of an aligned group in one instruction.
__device__ __forceinline__ void read4(float (&v)[4], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void read4(float (&v)[4],
                                      const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// Asynchronous copies from device to shared memory, `B` bytes each.
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(B)
                 : "memory");
  }
}

// Waits until this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stages a thread's `nv` (<= V) floats of one row: one copy of the four
// when VEC, else one per float (a bf16 float, 2 bytes, is below cp.async's
// least size: a plain load and store).
template <typename T, int V, bool VEC>
__device__ __forceinline__ void stage(T* dst, const T* src, int nv) {
  if constexpr (VEC) {
    cp_async<int(4 * sizeof(T))>(dst, src);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < nv) cp_async<4>(dst + e, src + e);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < nv) dst[e] = src[e];
  }
}

// A thread's staged floats of one client, x + ef with EF, and 0 past the
// row's end (nv floats are its own).
template <typename T, int V, bool VEC>
__device__ __forceinline__ void load_row(float (&xe)[V], const T* xs,
                                         const T* es, bool with_ef, int nv) {
  if constexpr (VEC) {
    if (nv == V) {
      read4(xe, xs);
      if (with_ef) {
        float ev[4];
        read4(ev, es);
#pragma unroll
        for (int e = 0; e < 4; ++e) xe[e] += ev[e];
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    xe[e] = 0.f;
    if (e < nv) {
      xe[e] = to_f32(xs[e]);
      if (with_ef) xe[e] += to_f32(es[e]);
    }
  }
}

// V: the floats a thread owns (1 or 4). VEC (V = 4 only): F % 4 == 0 and
// x, ef 16-byte (f32) or 8-byte (bf16) aligned, so each thread's 4 floats
// are whole and aligned in every row.
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32) uplink_fused_kernel(
    const T* __restrict__ x, const T* __restrict__ ef,
    const float* __restrict__ m, const float* __restrict__ q,
    const float* __restrict__ w_or_den, float* __restrict__ agg,
    T* __restrict__ ef_out, float* __restrict__ ssq, int C, int P, int F,
    int per_coord, float eps, int chunk, int tiles) {
  static_assert(V == 1 || V == 4, "a thread owns 1 or 4 floats");
  static_assert(!VEC || V == 4, "vector copies are of 4 floats");
  // the chunk's x rows (chunk, span), then its ef rows (chunk, span) with EF
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per chunk, double-buffered: the scalars and each warp's ssq words
  __shared__ float s_m[2][kChunk], s_q[2][kChunk], s_w[2][kChunk];
  __shared__ float s_ss[2][kChunk][kMaxWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = blockDim.x >> 5;
  const int span = blockDim.x * V;  // a tile's floats
  const int p = blockIdx.x / tiles;
  const int tile = blockIdx.x - p * tiles;
  const size_t sc = blockIdx.y;  // scenario
  const size_t plane = (size_t)P * F;  // one client's floats
  x += sc * C * plane;
  if (ef != nullptr) {
    ef += sc * C * plane;
    ef_out += sc * C * plane;
  }
  m += sc * C * P;
  q += sc * C;
  w_or_den += per_coord ? sc * C : sc;
  agg += sc * plane;
  const size_t n_part = (size_t)P * tiles;  // ssq partials per client
  if (ssq != nullptr) ssq += sc * C * n_part;
  const float den_ready = per_coord ? 0.f : w_or_den[0];
  const int f0 = tile * span + V * t;  // this thread's first float
  const int nv = F - f0 < 0 ? 0 : (F - f0 < V ? F - f0 : V);
  const size_t col = (size_t)p * F + f0;  // ... in a plane
  T* xr = reinterpret_cast<T*>(smem_raw) + V * t;  // row j: xr[j * span]
  T* er = xr + (size_t)chunk * span;

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  float den = 0.f;
  for (int c0 = 0, b = 0; c0 < C; c0 += chunk, b ^= 1) {
    const int nc = C - c0 < chunk ? C - c0 : chunk;
    if (nv > 0) {
      const T* xg = x + (size_t)c0 * plane + col;
      for (int j = 0; j < nc; ++j)
        stage<T, V, VEC>(xr + (size_t)j * span, xg + j * plane, nv);
      if (ef != nullptr) {
        const T* eg = ef + (size_t)c0 * plane + col;
        for (int j = 0; j < nc; ++j)
          stage<T, V, VEC>(er + (size_t)j * span, eg + j * plane, nv);
      }
    }
    if (t < nc) {
      const int c = c0 + t;
      cp_async<4>(&s_m[b][t], m + (size_t)c * P + p);
      cp_async<4>(&s_q[b][t], q + c);
      if (per_coord) cp_async<4>(&s_w[b][t], w_or_den + c);
    }
    cp_async_wait_all();
    if (ssq != nullptr) {
      // each client's sum of squares over this thread's floats, then over
      // the warp by a transposed butterfly: a step of width 2h sends h of
      // each lane's sums to its partner and keeps the other h, so the
      // chunk's 16 sums take 16 shuffles, 5 deep, and lane L ends with
      // client c(L)'s (lane bits 4..1, high to low)
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = 0.f;
        if (j < nc) {
          float xe[V];
          load_row<T, V, VEC>(xe, xr + (size_t)j * span,
                              er + (size_t)j * span, ef != nullptr, nv);
#pragma unroll
          for (int e = 0; e < V; ++e) s[j] += xe[e] * xe[e];
        }
      }
#pragma unroll
      for (int step = 0; step < 4; ++step) {
        const int h = (kChunk / 2) >> step;  // 8, 4, 2, 1
        const bool up = lane & (2 * h);
#pragma unroll
        for (int j = 0; j < h; ++j) {
          const float send = up ? s[j] : s[j + h];
          const float keep = up ? s[j + h] : s[j];
          s[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * h);
        }
      }
      s[0] += __shfl_xor_sync(0xffffffffu, s[0], 1);
      const int c = (lane >> 1 & 1) | (lane >> 2 & 1) << 1 |
                    (lane >> 3 & 1) << 2 | (lane >> 4 & 1) << 3;
      if (!(lane & 1) && c < nc) s_ss[b][c][warp] = s[0];
    }
    __syncthreads();  // the chunk's one barrier
    if (ssq != nullptr && t < nc) {
      float s = 0.f;
      for (int w = 0; w < n_warps; ++w) s += s_ss[b][t][w];
      ssq[(size_t)(c0 + t) * n_part + (size_t)p * tiles + tile] =
          s * s_m[b][t];
    }
    for (int j = 0; j < nc; ++j) {
      const float mc = s_m[b][j];
      const float wm = mc * s_q[b][j];
      if (per_coord) den += mc * s_w[b][j];
      float xe[V];
      load_row<T, V, VEC>(xe, xr + (size_t)j * span, er + (size_t)j * span,
                          ef != nullptr, nv);
      if (ef != nullptr) {
        float out[V];
#pragma unroll
        for (int e = 0; e < V; ++e) out[e] = xe[e] * (1.f - mc);
        T* dst = ef_out + (size_t)(c0 + j) * plane + col;
        if constexpr (VEC) {
          if (nv == V) store4(dst, out);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (e < nv) store_from_f32(dst + e, out[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += xe[e] * wm;
    }
  }
  // max(den, eps) that keeps a NaN, as torch.clamp does
  const float d = per_coord ? (den < eps ? eps : den) : den_ready;
  float out[V];
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = acc[e] / d;
  if constexpr (VEC) {
    if (nv == V) store4(agg + col, out);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < nv) agg[col + e] = out[e];
  }
}

template <typename T, int V, bool VEC>
void launch(const void* x, const void* ef, const float* m, const float* q,
            const float* wd, float* agg, void* ef_out, float* ssq, int S,
            int C, int P, int F, int per_coord, float eps, int chunk,
            int threads, int tiles, int smem, cudaStream_t s) {
  const dim3 grid(P * tiles, S);
  uplink_fused_kernel<T, V, VEC><<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(ef), m, q, wd, agg,
      static_cast<T*>(ef_out), ssq, C, P, F, per_coord, eps, chunk, tiles);
}

using LaunchFn = void (*)(const void*, const void*, const float*,
                          const float*, const float*, float*, void*, float*,
                          int, int, int, int, int, float, int, int, int, int,
                          cudaStream_t);

template <typename T>
LaunchFn pick(int floats, int vec) {
  if (floats == 1) return &launch<T, 1, false>;
  return vec ? &launch<T, 4, true> : &launch<T, 4, false>;
}

}  // namespace

extern "C" {

// Launches the fused uplink step of S scenarios on `stream`: P * tiles CTAs
// of `threads` threads (whole warps, at most kMaxWarps) per scenario, each
// thread over `floats` (1 or 4) floats of its tile, the clients in chunks
// of `chunk` (1..kChunk), `smem` bytes of dynamic shared memory (chunk *
// threads * floats elements of the stream dtype, twice that with EF): the
// binding's plan. `vec` as the kernel's VEC (floats = 4 only). ef/ef_out
// are both null or both set; ssq may be null, else (S, C, P * tiles)
// partials. Returns the first CUDA error, or cudaGetLastError() after the
// launch.
int uplink_fused_launch(const void* x, const void* ef, const void* m,
                        const void* q, const void* w_or_den, void* agg,
                        void* ef_out, void* ssq, int S, int C, int P, int F,
                        int is_bf16, int per_coord, float eps, int chunk,
                        int threads, int tiles, int floats, int smem,
                        int vec, int device, void* stream) {
  if (chunk < 1 || chunk > kChunk || threads < 32 || threads % 32 ||
      threads > kMaxWarps * 32 || tiles < 1 ||
      (floats != 1 && floats != 4) || (vec && floats != 4))
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  const LaunchFn run = is_bf16 ? pick<__nv_bfloat16>(floats, vec)
                               : pick<float>(floats, vec);
  run(x, ef, static_cast<const float*>(m), static_cast<const float*>(q),
      static_cast<const float*>(w_or_den), static_cast<float*>(agg), ef_out,
      static_cast<float*>(ssq), S, C, P, F, per_coord, eps, chunk, threads,
      tiles, smem, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

const char* uplink_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
