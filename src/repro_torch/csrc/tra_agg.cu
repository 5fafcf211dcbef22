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
// Design: a CTA covers `rows` whole packet rows (several only where F is
// under 256, so that a warp has work), or one tile of 1024 floats of a
// row wider than that; each thread owns 4 consecutive floats of it. The
// clients go in chunks of `chunk` (at most kChunk). For a chunk each thread
// first issues an asynchronous copy (cp.async) of its floats of every
// client into shared memory, from a rolled loop: one 16-byte copy a client
// where F % 4 == 0 and x is aligned (`vec`), else one a float. So at
// (16, 1024, 256) each thread has 16 copies of 16 bytes in flight, without
// holding them in registers (which cost occupancy), where the parent
// kernel (a thread a float, the loop over C in index order) waited on
// loads of 4 bytes. Meanwhile the CTA stages each client's mask weights of
// its rows, wm = m[c,p] * w[c], once in shared memory (double-buffered:
// one barrier a chunk), so those trips to memory overlap the copies. A
// thread reads back only its own floats.
//
// num and den accumulate in registers in client index order with the
// parent's expressions (wm = m * w, num += wm * x, den += wm), so the
// output is bitwise the parent kernel's. No float atomics: every run gives
// the same bits.
//
// Scenario batching: under vmap the operands carry a leading S.
// blockIdx.y is the scenario; each CTA offsets its pointers to its
// scenario and then does exactly what a single launch's CTA does, so one
// batched launch is bitwise S single launches.

#include <cuda_runtime.h>

namespace {

// The most clients whose loads are in flight together; the binding's
// CHUNK follows it.
constexpr int kChunk = 16;
// The most packet rows a CTA covers; the binding's MAX_ROWS.
constexpr int kMaxRows = 32;
// The floats of a tile of a row wider than kTile; the binding's TILE.
constexpr int kTile = 1024;

// Copies B bytes from device memory to shared memory without waiting.
template <int B>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  }
}

// Waits until this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// VEC: F % 4 == 0 and x 16-byte aligned, so a thread's 4 floats are whole
// and aligned in one row.
template <bool VEC>
__global__ void __launch_bounds__(kTile / 4) tra_agg_kernel(
    const float* __restrict__ x, const float* __restrict__ m,
    const float* __restrict__ w, float* __restrict__ out, int C, int P,
    int F, float eps, int rows, int tiles, int chunk) {
  // the chunk's rows of x (chunk, 4 * blockDim)
  extern __shared__ __align__(16) float sx[];
  // per chunk, double-buffered: the mask weights (client, row)
  __shared__ float s_wm[2][kChunk][kMaxRows];
  const int t = threadIdx.x;
  const int span = 4 * blockDim.x;
  const int blk = blockIdx.x / tiles;
  const int tile = blockIdx.x - blk * tiles;
  const int p0 = blk * rows;
  const int nrows = P - p0 < rows ? P - p0 : rows;
  const size_t sc = blockIdx.y;  // scenario
  const size_t PF = (size_t)P * F;
  x += sc * C * PF;
  m += sc * C * P;
  w += sc * C;
  out += sc * PF;
  // the CTA's floats: [lo, lo + len) of the plane, len <= kTile
  const size_t lo = (size_t)p0 * F + (size_t)tile * kTile;
  const int len = tiles > 1
                      ? (F - tile * kTile < kTile ? F - tile * kTile : kTile)
                      : nrows * F;
  const int l0 = 4 * t;  // this thread's first float in the CTA
  const int nv = len - l0 < 0 ? 0 : (len - l0 < 4 ? len - l0 : 4);
  int r[4];  // each float's row in the CTA (the last, past its floats)
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int re = tiles > 1 ? 0 : (l0 + e) / F;
    r[e] = re < nrows ? re : nrows - 1;
  }
  const float* xt = x + lo + l0;
  float* xr = sx + l0;  // client j's floats: xr[j * span]

  float num[4] = {0.f, 0.f, 0.f, 0.f};
  float den[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0, b = 0; c0 < C; c0 += chunk, b ^= 1) {
    const int nc = C - c0 < chunk ? C - c0 : chunk;
    // the chunk's loads go out first, so that they overlap the staging
    if (nv > 0) {
      for (int j = 0; j < nc; ++j) {
        const float* src = xt + (size_t)(c0 + j) * PF;
        if (VEC) {
          cp_async<16>(xr + (size_t)j * span, src);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < nv) cp_async<4>(xr + (size_t)j * span + e, src + e);
        }
      }
    }
    for (int i = t; i < nc * nrows; i += blockDim.x) {
      const int j = i / nrows;
      const int rr = i - j * nrows;
      s_wm[b][j][rr] = m[(size_t)(c0 + j) * P + p0 + rr] * w[c0 + j];
    }
    cp_async_wait_all();
    __syncthreads();  // the chunk's one barrier
    for (int j = 0; j < nc; ++j) {
      if (VEC) {
        // one row, one weight, one 16-byte read for the 4 floats
        const float4 v =
            *reinterpret_cast<const float4*>(xr + (size_t)j * span);
        const float wm = s_wm[b][j][r[0]];
        num[0] += wm * v.x;
        num[1] += wm * v.y;
        num[2] += wm * v.z;
        num[3] += wm * v.w;
        den[0] += wm;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = e < nv ? xr[(size_t)j * span + e] : 0.f;
          const float wm = s_wm[b][j][r[e]];
          num[e] += wm * v;
          den[e] += wm;
        }
      }
    }
  }
  if (VEC) den[1] = den[2] = den[3] = den[0];
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = num[e] / (den[e] < eps ? eps : den[e]);
  float* dst = out + lo + l0;
  if (VEC && nv == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < nv) dst[e] = o[e];
  }
}

}  // namespace

extern "C" {

// Launches the aggregate of S scenarios on `stream`: ceil(P / rows) * tiles
// CTAs of `threads` threads per scenario, the clients in chunks of `chunk`
// (1..kChunk) with `smem` bytes of dynamic shared memory (chunk * threads
// * 4 floats): the binding's plan (`rows` whole rows a CTA, or `tiles`
// tiles of kTile floats a row when tiles > 1, each thread over 4 floats).
// `vec` as the kernel's VEC. Returns the first CUDA error, or
// cudaGetLastError() after the launch.
int tra_agg_launch(const void* x, const void* m, const void* w, void* out,
                   int S, int C, int P, int F, float eps, int rows,
                   int tiles, int threads, int chunk, int smem, int vec,
                   int device, void* stream) {
  if (rows < 1 || rows > kMaxRows || tiles < 1 || threads < 32 ||
      threads % 32 || threads > kTile / 4 || (tiles > 1 && rows != 1) ||
      chunk < 1 || chunk > kChunk)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((P + rows - 1) / rows * tiles), S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(m);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (vec)
    tra_agg_kernel<true><<<grid, threads, smem, s>>>(
        xf, mf, wf, of, C, P, F, eps, rows, tiles, chunk);
  else
    tra_agg_kernel<false><<<grid, threads, smem, s>>>(
        xf, mf, wf, of, C, P, F, eps, rows, tiles, chunk);
  return (int)cudaGetLastError();
}

const char* tra_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
