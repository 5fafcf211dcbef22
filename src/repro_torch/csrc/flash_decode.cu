// One-token decode attention against a KV cache (flash decoding), for
// Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces: repro/kernels/flash_decode/flash_decode.py::flash_decode_call,
// the Pallas TPU kernel (its body is _kernel, flash_decode.py:24).
//
// For each batch row b and kv head h, the G query heads of h attend over
// the T cache rows:
//
//   s[g,t] = (q[b,h,g,:] . k[b,t,h,:]) * dh^-0.5 + bias[t]           f32
//   out[b,h,g,:] = sum_t exp(s[g,t] - M) v[b,t,h,:] / max(l, 1e-30)
//
// with M the running max and l = sum_t exp(s[g,t] - M): an online softmax
// in f32, K and V read in their own dtype (f32 or bf16) and widened, the
// output in f32. bias is the additive mask, 0 or -1e30 (ops.decode_bias).
// Both products are in this file's own loops: no library call.
//
// What bounds it: bytes. Every K and V row is read once: 2*B*T*KV*dh*
// sizeof(elem) bytes, beside which q, bias and the output are small. It
// does about 4*B*KV*G*T*dh flops, far below the byte time at G <= 12.
//
// Design. The TPU kernel walks T in order on one core and carries
// (m, l, acc) in VMEM from one T block to the next. CUDA blocks run in no
// order, so this is split-T flash decoding in two passes:
// - Pass 1: one CTA of 4 warps per (T split, head chunk, kv head, b).
//   A row of dh elements is read by a group of `lpr` lanes with 16-byte
//   loads (4 f32 or 8 bf16 a lane; neighbouring lanes, neighbouring
//   addresses), 32/lpr rows per warp at a time. The CTA's query heads
//   (up to GMAX of the G, in registers) each keep their own (m, l, acc)
//   per row group; the dot product is reduced across the group with
//   shuffles. At the end the row groups merge (shuffles within a warp,
//   shared memory across warps, in a fixed order) into the split's
//   (m, l, acc).
// - Pass 2 (only when there is more than one split): one CTA per
//   (g, kv head, b) merges the splits in index order, each weighted by
//   exp(m_s - M), and divides once, at the end. No float atomics.
// - The number of splits comes from T and B*KV (plan() in
//   kernels/flash_decode/flash_decode.py): enough CTAs for about 8 a SM,
//   so that the slice's 40 (b, kv) pairs do not leave most of the 132
//   SMs idle at long T, but no split shorter than t_blk rows. At the serving slice's T = 25 that
//   is one split: pass 1 writes the normalised output and pass 2 is not
//   launched.
// - A masked row has s = -1e30 exactly (-1e30 + x rounds to -1e30 in
//   f32), and m starts at -1e30, as in the TPU kernel, so a run of masked
//   rows contributes exp(0) = 1 per row until a live row arrives and its
//   weight exp(-1e30 - s) = 0 wipes them. The same holds when a whole
//   split, or a whole warp, saw only masked rows: the merge weights it by
//   exp(-1e30 - M) = 0. This holds whether the masked rows come first (a
//   sliding window) or last (rows past pos).
// - Tail rule: any T >= 1. A split ends at min(T, start + split_len) and
//   rows past T are never read; T need not be a multiple of t_blk.
// - dh must be a multiple of 16/sizeof(elem) (4 for f32, 8 for bf16), up
//   to 256; q and the K/V base pointers 16-byte aligned. The binding
//   checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

template <typename T>
struct Loader;

template <>
struct Loader<float> {
  static constexpr int VEC = 4;
  __device__ __forceinline__ static void load(const float* __restrict__ p,
                                              float* out) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
  }
};

template <>
struct Loader<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ __forceinline__ static void load(
      const __nv_bfloat16* __restrict__ p, float* out) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Pass 1. Grid (n_splits * n_hc, KV, B); blockIdx.x = split * n_hc + hc,
// so the head chunks of one split sit side by side and share its rows in
// L2. Each lane holds CPL chunks of VEC elements of a row. Dynamic shared
// memory: WARPS * GMAX * (2 + dh) floats.
template <typename T, int GMAX, int CPL>
__global__ void __launch_bounds__(THREADS)
flash_decode_split(const float* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   float* __restrict__ out, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   int T_len, int KV, int G, int dh, int n_splits,
                   int split_len, int n_hc, int lpr, float scale) {
  constexpr int VEC = Loader<T>::VEC;
  constexpr int E = CPL * VEC;  // floats of a row that one lane holds
  extern __shared__ float smem[];

  const int hc = blockIdx.x % n_hc;
  const int split = blockIdx.x / n_hc;
  const int kv = blockIdx.y;
  const long long bkv = (long long)blockIdx.z * KV + kv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rpw = 32 / lpr;  // rows a warp reads at a time
  const int sub = lane / lpr;
  const int li = lane - sub * lpr;
  const int ch = dh / VEC;   // 16-byte chunks of a row
  const int g0 = hc * GMAX;
  const int gc = min(GMAX, G - g0);

  float qf[GMAX][E];
  float m[GMAX], l[GMAX], acc[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
    const float* qg = q + ((bkv * G) + g0 + g) * dh;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = li + j * lpr;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        if (g < gc && c < ch) {
          Loader<float>::load(qg + c * VEC + e, &qf[g][j * VEC + e]);
        } else {
          qf[g][j * VEC + e] = qf[g][j * VEC + e + 1] = 0.f;
          qf[g][j * VEC + e + 2] = qf[g][j * VEC + e + 3] = 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][j * VEC + e] = 0.f;
    }
  }

  const int t0 = split * split_len;
  const int t1 = min(T_len, t0 + split_len);
  const long long stride = (long long)KV * dh;
  const long long base_off = (long long)blockIdx.z * T_len * stride +
                             (long long)kv * dh;
  const T* kb = k + base_off;
  const T* vb = v + base_off;
  const int n_rg = WARPS * rpw;

  // every lane of a warp runs the same trips, so the shuffles never
  // diverge; a lane past t1 loads nothing and updates nothing
  for (int base = t0 + warp * rpw; base < t1; base += n_rg) {
    const int t = base + sub;
    const bool live = t < t1;
    float kf[E], vf[E];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = li + j * lpr;
      if (live && c < ch) {
        Loader<T>::load(kb + t * stride + c * VEC, kf + j * VEC);
        Loader<T>::load(vb + t * stride + c * VEC, vf + j * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[j * VEC + e] = vf[j * VEC + e] = 0.f;
      }
    }
    const float bt = live ? bias[t] : 0.f;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < gc) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kf[e], d);
        for (int off = lpr >> 1; off > 0; off >>= 1)
          d += __shfl_xor_sync(FULL, d, off);
        if (live) {
          const float s = d * scale + bt;
          const float mn = fmaxf(m[g], s);
          const float alpha = expf(m[g] - mn);
          const float p = expf(s - mn);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * alpha + p * vf[e];
          m[g] = mn;
        }
      }
    }
  }

  // merge the row groups of a warp: partners at lane distance lpr, 2*lpr,
  // ... hold the same chunks; both partners compute the same sums
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < gc) {
        const float m2 = __shfl_xor_sync(FULL, m[g], off);
        const float l2 = __shfl_xor_sync(FULL, l[g], off);
        const float mn = fmaxf(m[g], m2);
        const float a1 = expf(m[g] - mn);
        const float a2 = expf(m2 - mn);
        l[g] = l[g] * a1 + l2 * a2;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float o = __shfl_xor_sync(FULL, acc[g][e], off);
          acc[g][e] = acc[g][e] * a1 + o * a2;
        }
        m[g] = mn;
      }
    }
  }

  // merge the warps through shared memory, in warp order
  float* sm_m = smem;                       // [WARPS][GMAX]
  float* sm_l = smem + WARPS * GMAX;        // [WARPS][GMAX]
  float* sm_acc = smem + 2 * WARPS * GMAX;  // [WARPS][GMAX][dh]
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < gc) {
        if (li == 0) {
          sm_m[warp * GMAX + g] = m[g];
          sm_l[warp * GMAX + g] = l[g];
        }
        float* row = sm_acc + (warp * GMAX + g) * dh;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = li + j * lpr;
          if (c < ch) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) row[c * VEC + e] = acc[g][j * VEC + e];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gc * dh; i += THREADS) {
    const int g = i / dh;
    const int d = i - g * dh;
    float M = NEG;
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w * GMAX + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(sm_m[w * GMAX + g] - M);
      L += sm_l[w * GMAX + g] * a;
      A += sm_acc[(w * GMAX + g) * dh + d] * a;
    }
    if (n_splits == 1) {
      out[(bkv * G + g0 + g) * dh + d] = A / fmaxf(L, 1e-30f);
    } else {
      const long long ps = (bkv * n_splits + split) * G + g0 + g;
      part_acc[ps * dh + d] = A;
      if (d == 0) {
        part_m[ps] = M;
        part_l[ps] = L;
      }
    }
  }
}

// Pass 2. Grid (G, KV, B): the splits of one query head merged in index
// order, the division once at the end.
__global__ void __launch_bounds__(THREADS)
flash_decode_combine(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc,
                     float* __restrict__ out, int G, int dh, int n_splits) {
  const long long bkv = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int g = blockIdx.x;
  const long long first = bkv * n_splits * G + g;  // split 0's index
  float M = NEG;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, part_m[first + s * G]);
  float L = 0.f;
  for (int s = 0; s < n_splits; ++s)
    L += part_l[first + s * G] * expf(part_m[first + s * G] - M);
  for (int d = threadIdx.x; d < dh; d += THREADS) {
    float A = 0.f;
    for (int s = 0; s < n_splits; ++s)
      A += part_acc[(first + s * G) * dh + d] *
           expf(part_m[first + s * G] - M);
    out[(bkv * G + g) * dh + d] = A / fmaxf(L, 1e-30f);
  }
}

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* bias;
  float* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  int B, T_len, KV, G, dh, n_splits, split_len, n_hc, lpr;
  float scale;
  cudaStream_t s;
};

template <typename T, int GMAX, int CPL>
cudaError_t launch_split(const Args& a) {
  const dim3 grid(a.n_splits * a.n_hc, a.KV, a.B);
  const size_t smem = (size_t)WARPS * GMAX * (2 + a.dh) * sizeof(float);
  flash_decode_split<T, GMAX, CPL><<<grid, THREADS, smem, a.s>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.bias,
      a.out, a.part_m, a.part_l, a.part_acc, a.T_len, a.KV, a.G, a.dh,
      a.n_splits, a.split_len, a.n_hc, a.lpr, a.scale);
  return cudaGetLastError();
}

template <typename T, int CPL>
cudaError_t by_gmax(int gmax, const Args& a) {
  switch (gmax) {
    case 1: return launch_split<T, 1, CPL>(a);
    case 2: return launch_split<T, 2, CPL>(a);
    case 4: return launch_split<T, 4, CPL>(a);
    case 8: return launch_split<T, 8, CPL>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches pass 1 on `stream`, and pass 2 when n_splits > 1 (the part_*
// buffers are then (B, KV, n_splits, G) and (B, KV, n_splits, G, dh)
// f32; with one split they may be null). gmax in {1, 2, 4, 8}; cpl 1 or
// 2 for f32, 1 for bf16; lpr a power of two <= 32. Returns
// cudaGetLastError() after the launches.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* bias, void* out, void* part_m,
                        void* part_l, void* part_acc, int B, int T, int KV,
                        int G, int dh, int n_splits, int split_len, int gmax,
                        int n_hc, int cpl, int lpr, int is_bf16, float scale,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{static_cast<const float*>(q), k, v,
               static_cast<const float*>(bias), static_cast<float*>(out),
               static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_acc), B, T, KV, G, dh, n_splits,
               split_len, n_hc, lpr, scale,
               static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    err = cpl == 1 ? by_gmax<__nv_bfloat16, 1>(gmax, a) : cudaErrorInvalidValue;
  } else if (cpl == 1) {
    err = by_gmax<float, 1>(gmax, a);
  } else if (cpl == 2) {
    err = by_gmax<float, 2>(gmax, a);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  flash_decode_combine<<<dim3(G, KV, B), THREADS, 0, a.s>>>(
      a.part_m, a.part_l, a.part_acc, a.out, G, dh, n_splits);
  return (int)cudaGetLastError();
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
