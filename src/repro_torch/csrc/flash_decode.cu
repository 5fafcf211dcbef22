// One-token decode attention against a KV cache (flash decoding), for
// Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces: repro/kernels/flash_decode/flash_decode.py::flash_decode_call
// (flash_decode.py:65), the Pallas TPU kernel whose body is _kernel
// (flash_decode.py:24).
//
// For each batch row b and kv head h, the G query heads of h attend over
// the T cache rows:
//
//   s[g,t] = (q[b,h,g,:] . k[b,t,h,:]) * dh^-0.5 + bias[t]           f32
//   out[b,h,g,:] = sum_t exp(s[g,t] - M) v[b,t,h,:] / max(l, 1e-30)
//
// with M the running max and l = sum_t exp(s[g,t] - M): an online softmax
// in f32, K and V in their own dtype (f32 or bf16), the output in f32.
// bias is the additive mask, 0 or -1e30 (ops.decode_bias). Both products
// are in this file: no library call.
//
// What bounds it: bytes. Every K and V row must be read once,
// 2*B*T*KV*dh*sizeof(elem) bytes, beside which q, bias and the output are
// small. The work is 4*B*KV*G*T*dh flops: G flops a byte of bf16 K/V (G/2
// in f32), far below the roughly 295 a byte at which the card's tensor
// cores, not its memory, would be the limit, for every G <= 16.
//
// How the design meets that bound. The TPU kernel walks T in order on one
// core and carries (m, l, acc) from one T block to the next. CUDA blocks
// run in no order, so this is split-T flash decoding in two passes:
// - Pass 1: one CTA per (kv head, T split, head chunk, b). The
//   CTA holds all G query heads of its kv head (head chunks of 16 only for
//   G > 16), so each cache row crosses HBM once. Rows arrive in tiles in a
//   shared-memory ring of `stages` slots filled by cp.async (16-byte
//   copies, zero-filled past the split's end), stages - 1 tiles ahead of
//   the one in use, so tens of KB stay in flight on each SM. The softmax
//   runs once a tile: the scores S[G, tile] for all heads, one max per
//   head, one exp per (head, row), one rescale of the accumulator. Rows
//   of a slot sit at an odd number of 16-byte chunks apart, so the reads
//   that walk across rows hit distinct banks.
//   * bf16 K/V (flash_decode_mma, 4 warps): tiles of 64 rows;
//     mma.sync.m16n8k16 bf16 with f32 accumulation, the G heads padded
//     to the MMA's 16 rows. S = Q.K^T with K fed by ldmatrix; q is split
//     into a bf16 high and low part (two MMAs) so the scores keep q's f32
//     precision. Each warp scores 16 rows of the tile; the per-head max
//     and sum cross the warps through shared memory. P is rounded to
//     bf16 once, l sums the rounded values, and O += P.V with V fed by
//     ldmatrix.trans; each warp owns a disjoint set of 8-column slices of
//     dh, so the warps never merge.
//   * f32 K/V (flash_decode_simt, 8 warps): tiles of 32 rows on f32
//     FMAs (TF32 would break the 2e-5 tolerance). Each warp owns an
//     eighth of dh and holds q's values there in registers; a lane
//     scores 4 rows for up to 4 heads, so 4 reads of K feed 64 FMAs; the
//     eight partial sums meet in shared memory in warp order; a warp
//     runs the softmax of a head with a lane per row; then a thread owns
//     one 16-byte slice of dh for 1-4 heads and adds P.V over the tile.
//   * G <= 2 (flash_decode_rows): the row loop, rows read straight into
//     registers, a softmax step per row. With one or two heads a tile
//     has too little work to share, and this loop streams at the HBM
//     rate; the tiled kernels at G = 1 were slower on the card, so
//     plan() keeps this one there.
// - Pass 2 (only when there is more than one split): one CTA per
//   (g, kv head, b) merges the splits in index order, each weighted by
//   exp(m_s - M), and divides once, at the end. No float atomics.
// - Geometry (plan() in kernels/flash_decode/flash_decode.py): the stage
//   count is the most (up to 4) that lets 2 CTAs share an SM; the splits
//   fill about one wave of CTAs over the SMs (two waves measured slower),
//   none shorter than t_blk rows. At the serving slices' T = 25 that is
//   one split, one tile, and pass 2 is not launched.
// - Masked rows: a masked row has s = -1e30 exactly (-1e30 + x rounds to
//   -1e30 in f32), and m starts at -1e30, as in the TPU kernel, so a run
//   of masked rows weighs exp(0) = 1 a row until a live row arrives and
//   its factor exp(-1e30 - s) = 0 wipes them. The same holds when a whole
//   tile, warp or split saw only masked rows: the merge weighs it by
//   exp(-1e30 - M) = 0. This holds whether the masked rows come first (a
//   sliding window) or last (rows past pos). Rows of a tile past the
//   split's end are not rows at all: their score is -inf, their weight 0,
//   and their K and V are zero-filled.
// - Tail rule: any T >= 1. A split ends at min(T, start + split_len);
//   rows past T are never read; T need not be a multiple of anything.
// - dh must be a multiple of 16/sizeof(elem) (4 for f32, 8 for bf16), up
//   to 256; q and the K/V base pointers 16-byte aligned. The binding
//   checks.
//
// P in bf16. The bf16 path rounds P to bf16 once (one MMA, not a
// high/low pair) and sums l over the rounded values, so the weights
// still sum to 1. Against the plain version, which widens the same bf16
// K/V to f32, it measured at most 1.6e-3 over chip_smoke.py's cases and
// 6.8e-5 at (B, KV, G, dh, T) = (8, 4, 12, 128, 32768), on an NVIDIA H100
// 80GB HBM3, inside the 2e-2 tolerance; the f32 path at most 2e-6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GRID = 65535;  // the most CTAs along grid.y or grid.z
constexpr int GH = 16;  // query heads a CTA holds at most: the MMA's M
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; zero-filled when !live
// (the source is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most stages - 2 groups are pending: the oldest tile landed
__device__ __forceinline__ void cp_async_wait_tile(int stages) {
  if (stages >= 4) {
    asm volatile("cp.async.wait_group 2;\n" ::);
  } else if (stages == 3) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
}

// Rows [tb, tb + rows) of one (b, kv head) into a ring slot, by NT
// threads: `kc` chunks of 16 bytes a row at `sstride` chunks apart, zero
// past row t1 or chunk nch. kg and vg point at row 0 of the (b, kv head);
// a row is row_bytes on.
template <int NT>
__device__ __forceinline__ void load_tile(unsigned char* ks,
                                          unsigned char* vs,
                                          const unsigned char* kg,
                                          const unsigned char* vg,
                                          long long row_bytes, int tb, int t1,
                                          int rows, int kc, int nch,
                                          int sstride) {
  int r = threadIdx.x / kc;
  int c = threadIdx.x - r * kc;
  const int dr = NT / kc;
  const int dc = NT - dr * kc;
  for (int i = threadIdx.x; i < rows * kc; i += NT) {
    const int t = tb + r;
    const bool live = t < t1 && c < nch;
    const long long off = live ? (long long)t * row_bytes + c * 16 : 0;
    const int so = (r * sstride + c) * 16;
    cp_async16(ks + so, kg + off, live);
    cp_async16(vs + so, vg + off, live);
    r += dr;
    c += dc;
    if (c >= kc) {
      c -= kc;
      ++r;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// f32 K/V: tiles of 32 rows on FMAs, 8 warps a CTA (more warps in flight
// to hide the latency of the shared-memory reads). Scores: warp w owns
// the 16-byte chunks w, w + 8, ... of dh (CPW of them at most) and holds
// q's values there in registers; lane (hq, rg) scores rows rg + 8i (i < 4)
// for heads hq + 4j (j < 4): 4 K reads feed 64 FMAs. P.V: HPT heads a
// thread; a row of dh/4 chunks is covered by CS = 16 * HPT chunk slots,
// so 256 / CS head groups of HPT heads cover the 16 heads.
// Shared memory: K and V rings, then the partial scores
// [SIMT_WARPS][GH][33], P [GH][36], and alpha, m, l [GH] (all f32);
// simt_smem() in the launcher and plan() in the binding count the same.
// ---------------------------------------------------------------------------
constexpr int SIMT_ROWS = 32;
// a head's P: 16-byte aligned runs of 4 rows, heads 4 banks apart
constexpr int SIMT_PSTR = SIMT_ROWS + 4;
constexpr int SIMT_SSTR = SIMT_ROWS + 1;  // partial scores of a head
constexpr int SIMT_THREADS = 256;
constexpr int SIMT_WARPS = SIMT_THREADS / 32;

template <int HPT, int CPW>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_decode_simt(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  float* __restrict__ out, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int T_len, int KV, int G, int dh, int n_splits,
                  int split_len, int n_hc, int stages, float scale, int b0,
                  int kv0) {
  constexpr int TR = SIMT_ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nch = dh >> 2;
  const int sstride = nch | 1;
  const int slot_bytes = TR * sstride * 16;
  unsigned char* ks = smem;
  unsigned char* vs = ks + stages * slot_bytes;
  float* spart = reinterpret_cast<float*>(vs + stages * slot_bytes);
  float* pt = spart + SIMT_WARPS * GH * SIMT_SSTR;
  float* alpha_s = pt + GH * SIMT_PSTR;
  float* m_s = alpha_s + GH;
  float* l_s = m_s + GH;

  const int hc = blockIdx.y % n_hc;
  const int split = blockIdx.y / n_hc;
  const int kvh = kv0 + blockIdx.x;
  const long long b = b0 + (long long)blockIdx.z;
  const long long bkv = b * KV + kvh;
  const int g0 = hc * GH;
  const int gc = min(GH, G - g0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // scores: this lane's heads hq + 4j and rows rg + 8i of a tile
  const int hq = lane & 3;
  const int rg = lane >> 2;
  float4 qr[4][CPW];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int cc = 0; cc < CPW; ++cc) {
      const int g = hq + 4 * j;
      const int c = warp + SIMT_WARPS * cc;
      qr[j][cc] = g < gc && c < nch
                      ? reinterpret_cast<const float4*>(
                            q + (bkv * G + g0 + g) * dh)[c]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int i = threadIdx.x; i < GH * SIMT_PSTR + GH; i += SIMT_THREADS)
    pt[i] = 0.f;

  const int t0 = split * split_len;
  const int t1 = min(T_len, t0 + split_len);
  const int n_tiles = (t1 - t0 + TR - 1) / TR;
  const long long row_bytes = (long long)KV * dh * sizeof(float);
  const long long base = (b * T_len * KV + kvh) * dh;
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(k + base);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(v + base);

  // P.V: this thread's 16-byte slice ct of dh and its heads hg0..hg0+HPT-1;
  // the 8 lanes of a quarter-warp hold neighbouring slices
  const int X = warp | ((lane >> 3) << 3);
  const int ct = (lane & 7) + 8 * (X % (2 * HPT));
  const int hg0 = (X / (2 * HPT)) * HPT;
  float acc[HPT][4];
#pragma unroll
  for (int j = 0; j < HPT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // softmax: warp w keeps (m, l) of heads w and w + 8
  constexpr int HPW = GH / SIMT_WARPS;
  float m[HPW], l[HPW];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    m[j] = NEG;
    l[j] = 0.f;
  }

  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_tiles)
      load_tile<SIMT_THREADS>(ks + s * slot_bytes, vs + s * slot_bytes, kg,
                              vg, row_bytes, t0 + s * TR, t1, TR, nch, nch,
                              sstride);
    cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_tile(stages);
    __syncthreads();
    const int nxt = it + stages - 1;
    if (nxt < n_tiles) {
      const int sl = nxt % stages;
      load_tile<SIMT_THREADS>(ks + sl * slot_bytes, vs + sl * slot_bytes, kg,
                              vg, row_bytes, t0 + nxt * TR, t1, TR, nch, nch,
                              sstride);
    }
    cp_async_commit();
    const int sl = it % stages;
    const float4* kt = reinterpret_cast<const float4*>(ks + sl * slot_bytes);
    const float4* vt = reinterpret_cast<const float4*>(vs + sl * slot_bytes);
    const int tb = t0 + it * TR;
    // the bias of this lane's row, loaded before the scores need it
    const bool row_live = tb + lane < t1;
    const float bt = row_live ? bias[tb + lane] : 0.f;

    // scores: partial sums over this warp's chunks of dh
    float sc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPW; ++cc) {
      const int c = warp + SIMT_WARPS * cc;
      if (c < nch) {
        float4 kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kk[i] = kt[(rg + 8 * i) * sstride + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (hq + 4 * j < gc) {
            const float4 qq = qr[j][cc];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              sc[j][i] = fmaf(qq.x, kk[i].x, sc[j][i]);
              sc[j][i] = fmaf(qq.y, kk[i].y, sc[j][i]);
              sc[j][i] = fmaf(qq.z, kk[i].z, sc[j][i]);
              sc[j][i] = fmaf(qq.w, kk[i].w, sc[j][i]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = hq + 4 * j;
      if (g < gc) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          spart[(warp * GH + g) * SIMT_SSTR + rg + 8 * i] = sc[j][i];
      }
    }
    __syncthreads();

    // softmax of heads warp + 8j, a lane per row
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int g = warp + SIMT_WARPS * j;
      if (g < gc) {
        float s = -INFINITY;
        if (row_live) {
          float d = 0.f;
#pragma unroll
          for (int w = 0; w < SIMT_WARPS; ++w)
            d += spart[(w * GH + g) * SIMT_SSTR + lane];
          s = d * scale + bt;
        }
        const float mn = fmaxf(m[j], warp_max(s));
        const float p = expf(s - mn);
        const float a = expf(m[j] - mn);
        l[j] = l[j] * a + warp_sum(p);
        m[j] = mn;
        pt[g * SIMT_PSTR + lane] = p;
        if (lane == 0) alpha_s[g] = a;
      }
    }
    __syncthreads();

    // one rescale per tile, then acc += P.V over the tile's rows
    if (ct < nch && hg0 < gc) {
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
        const float a = alpha_s[hg0 + j];
        acc[j][0] *= a;
        acc[j][1] *= a;
        acc[j][2] *= a;
        acc[j][3] *= a;
      }
      const float* pg = pt + hg0 * SIMT_PSTR;
#pragma unroll 2
      for (int r = 0; r < TR; r += 4) {
        float4 p4[HPT];
#pragma unroll
        for (int j = 0; j < HPT; ++j)
          p4[j] = *reinterpret_cast<const float4*>(pg + j * SIMT_PSTR + r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 vv = vt[(r + i) * sstride + ct];
#pragma unroll
          for (int j = 0; j < HPT; ++j) {
            const float p = i == 0 ? p4[j].x
                            : i == 1 ? p4[j].y
                            : i == 2 ? p4[j].z : p4[j].w;
            acc[j][0] = fmaf(p, vv.x, acc[j][0]);
            acc[j][1] = fmaf(p, vv.y, acc[j][1]);
            acc[j][2] = fmaf(p, vv.z, acc[j][2]);
            acc[j][3] = fmaf(p, vv.w, acc[j][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int g = warp + SIMT_WARPS * j;
    if (g < gc && lane == 0) {
      m_s[g] = m[j];
      l_s[g] = l[j];
    }
  }
  __syncthreads();
  if (ct < nch) {
#pragma unroll
    for (int j = 0; j < HPT; ++j) {
      const int g = hg0 + j;
      if (g < gc) {
        float4 o = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        if (n_splits == 1) {
          const float L = fmaxf(l_s[g], 1e-30f);
          o.x /= L;
          o.y /= L;
          o.z /= L;
          o.w /= L;
          reinterpret_cast<float4*>(out + (bkv * G + g0 + g) * dh)[ct] = o;
        } else {
          const long long ps = (bkv * n_splits + split) * G + g0 + g;
          reinterpret_cast<float4*>(part_acc + ps * dh)[ct] = o;
          if (ct == 0) {
            part_m[ps] = m_s[g];
            part_l[ps] = l_s[g];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 K/V: tiles of 64 rows on tensor cores (mma.sync.m16n8k16, bf16 in,
// f32 accumulate). NKS: the most k-steps of 16 over dh; NTW: the most
// 8-column slices of dh a warp owns in P.V (dh / 8 slices over 4 warps).
// Shared memory: K and V rings (a row is kc = 2 * ceil(dh / 16) chunks of
// 16 bytes, the last zero when dh / 8 is odd, at kc + 1 chunks apart),
// then P [GH][MMA_ROWS + 8] bf16, and the per-warp max and sum
// [MMA_WARPS][GH] f32; mma_smem() in the launcher and plan() in the
// binding count the same.
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 4;  // 8 warps and 128-row tiles measured slower
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_ROWS = 16 * MMA_WARPS;  // each warp scores 16 rows
constexpr int PSTR = MMA_ROWS + 8;  // bf16 a row of P: 9 chunks of 16 bytes

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int NKS, int NTW>
__global__ void __launch_bounds__(MMA_THREADS)
flash_decode_mma(const float* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias, float* __restrict__ out,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, int T_len, int KV, int G,
                 int dh, int n_splits, int split_len, int n_hc, int stages,
                 float scale, int b0, int kv0) {
  constexpr int TR = MMA_ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nch = dh >> 3;          // 16-byte chunks = 8-column slices
  const int nks = (nch + 1) >> 1;   // k-steps of 16 over dh
  const int kc = 2 * nks;
  const int sstride = kc + 1;
  const int slot_bytes = TR * sstride * 16;
  unsigned char* ks = smem;
  unsigned char* vs = ks + stages * slot_bytes;
  __nv_bfloat16* ps =
      reinterpret_cast<__nv_bfloat16*>(vs + stages * slot_bytes);
  float* red_max = reinterpret_cast<float*>(ps + GH * PSTR);
  float* red_sum = red_max + MMA_WARPS * GH;

  const int hc = blockIdx.y % n_hc;
  const int split = blockIdx.y / n_hc;
  const int kvh = kv0 + blockIdx.x;
  const long long b = b0 + (long long)blockIdx.z;
  const long long bkv = b * KV + kvh;
  const int g0 = hc * GH;
  const int gc = min(GH, G - g0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // the MMA's row group: heads gid, gid + 8
  const int tig = lane & 3;

  // q as A fragments, split into bf16 high and low parts: q = hi + lo
  // to about 2^-17 relative, so Q.K^T keeps q's f32 precision
  uint32_t qh[NKS][4], ql[NKS][4];
#pragma unroll
  for (int s = 0; s < NKS; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = gid + 8 * (r & 1);
      const int col = 16 * s + 2 * tig + 8 * (r >> 1);
      float2 x = make_float2(0.f, 0.f);
      if (row < gc && col < dh)
        x = *reinterpret_cast<const float2*>(q + (bkv * G + g0 + row) * dh +
                                             col);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x.x, x.y);
      const float2 hf = __bfloat1622float2(hi);
      qh[s][r] = bf16x2_bits(hi);
      ql[s][r] = bf16x2_bits(__floats2bfloat162_rn(x.x - hf.x, x.y - hf.y));
    }
  }

  const int t0 = split * split_len;
  const int t1 = min(T_len, t0 + split_len);
  const int n_tiles = (t1 - t0 + TR - 1) / TR;
  const long long row_bytes = (long long)KV * dh * sizeof(__nv_bfloat16);
  const long long base = (b * T_len * KV + kvh) * dh;
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(k + base);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(v + base);

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // heads gid, gid + 8

  // ldmatrix addresses: lane l gives row (l & 7) of matrix l >> 3
  const int k_row = 16 * warp + (lane & 7) + ((lane >> 4) << 3);
  const int k_chunk = (lane >> 3) & 1;
  const int p_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int p_col = 8 * (lane >> 4);
  const int v_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t p_base = smem_u32(ps);

  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_tiles)
      load_tile<MMA_THREADS>(ks + s * slot_bytes, vs + s * slot_bytes, kg, vg,
                         row_bytes, t0 + s * TR, t1, TR, kc, nch, sstride);
    cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_tile(stages);
    __syncthreads();
    const int nxt = it + stages - 1;
    if (nxt < n_tiles) {
      const int sl = nxt % stages;
      load_tile<MMA_THREADS>(ks + sl * slot_bytes, vs + sl * slot_bytes, kg, vg,
                         row_bytes, t0 + nxt * TR, t1, TR, kc, nch, sstride);
    }
    cp_async_commit();
    const int sl = it % stages;
    const uint32_t k_base = smem_u32(ks + sl * slot_bytes);
    const uint32_t v_base = smem_u32(vs + sl * slot_bytes);
    const int tb = t0 + it * TR;
    // the bias of this lane's four rows, loaded before the scores need it
    float bt[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = tb + 16 * warp + 8 * n + 2 * tig + e;
        bt[n][e] = t < t1 ? bias[t] : -INFINITY;
      }
    }

    // S = Q.K^T for this warp's 16 rows: two n-tiles of 8 rows
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int s = 0; s < NKS; ++s) {
      if (s < nks) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                k_base + (k_row * sstride + 2 * s + k_chunk) * 16);
        mma_bf16(sc[0], ql[s], b0, b1);
        mma_bf16(sc[0], qh[s], b0, b1);
        mma_bf16(sc[1], ql[s], b2, b3);
        mma_bf16(sc[1], qh[s], b2, b3);
      }
    }
    // sc[n][e]: head gid + 8 * (e >> 1), row 16 * warp + 8 * n + 2 * tig
    // + (e & 1) of the tile
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a row past the split's end has bias -inf here: weight 0
        const float s = sc[n][e] * scale + bt[n][e & 1];
        sc[n][e] = s;
        if (e < 2) {
          mx0 = fmaxf(mx0, s);
        } else {
          mx1 = fmaxf(mx1, s);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    if (tig == 0) {
      red_max[warp * GH + gid] = mx0;
      red_max[warp * GH + gid + 8] = mx1;
    }
    __syncthreads();
    float tm0 = red_max[gid], tm1 = red_max[gid + 8];
#pragma unroll
    for (int w = 1; w < MMA_WARPS; ++w) {
      tm0 = fmaxf(tm0, red_max[w * GH + gid]);
      tm1 = fmaxf(tm1, red_max[w * GH + gid + 8]);
    }
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    // P in bf16, one exp per (head, row); l sums the rounded values
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(
          expf(sc[n][0] - mn0), expf(sc[n][1] - mn0));
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(
          expf(sc[n][2] - mn1), expf(sc[n][3] - mn1));
      const float2 f0 = __bfloat1622float2(p0);
      const float2 f1 = __bfloat1622float2(p1);
      sum0 += f0.x + f0.y;
      sum1 += f1.x + f1.y;
      const int col = 16 * warp + 8 * n + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(ps + gid * PSTR + col) = p0;
      *reinterpret_cast<__nv_bfloat162*>(ps + (gid + 8) * PSTR + col) = p1;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(FULL, sum0, off);
      sum1 += __shfl_xor_sync(FULL, sum1, off);
    }
    if (tig == 0) {
      red_sum[warp * GH + gid] = sum0;
      red_sum[warp * GH + gid + 8] = sum1;
    }
    __syncthreads();
    float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      ts0 += red_sum[w * GH + gid];
      ts1 += red_sum[w * GH + gid + 8];
    }
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    l0 = l0 * a0 + ts0;
    l1 = l1 * a1 + ts1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }

    // O += P.V: k-steps of 16 rows; this warp's slices warp + 4j of dh,
    // two a V load
#pragma unroll
    for (int kr = 0; kr < TR / 16; ++kr) {
      uint32_t a[4];
      ldsm_x4(a[0], a[1], a[2], a[3],
              p_base + (p_row * PSTR + 16 * kr + p_col) * 2);
#pragma unroll
      for (int jp = 0; jp < NTW; jp += 2) {
        const int j0 = warp + MMA_WARPS * jp;
        const int j1 = j0 + MMA_WARPS;
        if (j0 < nch) {
          const int ch = (lane >> 4) && j1 < nch ? j1 : j0;
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(b0, b1, b2, b3,
                        v_base + ((16 * kr + v_row) * sstride + ch) * 16);
          mma_bf16(acc[jp], a, b0, b1);
          if (j1 < nch) mma_bf16(acc[jp + 1], a, b2, b3);
        }
      }
    }
  }

  // acc[j]: heads gid (0, 1) and gid + 8 (2, 3), columns 8 * (warp + 4j)
  // + 2 * tig + (0, 1)
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int d = 8 * (warp + MMA_WARPS * j) + 2 * tig;
    if (d < dh) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = gid + 8 * h;
        if (g < gc) {
          float2 o = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
          if (n_splits == 1) {
            const float L = fmaxf(h ? l1 : l0, 1e-30f);
            o.x /= L;
            o.y /= L;
            *reinterpret_cast<float2*>(out + (bkv * G + g0 + g) * dh + d) = o;
          } else {
            const long long pi = (bkv * n_splits + split) * G + g0 + g;
            *reinterpret_cast<float2*>(part_acc + pi * dh + d) = o;
            if (warp == 0 && j == 0 && tig == 0) {
              part_m[pi] = h ? m1 : m0;
              part_l[pi] = h ? l1 : l0;
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// G <= 2 (MHA and near it): the row loop, rows read straight into
// registers. A row of dh elements is read by `lpr` lanes with 16-byte
// loads, 32/lpr rows a warp at a time; each query head (GMAX of them, in
// registers) keeps (m, l, acc) per row group, the dot product reduced
// with shuffles; the row groups merge in a fixed order at the end. With
// one or two heads there is no tile's worth of work to share, and this
// loop streams at the HBM rate; plan() picks it for G <= ROWS_MAX_G.
// Dynamic shared memory: WARPS * GMAX * (2 + dh) floats.
// ---------------------------------------------------------------------------
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

template <typename T, int GMAX, int CPL>
__global__ void __launch_bounds__(THREADS)
flash_decode_rows(const float* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ bias,
                  float* __restrict__ out, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int T_len, int KV, int G, int dh, int n_splits,
                  int split_len, int lpr, float scale, int b0, int kv0) {
  constexpr int VEC = Loader<T>::VEC;
  constexpr int E = CPL * VEC;  // floats of a row that one lane holds
  extern __shared__ float smem_rows[];

  const int split = blockIdx.x;
  const int kv = kv0 + blockIdx.y;
  const long long b = b0 + (long long)blockIdx.z;
  const long long bkv = b * KV + kv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rpw = 32 / lpr;  // rows a warp reads at a time
  const int sub = lane / lpr;
  const int li = lane - sub * lpr;
  const int ch = dh / VEC;   // 16-byte chunks of a row

  float qf[GMAX][E];
  float m[GMAX], l[GMAX], acc[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
    const float* qg = q + (bkv * G + g) * dh;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = li + j * lpr;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        if (g < G && c < ch) {
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
  const long long base_off = b * T_len * stride + (long long)kv * dh;
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
      if (g < G) {
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
      if (g < G) {
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
  float* sm_m = smem_rows;                       // [WARPS][GMAX]
  float* sm_l = smem_rows + WARPS * GMAX;        // [WARPS][GMAX]
  float* sm_acc = smem_rows + 2 * WARPS * GMAX;  // [WARPS][GMAX][dh]
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
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
            for (int e = 0; e < VEC; ++e)
              row[c * VEC + e] = acc[g][j * VEC + e];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * dh; i += THREADS) {
    const int g = i / dh;
    const int d = i - g * dh;
    float M = NEG;
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w * GMAX + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float a = expf(sm_m[w * GMAX + g] - M);
      L += sm_l[w * GMAX + g] * a;
      A += sm_acc[(w * GMAX + g) * dh + d] * a;
    }
    if (n_splits == 1) {
      out[(bkv * G + g) * dh + d] = A / fmaxf(L, 1e-30f);
    } else {
      const long long ps = (bkv * n_splits + split) * G + g;
      part_acc[ps * dh + d] = A;
      if (d == 0) {
        part_m[ps] = M;
        part_l[ps] = L;
      }
    }
  }
}

// Pass 2. Grid (G, KV, B) of a chunk: the splits of one query head merged
// in index order, the division once at the end.
__global__ void __launch_bounds__(THREADS)
flash_decode_combine(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc,
                     float* __restrict__ out, int G, int dh, int n_splits,
                     int KV, int b0, int kv0) {
  const long long bkv =
      (b0 + (long long)blockIdx.z) * KV + kv0 + blockIdx.y;
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Kind { KIND_ROWS = 0, KIND_SIMT = 1, KIND_MMA = 2 };

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* bias;
  float* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  int B, T_len, KV, G, dh, n_splits, split_len, n_hc, stages, cpl, lpr;
  float scale;
  cudaStream_t s;
  // the chunk of one launch: batch rows [b0, b0 + nb), kv heads
  // [kv0, kv0 + nkv), each at most MAX_GRID (grid.y and grid.z's limit)
  int b0, nb, kv0, nkv;
};

// The shared memory of each kind, as the kernels carve it up; plan() in
// the binding counts the same bytes.
size_t simt_smem(int dh, int stages) {
  const int sstride = (dh / 4) | 1;
  return (size_t)2 * stages * SIMT_ROWS * sstride * 16 +
         sizeof(float) * ((size_t)SIMT_WARPS * GH * SIMT_SSTR +
                          GH * SIMT_PSTR + 3 * GH);
}

size_t mma_smem(int dh, int stages) {
  const int sstride = 2 * ((dh / 8 + 1) / 2) + 1;
  return (size_t)2 * stages * MMA_ROWS * sstride * 16 +
         sizeof(__nv_bfloat16) * GH * PSTR +
         sizeof(float) * 2 * MMA_WARPS * GH;
}

// Launch `kernel` on a grid of (nkv, n_splits * n_hc, nb) CTAs of NT
// threads with `smem` bytes of dynamic shared memory, raising the
// kernel's limit to the card's once, since above 48 KB it must be asked
// for. The kv heads of one split are neighbours in launch order: they
// read neighbouring bytes of the same cache rows.
template <auto kernel, int NT, typename T>
cudaError_t launch_tiled(const T* k, const T* v, size_t smem,
                         const Args& a) {
  static bool raised = false;  // one flag per kernel instance
  if (!raised) {
    int dev = 0, max_optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_optin);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const dim3 grid(a.nkv, a.n_splits * a.n_hc, a.nb);
  kernel<<<grid, NT, smem, a.s>>>(
      a.q, k, v, a.bias, a.out, a.part_m, a.part_l, a.part_acc, a.T_len,
      a.KV, a.G, a.dh, a.n_splits, a.split_len, a.n_hc, a.stages, a.scale,
      a.b0, a.kv0);
  return cudaGetLastError();
}

cudaError_t launch_simt(const Args& a) {
  const size_t smem = simt_smem(a.dh, a.stages);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  constexpr int NT = SIMT_THREADS;
  const int nch = a.dh / 4;
  if (nch <= 16)
    return launch_tiled<flash_decode_simt<1, 2>, NT>(k, v, smem, a);
  if (nch <= 32)
    return launch_tiled<flash_decode_simt<2, 4>, NT>(k, v, smem, a);
  if (nch <= 64)
    return launch_tiled<flash_decode_simt<4, 8>, NT>(k, v, smem, a);
  return cudaErrorInvalidValue;
}

cudaError_t launch_mma(const Args& a) {
  const size_t smem = mma_smem(a.dh, a.stages);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  constexpr int NT = MMA_THREADS;
  if (a.dh <= 64)
    return launch_tiled<flash_decode_mma<4, 2>, NT>(k, v, smem, a);
  if (a.dh <= 128)
    return launch_tiled<flash_decode_mma<8, 4>, NT>(k, v, smem, a);
  if (a.dh <= 256)
    return launch_tiled<flash_decode_mma<16, 8>, NT>(k, v, smem, a);
  return cudaErrorInvalidValue;
}

template <typename T, int GMAX, int CPL>
cudaError_t launch_rows_inst(const Args& a) {
  const dim3 grid(a.n_splits, a.nkv, a.nb);
  const size_t smem = (size_t)WARPS * GMAX * (2 + a.dh) * sizeof(float);
  flash_decode_rows<T, GMAX, CPL><<<grid, THREADS, smem, a.s>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.bias,
      a.out, a.part_m, a.part_l, a.part_acc, a.T_len, a.KV, a.G, a.dh,
      a.n_splits, a.split_len, a.lpr, a.scale, a.b0, a.kv0);
  return cudaGetLastError();
}

template <typename T, int CPL>
cudaError_t launch_rows_g(const Args& a) {
  switch (a.G) {
    case 1: return launch_rows_inst<T, 1, CPL>(a);
    case 2: return launch_rows_inst<T, 2, CPL>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_rows(const Args& a, int is_bf16) {
  if (is_bf16) {
    return a.cpl == 1 ? launch_rows_g<__nv_bfloat16, 1>(a)
                      : cudaErrorInvalidValue;
  }
  if (a.cpl == 1) return launch_rows_g<float, 1>(a);
  if (a.cpl == 2) return launch_rows_g<float, 2>(a);
  return cudaErrorInvalidValue;
}

// Pass 1, and pass 2 when there is more than one split, of one chunk.
cudaError_t launch_chunk(const Args& a, int kind, int is_bf16) {
  cudaError_t err;
  if (kind == KIND_ROWS) {
    err = launch_rows(a, is_bf16);
  } else if (a.stages < 2 || a.stages > 4) {
    err = cudaErrorInvalidValue;
  } else if (kind == KIND_SIMT && !is_bf16) {
    err = launch_simt(a);
  } else if (kind == KIND_MMA && is_bf16) {
    err = launch_mma(a);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || a.n_splits == 1) return err;
  flash_decode_combine<<<dim3(a.G, a.nkv, a.nb), THREADS, 0, a.s>>>(
      a.part_m, a.part_l, a.part_acc, a.out, a.G, a.dh, a.n_splits, a.KV,
      a.b0, a.kv0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches pass 1 on `stream`, and pass 2 when n_splits > 1 (the part_*
// buffers are then (B, KV, n_splits, G) f32 for m and l and
// (B, KV, n_splits, G, dh) for acc; with one split they may be null).
// B and KV past MAX_GRID, the limit of grid.y and grid.z, are cut into
// chunks of at most MAX_GRID each, launched in turn (batch chunks outer):
// a CTA computes the same (b, kv) slice in the same order whatever chunk
// holds it.
// kind: 0 the row loop (G in {1, 2}; cpl 1 or 2 in f32, 1 in bf16; lpr a
// power of two <= 32), 1 the f32 tiles, 2 the bf16 tensor-core tiles
// (n_hc head chunks of 16, `stages` ring slots, 2 to 4). Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments no instance takes.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* bias, void* out, void* part_m,
                        void* part_l, void* part_acc, int B, int T, int KV,
                        int G, int dh, int n_splits, int split_len, int kind,
                        int n_hc, int stages, int cpl, int lpr, int is_bf16,
                        float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{static_cast<const float*>(q), k, v,
         static_cast<const float*>(bias), static_cast<float*>(out),
         static_cast<float*>(part_m), static_cast<float*>(part_l),
         static_cast<float*>(part_acc), B, T, KV, G, dh, n_splits,
         split_len, n_hc, stages, cpl, lpr, scale,
         static_cast<cudaStream_t>(stream), 0, 0, 0, 0};
  for (a.b0 = 0; a.b0 < B; a.b0 += MAX_GRID) {
    a.nb = B - a.b0 < MAX_GRID ? B - a.b0 : MAX_GRID;
    for (a.kv0 = 0; a.kv0 < KV; a.kv0 += MAX_GRID) {
      a.nkv = KV - a.kv0 < MAX_GRID ? KV - a.kv0 : MAX_GRID;
      err = launch_chunk(a, kind, is_bf16);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaSuccess;
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
