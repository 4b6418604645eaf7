// The whole-table fused site, shared by the head-folded site
// (fused_site_fold_heads.cu, HB = HPG heads a block), the window-prefetch
// site (fused_site_wide_prefetch.cu, one head a block), the wide site and
// its logsumexp instance (fused_site_wide.cu) and the row-folded site
// (fused_site_fold_rows.cu):
//   out[b, g, h, m, :] = sum_n softmax_n(bias[h, n, m] + scale q[h, m] . k[h, n]) v[h, n]
//
// A block owns HB heads of one (b, g) cell (heads hb HB .. hb HB + HB - 1 of
// its Hpg) and a strip of S queries, one thread per (head, query): HB x S
// threads, head h of the block in threads h S .. h S + S - 1. Block row y =
// (b G + g) Hpg / HB + hb; the key geometry is the cell's, (b G + g). A
// pair's bias comes from one of two table sources (Source):
// - WHOLE: the block stages its heads' zero-padded tables once, from the raw
//   table (lattice_common.cuh::stage_padded: (Ht + 2 PAD) x Xp bf16 a head,
//   63 x 429 x 2 B = 54 KB at the flagship's SCA), so a pair's bias is four
//   reads of shared memory with no per-key copy and no scratch;
// - RAW: each thread reads the four entries of a pair from its head's raw
//   table in device memory through L1, with bounds checks in place of the
//   padding (lattice_common.cuh::bias_at_raw), so a table of any size
//   launches; the block's shared memory is the key stages alone.
// Only the key tile moves: its K and V rows of every head of the block in
// bf16 and its geometry (ys, ms, wy, f), in two stages filled by cp.async
// while the block scores the other, so each tile of KT keys costs one
// __syncthreads. Per thread the work is fused_site.cu's: score every key of
// the tile (site_common.cuh::score) and fold the tile into the one state
// (update_rows). bias_at on the staged table and bias_at_raw read the same
// four entries with the same arithmetic, so on either source the output
// equals fused_site.cu's bit for bit and the logsumexp fused_site.cu's lse
// instance.
//
// Bound: operations per (query, key) pair, as fused_site.cu (the bias's
// three lerps from four reads, the exp, 2 ch multiply-adds). What this
// layout buys on the H100 is occupancy: a block's shared memory is its
// tables (none on RAW) and 2 x (2 HB KT CH x 2 + 4 KT x 4) bytes of key
// stages, where a window ring of the same tile took 136 KB at the
// flagship's SCA and left one 128-thread block an SM.
//
// Each source file instantiates the body (`site_block`) in a kernel of its
// own name and launch bounds; fused_site_whole_kernel is the instance of
// fused_site_wide_prefetch.cu and fused_site_fold_heads.cu. The shared
// memory, the strip and the launch check come from the wrappers
// (ops/kernels/fused_site_fold.py::whole_smem, heads_plan, rows_plan;
// fused_site_wide.py::prefetch_plan, wide_plan), which pick the path from
// the shapes.
#pragma once

#include "lattice_ring.cuh"
#include "site_common.cuh"

namespace site_whole {

using site::KT;

// Where a pair's bias comes from
enum Source : int {
  WHOLE = 0,  // the block's heads' padded tables, staged once in shared memory
  RAW = 1,    // the raw table in device memory, through L1
};

// One stage of the key pipeline: the block's heads' K rows, then V rows, of
// a key tile in bf16, (HB, KT, CH) each, then the tile's ys, ms, wy and f
// (KT words each).
template <int CH, int HB>
struct Stage {
  static constexpr int KV = HB * KT * CH;                // bf16 of K or V
  static constexpr int BYTES = 2 * KV * 2 + 4 * KT * 4;  // a multiple of 16
};

// Shared memory of a block: two stages, then on WHOLE the HB padded tables.
template <int CH, int HB, int SRC>
size_t smem_bytes(int Ht, int Xp) {
  return (size_t)2 * Stage<CH, HB>::BYTES +
         (SRC == WHOLE ? (size_t)HB * (Ht + 2 * lattice::PAD) * Xp *
                             sizeof(__nv_bfloat16)
                       : 0);
}

// CH consecutive bf16 in shared memory (2 CH-byte aligned) as floats.
template <int CH>
__device__ __forceinline__ void load_row(float (&x)[CH],
                                         const __nv_bfloat16* p) {
  unsigned w[CH / 2];
  if constexpr (CH == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    static_assert(CH == 4, "head widths 4 and 8");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  }
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {  // the lower address is the lower half
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The parameters of every kernel of the template, and their names as the
// arguments of `site_block`. The pointers are __restrict__, as the kernels'
// own parameters, so the compiler may move their loads past the block's
// shared-memory stores.
#define SITE_WHOLE_PARAMS                                                    \
  const __nv_bfloat16 *__restrict__ table, /* (G, Hpg, Ht, Wt) */           \
      const int *__restrict__ ys, const int *__restrict__ ms, /* (B, G, N) */ \
      const float *__restrict__ wy, const float *__restrict__ fx,            \
      const int *__restrict__ u0, const float *__restrict__ gcomb, /* (W,) */ \
      const __nv_bfloat16 *__restrict__ q,   /* (B, G, Hpg, M, CH) */       \
      const __nv_bfloat16 *__restrict__ k,   /* (B, G, Hpg, N, CH) */       \
      const __nv_bfloat16 *__restrict__ v,   /* (B, G, Hpg, N, CH) */       \
      float *__restrict__ out,               /* (B, G, Hpg, M, CH) */       \
      float *__restrict__ lse,               /* (B, G, Hpg, M) or null */   \
      int G, int Hpg, int Ht, int Wt, int Xp, int N, int H, int W, int S,    \
      float scale
#define SITE_WHOLE_ARGS                                                     \
  table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, lse, G, Hpg, Ht, Wt, Xp, N, \
      H, W, S, scale

// The work of one block (the layout above), in a kernel of HB S threads; Xp
// is the staged pitch on WHOLE.
template <int CH, int HB, int SRC>
__device__ __forceinline__ void site_block(SITE_WHOLE_PARAMS) {
  using St = Stage<CH, HB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two stages, then on WHOLE the (HB, Ht + 2 PAD, Xp) padded tables
  __nv_bfloat16* st =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * St::BYTES);

  const int per_cell = Hpg / HB;         // blocks of heads of a (b, g) cell
  const int bg = blockIdx.y / per_cell;  // b * G + g
  const int g = bg % G;
  const int h0 = (blockIdx.y - bg * per_cell) * HB;  // the block's first head
  const int M = H * W;
  const int h = threadIdx.x / S;
  const int m_raw = blockIdx.x * S + threadIdx.x - h * S;
  const bool active = m_raw < M;
  const int m = active ? m_raw : M - 1;  // idle lanes still help stage tiles
  const int iy = m / W;
  const int ix = m - iy * W;
  const float gcol = gcomb[ix];
  const __nv_bfloat16* heads = table + ((size_t)g * Hpg + h0) * Ht * Wt;
  // WHOLE: this thread's corner in its head's staged table; RAW: its head's
  // raw table
  const __nv_bfloat16* tq =
      SRC == WHOLE ? st + (h * (Ht + 2 * lattice::PAD) + iy) * Xp + u0[ix]
                   : heads + (size_t)h * Ht * Wt;
  const int cq = SRC == WHOLE ? 0 : u0[ix];  // the corner's column on RAW

  const size_t bgh0 = (size_t)bg * Hpg + h0;  // (b, g, first head) row
  const __nv_bfloat16* kb = k + bgh0 * N * CH;
  const __nv_bfloat16* vb = v + bgh0 * N * CH;
  const size_t geo = (size_t)bg * N;

  // start the copies of the tile from key n0 into stage `buf`; one commit
  // group a tile, empty past the last key
  auto issue = [&](int n0, int buf) {
    if (n0 < N) {
      __nv_bfloat16* sk =
          reinterpret_cast<__nv_bfloat16*>(smem_raw + buf * St::BYTES);
      int* sg = reinterpret_cast<int*>(sk + 2 * St::KV);
      const int nk = min(KT, N - n0);
      for (int i = threadIdx.x; i < 2 * HB * nk; i += blockDim.x) {
        const int r = i / nk;  // V rows after K rows, head by head
        const int j = i - r * nk;
        const int hh = r % HB;
        const __nv_bfloat16* src =
            (r < HB ? kb : vb) + ((size_t)hh * N + n0 + j) * CH;
        lattice::cp_async<CH * 2>(
            sk + (r >= HB ? St::KV : 0) + (hh * KT + j) * CH, src);
      }
      for (int i = threadIdx.x; i < 4 * nk; i += blockDim.x) {
        const int a = i / nk;
        const int j = i - a * nk;
        const void* src = a == 0   ? (const void*)(ys + geo + n0 + j)
                          : a == 1 ? (const void*)(ms + geo + n0 + j)
                          : a == 2 ? (const void*)(wy + geo + n0 + j)
                                   : (const void*)(fx + geo + n0 + j);
        lattice::cp_async<4>(sg + a * KT + j, src);
      }
    }
    lattice::cp_async_commit();
  };

  float qf[CH];
  const __nv_bfloat16* qp = q + ((bgh0 + h) * M + m) * CH;
#pragma unroll
  for (int c = 0; c < CH; ++c) qf[c] = __bfloat162float(qp[c]);

  issue(0, 0);
  if constexpr (SRC == WHOLE)
    lattice::stage_padded(st, heads, HB, Ht, Wt, Xp);
  site::Online<CH> state;
  for (int n0 = 0, t = 0; n0 < N; n0 += KT, ++t) {
    const int nk = min(KT, N - n0);
    lattice::cp_async_wait<0>();  // this thread's copies of tile t landed
    __syncthreads();  // every thread's; tile t-1 consumed; tables staged
    issue(n0 + KT, (t + 1) & 1);
    const __nv_bfloat16* sk =
        reinterpret_cast<const __nv_bfloat16*>(smem_raw + (t & 1) * St::BYTES);
    const int* sys = reinterpret_cast<const int*>(sk + 2 * St::KV);
    const int* sms = sys + KT;
    const float* swy = reinterpret_cast<const float*>(sms + KT);
    const float* sf = swy + KT;
    const __nv_bfloat16* skh = sk + h * KT * CH;
    const __nv_bfloat16* svh = skh + St::KV;
    float s[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < nk) {
        float kj[CH];
        load_row<CH>(kj, skh + j * CH);
        float b;
        if constexpr (SRC == WHOLE)
          b = lattice::bias_at(tq + sys[j] * Xp + sms[j], Xp, gcol, swy[j],
                               sf[j]);
        else
          b = lattice::bias_at_raw(tq, Ht, Wt, sys[j] + iy, sms[j] + cq, gcol,
                                   swy[j], sf[j]);
        s[j] = site::score(qf, kj, scale, b);
      }
    }
    site::update_rows(state, s, nk, [&](int j, float (&vj)[CH]) {
      load_row<CH>(vj, svh + j * CH);
    });
  }
  if (active) {
    const size_t bhm = (bgh0 + h) * M + m;
    site::finish(state, out + bhm * CH, lse == nullptr ? nullptr : lse + bhm);
  }
}

// The instance of fused_site_wide_prefetch.cu and fused_site_fold_heads.cu:
// the staged tables, MAXT threads a block at most, MINB blocks an SM asked
// of the compiler.
template <int CH, int HB, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    fused_site_whole_kernel(SITE_WHOLE_PARAMS) {
  site_block<CH, HB, WHOLE>(SITE_WHOLE_ARGS);
}

// The arguments of one launch, on the host.
struct Args {
  const void *table, *ys, *ms, *wy, *fx, *u0, *gcomb, *q, *k, *v;
  void *out, *lse;
  int G, Hpg, Ht, Wt, Xp, N, H, W, S;
  float scale;
};

// A kernel of the template (SITE_WHOLE_PARAMS).
using Kernel = void (*)(const __nv_bfloat16*, const int*, const int*,
                        const float*, const float*, const int*, const float*,
                        const __nv_bfloat16*, const __nv_bfloat16*,
                        const __nv_bfloat16*, float*, float*, int, int, int,
                        int, int, int, int, int, int, float);

// Launch `kernel` (an instance of site_block<CH, HB, SRC> of at most `maxt`
// threads) on `stream`: S queries a head (HB S threads, a multiple of 32),
// Xp the row pitch of the padded tables on WHOLE. k and v must start on a 2
// CH-byte boundary (one vector copy a row). Returns cudaGetLastError.
template <int CH, int HB, int SRC>
int launch_kernel(Kernel kernel, int maxt, const Args& a, int B,
                  cudaStream_t stream) {
  const int threads = HB * a.S;
  if (a.S < 1 || threads > maxt || threads % 32 || a.Hpg % HB ||
      (size_t)a.k % (CH * 2) || (size_t)a.v % (CH * 2))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<CH, HB, SRC>(a.Ht, a.Xp);
  const int rc = lattice::set_smem((const void*)kernel, smem);
  if (rc) return rc;
  const dim3 grid((a.H * a.W + a.S - 1) / a.S, B * a.G * (a.Hpg / HB));
  kernel<<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)a.table, (const int*)a.ys, (const int*)a.ms,
      (const float*)a.wy, (const float*)a.fx, (const int*)a.u0,
      (const float*)a.gcomb, (const __nv_bfloat16*)a.q,
      (const __nv_bfloat16*)a.k, (const __nv_bfloat16*)a.v, (float*)a.out,
      (float*)a.lse, a.G, a.Hpg, a.Ht, a.Wt, a.Xp, a.N, a.H, a.W, a.S,
      a.scale);
  return (int)cudaGetLastError();
}

// fused_site_whole_kernel's launch (the staged tables).
template <int CH, int HB, int MAXT, int MINB>
int launch(const void* table, const void* ys, const void* ms, const void* wy,
           const void* fx, const void* u0, const void* gcomb, const void* q,
           const void* k, const void* v, void* out, void* lse, int B, int G,
           int Hpg, int Ht, int Wt, int Xp, int N, int H, int W, int S,
           float scale, cudaStream_t stream) {
  return launch_kernel<CH, HB, WHOLE>(
      fused_site_whole_kernel<CH, HB, MAXT, MINB>, MAXT,
      Args{table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, lse, G, Hpg, Ht,
           Wt, Xp, N, H, W, S, scale},
      B, stream);
}

// Blocks of `threads` threads with `smem` bytes of dynamic shared memory that
// one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for
// `kernel`; a negative CUDA error code where the query fails.
inline int occupancy(const void* kernel, int threads, int smem) {
  int rc = lattice::set_smem(kernel, smem);
  int blocks = 0;
  if (!rc)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                            threads, smem);
  return rc ? -rc : blocks;
}

}  // namespace site_whole
