// The whole-table fused site, shared by the head-folded site
// (fused_site_fold_heads.cu, HB = HPG heads a block) and the window-prefetch
// site (fused_site_wide_prefetch.cu, one head a block):
//   out[b, g, h, m, :] = sum_n softmax_n(bias[h, n, m] + scale q[h, m] . k[h, n]) v[h, n]
//
// A block owns HB heads of one (b, g) cell (heads hb HB .. hb HB + HB - 1 of
// its Hpg) and a strip of S queries, one thread per (head, query): HB x S
// threads, head h of the block in threads h S .. h S + S - 1. Block row y =
// (b G + g) Hpg / HB + hb; the key geometry is the cell's, (b G + g). The
// block stages its heads' zero-padded tables once, from the raw table
// (lattice_common.cuh::stage_padded: (Ht + 2 PAD) x Xp bf16 a head, 63 x 429
// x 2 B = 54 KB at the flagship's SCA), so a pair's bias is four reads of
// shared memory with no per-key copy and no scratch. Only the key tile
// moves: its K and V rows of every head of the block in bf16 and its
// geometry (ys, ms, wy, f), in two stages filled by cp.async while the block
// scores the other, so each tile of KT keys costs one __syncthreads. Per
// thread the work is fused_site.cu's: score every key of the tile
// (site_common.cuh::score) and fold the tile into the one state
// (update_rows), so the output equals fused_site.cu's and
// fused_site_wide.cu's bit for bit and the logsumexp fused_site.cu's lse
// instance.
//
// Bound: operations per (query, key) pair, as fused_site.cu (the bias's
// three lerps from four shared-memory reads, the exp, 2 ch multiply-adds).
// What this layout buys on the H100 is occupancy: a block's shared memory is
// its tables and 2 x (2 HB KT CH x 2 + 4 KT x 4) bytes of key stages, where
// a window ring of the same tile took 136 KB at the flagship's SCA and left
// one 128-thread block an SM.
//
// The shared memory and the launch check come from the wrappers
// (ops/kernels/fused_site_fold.py::whole_smem, heads_plan;
// fused_site_wide.py::prefetch_plan), which pick this path from the shapes.
#pragma once

#include "lattice_ring.cuh"
#include "site_common.cuh"

namespace site_whole {

using site::KT;

// One stage of the key pipeline: the block's heads' K rows, then V rows, of
// a key tile in bf16, (HB, KT, CH) each, then the tile's ys, ms, wy and f
// (KT words each).
template <int CH, int HB>
struct Stage {
  static constexpr int KV = HB * KT * CH;                // bf16 of K or V
  static constexpr int BYTES = 2 * KV * 2 + 4 * KT * 4;  // a multiple of 16
};

// Shared memory of a block: two stages, then the HB padded tables.
template <int CH, int HB>
size_t smem_bytes(int Ht, int Xp) {
  return (size_t)2 * Stage<CH, HB>::BYTES +
         (size_t)HB * (Ht + 2 * lattice::PAD) * Xp * sizeof(__nv_bfloat16);
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

// MAXT threads a block at most, MINB blocks an SM asked of the compiler.
template <int CH, int HB, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) fused_site_whole_kernel(
    const __nv_bfloat16* __restrict__ table,  // (G, Hpg, Ht, Wt)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    const __nv_bfloat16* __restrict__ q,  // (B, G, Hpg, M, CH)
    const __nv_bfloat16* __restrict__ k,  // (B, G, Hpg, N, CH)
    const __nv_bfloat16* __restrict__ v,  // (B, G, Hpg, N, CH)
    float* __restrict__ out,              // (B, G, Hpg, M, CH)
    float* __restrict__ lse,              // (B, G, Hpg, M) or null
    int G, int Hpg, int Ht, int Wt, int Xp, int N, int H, int W, int S,
    float scale) {
  using St = Stage<CH, HB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two stages, then the (HB, Ht + 2 PAD, Xp) padded tables
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
  // this thread's corner in its head's table
  const __nv_bfloat16* tq =
      st + (h * (Ht + 2 * lattice::PAD) + iy) * Xp + u0[ix];

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
  lattice::stage_padded(st, table + ((size_t)g * Hpg + h0) * Ht * Wt, HB, Ht,
                        Wt, Xp);
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
        const float b = lattice::bias_at(tq + sys[j] * Xp + sms[j], Xp, gcol,
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

// Launch on `stream`: S queries a head (HB S threads, a multiple of 32, at
// most MAXT), Xp the row pitch of the padded tables. k and v must start on
// a 2 CH-byte boundary (one vector copy a row). Returns cudaGetLastError.
template <int CH, int HB, int MAXT, int MINB>
int launch(const void* table, const void* ys, const void* ms, const void* wy,
           const void* fx, const void* u0, const void* gcomb, const void* q,
           const void* k, const void* v, void* out, void* lse, int B, int G,
           int Hpg, int Ht, int Wt, int Xp, int N, int H, int W, int S,
           float scale, cudaStream_t stream) {
  const int threads = HB * S;
  if (S < 1 || threads > MAXT || threads % 32 || Hpg % HB ||
      (size_t)k % (CH * 2) || (size_t)v % (CH * 2))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<CH, HB>(Ht, Xp);
  const int rc = lattice::set_smem(
      (const void*)fused_site_whole_kernel<CH, HB, MAXT, MINB>, smem);
  if (rc) return rc;
  dim3 grid((H * W + S - 1) / S, B * G * (Hpg / HB));
  fused_site_whole_kernel<CH, HB, MAXT, MINB><<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (float*)out, (float*)lse, G, Hpg, Ht, Wt, Xp,
      N, H, W, S, scale);
  return (int)cudaGetLastError();
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
