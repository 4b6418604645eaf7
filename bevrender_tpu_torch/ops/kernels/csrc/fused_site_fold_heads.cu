// The fused site with the HPG heads of a (b, g) cell folded into one block:
//   out[b, g, h, m, :] = sum_n softmax_n(bias[h, n, m] + scale q[h, m] . k[h, n]) v[h, n]
// for every head h of the cell at once, each key's geometry staged once for
// all heads.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/experimental.py
// ::fused_site_call_v2 / _site_kernel_v2 (_site_v2_body), the DMA-prefetch
// site on the plain staging with the Hpg heads folded: one kernel instance
// per (b, g) cell for all heads, the scores in one (keys, H x 128 lanes)
// tile whose column iy * 128 + h * W + x folds the heads into each query
// row, and QK and AV as one block-diagonal product. With a non-null `lse`
// it is the instance _site_kernel_v2_lse (fused_site_call_v2_lse), the
// forward of a fused_bwd training site: it also writes the softmax's
// logsumexp per (head, query), the residual of fused_site_bwd.cu. The TPU
// prefetches key windows because its VMEM cannot hold shift-replicated
// tables; the lane layout and the windows are the TPU's and are not carried
// over where the tables fit. The fold is.
//
// Two paths, chosen by the wrapper (ops/kernels/fused_site_fold.py
// ::heads_plan) from the shapes alone:
//
// - Whole tables (fused_site_fold_heads_kernel), wherever both heads'
//   zero-padded tables fit one block: every site of the supported models.
//   A block owns one (b, g) cell and a strip of S queries, one thread per
//   (head, query): HPG x S threads, head h in threads h S .. h S + S - 1. It
//   stages the HPG padded tables once ((Ht + 2 PAD) x Xp bf16 each, as
//   fused_site.cu stages one; 2 x 63 x 429 x 2 B = 108 KB at the flagship's
//   SCA), so a pair's bias is four reads of shared memory with no per-key
//   copy. Only the key tile moves: every head's K and V rows in bf16 and
//   the tile's geometry (ys, ms, wy, f) for all heads, in two stages filled
//   by cp.async while the block scores the other, so each tile of KT keys
//   costs one __syncthreads. Per thread the work is fused_site.cu's:
//   score every key of the tile (site_common.cuh::score) and fold the tile
//   into the one state (update_rows), so the output equals fused_site.cu's
//   and fused_site_wide_prefetch.cu's bit for bit and the logsumexp equals
//   fused_site.cu's lse instance. Two blocks of up to 256 threads fit an SM
//   at the flagship's SCA (113 KB each) where one 128-thread block with the
//   ring (below) did.
// - The window ring (fused_site_fold_heads_ring_kernel), for a folded site
//   whose tables do not fit: a block owns one (b, g) cell, all HPG heads
//   and THREADS consecutive queries (query rows iy0 .. iy1), one thread per
//   query carrying HPG online-softmax states. Of a key's window its queries
//   touch, per head, R rows from ys + iy0 and CW columns (whole 16-byte
//   chunks) from ms, as in fused_site_wide_prefetch.cu; the copies come
//   from a pitched zero-padded copy of the table that the launch makes
//   first (lattice_ring.cuh). Two ring stages of KT keys for every head
//   would not fit (2 x 32 x 2 x 7 x 152 x 2 B = 272 KB at a window of the
//   flagship's SCA), and a smaller key tile would change the softmax's
//   roundings, so each KT-key tile is staged in two halves of KH keys: the
//   ring is two slots of KH keys x HPG heads x R x CW, sub-tile u in slot u
//   & 1, which lays a whole tile's windows out as one (KT, HPG, R, CW)
//   array. Per tile t: __syncthreads (tile t-1 consumed); issue sub-tile
//   2t+1 into slot 1 and commit; stage the tile's K, V (every head) and
//   geometry; wait for all but the newest group; __syncthreads; score the
//   first half from slot 0; __syncthreads (slot 0 free); issue sub-tile
//   2t+2 into slot 0 and commit; wait; __syncthreads; score the second half
//   from slot 1; fold the tile's scores into each head's state. One commit
//   group per sub-tile, even when empty, so `wait_group 1` always means
//   "this sub-tile's copies". R, CW and the shared memory come from the
//   wrapper (fused_site_fold.py::fold_ring), which refuses a shape over
//   SMEM_PER_BLOCK. Per (head, query) the tiles, their order and every
//   rounding are the same (site_common.cuh: scores_heads and update), so
//   it equals the whole-table path bit for bit.
//
// Bound: operations per (query, key) pair, as fused_site.cu (the bias's
// three lerps from four shared-memory reads, the exp, 2 ch multiply-adds),
// less the column fraction the ring's heads share. What held the ring back
// on the H100 was its 136 KB of shared memory at the flagship's SCA: one
// 128-thread block an SM, so its time counted waves of 132 blocks, each
// thread carrying both heads' chains one after the other.
//
// Head widths 4 and 8, heads per group 1 and 2 (every supported model has
// two); the wrapper takes a site only where HPG x W <= 128, the JAX
// package's condition for its fold.

#include "lattice_ring.cuh"
#include "site_common.cuh"

namespace {

using site::KT;
constexpr int KH = KT / 2;        // keys per ring slot
constexpr int THREADS = 128;      // queries of a ring block
constexpr int MAX_THREADS = 256;  // HPG x S of a whole-table block

// One stage of the whole-table path's key pipeline: every head's K rows,
// then V rows, of a key tile in bf16, (HPG, KT, CH) each, then the tile's
// ys, ms, wy and f (KT words each).
template <int CH, int HPG>
struct Stage {
  static constexpr int KV = HPG * KT * CH;         // bf16 entries of K or V
  static constexpr int BYTES = 2 * KV * 2 + 4 * KT * 4;  // a multiple of 16
};

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

template <int CH, int HPG>
__global__ void __launch_bounds__(MAX_THREADS, 2) fused_site_fold_heads_kernel(
    const __nv_bfloat16* __restrict__ table,  // (G, HPG, Ht, Wt)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    const __nv_bfloat16* __restrict__ q,  // (B, G, HPG, M, CH)
    const __nv_bfloat16* __restrict__ k,  // (B, G, HPG, N, CH)
    const __nv_bfloat16* __restrict__ v,  // (B, G, HPG, N, CH)
    float* __restrict__ out,              // (B, G, HPG, M, CH)
    float* __restrict__ lse,              // (B, G, HPG, M) or null
    int G, int Ht, int Wt, int Xp, int N, int H, int W, int S,
    float scale) {
  using St = Stage<CH, HPG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two stages, then the (HPG, Ht + 2 PAD, Xp) padded tables
  __nv_bfloat16* st =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * St::BYTES);

  const int bg = blockIdx.y;  // b * G + g
  const int g = bg % G;
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

  const __nv_bfloat16* kb = k + (size_t)bg * HPG * N * CH;
  const __nv_bfloat16* vb = v + (size_t)bg * HPG * N * CH;
  const size_t geo = (size_t)bg * N;

  // start the copies of the tile from key n0 into stage `buf`; one commit
  // group a tile, empty past the last key
  auto issue = [&](int n0, int buf) {
    if (n0 < N) {
      __nv_bfloat16* sk =
          reinterpret_cast<__nv_bfloat16*>(smem_raw + buf * St::BYTES);
      int* sg = reinterpret_cast<int*>(sk + 2 * St::KV);
      const int nk = min(KT, N - n0);
      for (int i = threadIdx.x; i < 2 * HPG * nk; i += blockDim.x) {
        const int r = i / nk;  // V rows after K rows, head by head
        const int j = i - r * nk;
        const int hh = r % HPG;
        const __nv_bfloat16* src =
            (r < HPG ? kb : vb) + ((size_t)hh * N + n0 + j) * CH;
        lattice::cp_async<CH * 2>(
            sk + (r >= HPG ? St::KV : 0) + (hh * KT + j) * CH, src);
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
  const __nv_bfloat16* qp = q + (((size_t)bg * HPG + h) * M + m) * CH;
#pragma unroll
  for (int c = 0; c < CH; ++c) qf[c] = __bfloat162float(qp[c]);

  issue(0, 0);
  lattice::stage_padded(st, table + (size_t)g * HPG * Ht * Wt, HPG, Ht, Wt,
                        Xp);
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
    const size_t bhm = ((size_t)bg * HPG + h) * M + m;
    site::finish(state, out + bhm * CH, lse == nullptr ? nullptr : lse + bhm);
  }
}

template <int CH, int HPG>
__global__ void __launch_bounds__(THREADS) fused_site_fold_heads_ring_kernel(
    const __nv_bfloat16* __restrict__ tp,  // (G * HPG, Yp, Xs) pitched
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    const __nv_bfloat16* __restrict__ q,  // (B, G, HPG, M, CH)
    const __nv_bfloat16* __restrict__ k,  // (B, G, HPG, N, CH)
    const __nv_bfloat16* __restrict__ v,  // (B, G, HPG, N, CH)
    float* __restrict__ out,              // (B, G, HPG, M, CH)
    float* __restrict__ lse,              // (B, G, HPG, M) or null
    int G, int Yp, int Xs, int N, int H, int W, int R, int CW, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int head_win = R * CW;           // one head's window of one key
  const int key_pitch = HPG * head_win;  // every head's window of one key
  const int slot = KH * key_pitch;
  // (2, KH, HPG, R, CW) ring: (KT, HPG, R, CW) for the tile in flight
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* sk = reinterpret_cast<float*>(ring + 2 * slot);  // (HPG, KT, CH)
  float* sv = sk + HPG * KT * CH;                          // (HPG, KT, CH)
  float* swy = sv + HPG * KT * CH;                         // (KT,)
  float* sf = swy + KT;                                    // (KT,)
  int* soff = reinterpret_cast<int*>(sf + KT);  // (KT,) ms & 7

  const int bg = blockIdx.y;  // b * G + g
  const int g = bg % G;
  const int M = H * W;
  const __nv_bfloat16* tpg = tp + (size_t)g * HPG * Yp * Xs;  // head 0

  const int m0 = blockIdx.x * THREADS;
  const int iy0 = m0 / W;
  const int rows = (min(m0 + THREADS, M) - 1) / W - iy0 + 2;
  const int m_raw = m0 + threadIdx.x;
  const bool active = m_raw < M;
  const int m = active ? m_raw : M - 1;  // idle lanes still help stage tiles
  const int iy = m / W;
  const int ix = m - iy * W;
  const float gcol = gcomb[ix];
  const int corner = (iy - iy0) * CW + u0[ix];  // in a head's window

  float qf[HPG][CH];
#pragma unroll
  for (int h = 0; h < HPG; ++h) {
    const __nv_bfloat16* qp = q + (((size_t)bg * HPG + h) * M + m) * CH;
#pragma unroll
    for (int c = 0; c < CH; ++c) qf[h][c] = __bfloat162float(qp[c]);
  }

  const __nv_bfloat16* kb = k + (size_t)bg * HPG * N * CH;
  const __nv_bfloat16* vb = v + (size_t)bg * HPG * N * CH;
  const size_t geo = (size_t)bg * N;

  // start the copies of sub-tile u (keys u * KH ...) into slot u & 1
  auto issue = [&](int u) {
    const int n = u * KH;
    if (n < N) {
      __nv_bfloat16* dst = ring + (u & 1) * slot;
#pragma unroll
      for (int h = 0; h < HPG; ++h)
        lattice::copy_windows(dst + h * head_win, key_pitch,
                              tpg + (size_t)h * Yp * Xs, Xs, ys + geo + n,
                              ms + geo + n, min(KH, N - n), iy0, rows, CW);
    }
    lattice::cp_async_commit();  // possibly empty: one group per sub-tile
  };
  const auto bias = [&](int j, float (&b)[HPG]) {
    const lattice::Column col = lattice::column(gcol, sf[j]);
    const __nv_bfloat16* w = ring + j * key_pitch + corner + soff[j];
#pragma unroll
    for (int h = 0; h < HPG; ++h)
      b[h] = lattice::bias_col(w + h * head_win, CW, col, swy[j]);
  };

  site::Online<CH> state[HPG];
  float s[HPG][KT];
  issue(0);
  for (int n0 = 0, t = 0; n0 < N; n0 += KT, ++t) {
    const int nk = min(KT, N - n0);
    __syncthreads();  // tile t-1 consumed: slot 1 and the key tile free
    issue(2 * t + 1);
#pragma unroll
    for (int h = 0; h < HPG; ++h)
      site::stage_kv<CH>(sk + h * KT * CH, sv + h * KT * CH,
                         kb + (size_t)h * N * CH, vb + (size_t)h * N * CH, n0,
                         nk);
    for (int i = threadIdx.x; i < nk; i += THREADS) {
      soff[i] = ms[geo + n0 + i] & 7;
      swy[i] = wy[geo + n0 + i];
      sf[i] = fx[geo + n0 + i];
    }
    lattice::cp_async_wait<1>();  // this thread's copies of sub-tile 2t landed
    __syncthreads();              // and every other thread's
    site::scores_heads<0, KH>(s, qf, sk, nk, scale, bias);
    __syncthreads();  // slot 0 consumed
    issue(2 * t + 2);
    lattice::cp_async_wait<1>();  // sub-tile 2t + 1 landed
    __syncthreads();
    site::scores_heads<KH, KT>(s, qf, sk, nk, scale, bias);
#pragma unroll
    for (int h = 0; h < HPG; ++h)
      site::update(state[h], s[h], sv + h * KT * CH, nk);
  }

  if (active) {
#pragma unroll
    for (int h = 0; h < HPG; ++h) {
      const size_t bhm = ((size_t)bg * HPG + h) * M + m;
      site::finish(state[h], out + bhm * CH,
                   lse == nullptr ? nullptr : lse + bhm);
    }
  }
}

// Shared memory of each path, as the kernels lay it out
// (fused_site_fold.py::whole_smem and fold_ring compute the same).
template <int CH, int HPG>
size_t whole_smem(int Ht, int Xp) {
  return (size_t)2 * Stage<CH, HPG>::BYTES +
         (size_t)HPG * (Ht + 2 * lattice::PAD) * Xp * sizeof(__nv_bfloat16);
}

template <int CH, int HPG>
size_t ring_smem(int R, int CW) {
  return (size_t)2 * KH * HPG * R * CW * sizeof(__nv_bfloat16) +
         (size_t)2 * HPG * KT * CH * sizeof(float) +
         (size_t)KT * 3 * sizeof(float);
}

template <int CH, int HPG>
int launch_whole(const void* table, const void* ys, const void* ms,
                 const void* wy, const void* fx, const void* u0,
                 const void* gcomb, const void* q, const void* k,
                 const void* v, void* out, void* lse, int B, int G, int Ht,
                 int Wt, int Xp, int N, int H, int W, int S, float scale,
                 cudaStream_t stream) {
  const int threads = HPG * S;
  if (S < 1 || threads > MAX_THREADS || threads % 32 ||
      (size_t)k % (CH * 2) || (size_t)v % (CH * 2))
    return (int)cudaErrorInvalidValue;
  const size_t smem = whole_smem<CH, HPG>(Ht, Xp);
  const int rc =
      lattice::set_smem((const void*)fused_site_fold_heads_kernel<CH, HPG>,
                        smem);
  if (rc) return rc;
  dim3 grid((H * W + S - 1) / S, B * G);
  fused_site_fold_heads_kernel<CH, HPG><<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (float*)out, (float*)lse, G, Ht, Wt, Xp, N, H,
      W, S, scale);
  return (int)cudaGetLastError();
}

template <int CH, int HPG>
int launch_ring(const void* table, void* pitched, const void* ys,
                const void* ms, const void* wy, const void* fx,
                const void* u0, const void* gcomb, const void* q,
                const void* k, const void* v, void* out, void* lse, int B,
                int G, int Ht, int Wt, int Xs, int N, int H, int W, int R,
                int CW, float scale, cudaStream_t stream) {
  if (Xs % 8 || CW % 8) return (int)cudaErrorInvalidValue;
  int rc = lattice::pitch_table(pitched, table, G * HPG, Ht, Wt, Xs, stream);
  if (rc) return rc;
  const size_t smem = ring_smem<CH, HPG>(R, CW);
  rc = lattice::set_smem(
      (const void*)fused_site_fold_heads_ring_kernel<CH, HPG>, smem);
  if (rc) return rc;
  const int M = H * W;
  dim3 grid((M + THREADS - 1) / THREADS, B * G);
  fused_site_fold_heads_ring_kernel<CH, HPG><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)pitched, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (float*)out, (float*)lse, G,
      Ht + 2 * lattice::PAD, Xs, N, H, W, R, CW, scale);
  return (int)cudaGetLastError();
}

// The instances: head widths 4 and 8, heads per group 1 and 2.
#define FOLD_INSTANCES(CASE) CASE(4, 1) CASE(4, 2) CASE(8, 1) CASE(8, 2)

int dispatch_whole(const void* table, const void* ys, const void* ms,
                   const void* wy, const void* fx, const void* u0,
                   const void* gcomb, const void* q, const void* k,
                   const void* v, void* out, void* lse, int B, int G,
                   int Hpg, int Ht, int Wt, int Xp, int N, int H, int W,
                   int S, int ch, float scale, void* stream) {
#define WHOLE_CASE(C, P)                                                      \
  if (ch == C && Hpg == P)                                                    \
    return launch_whole<C, P>(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, \
                              lse, B, G, Ht, Wt, Xp, N, H, W, S, scale,       \
                              (cudaStream_t)stream);
  FOLD_INSTANCES(WHOLE_CASE)
#undef WHOLE_CASE
  return (int)cudaErrorInvalidValue;
}

int dispatch_ring(const void* table, void* pitched, const void* ys,
                  const void* ms, const void* wy, const void* fx,
                  const void* u0, const void* gcomb, const void* q,
                  const void* k, const void* v, void* out, void* lse, int B,
                  int G, int Hpg, int Ht, int Wt, int Xs, int N, int H, int W,
                  int R, int CW, int ch, float scale, void* stream) {
#define RING_CASE(C, P)                                                      \
  if (ch == C && Hpg == P)                                                   \
    return launch_ring<C, P>(table, pitched, ys, ms, wy, fx, u0, gcomb, q, k, \
                             v, out, lse, B, G, Ht, Wt, Xs, N, H, W, R, CW,  \
                             scale, (cudaStream_t)stream);
  FOLD_INSTANCES(RING_CASE)
#undef RING_CASE
  return (int)cudaErrorInvalidValue;
}

// The kernel of one path and instance, or null where there is none.
const void* kernel_of(int whole, int ch, int Hpg) {
#define KERNEL_CASE(C, P)                                              \
  if (ch == C && Hpg == P)                                             \
    return whole ? (const void*)fused_site_fold_heads_kernel<C, P>     \
                 : (const void*)fused_site_fold_heads_ring_kernel<C, P>;
  FOLD_INSTANCES(KERNEL_CASE)
#undef KERNEL_CASE
  return nullptr;
}

}  // namespace

// The whole-table path: S queries a block per head (Hpg * S threads, a
// multiple of 32, at most 256), Xp the row pitch of the padded tables.
extern "C" int fused_site_fold_heads_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* q,
    const void* k, const void* v, void* out, int B, int G, int Hpg, int Ht,
    int Wt, int Xp, int N, int H, int W, int S, int ch, float scale,
    void* stream) {
  return dispatch_whole(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out,
                        nullptr, B, G, Hpg, Ht, Wt, Xp, N, H, W, S, ch, scale,
                        stream);
}

// The instance that also writes the logsumexp, `lse` (B, G, Hpg, M) float32.
extern "C" int fused_site_fold_heads_lse_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* q,
    const void* k, const void* v, void* out, void* lse, int B, int G,
    int Hpg, int Ht, int Wt, int Xp, int N, int H, int W, int S, int ch,
    float scale, void* stream) {
  return dispatch_whole(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, lse,
                        B, G, Hpg, Ht, Wt, Xp, N, H, W, S, ch, scale, stream);
}

// The ring path. `pitched` is scratch of G * Hpg * (Ht + 2 PAD) * Xs bf16
// (Xs a multiple of 8) for the pitched copy of the table.
extern "C" int fused_site_fold_heads_ring_launch(
    const void* table, void* pitched, const void* ys, const void* ms,
    const void* wy, const void* fx, const void* u0, const void* gcomb,
    const void* q, const void* k, const void* v, void* out, int B, int G,
    int Hpg, int Ht, int Wt, int Xs, int N, int H, int W, int R, int CW,
    int ch, float scale, void* stream) {
  return dispatch_ring(table, pitched, ys, ms, wy, fx, u0, gcomb, q, k, v,
                       out, nullptr, B, G, Hpg, Ht, Wt, Xs, N, H, W, R, CW,
                       ch, scale, stream);
}

extern "C" int fused_site_fold_heads_ring_lse_launch(
    const void* table, void* pitched, const void* ys, const void* ms,
    const void* wy, const void* fx, const void* u0, const void* gcomb,
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int G, int Hpg, int Ht, int Wt, int Xs, int N, int H, int W, int R,
    int CW, int ch, float scale, void* stream) {
  return dispatch_ring(table, pitched, ys, ms, wy, fx, u0, gcomb, q, k, v,
                       out, lse, B, G, Hpg, Ht, Wt, Xs, N, H, W, R, CW, ch,
                       scale, stream);
}

// Blocks of `threads` threads with `smem` bytes of dynamic shared memory
// that one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// for the whole-table kernel (`whole` non-zero) or the ring kernel of (ch,
// Hpg). A negative CUDA error code where the query fails.
extern "C" int fused_site_fold_heads_occupancy(int whole, int ch, int hpg,
                                               int threads, int smem) {
  const void* f = kernel_of(whole, ch, hpg);
  if (f == nullptr) return -(int)cudaErrorInvalidValue;
  int rc = lattice::set_smem(f, smem);
  int blocks = 0;
  if (!rc)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f,
                                                            threads, smem);
  return rc ? -rc : blocks;
}
