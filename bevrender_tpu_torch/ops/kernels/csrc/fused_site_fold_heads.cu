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
// - Whole tables (site_whole.cuh::fused_site_whole_kernel with HB = HPG
//   heads a block), wherever both heads' zero-padded tables fit one block:
//   every site of the supported models. A block owns one (b, g) cell and a
//   strip of S queries, one thread per (head, query): HPG x S threads. It
//   stages the HPG padded tables once (2 x 63 x 429 x 2 B = 108 KB at the
//   flagship's SCA); only the key tile moves, in two cp.async stages with
//   one __syncthreads a tile. Per thread the work is fused_site.cu's, so
//   the output equals fused_site.cu's and fused_site_wide_prefetch.cu's bit
//   for bit and the logsumexp equals fused_site.cu's lse instance. Two
//   blocks of up to 256 threads fit an SM at the flagship's SCA (113 KB
//   each) where one 128-thread block with the ring (below) did.
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

#include "site_whole.cuh"

namespace {

using site::KT;
constexpr int KH = KT / 2;        // keys per ring slot
constexpr int THREADS = 128;      // queries of a ring block
constexpr int MAX_THREADS = 256;  // HPG x S of a whole-table block

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

// Shared memory of the ring path, as the kernel lays it out
// (fused_site_fold.py::fold_ring computes the same).
template <int CH, int HPG>
size_t ring_smem(int R, int CW) {
  return (size_t)2 * KH * HPG * R * CW * sizeof(__nv_bfloat16) +
         (size_t)2 * HPG * KT * CH * sizeof(float) +
         (size_t)KT * 3 * sizeof(float);
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
#define WHOLE_CASE(C, P)                                                   \
  if (ch == C && Hpg == P)                                                 \
    return site_whole::launch<C, P, MAX_THREADS, 2>(                       \
        table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, lse, B, G, Hpg, Ht, \
        Wt, Xp, N, H, W, S, scale, (cudaStream_t)stream);
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
    return whole ? (const void*)site_whole::fused_site_whole_kernel<  \
                       C, P, MAX_THREADS, 2>                           \
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
  return site_whole::occupancy(f, threads, smem);
}
