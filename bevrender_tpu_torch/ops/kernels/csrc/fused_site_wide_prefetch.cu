// fused_site_wide.cu with the next key tile's windows prefetched into a
// two-stage ring in shared memory by asynchronous copies (cp.async) while
// the current tile computes.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/experimental.py
// ::fused_site_call_dma / _site_kernel_dma, the fused site on the plain
// staging with tile t+1's windows drained by pltpu.make_async_copy (double
// buffered) while tile t computes.
//
// Two paths, chosen by the wrapper (ops/kernels/fused_site_wide.py
// ::prefetch_plan) from the shapes alone:
//
// - Whole table (site_whole.cuh::fused_site_whole_kernel with HB = 1 head a
//   block), wherever one head's zero-padded table and two key stages fit
//   one block: every site of the supported models (63 x 429 x 2 B + 3 KB =
//   57 KB at the flagship's SCA). A block owns one (b, g, h) and a strip of
//   S queries, one thread per query; it stages the head's padded table
//   once from the raw table, and K, V (bf16) and the tile's geometry are
//   double-buffered by cp.async with one __syncthreads a tile. The TPU
//   prefetches windows because its VMEM cannot hold a replicated table; an
//   SM's shared memory holds the whole head table several times over, so
//   nothing but the key tile needs to move.
// - The window ring (fused_site_wide_prefetch_kernel), for a site whose one
//   head's table does not fit (a head of BEV 64 at depth 5: 264,702 bytes
//   whole, 174,464 ring). Each block takes one (b, g, h) and THREADS
//   consecutive queries, which lie on query rows iy0 .. iy1 (iy1 - iy0 <=
//   ceil((THREADS - 1) / W)). Of a key's window they touch table rows ys +
//   iy0 .. ys + iy1 + 1 and the columns ms .. ms + max(u0) + 2, so a ring
//   stage holds, for each of the KT keys of a tile, R x CW bf16 with R =
//   min(ceil((THREADS - 1) / W), H - 1) + 2 and CW the columns rounded out
//   to whole 16-byte chunks. R, CW and the shared memory they need come
//   from the wrapper (fused_site_wide.py::prefetch_ring), which refuses a
//   shape over SMEM_PER_BLOCK. Copies are 16 bytes from a pitched
//   zero-padded copy of the table that the launch makes first
//   (lattice_ring.cuh): aligned, and with no bounds checks. Per tile t:
//   __syncthreads (tile t-1 consumed, its stage free); issue tile t+1's
//   copies into the other stage and commit; load tile t's K, V and
//   geometry; wait for all but the newest group; __syncthreads; compute
//   tile t from its stage.
//
// On both paths the tile order and the online softmax are
// fused_site_wide.cu's (site_common.cuh), and lattice_common.cuh::bias_at on
// the staged table or window reads the same four entries as its
// bias_at_raw, so the output equals it, and fused_site.cu, bit for bit.
//
// Bound: operations per (query, key) pair, as fused_site_wide.cu. The ring
// adds R x CW / THREADS = 8.3 staged entries per pair at the flagship's SCA
// against the 4 that the bias reads, and its 136 KB there left one block of
// THREADS threads per SM, so its time counted waves of 132 blocks; the
// whole-table path stages the table once a block and fits several blocks
// an SM.
//
// Head widths: 4 and 8, as fused_site.cu.

#include "site_whole.cuh"

namespace {

using site::KT;
constexpr int THREADS = 128;  // queries of a ring block
// queries of a whole-table block at most, and the blocks an SM the compiler
// is asked to fit (fused_site_wide.py::WHOLE_THREADS)
constexpr int WHOLE_THREADS = 160;
constexpr int WHOLE_MIN_BLOCKS = 4;

template <int CH>
__global__ void __launch_bounds__(THREADS) fused_site_wide_prefetch_kernel(
    const __nv_bfloat16* __restrict__ tp,  // (G * Hpg, Yp, Xs) pitched
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    const __nv_bfloat16* __restrict__ q,  // (B, G, Hpg, M, CH)
    const __nv_bfloat16* __restrict__ k,  // (B, G, Hpg, N, CH)
    const __nv_bfloat16* __restrict__ v,  // (B, G, Hpg, N, CH)
    float* __restrict__ out,              // (B, G, Hpg, M, CH)
    int G, int Hpg, int Yp, int Xs, int N, int H, int W, int R, int CW,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int key_pitch = R * CW;
  const int stage = KT * key_pitch;
  // (2, KT, R, CW) ring of key windows
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* sk = reinterpret_cast<float*>(ring + 2 * stage);  // (KT, CH)
  float* sv = sk + KT * CH;                                 // (KT, CH)
  float* swy = sv + KT * CH;                                // (KT,)
  float* sf = swy + KT;                                     // (KT,)
  int* soff = reinterpret_cast<int*>(sf + KT);  // (KT,) ms & 7

  const int bgh = blockIdx.y;  // (b * G + g) * Hpg + h
  const int bg = bgh / Hpg;    // b * G + g
  const int g = bg % G;
  const int h = bgh - bg * Hpg;
  const int M = H * W;
  const __nv_bfloat16* tph = tp + ((size_t)g * Hpg + h) * Yp * Xs;

  const int m0 = blockIdx.x * THREADS;
  const int iy0 = m0 / W;
  const int rows = (min(m0 + THREADS, M) - 1) / W - iy0 + 2;
  const int m_raw = m0 + threadIdx.x;
  const bool active = m_raw < M;
  const int m = active ? m_raw : M - 1;  // idle lanes still help stage tiles
  const int iy = m / W;
  const int ix = m - iy * W;
  const float gcol = gcomb[ix];
  const int corner = (iy - iy0) * CW + u0[ix];  // in a key's window

  float qf[CH];
  const __nv_bfloat16* qp = q + ((size_t)bgh * M + m) * CH;
#pragma unroll
  for (int c = 0; c < CH; ++c) qf[c] = __bfloat162float(qp[c]);

  const __nv_bfloat16* kb = k + (size_t)bgh * N * CH;
  const __nv_bfloat16* vb = v + (size_t)bgh * N * CH;
  const size_t geo = (size_t)bg * N;
  site::Online<CH> state;

  lattice::copy_windows(ring, key_pitch, tph, Xs, ys + geo, ms + geo,
                        min(KT, N), iy0, rows, CW);
  lattice::cp_async_commit();
  for (int n0 = 0, t = 0; n0 < N; n0 += KT, ++t) {
    const int nk = min(KT, N - n0);
    const int buf = t & 1;
    __syncthreads();  // tile t-1 consumed: its stage and the key tile free
    if (n0 + KT < N)
      lattice::copy_windows(ring + (buf ^ 1) * stage, key_pitch, tph, Xs,
                            ys + geo + n0 + KT, ms + geo + n0 + KT,
                            min(KT, N - n0 - KT), iy0, rows, CW);
    lattice::cp_async_commit();  // possibly empty: one group per tile
    site::stage_kv<CH>(sk, sv, kb, vb, n0, nk);
    for (int i = threadIdx.x; i < nk; i += THREADS) {
      soff[i] = ms[geo + n0 + i] & 7;
      swy[i] = wy[geo + n0 + i];
      sf[i] = fx[geo + n0 + i];
    }
    lattice::cp_async_wait<1>();  // this thread's copies of tile t landed
    __syncthreads();              // and every other thread's
    const __nv_bfloat16* win = ring + buf * stage + corner;
    site::tile(state, qf, sk, sv, nk, scale, [&](int j) {
      return lattice::bias_at(win + j * key_pitch + soff[j], CW, gcol, swy[j],
                              sf[j]);
    });
  }

  if (active) site::finish(state, out + ((size_t)bgh * M + m) * CH, nullptr);
}

template <int CH>
int launch(const void* table, void* pitched, const void* ys, const void* ms,
           const void* wy, const void* fx, const void* u0, const void* gcomb,
           const void* q, const void* k, const void* v, void* out, int B,
           int G, int Hpg, int Ht, int Wt, int Xs, int N, int H, int W, int R,
           int CW, float scale, cudaStream_t stream) {
  int rc = lattice::pitch_table(pitched, table, G * Hpg, Ht, Wt, Xs, stream);
  if (rc) return rc;
  const size_t smem = (size_t)2 * KT * R * CW * sizeof(__nv_bfloat16) +
                      (size_t)KT * (2 * CH + 3) * sizeof(float);
  rc = lattice::set_smem((const void*)fused_site_wide_prefetch_kernel<CH>,
                         smem);
  if (rc) return rc;
  const int M = H * W;
  dim3 grid((M + THREADS - 1) / THREADS, B * G * Hpg);
  fused_site_wide_prefetch_kernel<CH><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)pitched, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (float*)out, G, Hpg, Ht + 2 * lattice::PAD,
      Xs, N, H, W, R, CW, scale);
  return (int)cudaGetLastError();
}

template <int CH>
const void* whole_kernel() {
  return (const void*)site_whole::fused_site_whole_kernel<
      CH, 1, WHOLE_THREADS, WHOLE_MIN_BLOCKS>;
}

}  // namespace

// The whole-table path: S queries a block (a multiple of 32, at most
// WHOLE_THREADS), Xp the row pitch of the padded table; k and v on a 2
// ch-byte boundary.
extern "C" int fused_site_wide_prefetch_whole_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* q,
    const void* k, const void* v, void* out, int B, int G, int Hpg, int Ht,
    int Wt, int Xp, int N, int H, int W, int S, int ch, float scale,
    void* stream) {
  if (ch != 4 && ch != 8) return (int)cudaErrorInvalidValue;
  auto fn = ch == 4 ? site_whole::launch<4, 1, WHOLE_THREADS, WHOLE_MIN_BLOCKS>
                    : site_whole::launch<8, 1, WHOLE_THREADS, WHOLE_MIN_BLOCKS>;
  return fn(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, nullptr, B, G, Hpg,
            Ht, Wt, Xp, N, H, W, S, scale, (cudaStream_t)stream);
}

// The ring path. `pitched` is scratch of G * Hpg * (Ht + 2 PAD) * Xs bf16
// (Xs a multiple of 8) for the pitched copy of the table.
extern "C" int fused_site_wide_prefetch_launch(
    const void* table, void* pitched, const void* ys, const void* ms,
    const void* wy, const void* fx, const void* u0, const void* gcomb,
    const void* q, const void* k, const void* v, void* out, int B, int G,
    int Hpg, int Ht, int Wt, int Xs, int N, int H, int W, int R, int CW,
    int ch, float scale, void* stream) {
  if (Xs % 8 || CW % 8 || (ch != 4 && ch != 8))
    return (int)cudaErrorInvalidValue;
  auto fn = ch == 4 ? launch<4> : launch<8>;
  return fn(table, pitched, ys, ms, wy, fx, u0, gcomb, q, k, v, out, B, G,
            Hpg, Ht, Wt, Xs, N, H, W, R, CW, scale, (cudaStream_t)stream);
}

// Blocks of `threads` threads with `smem` bytes of dynamic shared memory that
// one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for
// the whole-table kernel (`whole` non-zero) or the ring kernel of head width
// ch. A negative CUDA error code where the query fails.
extern "C" int fused_site_wide_prefetch_occupancy(int whole, int ch,
                                                  int threads, int smem) {
  if (ch != 4 && ch != 8) return -(int)cudaErrorInvalidValue;
  const void* f =
      whole ? (ch == 4 ? whole_kernel<4>() : whole_kernel<8>())
            : (ch == 4 ? (const void*)fused_site_wide_prefetch_kernel<4>
                       : (const void*)fused_site_wide_prefetch_kernel<8>);
  return site_whole::occupancy(f, threads, smem);
}
