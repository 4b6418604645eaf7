// fused_site.cu with the HPG heads of a (b, g) cell folded into one block:
//   out[b, g, h, m, :] = sum_n softmax_n(bias[h, n, m] + scale q[h, m] . k[h, n]) v[h, n]
// for every head h of the cell at once.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/experimental.py
// ::fused_site_call_sh2 / _site_kernel_sh2, the row-folded shift-replica
// site: one kernel instance per (b, g) cell for all Hpg heads, its scores in
// one (keys, H x 64 lanes) tile whose column iy * 64 + h * W + x folds the
// heads into each query row, and QK and AV as one block-diagonal product.
// That lane layout is the TPU's and is not carried over; the fold is. A
// block owns one (b, g) cell, all HPG heads and THREADS consecutive queries,
// one thread per query carrying HPG online-softmax states. It stages the
// HPG zero-padded head tables in shared memory (2 x 63 x 429 x 2 B = 108 KB
// at the flagship's SCA, against fused_site.cu's 54 KB for one head) and
// every head's K and V of a key tile. Each key's geometry (ys * Xp + ms,
// wy, f) is staged once for all heads, and each pair's column fraction
// (lattice_common.cuh::column) and the query's corner are found once: only
// the four table reads and the lerps are per head.
//
// Per (head, query) the tiles, their order and every rounding are
// fused_site.cu's (site_common.cuh: scores_heads and update run tile's
// steps head by head), so the output equals fused_site.cu's bit for bit.
//
// Bound: operations per (query, key) pair, as fused_site.cu, less the
// column fraction that the heads share. HPG states and HPG x KT scores per
// thread raise its registers; the HPG tables leave two blocks of THREADS
// per SM at the flagship's SCA where fused_site.cu fits three.
//
// Head widths 4 and 8, heads per group 1 and 2 (every supported model has
// two); the wrapper (ops/kernels/fused_site_fold.py) takes a site only
// where HPG x W <= 128, the JAX package's condition for its row fold, and
// the tables fit.

#include "site_common.cuh"

namespace {

using site::KT;
constexpr int THREADS = 128;

template <int CH, int HPG>
__global__ void __launch_bounds__(THREADS) fused_site_fold_rows_kernel(
    const __nv_bfloat16* __restrict__ table,  // (G, HPG, Ht, Wt)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    const __nv_bfloat16* __restrict__ q,  // (B, G, HPG, M, CH)
    const __nv_bfloat16* __restrict__ k,  // (B, G, HPG, N, CH)
    const __nv_bfloat16* __restrict__ v,  // (B, G, HPG, N, CH)
    float* __restrict__ out,              // (B, G, HPG, M, CH)
    int G, int Ht, int Wt, int Xp, int N, int H, int W, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);  // (HPG, KT, CH)
  float* sv = sk + HPG * KT * CH;                   // (HPG, KT, CH)
  float* swy = sv + HPG * KT * CH;                  // (KT,)
  float* sf = swy + KT;                             // (KT,)
  int* sbase = reinterpret_cast<int*>(sf + KT);     // (KT,) ys * Xp + ms
  // (HPG, Ht + 2 PAD, Xp) padded tables
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(sbase + KT);

  const int bg = blockIdx.y;  // b * G + g
  const int g = bg % G;
  const int M = H * W;
  const int head_pitch = (Ht + 2 * lattice::PAD) * Xp;
  lattice::stage_padded(st, table + (size_t)g * HPG * Ht * Wt, HPG, Ht, Wt,
                        Xp);

  const int m_raw = blockIdx.x * THREADS + threadIdx.x;
  const bool active = m_raw < M;
  const int m = active ? m_raw : M - 1;  // idle lanes still help stage tiles
  const int iy = m / W;
  const int ix = m - iy * W;
  const float gcol = gcomb[ix];
  const __nv_bfloat16* tq = st + iy * Xp + u0[ix];  // head 0's corner

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

  site::Online<CH> state[HPG];
  float s[HPG][KT];
  for (int n0 = 0; n0 < N; n0 += KT) {
    const int nk = min(KT, N - n0);
    __syncthreads();  // the previous tile is consumed; the tables are staged
#pragma unroll
    for (int h = 0; h < HPG; ++h)
      site::stage_kv<CH>(sk + h * KT * CH, sv + h * KT * CH,
                         kb + (size_t)h * N * CH, vb + (size_t)h * N * CH, n0,
                         nk);
    for (int i = threadIdx.x; i < nk; i += THREADS) {
      sbase[i] = ys[geo + n0 + i] * Xp + ms[geo + n0 + i];
      swy[i] = wy[geo + n0 + i];
      sf[i] = fx[geo + n0 + i];
    }
    __syncthreads();
    site::scores_heads<0, KT>(s, qf, sk, nk, scale,
                              [&](int j, float (&b)[HPG]) {
      const lattice::Column col = lattice::column(gcol, sf[j]);
      const __nv_bfloat16* p0 = tq + sbase[j];
#pragma unroll
      for (int h = 0; h < HPG; ++h)
        b[h] = lattice::bias_col(p0 + h * head_pitch, Xp, col, swy[j]);
    });
#pragma unroll
    for (int h = 0; h < HPG; ++h)
      site::update(state[h], s[h], sv + h * KT * CH, nk);
  }
  if (active) {
#pragma unroll
    for (int h = 0; h < HPG; ++h)
      site::finish(state[h], out + (((size_t)bg * HPG + h) * M + m) * CH,
                   nullptr);
  }
}

template <int CH, int HPG>
int launch(const void* table, const void* ys, const void* ms, const void* wy,
           const void* fx, const void* u0, const void* gcomb, const void* q,
           const void* k, const void* v, void* out, int B, int G, int Ht,
           int Wt, int Xp, int N, int H, int W, float scale,
           cudaStream_t stream) {
  const size_t smem = (size_t)2 * HPG * KT * CH * sizeof(float) +
                      (size_t)KT * 3 * sizeof(float) +
                      (size_t)HPG * (Ht + 2 * lattice::PAD) * Xp *
                          sizeof(__nv_bfloat16);
  int rc = lattice::set_smem((const void*)fused_site_fold_rows_kernel<CH, HPG>,
                             smem);
  if (rc) return rc;
  const int M = H * W;
  dim3 grid((M + THREADS - 1) / THREADS, B * G);
  fused_site_fold_rows_kernel<CH, HPG><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (float*)out, G, Ht, Wt, Xp, N, H, W, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_site_fold_rows_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* q,
    const void* k, const void* v, void* out, int B, int G, int Hpg, int Ht,
    int Wt, int Xp, int N, int H, int W, int ch, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define FOLD_CASE(C, P)                                                      \
  if (ch == C && Hpg == P)                                                   \
    return launch<C, P>(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, B, G, \
                        Ht, Wt, Xp, N, H, W, scale, s);
  FOLD_CASE(4, 1)
  FOLD_CASE(4, 2)
  FOLD_CASE(8, 1)
  FOLD_CASE(8, 2)
#undef FOLD_CASE
  return (int)cudaErrorInvalidValue;
}

// Blocks of THREADS threads with `smem` bytes of dynamic shared memory that
// one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for
// the instance of (ch, Hpg); a negative CUDA error code where the query
// fails.
extern "C" int fused_site_fold_rows_occupancy(int ch, int hpg, int smem) {
  const void* f = nullptr;
#define KERNEL_CASE(C, P) \
  if (ch == C && hpg == P) f = (const void*)fused_site_fold_rows_kernel<C, P>;
  KERNEL_CASE(4, 1)
  KERNEL_CASE(4, 2)
  KERNEL_CASE(8, 1)
  KERNEL_CASE(8, 2)
#undef KERNEL_CASE
  if (f == nullptr) return -(int)cudaErrorInvalidValue;
  int rc = lattice::set_smem(f, smem);
  int blocks = 0;
  if (!rc)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f,
                                                            THREADS, smem);
  return rc ? -rc : blocks;
}
