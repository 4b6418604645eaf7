// Fused lattice attention site for narrow heads (ch 4 or 8) on a table of
// any size: fused_site.cu without the staged table.
//   out[b, g, h, m, :] = sum_n softmax_n(bias[n, m] + scale * q[m] . k[n]) v[n]
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/fused_attn.py
// ::_fused_site_pallas_call (_site_kernel, _site_fwd_body; public
// fused_site_call), the fused site on the plain ("resolve") staging, which
// the JAX package takes where the shift-replicated table block is too
// large or shift replication is switched off. That staging (a table
// rearranged per key shift class, 64-key padding, packed starts) is how a
// TPU kernel gets windows out of VMEM and is not carried over. With a
// non-null `lse` it is the instance of fused_attn.py::fused_site_call_lse
// (_site_kernel_lse), the forward of the fused training site.
//
// fused_site.cu keeps one head's zero-padded table in shared memory, which
// refuses a table over ~224 KB (ops/deform_attn.py::site_route). Here each
// thread reads the four window entries of each (key, query) pair from the
// raw bf16 table in device memory with __ldg, with bounds checks in place
// of the zero padding (lattice_common.cuh::bias_at_raw, the arithmetic of
// lattice_bias_wide.cu). The block shape, the key tiles of KT and their
// order are fused_site.cu's, and so is the online softmax
// (site_common.cuh), so the output and the logsumexp equal fused_site.cu's
// bit for bit.
//
// Bound: operations per (query, key) pair (the bias, an exp2, 2 ch
// multiply-adds). A block takes one (b, g, h) and THREADS consecutive
// queries, one per thread; neighbouring threads read neighbouring columns
// of one key's window, so the window stays in L1 and the table (0.05-0.4 MB
// a head) in L2. Shared memory holds only the key tile (K, V, geometry), so
// any table size launches and several blocks share an SM.
//
// Head widths: 4 and 8, as fused_site.cu.

#include "site_common.cuh"

namespace {

using site::KT;
constexpr int THREADS = 128;

template <int CH>
__global__ void __launch_bounds__(THREADS) fused_site_wide_kernel(
    const __nv_bfloat16* __restrict__ table,  // (G, Hpg, Ht, Wt)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    const __nv_bfloat16* __restrict__ q,  // (B, G, Hpg, M, CH)
    const __nv_bfloat16* __restrict__ k,  // (B, G, Hpg, N, CH)
    const __nv_bfloat16* __restrict__ v,  // (B, G, Hpg, N, CH)
    float* __restrict__ out,              // (B, G, Hpg, M, CH)
    float* __restrict__ lse,              // (B, G, Hpg, M) or null
    int G, int Hpg, int Ht, int Wt, int N, int H, int W, float scale) {
  __shared__ float sk[KT * CH];
  __shared__ float sv[KT * CH];
  __shared__ float swy[KT];
  __shared__ float sf[KT];
  __shared__ int sy[KT];  // window row start ys
  __shared__ int sx[KT];  // window column start ms

  const int bgh = blockIdx.y;  // (b * G + g) * Hpg + h
  const int bg = bgh / Hpg;    // b * G + g
  const int g = bg % G;
  const int h = bgh - bg * Hpg;
  const int M = H * W;
  const __nv_bfloat16* t = table + ((size_t)g * Hpg + h) * Ht * Wt;

  const int m_raw = blockIdx.x * THREADS + threadIdx.x;
  const bool active = m_raw < M;
  const int m = active ? m_raw : M - 1;  // idle lanes still help stage tiles
  const int iy = m / W;
  const int ix = m - iy * W;
  const float gcol = gcomb[ix];
  const int cq = u0[ix];

  float qf[CH];
  const __nv_bfloat16* qp = q + ((size_t)bgh * M + m) * CH;
#pragma unroll
  for (int c = 0; c < CH; ++c) qf[c] = __bfloat162float(qp[c]);

  const __nv_bfloat16* kb = k + (size_t)bgh * N * CH;
  const __nv_bfloat16* vb = v + (size_t)bgh * N * CH;
  const size_t geo = (size_t)bg * N;
  site::Online<CH> state;
  for (int n0 = 0; n0 < N; n0 += KT) {
    const int nk = min(KT, N - n0);
    __syncthreads();  // the previous tile is consumed
    site::stage_kv<CH>(sk, sv, kb, vb, n0, nk);
    for (int i = threadIdx.x; i < nk; i += THREADS) {
      sy[i] = ys[geo + n0 + i];
      sx[i] = ms[geo + n0 + i];
      swy[i] = wy[geo + n0 + i];
      sf[i] = fx[geo + n0 + i];
    }
    __syncthreads();
    site::tile(state, qf, sk, sv, nk, scale, [&](int j) {
      return lattice::bias_at_raw(t, Ht, Wt, sy[j] + iy, sx[j] + cq, gcol,
                                  swy[j], sf[j]);
    });
  }
  if (active)
    site::finish(state, out + ((size_t)bgh * M + m) * CH,
                 lse == nullptr ? nullptr : lse + (size_t)bgh * M + m);
}

template <int CH>
int launch(const void* table, const void* ys, const void* ms, const void* wy,
           const void* fx, const void* u0, const void* gcomb, const void* q,
           const void* k, const void* v, void* out, void* lse, int B, int G,
           int Hpg, int Ht, int Wt, int N, int H, int W, float scale,
           cudaStream_t stream) {
  const int M = H * W;
  dim3 grid((M + THREADS - 1) / THREADS, B * G * Hpg);
  fused_site_wide_kernel<CH><<<grid, THREADS, 0, stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (float*)out, (float*)lse, G, Hpg, Ht, Wt, N,
      H, W, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* table, const void* ys, const void* ms,
             const void* wy, const void* fx, const void* u0,
             const void* gcomb, const void* q, const void* k, const void* v,
             void* out, void* lse, int B, int G, int Hpg, int Ht, int Wt,
             int N, int H, int W, int ch, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (ch) {
    case 4:
      return launch<4>(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, lse, B,
                       G, Hpg, Ht, Wt, N, H, W, scale, s);
    case 8:
      return launch<8>(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, lse, B,
                       G, Hpg, Ht, Wt, N, H, W, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fused_site_wide_launch(const void* table, const void* ys,
                                      const void* ms, const void* wy,
                                      const void* fx, const void* u0,
                                      const void* gcomb, const void* q,
                                      const void* k, const void* v, void* out,
                                      int B, int G, int Hpg, int Ht, int Wt,
                                      int N, int H, int W, int ch, float scale,
                                      void* stream) {
  return dispatch(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, nullptr, B,
                  G, Hpg, Ht, Wt, N, H, W, ch, scale, stream);
}

extern "C" int fused_site_wide_lse_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* q,
    const void* k, const void* v, void* out, void* lse, int B, int G, int Hpg,
    int Ht, int Wt, int N, int H, int W, int ch, float scale, void* stream) {
  return dispatch(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, lse, B, G,
                  Hpg, Ht, Wt, N, H, W, ch, scale, stream);
}
