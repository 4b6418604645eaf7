// Fused lattice attention site for narrow heads (ch 4 or 8):
//   out[b, g, h, m, :] = sum_n softmax_n(bias[n, m] + scale * q[m] . k[n]) v[n]
// with the rpe bias built in registers, an online softmax over key tiles,
// and neither bias nor scores written to device memory.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/fused_attn.py
// ::fused_site_call_sh / _site_kernel_sh. The TPU staging (shift replicas,
// 8-row alignment, g-major grid order, 64-key padding, packed starts) is not
// carried over. It keeps the Pallas kernel's roundings: q . k from bf16
// inputs with float32 sums, the bias lerped in float32 from the bf16 table,
// and p = exp(s - running max) rounded to bf16 before it multiplies V.
//
// Bound: operations per (query, key) pair, not bytes: the bias (three lerps
// from four shared-memory reads), the exp and 2 * ch multiply-adds for QK
// and AV. A block takes one (b, g, h) and THREADS queries, one query per
// thread, with q, the running max, sum and output in registers. It keeps
// the zero-padded (g, h) table in shared memory (64 x 357 x 2 B = 46 KB for
// the flagship's SCA) and walks the keys in tiles of KT, staged in shared
// memory. Scores are kept in base 2 (scaled by log2 e) so the softmax uses
// exp2. The score of a pair is written with explicit roundings (fmaf for
// q . k and for scale * qk + bias, then one rounded multiply by log2 e), so
// ops/deform_attn.py::site_consumer_online can repeat it in PyTorch.
//
// With a non-null `lse` the kernel also writes the softmax's logsumexp per
// (head, query) in natural-log units, the residual of the training backward
// (fused_site_bwd.cu). That instance replaces fused_attn.py
// ::fused_site_call_lse / _site_kernel_lse; its output equals the plain
// instance's bit for bit.
//
// Head widths: 4 and 8, the two the supported models give it.

#include "lattice_common.cuh"

namespace {

constexpr int KT = 32;
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int CH>
__global__ void __launch_bounds__(THREADS) fused_site_kernel(
    const __nv_bfloat16* __restrict__ table,  // (G, Hpg, Ht, Wt)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    const __nv_bfloat16* __restrict__ q,  // (B, G, Hpg, M, CH)
    const __nv_bfloat16* __restrict__ k,  // (B, G, Hpg, N, CH)
    const __nv_bfloat16* __restrict__ v,  // (B, G, Hpg, N, CH)
    float* __restrict__ out,              // (B, G, Hpg, M, CH)
    float* __restrict__ lse,              // (B, G, Hpg, M) or null
    int G, int Hpg, int Ht, int Wt, int Xp, int N, int H, int W,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);  // (KT, CH)
  float* sv = sk + KT * CH;                         // (KT, CH)
  float* swy = sv + KT * CH;                        // (KT,)
  float* sf = swy + KT;                             // (KT,)
  int* sbase = reinterpret_cast<int*>(sf + KT);     // (KT,) ys * Xp + ms
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(sbase + KT);  // padded

  const int bgh = blockIdx.y;  // (b * G + g) * Hpg + h
  const int bg = bgh / Hpg;    // b * G + g
  const int g = bg % G;
  const int h = bgh - bg * Hpg;
  const int M = H * W;
  lattice::stage_padded(st, table + ((size_t)g * Hpg + h) * Ht * Wt, 1, Ht,
                        Wt, Xp);

  const int m_raw = blockIdx.x * THREADS + threadIdx.x;
  const bool active = m_raw < M;
  const int m = active ? m_raw : M - 1;  // idle lanes still help stage tiles
  const int iy = m / W;
  const int ix = m - iy * W;
  const float gcol = gcomb[ix];
  const __nv_bfloat16* tq = st + iy * Xp + u0[ix];  // this query's corner

  float qf[CH];
  const __nv_bfloat16* qp = q + ((size_t)bgh * M + m) * CH;
#pragma unroll
  for (int c = 0; c < CH; ++c) qf[c] = __bfloat162float(qp[c]);

  float mrun = -1e30f;
  float l = 0.0f;
  float o[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) o[c] = 0.0f;

  const __nv_bfloat16* kb = k + (size_t)bgh * N * CH;
  const __nv_bfloat16* vb = v + (size_t)bgh * N * CH;
  const size_t geo = (size_t)bg * N;

  for (int n0 = 0; n0 < N; n0 += KT) {
    const int nk = min(KT, N - n0);
    __syncthreads();  // the previous tile is consumed; the table is staged
    for (int i = threadIdx.x; i < nk * CH; i += THREADS) {
      sk[i] = __bfloat162float(kb[(size_t)n0 * CH + i]);
      sv[i] = __bfloat162float(vb[(size_t)n0 * CH + i]);
    }
    for (int i = threadIdx.x; i < nk; i += THREADS) {
      sbase[i] = ys[geo + n0 + i] * Xp + ms[geo + n0 + i];
      swy[i] = wy[geo + n0 + i];
      sf[i] = fx[geo + n0 + i];
    }
    __syncthreads();

    float s[KT];
    float tmax = -1e30f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < nk) {
        float qk = 0.0f;
#pragma unroll
        for (int c = 0; c < CH; ++c) qk = __fmaf_rn(qf[c], sk[j * CH + c], qk);
        const float bias =
            lattice::bias_at(tq + sbase[j], Xp, gcol, swy[j], sf[j]);
        s[j] = __fmul_rn(__fmaf_rn(scale, qk, bias), LOG2E);
        tmax = fmaxf(tmax, s[j]);
      }
    }
    const float mnew = fmaxf(mrun, tmax);
    const float alpha = exp2f(mrun - mnew);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < CH; ++c) o[c] *= alpha;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < nk) {
        const float p = exp2f(s[j] - mnew);
        l += p;
        const float pb = __bfloat162float(__float2bfloat16_rn(p));
#pragma unroll
        for (int c = 0; c < CH; ++c) o[c] = fmaf(pb, sv[j * CH + c], o[c]);
      }
    }
    mrun = mnew;
  }

  if (active) {
    const float lsafe = fmaxf(l, 1e-30f);
    float* op = out + ((size_t)bgh * M + m) * CH;
#pragma unroll
    for (int c = 0; c < CH; ++c) op[c] = o[c] / lsafe;
    // scores are in base 2: back to natural-log units, once
    if (lse != nullptr) lse[(size_t)bgh * M + m] = (mrun + log2f(lsafe)) * LN2;
  }
}

template <int CH>
int launch(const void* table, const void* ys, const void* ms, const void* wy,
           const void* fx, const void* u0, const void* gcomb, const void* q,
           const void* k, const void* v, void* out, void* lse, int B, int G,
           int Hpg, int Ht, int Wt, int Xp, int N, int H, int W, float scale,
           cudaStream_t stream) {
  const size_t smem = (size_t)KT * CH * 2 * sizeof(float) +
                      (size_t)KT * 3 * sizeof(float) +
                      (size_t)(Ht + 2 * lattice::PAD) * Xp *
                          sizeof(__nv_bfloat16);
  int rc = lattice::set_smem((const void*)fused_site_kernel<CH>, smem);
  if (rc) return rc;
  const int M = H * W;
  dim3 grid((M + THREADS - 1) / THREADS, B * G * Hpg);
  fused_site_kernel<CH><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (float*)out, (float*)lse, G, Hpg, Ht, Wt, Xp,
      N, H, W, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* table, const void* ys, const void* ms,
             const void* wy, const void* fx, const void* u0,
             const void* gcomb, const void* q, const void* k, const void* v,
             void* out, void* lse, int B, int G, int Hpg, int Ht, int Wt,
             int Xp, int N, int H, int W, int ch, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SITE_CASE(C)                                                         \
  case C:                                                                    \
    return launch<C>(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, lse, B, \
                     G, Hpg, Ht, Wt, Xp, N, H, W, scale, s);
  switch (ch) {
    SITE_CASE(4)
    SITE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SITE_CASE
}

}  // namespace

extern "C" int fused_site_launch(const void* table, const void* ys,
                                 const void* ms, const void* wy,
                                 const void* fx, const void* u0,
                                 const void* gcomb, const void* q,
                                 const void* k, const void* v, void* out,
                                 int B, int G, int Hpg, int Ht, int Wt,
                                 int Xp, int N, int H, int W, int ch,
                                 float scale, void* stream) {
  return dispatch(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, nullptr, B,
                  G, Hpg, Ht, Wt, Xp, N, H, W, ch, scale, stream);
}

extern "C" int fused_site_lse_launch(const void* table, const void* ys,
                                     const void* ms, const void* wy,
                                     const void* fx, const void* u0,
                                     const void* gcomb, const void* q,
                                     const void* k, const void* v, void* out,
                                     void* lse, int B, int G, int Hpg, int Ht,
                                     int Wt, int Xp, int N, int H, int W,
                                     int ch, float scale, void* stream) {
  return dispatch(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, lse, B, G,
                  Hpg, Ht, Wt, Xp, N, H, W, ch, scale, stream);
}
