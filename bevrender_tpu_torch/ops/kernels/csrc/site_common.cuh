// Shared pieces of the fused-site forward kernels (fused_site.cu, the
// whole-table template site_whole.cuh and its instances, and the window
// rings of fused_site_wide_prefetch.cu and fused_site_fold_heads.cu, whose
// folded ring carries every head of a query in one thread): one thread per
// query, the keys in tiles of KT staged in shared memory, an online softmax
// in base 2. The kernels differ only in where a pair's bias comes from and
// how the tile is staged.
//
// Every float32 step is written with an explicit rounding (fmaf for q . k
// and for scale * qk + bias, then one rounded multiply by log2 e; the
// rescale and sum of l and O), so the compiler contracts nothing,
// ops/deform_attn.py::site_consumer_online repeats it in PyTorch, and the
// kernels give the same output and logsumexp bit for bit. p = exp2(s
// - running max) is rounded to bf16 before it multiplies V, as the Pallas
// kernels round it; l sums the unrounded p. The folded ring runs the same
// steps per head (`scores_heads`, `update`), and the template `update_rows`,
// so they equal the others too.
#pragma once

#include "lattice_common.cuh"

namespace site {

constexpr int KT = 32;  // keys per online-softmax step
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One query's softmax state: the running max and sum of its base-2 scores
// and its unnormalised output.
template <int CH>
struct Online {
  float m = -1e30f;
  float l = 0.0f;
  float o[CH] = {};
};

// Stage nk <= KT keys' K and V (rows n0 .. n0 + nk of the head's (N, CH)
// bf16 arrays) into shared memory as float32, with the whole block.
template <int CH>
__device__ __forceinline__ void stage_kv(float* sk, float* sv,
                                         const __nv_bfloat16* kb,
                                         const __nv_bfloat16* vb, int n0,
                                         int nk) {
  for (int i = threadIdx.x; i < nk * CH; i += blockDim.x) {
    sk[i] = __bfloat162float(kb[(size_t)n0 * CH + i]);
    sv[i] = __bfloat162float(vb[(size_t)n0 * CH + i]);
  }
}

// Base-2 score of one (query, key) pair: (scale * q . k + bias) * log2 e,
// with q . k as an fmaf chain over the channels.
template <int CH>
__device__ __forceinline__ float score(const float (&qf)[CH], const float* kj,
                                       float scale, float bias) {
  float qk = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) qk = __fmaf_rn(qf[c], kj[c], qk);
  return __fmul_rn(__fmaf_rn(scale, qk, bias), LOG2E);
}

// Fold the base-2 scores s[0 .. nk) of one tile of keys into the state:
// `vrow(j, vj)` writes the value row of the tile's key j into vj[CH].
template <int CH, class VRow>
__device__ __forceinline__ void update_rows(Online<CH>& st,
                                            const float (&s)[KT], int nk,
                                            VRow vrow) {
  float tmax = -1e30f;
#pragma unroll
  for (int j = 0; j < KT; ++j)
    if (j < nk) tmax = fmaxf(tmax, s[j]);
  const float mnew = fmaxf(st.m, tmax);
  const float alpha = exp2f(__fsub_rn(st.m, mnew));
  st.l = __fmul_rn(st.l, alpha);
#pragma unroll
  for (int c = 0; c < CH; ++c) st.o[c] = __fmul_rn(st.o[c], alpha);
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j < nk) {
      const float p = exp2f(__fsub_rn(s[j], mnew));
      st.l = __fadd_rn(st.l, p);
      const float pb = __bfloat162float(__float2bfloat16_rn(p));
      float vj[CH];
      vrow(j, vj);
#pragma unroll
      for (int c = 0; c < CH; ++c) st.o[c] = __fmaf_rn(pb, vj[c], st.o[c]);
    }
  }
  st.m = mnew;
}

// `update_rows` with the values sv as `stage_kv` left them.
template <int CH>
__device__ __forceinline__ void update(Online<CH>& st, const float (&s)[KT],
                                       const float* sv, int nk) {
  update_rows(st, s, nk, [&](int j, float (&vj)[CH]) {
#pragma unroll
    for (int c = 0; c < CH; ++c) vj[c] = sv[j * CH + c];
  });
}

// One tile of nk keys (sk, sv as `stage_kv` left them) for the query qf:
// `bias(j)` gives the rpe bias of the tile's key j.
template <int CH, class Bias>
__device__ __forceinline__ void tile(Online<CH>& st, const float (&qf)[CH],
                                     const float* sk, const float* sv, int nk,
                                     float scale, Bias bias) {
  float s[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j)
    if (j < nk) s[j] = score(qf, sk + j * CH, scale, bias(j));
  update(st, s, sv, nk);
}

// The scores of keys J0 .. J1 - 1 (and below nk) of one tile for the HPG
// heads of one query (the folded kernels): `bias(j, b)` writes the bias of
// the tile's key j for every head into b[HPG], so what the heads share of a
// pair's geometry is found once. sk holds the heads' key tiles one after
// the other, (HPG, KT, CH). Each score is `tile`'s, so `update` on a head's
// row of s leaves that head's state as `tile` would.
template <int J0, int J1, int CH, int HPG, class Bias>
__device__ __forceinline__ void scores_heads(float (&s)[HPG][KT],
                                             const float (&qf)[HPG][CH],
                                             const float* sk, int nk,
                                             float scale, Bias bias) {
#pragma unroll
  for (int j = J0; j < J1; ++j) {
    if (j < nk) {
      float b[HPG];
      bias(j, b);
#pragma unroll
      for (int h = 0; h < HPG; ++h)
        s[h][j] = score(qf[h], sk + (h * KT + j) * CH, scale, b[h]);
    }
  }
}

// Write O / l to `op` and, with a non-null `lsep`, the logsumexp in
// natural-log units (the scores are in base 2: converted once).
template <int CH>
__device__ __forceinline__ void finish(const Online<CH>& st, float* op,
                                       float* lsep) {
  const float lsafe = fmaxf(st.l, 1e-30f);
#pragma unroll
  for (int c = 0; c < CH; ++c) op[c] = __fdiv_rn(st.o[c], lsafe);
  if (lsep != nullptr) *lsep = __fmul_rn(__fadd_rn(st.m, log2f(lsafe)), LN2);
}

}  // namespace site
