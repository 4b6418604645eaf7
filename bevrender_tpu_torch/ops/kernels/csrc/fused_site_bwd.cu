// Backward of the fused lattice attention site for narrow heads (ch 4 or 8),
// flash style: from q, k, v, the forward's logsumexp and the cotangent dO to
// dq, dk, dv, the gradient of the raw rpe table and the cotangents of the
// per-key fractions (dwy, df). Neither bias, scores nor probabilities touch
// device memory.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/fused_attn.py
// ::site_bwd_call / _site_bwd_kernel. Per (key n, query m) pair of one
// (b, g, h), with the forward kernel's roundings (fused_site.cu):
//   s  = scale * q[m] . k[n] + bias[n, m]       (fmaf chain, float32)
//   p  = exp(s - lse[m])                        (in base 2, as the forward)
//   dv[n] += bf16(p) * bf16(dO[m])              dp = v[n] . bf16(dO[m])
//   ds = p * (dp - D[m])                        D = rowsum(dO * O)
//   dk[n] += bf16(ds) * q[m]                    dq[m] += bf16(ds) * k[n]
// with dk and dq scaled by `scale` at the end, and the unrounded ds fed to
// the bias cotangent tail shared with lattice_bias_bwd.cu. Products take
// bf16 factors and sum in float32, as the Pallas kernel's MXU dots do. The
// TPU staging (shift replicas, packed starts, -1e30 rows for padded keys)
// is not carried over: N is exact here.
//
// Bound: operations per pair (the bias window, an exp2, 5 products of ch
// multiply-adds, 4 shared-memory atomics). One of dq or dk/dv is a sum
// across blocks whichever axis a block owns. Here a block owns THREADS
// keys, one per thread, and walks all queries in tiles staged in shared
// memory: dk, dv, dwy and df of a key stay in that thread's registers and
// are written once, which keeps the 2 ch + 2 per-key sums free of any
// reduction; dq needs only ch sums per query, reduced over the warp by
// shuffles, over the block's warps in shared memory, and over the key
// blocks by one float32 atomic per (query, channel) and block. The other
// choice (a thread per query, as the forward) would reduce 2 ch + 2 values
// per key instead of ch per query. Shared memory holds the head's padded
// table in bf16 and its gradient in float32 (162 KB for the flagship's
// SCA), so one block runs per SM. Float atomics make the order of the sums
// of dq, dtable, dwy (over heads) and df vary from run to run.
//
// Head widths: 4 and 8, as the forward.

#include "lattice_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int QT = 32;  // queries staged per tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int CH>
__global__ void __launch_bounds__(THREADS) fused_site_bwd_kernel(
    const __nv_bfloat16* __restrict__ table,  // (G, Hpg, Ht, Wt)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    const __nv_bfloat16* __restrict__ q,  // (B, G, Hpg, M, CH)
    const __nv_bfloat16* __restrict__ k,  // (B, G, Hpg, N, CH)
    const __nv_bfloat16* __restrict__ v,  // (B, G, Hpg, N, CH)
    const float* __restrict__ dout,       // (B, G, Hpg, M, CH)
    const float* __restrict__ lse,        // (B, G, Hpg, M), natural log
    const float* __restrict__ dsum,       // (B, G, Hpg, M): rowsum(dO * O)
    float* __restrict__ dq,               // (B, G, Hpg, M, CH), zeroed
    float* __restrict__ dk,               // (B, G, Hpg, N, CH)
    float* __restrict__ dv,               // (B, G, Hpg, N, CH)
    float* __restrict__ dtable,           // (G, Hpg, Ht, Wt), zeroed
    float* __restrict__ dwy, float* __restrict__ df,  // (B, G, N), zeroed
    int G, int Hpg, int Ht, int Wt, int Xp, int N, int H, int W,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tsize = (Ht + 2 * lattice::PAD) * Xp;
  float* sg = reinterpret_cast<float*>(smem_raw);  // (Yp, Xp) gradient
  float* sq = sg + tsize;                          // (QT, CH)
  float* sdo = sq + QT * CH;                       // (QT, CH) bf16-rounded
  float* sdq = sdo + QT * CH;                      // (QT, CH)
  float* slse = sdq + QT * CH;                     // (QT,) in base 2
  float* sds = slse + QT;                          // (QT,) rowsum(dO * O)
  float* sgc = sds + QT;                           // (QT,) column fraction
  int* soff = reinterpret_cast<int*>(sgc + QT);    // (QT,) iy * Xp + u0[ix]
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(soff + QT);  // table

  const int bgh = blockIdx.y;  // (b * G + g) * Hpg + h
  const int bg = bgh / Hpg;    // b * G + g
  const int g = bg % G;
  const int h = bgh - bg * Hpg;
  const int M = H * W;
  const size_t tab = ((size_t)g * Hpg + h) * Ht * Wt;
  lattice::stage_padded(st, table + tab, 1, Ht, Wt, Xp);
  for (int i = threadIdx.x; i < tsize; i += THREADS) sg[i] = 0.0f;

  const int n_raw = blockIdx.x * THREADS + threadIdx.x;
  const bool active = n_raw < N;
  const int n = active ? n_raw : N - 1;  // idle lanes still stage and shuffle
  const size_t key = (size_t)bg * N + n;
  const float w_y = wy[key];
  const float f = fx[key];
  const int base = ys[key] * Xp + ms[key];
  float kf[CH], vf[CH], dkr[CH], dvr[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    kf[c] = __bfloat162float(k[((size_t)bgh * N + n) * CH + c]);
    vf[c] = __bfloat162float(v[((size_t)bgh * N + n) * CH + c]);
    dkr[c] = 0.0f;
    dvr[c] = 0.0f;
  }
  float a_wy = 0.0f, a_f = 0.0f;
  const int lane = threadIdx.x & 31;

  for (int m0 = 0; m0 < M; m0 += QT) {
    const int mq = min(QT, M - m0);
    const size_t row0 = (size_t)bgh * M + m0;
    __syncthreads();  // the previous tile is consumed and its dq flushed
    for (int i = threadIdx.x; i < mq * CH; i += THREADS) {
      sq[i] = __bfloat162float(q[row0 * CH + i]);
      sdo[i] = round_bf16(dout[row0 * CH + i]);
      sdq[i] = 0.0f;
    }
    for (int i = threadIdx.x; i < mq; i += THREADS) {
      const int m = m0 + i;
      const int iy = m / W;
      const int ix = m - iy * W;
      soff[i] = iy * Xp + u0[ix];
      sgc[i] = gcomb[ix];
      slse[i] = lse[row0 + i] * LOG2E;
      sds[i] = dsum[row0 + i];
    }
    __syncthreads();

    for (int j = 0; j < mq; ++j) {
      float dqp[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) dqp[c] = 0.0f;
      if (active) {
        float qk = 0.0f;
#pragma unroll
        for (int c = 0; c < CH; ++c) qk = __fmaf_rn(sq[j * CH + c], kf[c], qk);
        const int off = base + soff[j];
        const lattice::Window w = lattice::load_window(st + off, Xp, sgc[j], f);
        const float bias = lattice::window_bias(w, w_y);
        const float s = __fmul_rn(__fmaf_rn(scale, qk, bias), LOG2E);
        const float p = exp2f(s - slse[j]);
        const float pb = round_bf16(p);
        float dp = 0.0f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          dp = fmaf(vf[c], sdo[j * CH + c], dp);
          dvr[c] = fmaf(pb, sdo[j * CH + c], dvr[c]);
        }
        const float ds = p * (dp - sds[j]);
        const float dsb = round_bf16(ds);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          dkr[c] = fmaf(dsb, sq[j * CH + c], dkr[c]);
          dqp[c] = dsb * kf[c];
        }
        lattice::window_tail(w, sg + off, Xp, w_y, ds, a_wy, a_f);
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float tot = lattice::warp_sum(dqp[c]);
        if (lane == 0) atomicAdd(sdq + j * CH + c, tot);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < mq * CH; i += THREADS)
      atomicAdd(dq + row0 * CH + i, scale * sdq[i]);
  }

  if (active) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      dk[((size_t)bgh * N + n) * CH + c] = scale * dkr[c];
      dv[((size_t)bgh * N + n) * CH + c] = dvr[c];
    }
    atomicAdd(dwy + key, a_wy);  // the other heads add to the same key
    atomicAdd(df + key, a_f);
  }
  __syncthreads();
  lattice::flush_gradient(dtable + tab, sg, Ht, Wt, Xp);
}

template <int CH>
int launch(const void* table, const void* ys, const void* ms, const void* wy,
           const void* fx, const void* u0, const void* gcomb, const void* q,
           const void* k, const void* v, const void* dout, const void* lse,
           const void* dsum, void* dq, void* dk, void* dv, void* dtable,
           void* dwy, void* df, int B, int G, int Hpg, int Ht, int Wt, int Xp,
           int N, int H, int W, float scale, cudaStream_t stream) {
  const size_t tsize = (size_t)(Ht + 2 * lattice::PAD) * Xp;
  const size_t smem = tsize * (sizeof(float) + sizeof(__nv_bfloat16)) +
                      (size_t)QT * (3 * CH + 4) * sizeof(float);
  int rc = lattice::set_smem((const void*)fused_site_bwd_kernel<CH>, smem);
  if (rc) return rc;
  dim3 grid((N + THREADS - 1) / THREADS, B * G * Hpg);
  fused_site_bwd_kernel<CH><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)dout, (const float*)lse,
      (const float*)dsum, (float*)dq, (float*)dk, (float*)dv, (float*)dtable,
      (float*)dwy, (float*)df, G, Hpg, Ht, Wt, Xp, N, H, W, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_site_bwd_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* q,
    const void* k, const void* v, const void* dout, const void* lse,
    const void* dsum, void* dq, void* dk, void* dv, void* dtable, void* dwy,
    void* df, int B, int G, int Hpg, int Ht, int Wt, int Xp, int N, int H,
    int W, int ch, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SITE_CASE(C)                                                        \
  case C:                                                                   \
    return launch<C>(table, ys, ms, wy, fx, u0, gcomb, q, k, v, dout, lse, \
                     dsum, dq, dk, dv, dtable, dwy, df, B, G, Hpg, Ht, Wt, \
                     Xp, N, H, W, scale, s);
  switch (ch) {
    SITE_CASE(4)
    SITE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SITE_CASE
}
