// Backward of the lattice rpe bias: from the cotangent of the n-major bias
// gout[b, g, h, n, m] (bf16) to the gradient of the raw table (float32) and
// the cotangents of the per-key fractions, dwy[b, g, n] and df[b, g, n].
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/lattice_bias.py
// ::_bwd_call_sh / _bwd_kernel_sh. That kernel scatters into the gradient
// of the 8-fold shift-replicated staged table and leaves the un-staging to
// XLA; this one reads the raw bf16 table and writes the gradient of the raw
// table directly. Per (key, query, head) the forward is two x-lerps and one
// y-lerp over a 2 x 2 window of the zero-padded table; the backward spreads
// the cotangent over those four entries with the same weights
// (lattice_common.cuh::window_tail). Window starts are clipped in the
// forward, so gradient flows to the clipped entries; what lands in the
// padding is dropped.
//
// Bound: bytes (gout dominates: B * G * Hpg * N * M * 2 bytes), but four
// scatter-adds per element into a table of a few ten thousand entries would
// serialise as global atomics. A block takes one (b, g, h) and a run of
// keys, keeps the head's padded table in bf16 and its gradient in float32
// in shared memory (63 x 429 x 6 B = 162 KB for the flagship's SCA),
// accumulates there with shared-memory atomics and adds the interior to
// device memory once at the end. One warp takes one key at a time, its
// lanes along the queries, so gout is read in whole rows and dwy, df are
// one warp reduction per (key, head). Float atomics make the order of the
// sums, and so the last bits, vary from run to run.

#include "lattice_common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) lattice_bias_bwd_kernel(
    const __nv_bfloat16* __restrict__ table,  // (G, Hpg, Ht, Wt)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    const __nv_bfloat16* __restrict__ gout,  // (B, G, Hpg, N, H * W)
    float* __restrict__ dtable,              // (G, Hpg, Ht, Wt), zeroed
    float* __restrict__ dwy, float* __restrict__ df,  // (B, G, N), zeroed
    int G, int Hpg, int Ht, int Wt, int Xp, int N, int H, int W,
    int keys_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tsize = (Ht + 2 * lattice::PAD) * Xp;
  float* sg = reinterpret_cast<float*>(smem_raw);                 // gradient
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(sg + tsize);  // table
  const int gh = blockIdx.y;  // g * Hpg + h
  const int g = gh / Hpg;
  const int h = gh - g * Hpg;
  const int b = blockIdx.z;
  lattice::stage_padded(st, table + (size_t)gh * Ht * Wt, 1, Ht, Wt, Xp);
  for (int i = threadIdx.x; i < tsize; i += THREADS) sg[i] = 0.0f;
  __syncthreads();

  const int M = H * W;
  const int n0 = blockIdx.x * keys_per_block;
  const int nk = min(keys_per_block, N - n0);
  const int lane = threadIdx.x & 31;
  for (int kl = threadIdx.x >> 5; kl < nk; kl += THREADS >> 5) {
    const int n = n0 + kl;
    const size_t key = ((size_t)b * G + g) * N + n;
    const float w_y = wy[key];
    const float f = fx[key];
    const int base = ys[key] * Xp + ms[key];
    const __nv_bfloat16* go =
        gout + ((((size_t)b * G + g) * Hpg + h) * N + n) * M;
    float a_wy = 0.0f, a_f = 0.0f;
    for (int m = lane; m < M; m += 32) {
      const int iy = m / W;
      const int ix = m - iy * W;
      const int off = base + iy * Xp + u0[ix];
      const lattice::Window w = lattice::load_window(st + off, Xp, gcomb[ix], f);
      lattice::window_tail(w, sg + off, Xp, w_y, __bfloat162float(go[m]), a_wy,
                           a_f);
    }
    a_wy = lattice::warp_sum(a_wy);
    a_f = lattice::warp_sum(a_f);
    if (lane == 0) {  // the other heads of the group add to the same key
      atomicAdd(dwy + key, a_wy);
      atomicAdd(df + key, a_f);
    }
  }
  __syncthreads();
  lattice::flush_gradient(dtable + (size_t)gh * Ht * Wt, sg, Ht, Wt, Xp);
}

}  // namespace

extern "C" int lattice_bias_bwd_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* gout,
    void* dtable, void* dwy, void* df, int B, int G, int Hpg, int Ht, int Wt,
    int Xp, int N, int H, int W, int keys_per_block, void* stream) {
  const size_t smem = (size_t)(Ht + 2 * lattice::PAD) * Xp *
                      (sizeof(float) + sizeof(__nv_bfloat16));
  int rc = lattice::set_smem((const void*)lattice_bias_bwd_kernel, smem);
  if (rc) return rc;
  dim3 grid((N + keys_per_block - 1) / keys_per_block, G * Hpg, B);
  lattice_bias_bwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)gout, (float*)dtable,
      (float*)dwy, (float*)df, G, Hpg, Ht, Wt, Xp, N, H, W, keys_per_block);
  return (int)cudaGetLastError();
}
