// Backward of the lattice rpe bias at a wide site: from the cotangent of the
// n-major bias gout[b, g, h, n, m] (bf16) to the gradient of the raw table
// (float32) and the cotangents of the per-key fractions, dwy[b, g, n] and
// df[b, g, n], for a table too large for lattice_bias_bwd.cu's shared
// memory.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/lattice_bias.py
// ::_bwd_call / _bwd_kernel (with `_bias_cotangent_tail`), the VJP of the
// resolve-staged forward that the pyramid's 56 x 56 sites take. That kernel
// scatters into the gradient of the staged table, rounds it to bf16 and
// leaves the un-staging to XLA; this one writes the float32 gradient of the
// raw table directly, with lattice_bias_bwd.cu's arithmetic
// (lattice_common.cuh::window_tail: per (key, query, head) the cotangent
// spread over the 2 x 2 window with the forward's weights, and the shares of
// dwy and df). Window starts are clipped in the forward, so gradient flows
// to the clipped entries; what lands in the padding is dropped.
//
// Bound: bytes (gout, 197 MB for the pyramid's SCA at BEV 56, B = 2). The
// trouble is where the sums go: one head's float32 gradient there is 119 x
// 849 x 4 B = 404 KB with the padding, more than a block's 227 KB of shared
// memory, and four global float atomics per (key, query, head) would be
// ~390 M per call. So a block owns (b, g, h, a run of keys, a band of R rows
// of the padded table) and keeps only that band's gradient in shared memory
// (R = 60 rows, 204 KB, at that site: two bands). It takes, for each of its
// keys, the query rows whose two table rows touch the band; a query row adds
// its upper-row terms where its upper row lies in the band and its
// lower-row terms where its lower row does, so every term lands in exactly
// one band, and its dwy and df shares are counted in the band that holds its
// upper row. gout is then read about (1 + 1 / H) times per band boundary a
// key straddles. The table itself is read from device memory through L1
// (__ldg, bounds checks for the padding), as lattice_bias_wide.cu does. One
// warp takes one key at a time, its lanes along the queries; dwy and df are
// one warp reduction and one global atomic per (key, head, band); the band
// is added to device memory once at the end. Float atomics make the order of
// the sums, and so the last bits, vary from run to run.

#include "lattice_common.cuh"

namespace {

constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS) lattice_bias_wide_bwd_kernel(
    const __nv_bfloat16* __restrict__ table,  // (G, Hpg, Ht, Wt)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    const __nv_bfloat16* __restrict__ gout,  // (B, G, Hpg, N, H * W)
    float* __restrict__ dtable,              // (G, Hpg, Ht, Wt), zeroed
    float* __restrict__ dwy, float* __restrict__ df,  // (B, G, N), zeroed
    int G, int Hpg, int Ht, int Wt, int Xp, int N, int H, int W,
    int keys_per_block, int band_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sg = reinterpret_cast<float*>(smem_raw);  // (band_rows, Xp)
  const int bgh = blockIdx.z;  // (b * G + g) * Hpg + h
  const int gh = bgh % (G * Hpg);
  const int b = bgh / (G * Hpg);
  const int g = gh / Hpg;
  const int r0 = blockIdx.y * band_rows;  // first padded row of the band
  const int r1 = min(r0 + band_rows, Ht + 2 * lattice::PAD);
  const __nv_bfloat16* t = table + (size_t)gh * Ht * Wt;
  for (int i = threadIdx.x; i < band_rows * Xp; i += THREADS) sg[i] = 0.0f;
  __syncthreads();

  const int M = H * W;
  const int n0 = blockIdx.x * keys_per_block;
  const int nk = min(keys_per_block, N - n0);
  const int lane = threadIdx.x & 31;
  for (int kl = threadIdx.x >> 5; kl < nk; kl += THREADS >> 5) {
    const int n = n0 + kl;
    const size_t key = ((size_t)b * G + g) * N + n;
    const int y0 = ys[key];
    // query rows iy whose upper (y0 + iy) or lower (y0 + iy + 1) table row
    // lies in [r0, r1)
    const int iy_lo = max(0, r0 - 1 - y0);
    const int iy_hi = min(H - 1, r1 - 1 - y0);
    if (iy_lo > iy_hi) continue;
    const float w_y = wy[key];
    const float f = fx[key];
    const int x0 = ms[key];
    const __nv_bfloat16* go = gout + ((size_t)bgh * N + n) * M;
    float a_wy = 0.0f, a_f = 0.0f;
    for (int m = iy_lo * W + lane; m < (iy_hi + 1) * W; m += 32) {
      const int iy = m / W;
      const int ix = m - iy * W;
      const int r = y0 + iy;
      lattice::Window w;
      const float phi = __fadd_rn(gcomb[ix], f);
      const float cross = floorf(phi);
      w.wx = __fsub_rn(phi, cross);
      w.cross = cross > 0.5f ? 1 : 0;
      const int c = x0 + u0[ix] + w.cross;
      w.t00 = lattice::padded_at(t, Ht, Wt, r, c);
      w.t01 = lattice::padded_at(t, Ht, Wt, r, c + 1);
      w.t10 = lattice::padded_at(t, Ht, Wt, r + 1, c);
      w.t11 = lattice::padded_at(t, Ht, Wt, r + 1, c + 1);
      const float gv = __bfloat162float(go[m]);
      // lattice::window_tail, split by band
      const float d0 = gv * (1.0f - w_y);
      const float d1 = gv * w_y;
      const float ux = 1.0f - w.wx;
      if (r >= r0) {  // upper row in the band (r < r1 by iy_hi)
        const float xa = lattice::lerp_rn(w.t00, w.t01, w.wx);
        const float xb = lattice::lerp_rn(w.t10, w.t11, w.wx);
        a_wy = fmaf(gv, xb - xa, a_wy);
        a_f += d0 * (w.t01 - w.t00) + d1 * (w.t11 - w.t10);
        float* gp = sg + (r - r0) * Xp + c;
        atomicAdd(gp, d0 * ux);
        atomicAdd(gp + 1, d0 * w.wx);
      }
      if (r + 1 < r1) {  // lower row in the band (r + 1 >= r0 by iy_lo)
        float* gp = sg + (r + 1 - r0) * Xp + c;
        atomicAdd(gp, d1 * ux);
        atomicAdd(gp + 1, d1 * w.wx);
      }
    }
    a_wy = lattice::warp_sum(a_wy);
    a_f = lattice::warp_sum(a_f);
    if (lane == 0) {  // other heads and bands add to the same key
      atomicAdd(dwy + key, a_wy);
      atomicAdd(df + key, a_f);
    }
  }
  __syncthreads();
  // add the band's interior rows into the table gradient; the padding drops
  float* dt = dtable + (size_t)gh * Ht * Wt;
  const int tr0 = max(r0, lattice::PAD);
  const int tr1 = min(r1, lattice::PAD + Ht);
  for (int i = threadIdx.x; i < (tr1 - tr0) * Wt; i += THREADS) {
    const int rr = i / Wt;
    const int cc = i - rr * Wt;
    const int r = tr0 + rr;
    const float val = sg[(r - r0) * Xp + cc + lattice::PAD];
    if (val != 0.0f) atomicAdd(dt + (r - lattice::PAD) * Wt + cc, val);
  }
}

}  // namespace

extern "C" int lattice_bias_wide_bwd_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* gout,
    void* dtable, void* dwy, void* df, int B, int G, int Hpg, int Ht, int Wt,
    int Xp, int N, int H, int W, int keys_per_block, int band_rows,
    void* stream) {
  const size_t smem = (size_t)band_rows * Xp * sizeof(float);
  int rc = lattice::set_smem((const void*)lattice_bias_wide_bwd_kernel, smem);
  if (rc) return rc;
  const int Yp = Ht + 2 * lattice::PAD;
  dim3 grid((N + keys_per_block - 1) / keys_per_block,
            (Yp + band_rows - 1) / band_rows, B * G * Hpg);
  lattice_bias_wide_bwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)gout, (float*)dtable,
      (float*)dwy, (float*)df, G, Hpg, Ht, Wt, Xp, N, H, W, keys_per_block,
      band_rows);
  return (int)cudaGetLastError();
}
