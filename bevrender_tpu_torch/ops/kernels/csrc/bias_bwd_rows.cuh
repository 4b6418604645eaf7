// The bias backward as one row-owned template, with no atomic: from the
// cotangent of the n-major bias gout[b, g, h, n, m] (bf16) to the gradient of
// the raw table (float32) and the cotangents of the per-key fractions,
// dwy[b, g, n] and df[b, g, n]. lattice_bias_bwd.cu and
// lattice_bias_wide_bwd.cu each instantiate it under their own kernel name.
//
// Per (key, query, head) the forward is two x-lerps and one y-lerp over a
// 2 x 2 window of the zero-padded table: rows ys + iy (the pair's upper row,
// weight 1 - wy) and ys + iy + 1 (its lower row, weight wy), columns c and
// c + 1 with c = ms + u0[ix] (+1 where the column fraction crossed into the
// next cell, lattice_common.cuh::column). The backward spreads the cotangent
// over those four entries with the same weights. Window starts are clipped
// in the forward, so gradient flows to the clipped entries; what lands in
// the padding is dropped.
//
// Bound: bytes, gout above all (B G Hpg N H W bf16). The work is where the
// sums go: four adds per (key, query, head) into a table of a few ten
// thousand entries. A shared-memory atomicAdd(float*) is a compare-and-swap
// loop on sm_90a, and a block that keeps a head's whole padded table and its
// float32 gradient holds one block an SM. So:
//
// - A block owns one (b, g, h), a run of keys and a band of R rows of the
//   padded table. It keeps the band's rows of the table in bf16 and their
//   float32 gradient in shared memory, both at a row pitch of Xa = m_max +
//   max(u0) (every column a window can reach). The wrapper's plan sizes R
//   for four blocks an SM where a band of 16 rows fits.
// - The rows have owners: a warp is SEG = 32 / P segments of P lanes (P =
//   32, or 16 or 8 where W is that narrow), and row r0 + o of the band
//   belongs to segment o % SEG of warp (o / SEG) % WARPS alone. A lane
//   takes K adjacent query columns (K = 2 where W > 32). For each key of the
//   run, in order, the terms that land in a row r come from two query rows:
//   iy = r - ys (the pair's upper row) and iy - 1 (the lower pair of the
//   row before), each a row of W bf16 in gout. Every add is a plain
//   load-add-store in a row the lane's segment owns, in a fixed order per
//   entry: for each key, the upper pair's left term (column c(ix)), the
//   right term of the column before (where c(ix - 1) + 1 = c(ix)), then the
//   lower pair's two.
// - The columns c(ix) strictly increase in ix: the plan refuses a table
//   where float32 rounding could merge two for some f
//   (lattice_bias_bwd.columns_increase). So each entry is one lane's: the
//   lane of its left term adds its neighbour's right terms too (in the
//   lane, or by shuffle), and the lane of a right term that no left term
//   shares adds it; the lanes' columns, passed on by shuffle, say which.
//   lattice_bias_bwd.lattice_bias_bwd_ordered adds the same terms in four
//   dense passes (uL, uR, lL, lR) in PyTorch: dtable equals it bit for bit.
// - dwy and df are sums over pairs, and each pair's share splits over its
//   two rows: row r adds (gd - gu) x_r to dwy and (d0 + d1) (t_r,c+1 -
//   t_r,c) to df, with x_r the x-lerp of row r, gu and gd the cotangents of
//   its upper and lower pair, d0 = gu (1 - wy), d1 = gd wy. So a row's owner
//   reads only its own row of the table. The lanes' sums are added per key
//   over the warp, then over the warps in order at the end of each chunk of
//   KC keys.
// - The time goes into instructions a (key, warp) visit and a row, not into
//   memory (PERF.md §6). So a warp visits only the keys of a chunk
//   that reach its rows (a ballot, lane k testing key k, whose span the
//   visit takes by shuffle); the block stages each chunk's key geometry two
//   chunks ahead and asks L2 for the next chunk's cotangent rows of its
//   band, so that a row's loads come from L2.
// - Each block writes its band's rows of the gradient, and its keys' dwy/df
//   partials, to float32 scratch; a second kernel sums them in a fixed order
//   (table: b, then run; keys: head, then band). No float atomic anywhere,
//   so every run gives the same bits.
//
// Every contractible float32 step of the table gradient is written with
// __fmul_rn / __fadd_rn, so that the PyTorch mirror can repeat it.
#pragma once

#include "lattice_common.cuh"

namespace bias_bwd_rows {

constexpr int WARPS = 8;  // WARPS in lattice_bias_bwd.py
constexpr int THREADS = WARPS * 32;
// blocks an SM the instances are compiled for (at most 64 registers a
// thread), the most the plan asks for
constexpr int MIN_BLOCKS = 4;
constexpr int KC = 16;  // keys a chunk (KEYS_A_CHUNK in lattice_bias_bwd.py)
constexpr int GEO_BUFS = 3;  // chunks of key geometry in shared memory
constexpr int SUM_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const __nv_bfloat16* table;  // (G, Hpg, Ht, Wt)
  const int* ys;               // (B, G, N) clipped starts in the padded table
  const int* ms;
  const float* wy;  // (B, G, N) fractions
  const float* fx;
  const int* u0;       // (W,)
  const float* gcomb;  // (W,)
  const __nv_bfloat16* gout;  // (B, G, Hpg, N, H * W)
  float* part_t;  // (B, runs, G * Hpg, Ht, Wt): each block's band of rows
  float* part_k;  // (bands, B, G, Hpg, N, 2): dwy, df of each band
  float* dtable;  // (G, Hpg, Ht, Wt)
  float* dwy;     // (B, G, N)
  float* df;
  int B, G, Hpg, Ht, Wt, Xa, N, H, W;
  int R, bands, runs, kpr;  // rows a band, bands, key runs, keys a run
};

// Shared memory of one block: the band's float32 gradient, the dwy/df
// partials of two chunks of keys and the geometry of three, and the band's
// table rows in bf16 (rows()'s layout; smem_bytes in lattice_bias_bwd.py).
inline size_t smem_bytes(int R, int Xa) {
  return (size_t)R * Xa * sizeof(float) + 2 * KC * WARPS * 2 * sizeof(float) +
         GEO_BUFS * KC * 3 * sizeof(float) +
         (size_t)R * Xa * sizeof(__nv_bfloat16);
}

// The rows kernel's body: P lanes a segment, K query columns a lane, W <= P K.
template <int P, int K>
__device__ __forceinline__ void rows(const Args& a) {
  constexpr int SEG = 32 / P;      // segments a warp, each on its own row
  constexpr int NO = WARPS * SEG;  // row owners a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Xa = a.Xa;
  float* acc = reinterpret_cast<float*>(smem_raw);  // (R, Xa)
  float* kpart = acc + a.R * Xa;                    // (2, KC, WARPS, 2)
  float* geo = kpart + 2 * KC * WARPS * 2;          // (GEO_BUFS, 3, KC)
  __nv_bfloat16* tab =
      reinterpret_cast<__nv_bfloat16*>(geo + GEO_BUFS * 3 * KC);
  int blk = blockIdx.x;
  const int band = blk % a.bands;
  blk /= a.bands;
  const int run = blk % a.runs;
  blk /= a.runs;
  const int GH = a.G * a.Hpg;
  const int gh = blk % GH;  // g * Hpg + h
  const int b = blk / GH;
  const int g = gh / a.Hpg;
  const int r0 = band * a.R;  // first padded row of the band
  const int r1 = min(r0 + a.R, a.Ht + 2 * lattice::PAD);
  const int n_begin = run * a.kpr;
  const int n_end = min(a.N, n_begin + a.kpr);
  const size_t kb = ((size_t)b * a.G + g) * a.N;  // key (b, g, 0)

  // the geometry of the chunk of keys from n0 into buffer buf, by the last
  // KC threads: ys | ms << 16 (both under 2^15), wy, f
  auto stage_keys = [&](int n0, int buf) {
    const int k = (int)threadIdx.x - (THREADS - KC);
    if (k >= 0 && n0 + k < n_end) {
      float* gb = geo + buf * 3 * KC;
      reinterpret_cast<int*>(gb)[k] =
          a.ys[kb + n0 + k] | (a.ms[kb + n0 + k] << 16);
      gb[KC + k] = a.wy[kb + n0 + k];
      gb[2 * KC + k] = a.fx[kb + n0 + k];
    }
  };

  const __nv_bfloat16* t = a.table + (size_t)gh * a.Ht * a.Wt;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  // a warp a row, its lanes along the row
  for (int rr = threadIdx.x >> 5; rr < a.R; rr += WARPS) {
    const int tr = r0 + rr - lattice::PAD;
    const bool in = (unsigned)tr < (unsigned)a.Ht;
    for (int cc = threadIdx.x & 31; cc < Xa; cc += 32) {
      const int tc = cc - lattice::PAD;
      tab[rr * Xa + cc] = in && (unsigned)tc < (unsigned)a.Wt
                              ? t[tr * a.Wt + tc]
                              : zero;
      acc[rr * Xa + cc] = 0.0f;
    }
  }
  stage_keys(n_begin, 0);
  stage_keys(n_begin + KC, 1);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = lane / P;  // this lane's row among the warp's SEG
  const int sl = lane % P;   // lane in the segment
  // the lane's query columns ix = sl K + j
  int cu[K];
  float cg[K];
  bool live[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int ix = sl * K + j;
    live[j] = ix < a.W;
    cu[j] = live[j] ? a.u0[ix] : 0;
    cg[j] = live[j] ? a.gcomb[ix] : 0.0f;
  }
  const bool has_prev = sl > 0 && live[0];
  const bool has_next = sl + 1 < P && (sl + 1) * K < a.W;
  const int M = a.H * a.W;
  const __nv_bfloat16* go_h = a.gout + ((size_t)b * GH + gh) * a.N * M;
  const __nv_bfloat16* go_lane = go_h + sl * K;  // N M < 2^31 (the plan)
  // the rows this lane owns are r0 + q NO + own, q = 0, 1, ...
  const int own = warp * SEG + seg;

  for (int n0 = n_begin, ci = 0; n0 < n_end; n0 += KC, ++ci) {
    // the geometry two chunks ahead, and the next chunk's cotangent rows of
    // this band into L2 (its geometry is in since the last barrier): gout
    // comes from device memory once, and a load then waits on L2, not DRAM
    stage_keys(n0 + 2 * KC, (ci + 2) % GEO_BUFS);
    if (n0 + KC < n_end) {
      const int* gn =
          reinterpret_cast<const int*>(geo + (ci + 1) % GEO_BUFS * 3 * KC);
      const int nk1 = min(KC, n_end - n0 - KC);
      for (int k = warp; k < nk1; k += WARPS) {
        const int y0 = gn[k] & 0xffff;
        const int iy0 = max(0, r0 - 1 - y0);
        const int iy1 = min(a.H - 1, r1 - 1 - y0);
        if (iy0 > iy1) continue;
        const char* key = reinterpret_cast<const char*>(
            go_h + (size_t)(n0 + KC + k) * M);
        const char* end = key + (size_t)(iy1 + 1) * a.W * 2;
        for (const char* p = reinterpret_cast<const char*>(
                 reinterpret_cast<size_t>(key + (size_t)iy0 * a.W * 2) &
                 ~(size_t)127) + lane * 128;
             p < end; p += 32 * 128)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
      }
    }
    float* kp = kpart + (ci & 1) * (KC * WARPS * 2);
    const float* gb = geo + ci % GEO_BUFS * 3 * KC;
    const int nk = min(KC, n_end - n0);
    // the key's rows in the band, lo .. hi (band-relative), and the warp's
    // passes q0 .. q1 over them: pass q holds rows q NO + warp SEG + 0 ..
    // SEG - 1, one a segment
    auto span = [&](int k, int& y0, int& lo, int& hi, int& q0, int& q1) {
      y0 = reinterpret_cast<const int*>(gb)[k] & 0xffff;
      lo = max(y0, r0) - r0;
      hi = min(y0 + a.H, r1 - 1) - r0;
      const int first = lo - warp * SEG - (SEG - 1);
      q0 = first <= 0 ? 0 : (unsigned)(first + NO - 1) / NO;
      q1 = hi < warp * SEG ? -1 : (unsigned)(hi - warp * SEG) / NO;
    };
    // the chunk's keys with rows of this warp, a bit each (lane k tests key
    // k); the others' shares are 0
    int y0_l = 0, lo_l = 0, hi_l = 0, q0_l = 0, q1_l = -1;  // lane k's key k
    if (lane < nk) span(lane, y0_l, lo_l, hi_l, q0_l, q1_l);
    unsigned todo = __ballot_sync(FULL, q0_l <= q1_l);
    if (lane < nk && q0_l > q1_l) {
      kp[(lane * WARPS + warp) * 2] = 0.0f;
      kp[(lane * WARPS + warp) * 2 + 1] = 0.0f;
    }
    for (; todo; todo &= todo - 1) {
      const int k = __ffs(todo) - 1;
      const int y0 = __shfl_sync(FULL, y0_l, k);
      const int lo = __shfl_sync(FULL, lo_l, k);
      const int hi = __shfl_sync(FULL, hi_l, k);
      const int q0 = __shfl_sync(FULL, q0_l, k);
      const int q1 = __shfl_sync(FULL, q1_l, k);
      float s_wy = 0.0f, s_f = 0.0f;
      const int x0 = reinterpret_cast<const int*>(gb)[k] >> 16;
      const float w_y = gb[KC + k];
      const float f = gb[2 * KC + k];
      const float om = __fsub_rn(1.0f, w_y);
      // columns: c = ms + u0 + cross. They strictly increase in ix (the
      // plan checks the table), so the left terms of column c(ix) are one
      // lane's, and the right terms of c(ix - 1) land there too exactly
      // where c(ix) = c(ix - 1) + 1 (adj); otherwise at a column no left
      // term reaches, which their own lane adds (lone).
      int c[K];
      float wx[K], ux[K];
      bool adj[K], lone[K];
      int e[K];  // u0 + cross, the column less ms
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const lattice::Column col = lattice::column(cg[j], f);
        wx[j] = col.wx;
        ux[j] = __fsub_rn(1.0f, col.wx);
        e[j] = cu[j] + col.cross;
        c[j] = x0 + e[j];
      }
      // the columns before and after the lane's (its neighbours' last
      // and first)
      const int e_prev = __shfl_up_sync(FULL, e[K - 1], 1, P);
      const int e_next = __shfl_down_sync(FULL, e[0], 1, P);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        adj[j] = live[j] && (j > 0 ? e[j] == e[j - 1] + 1
                                   : has_prev && e[0] == e_prev + 1);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        lone[j] = live[j] && !(j + 1 < K ? adj[j + 1]
                                         : has_next && e_next == e[j] + 1);
      }
      // the key's cotangents at the lane's first column
      const __nv_bfloat16* go = go_lane + (n0 + k) * M;
      for (int q = q0; q <= q1; ++q) {
        const int rr = q * NO + own;  // row - r0
        const bool on = rr >= lo && rr <= hi;
        const int iu = rr + r0 - y0;  // query row whose upper row it is
        // the cotangents of the query rows whose upper (gu) and lower
        // (gd) row this is; two columns in one 4-byte load where W is even
        const __nv_bfloat16* pu = go + iu * a.W;
        const bool up = on && live[0] && iu < a.H;
        const bool dn = on && live[0] && iu > 0;
        float gu[K], gd[K], d0[K], d1[K], uL[K], uR[K], lL[K], lR[K];
        if (K == 2 && (a.W & 1) == 0) {
          // a bf16 is the high half of its float: the pair's low element
          // shifted up, its high element masked
          unsigned vu = 0u, vd = 0u;
          if (up) vu = *reinterpret_cast<const unsigned*>(pu);
          if (dn) vd = *reinterpret_cast<const unsigned*>(pu - a.W);
          gu[0] = __uint_as_float(vu << 16);
          gu[K - 1] = __uint_as_float(vu & 0xffff0000u);
          gd[0] = __uint_as_float(vd << 16);
          gd[K - 1] = __uint_as_float(vd & 0xffff0000u);
        } else {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            gu[j] = up && live[j] ? __bfloat162float(pu[j]) : 0.0f;
            gd[j] = dn && live[j] ? __bfloat162float(pu[j - a.W]) : 0.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          d0[j] = __fmul_rn(gu[j], om);   // upper pair of the row
          d1[j] = __fmul_rn(gd[j], w_y);  // lower pair of the row
          uL[j] = __fmul_rn(d0[j], ux[j]);
          uR[j] = __fmul_rn(d0[j], wx[j]);
          lL[j] = __fmul_rn(d1[j], ux[j]);
          lR[j] = __fmul_rn(d1[j], wx[j]);
        }
        const float puR = __shfl_up_sync(FULL, uR[K - 1], 1, P);
        const float plR = __shfl_up_sync(FULL, lR[K - 1], 1, P);
        float* arow = acc + rr * Xa;
        const __nv_bfloat16* trow = tab + rr * Xa;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (on && live[j]) {
            float v = arow[c[j]];
            v = __fadd_rn(v, uL[j]);
            if (adj[j]) v = __fadd_rn(v, j > 0 ? uR[j - 1] : puR);
            v = __fadd_rn(v, lL[j]);
            if (adj[j]) v = __fadd_rn(v, j > 0 ? lR[j - 1] : plR);
            arow[c[j]] = v;
            if (lone[j]) {
              float v1 = arow[c[j] + 1];
              v1 = __fadd_rn(v1, uR[j]);
              v1 = __fadd_rn(v1, lR[j]);
              arow[c[j] + 1] = v1;
            }
            // the row's shares of dwy and df, from its own table row
            const float t0 = __bfloat162float(trow[c[j]]);
            const float t1 = __bfloat162float(trow[c[j] + 1]);
            const float x = lattice::lerp_rn(t0, t1, wx[j]);
            s_wy = fmaf(gd[j] - gu[j], x, s_wy);
            s_f = fmaf(d0[j] + d1[j], t1 - t0, s_f);
          }
        }
      }
      // the next key may add into these rows from other lanes
      __syncwarp();
      // lanes 0-15 sum dwy, lanes 16-31 df
      const bool upper_half = lane & 16;
      float keep = upper_half ? s_f : s_wy;
      keep += __shfl_xor_sync(FULL, upper_half ? s_wy : s_f, 16);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) keep += __shfl_xor_sync(FULL, keep, o);
      const float sum_f = __shfl_sync(FULL, keep, 16);
      if (lane == 0) {
        kp[(k * WARPS + warp) * 2] = keep;
        kp[(k * WARPS + warp) * 2 + 1] = sum_f;
      }
    }
    // the chunk's partials, summed over the warps in order; the other
    // buffers take the next chunk, so one barrier a chunk keeps them apart
    __syncthreads();
    if ((int)threadIdx.x < 2 * nk) {
      const int k = threadIdx.x >> 1;
      const int which = threadIdx.x & 1;
      float s = 0.0f;
      for (int w = 0; w < WARPS; ++w) s += kp[(k * WARPS + w) * 2 + which];
      a.part_k[((((size_t)band * a.B + b) * GH + gh) * a.N + n0 + k) * 2 +
               which] = s;
    }
  }
  __syncthreads();
  // the band's interior rows into this (b, run)'s slice; the padding drops
  float* pt = a.part_t + (((size_t)b * a.runs + run) * GH + gh) * a.Ht * a.Wt;
  const int tr0 = max(r0, lattice::PAD);
  const int tr1 = min(r1, lattice::PAD + a.Ht);
  for (int r = tr0 + (threadIdx.x >> 5); r < tr1; r += WARPS) {
    for (int cc = threadIdx.x & 31; cc < a.Wt; cc += 32)
      pt[(r - lattice::PAD) * a.Wt + cc] =
          acc[(r - r0) * Xa + cc + lattice::PAD];
  }
}

// dtable = the (b, run) slices summed over b, then run; dwy, df = the
// partials of every head and band, summed over the heads, then the bands.
__global__ void __launch_bounds__(SUM_THREADS) sum_partials(const Args a) {
  const size_t nt = (size_t)a.G * a.Hpg * a.Ht * a.Wt;
  const size_t i = (size_t)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i < nt) {
    float s = 0.0f;
    for (int p = 0; p < a.B * a.runs; ++p) s += a.part_t[p * nt + i];
    a.dtable[i] = s;
    return;
  }
  const size_t j = i - nt;  // (b * G + g) * N + n
  if (j >= (size_t)a.B * a.G * a.N) return;
  const int n = (int)(j % a.N);
  const size_t bg = j / a.N;
  float s_wy = 0.0f, s_f = 0.0f;
  for (int h = 0; h < a.Hpg; ++h) {
    for (int band = 0; band < a.bands; ++band) {
      const size_t o = (((size_t)band * a.B * a.G + bg) * a.Hpg + h) * a.N + n;
      s_wy += a.part_k[2 * o];
      s_f += a.part_k[2 * o + 1];
    }
  }
  a.dwy[j] = s_wy;
  a.df[j] = s_f;
}

// Launch the rows kernel `kernel` (an instance for W) and then sum_partials
// on `stream`; returns the first CUDA error, 0 when both were launched.
inline int launch(const void* kernel, const Args& a, void* stream) {
  const size_t smem = smem_bytes(a.R, a.Xa);
  int rc = lattice::set_smem(kernel, smem);
  if (rc) return rc;
  void* args[] = {const_cast<Args*>(&a)};
  const unsigned blocks = (unsigned)a.B * a.G * a.Hpg * a.runs * a.bands;
  cudaError_t e = cudaLaunchKernel(kernel, dim3(blocks), dim3(THREADS), args,
                                   smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  const size_t sums =
      (size_t)a.G * a.Hpg * a.Ht * a.Wt + (size_t)a.B * a.G * a.N;
  e = cudaLaunchKernel((const void*)sum_partials,
                       dim3((unsigned)((sums + SUM_THREADS - 1) / SUM_THREADS)),
                       dim3(SUM_THREADS), args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Blocks of `kernel` one SM holds at `smem` bytes of shared memory (a
// negative CUDA error code where the query fails).
inline int occupancy(const void* kernel, int smem) {
  int rc = lattice::set_smem(kernel, smem);
  if (rc) return -rc;
  int n = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace bias_bwd_rows
