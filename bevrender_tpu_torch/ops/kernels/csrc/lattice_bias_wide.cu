// Lattice rpe bias of a wide site, n-major: out[b, g, h, n, iy * W + ix] in
// bf16, for a table too large for lattice_bias.cu's shared memory.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/lattice_bias.py
// ::_fwd_call / _fwd_kernel (the resolve staging, which the JAX package
// takes where the shift-replicated table block is over 12 MB: the pyramid's
// 56 x 56 sites). That staging (a table rearranged per key shift class,
// `_fill_xres` and `_mix_resolve`, 64-key padding) is how a TPU kernel gets
// windows out of VMEM and is not carried over. The function is the one
// lattice_bias.cu computes (lattice_common.cuh::bias_at: two x-lerps and one
// y-lerp in float32 from the bf16 table), so the output equals it bit for
// bit.
//
// Bound: bytes; the output (B * G * Hpg * N * M * 2 bytes, 197 MB for the
// pyramid's SCA at BEV 56, B = 2) dominates. One head's zero-padded table
// there is 119 x 849 bf16 (202 KB); a group's two heads (404 KB) do not fit
// in the 227 KB of shared memory a block may have. Of the designs weighed
// (one head per block in shared memory; a band of table rows per block; the
// table read from device memory through L1), this takes the last: each
// thread reads its four window entries of the raw table with __ldg and
// bounds checks that stand in for the zero padding. A key's window spans
// H + 1 rows and about half the table's width, and the threads of a block
// walk one (key, head) row after the other along the queries, so
// neighbouring threads read neighbouring columns and the window stays in L1;
// the whole table (0.2-0.4 MB per group) stays in the 50 MB L2. No shared
// memory, so any table size launches and several blocks share an SM. Each
// thread computes VEC consecutive outputs of one (key, head) row: VEC = 8
// with one 16-byte store where M % 8 == 0, else VEC = 1.

#include "lattice_common.cuh"

namespace {

template <int VEC>
__global__ void lattice_bias_wide_kernel(
    const __nv_bfloat16* __restrict__ table,  // (G, Hpg, Ht, Wt)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    __nv_bfloat16* __restrict__ out,  // (B, G, Hpg, N, H * W)
    int G, int Hpg, int Ht, int Wt, int N, int H, int W, int keys_per_block) {
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int M = H * W;
  const int MV = M / VEC;  // vectors per (key, head) row (VEC divides M)
  const int n0 = blockIdx.x * keys_per_block;
  const int nk = min(keys_per_block, N - n0);
  for (int i = threadIdx.x; i < nk * Hpg * MV; i += blockDim.x) {
    const int kh = i / MV;  // local key * Hpg + head
    const int m = (i - kh * MV) * VEC;
    const int kl = kh / Hpg;
    const int h = kh - kl * Hpg;
    const int n = n0 + kl;
    const size_t key = ((size_t)b * G + g) * N + n;
    const float w_y = wy[key];
    const float f = fx[key];
    const int y0 = ys[key];
    const int x0 = ms[key];
    const __nv_bfloat16* t = table + ((size_t)g * Hpg + h) * Ht * Wt;
    int iy = m / W;
    int ix = m - iy * W;
    float vals[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      // lattice::bias_at, with the four reads from the raw table
      const float phi = __fadd_rn(gcomb[ix], f);
      const float cross = floorf(phi);
      const float wx = __fsub_rn(phi, cross);
      const int r = y0 + iy;
      const int c = x0 + u0[ix] + (cross > 0.5f ? 1 : 0);
      using lattice::lerp_rn;
      using lattice::padded_at;
      const float a0 = lerp_rn(padded_at(t, Ht, Wt, r, c),
                               padded_at(t, Ht, Wt, r, c + 1), wx);
      const float a1 = lerp_rn(padded_at(t, Ht, Wt, r + 1, c),
                               padded_at(t, Ht, Wt, r + 1, c + 1), wx);
      vals[e] = lerp_rn(a0, a1, w_y);
      if (++ix == W) {
        ix = 0;
        ++iy;
      }
    }
    __nv_bfloat16* dst = out + ((((size_t)b * G + g) * Hpg + h) * N + n) * M + m;
    lattice::store_bf16<VEC>(dst, vals);
  }
}

template <int VEC>
int launch(const void* table, const void* ys, const void* ms, const void* wy,
           const void* fx, const void* u0, const void* gcomb, void* out,
           int B, int G, int Hpg, int Ht, int Wt, int N, int H, int W,
           int keys_per_block, cudaStream_t stream) {
  dim3 grid((N + keys_per_block - 1) / keys_per_block, G, B);
  lattice_bias_wide_kernel<VEC><<<grid, 256, 0, stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (__nv_bfloat16*)out, G, Hpg, Ht, Wt, N, H, W,
      keys_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lattice_bias_wide_launch(const void* table, const void* ys,
                                        const void* ms, const void* wy,
                                        const void* fx, const void* u0,
                                        const void* gcomb, void* out, int B,
                                        int G, int Hpg, int Ht, int Wt, int N,
                                        int H, int W, int keys_per_block,
                                        void* stream) {
  auto fn = (H * W) % 8 == 0 ? launch<8> : launch<1>;
  return fn(table, ys, ms, wy, fx, u0, gcomb, out, B, G, Hpg, Ht, Wt, N, H, W,
            keys_per_block, (cudaStream_t)stream);
}
