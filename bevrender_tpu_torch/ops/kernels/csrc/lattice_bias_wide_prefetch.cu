// lattice_bias_wide.cu with each key's window staged in shared memory by
// asynchronous copies (cp.async), double buffered: the n-major rpe bias
// out[b, g, h, n, iy * W + ix] in bf16, for a table of any size.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/lattice_bias.py
// ::_fwd_call(dma=True) / _fwd_kernel_dma, the resolve-staged bias forward
// with tile t+1's windows drained by pltpu.make_async_copy while tile t
// computes (the JAX package's BEVRENDER_BIAS_DMA=1; here
// ModelConfig.bias_prefetch).
//
// A block owns (b, g, h, a run of keys). A key's window, the table rows
// ys .. ys + H and the columns ms .. ms + max(u0) + 2 that its H x W
// outputs read, is (H + 1) x CW bf16 with CW rounded out to whole 16-byte
// chunks (the pyramid's SCA 56: 57 x 296 x 2 B = 34 KB; the flagship's SCA:
// 29 x 152 x 2 B = 8.8 KB). A ring stage holds KS keys' windows, KS chosen
// by the wrapper (ops/kernels/lattice_bias.py::bias_ring) so that a stage
// gives every thread an output vector or more, and the two stages fit in
// shared memory. Copies are 16 bytes from a pitched zero-padded copy of the
// table that the launch makes first (lattice_ring.cuh). Per stage s:
// __syncthreads (stage s-1 consumed); issue stage s+1's copies and commit;
// wait for all but the newest group; __syncthreads; compute every output of
// stage s's keys from shared memory.
//
// The function and its arithmetic are lattice_bias_wide.cu's
// (lattice_common.cuh::bias_at on the staged window reads the same four
// entries that bias_at_raw reads from the raw table), so the output equals
// it, and lattice_bias.cu's, bit for bit.
//
// Bound: bytes; the output dominates, as for lattice_bias_wide.cu. Each
// thread computes VEC consecutive outputs of one (key, head) row: VEC = 8
// with one 16-byte store where M % 8 == 0, else VEC = 1
// (lattice_common.cuh::store_bf16).

#include "lattice_ring.cuh"

namespace {

constexpr int THREADS = 256;

template <int VEC>
__global__ void __launch_bounds__(THREADS) lattice_bias_wide_prefetch_kernel(
    const __nv_bfloat16* __restrict__ tp,  // (G * Hpg, Yp, Xs) pitched
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    __nv_bfloat16* __restrict__ out,  // (B, G, Hpg, N, H * W)
    int G, int Hpg, int Yp, int Xs, int N, int H, int W, int CW, int KS,
    int keys_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // (2, KS, H + 1, CW) ring of key windows
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int gh = blockIdx.y;  // g * Hpg + h
  const int g = gh / Hpg;
  const int h = gh - g * Hpg;
  const int b = blockIdx.z;
  const int M = H * W;
  const int MV = M / VEC;  // vectors per (key, head) row (VEC divides M)
  const int key_pitch = (H + 1) * CW;
  const int stage = KS * key_pitch;
  const int n0 = blockIdx.x * keys_per_block;
  const int nk = min(keys_per_block, N - n0);
  const size_t key0 = ((size_t)b * G + g) * N + n0;
  const __nv_bfloat16* tph = tp + (size_t)gh * Yp * Xs;
  __nv_bfloat16* ob = out + ((((size_t)b * G + g) * Hpg + h) * N + n0) * M;

  lattice::copy_windows(ring, key_pitch, tph, Xs, ys + key0, ms + key0,
                        min(KS, nk), 0, H + 1, CW);
  lattice::cp_async_commit();
  for (int j0 = 0, s = 0; j0 < nk; j0 += KS, ++s) {
    const int kn = min(KS, nk - j0);
    const int buf = s & 1;
    __syncthreads();  // stage s-1 consumed: its buffer is free
    if (j0 + KS < nk)
      lattice::copy_windows(ring + (buf ^ 1) * stage, key_pitch, tph, Xs,
                            ys + key0 + j0 + KS, ms + key0 + j0 + KS,
                            min(KS, nk - j0 - KS), 0, H + 1, CW);
    lattice::cp_async_commit();  // possibly empty: one group per stage
    lattice::cp_async_wait<1>();  // this thread's copies of stage s landed
    __syncthreads();              // and every other thread's
    for (int i = threadIdx.x; i < kn * MV; i += THREADS) {
      const int j = i / MV;
      const int m = (i - j * MV) * VEC;
      const size_t key = key0 + j0 + j;
      const float w_y = wy[key];
      const float f = fx[key];
      const __nv_bfloat16* win =
          ring + buf * stage + j * key_pitch + (ms[key] & 7);
      int iy = m / W;
      int ix = m - iy * W;
      float vals[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        vals[e] = lattice::bias_at(win + iy * CW + u0[ix], CW, gcomb[ix], w_y,
                                   f);
        if (++ix == W) {
          ix = 0;
          ++iy;
        }
      }
      lattice::store_bf16<VEC>(ob + (size_t)(j0 + j) * M + m, vals);
    }
  }
}

template <int VEC>
int launch(const void* table, void* pitched, const void* ys, const void* ms,
           const void* wy, const void* fx, const void* u0, const void* gcomb,
           void* out, int B, int G, int Hpg, int Ht, int Wt, int Xs, int N,
           int H, int W, int CW, int KS, int keys_per_block,
           cudaStream_t stream) {
  int rc = lattice::pitch_table(pitched, table, G * Hpg, Ht, Wt, Xs, stream);
  if (rc) return rc;
  const size_t smem =
      (size_t)2 * KS * (H + 1) * CW * sizeof(__nv_bfloat16);
  rc = lattice::set_smem((const void*)lattice_bias_wide_prefetch_kernel<VEC>,
                         smem);
  if (rc) return rc;
  dim3 grid((N + keys_per_block - 1) / keys_per_block, G * Hpg, B);
  lattice_bias_wide_prefetch_kernel<VEC><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)pitched, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (__nv_bfloat16*)out, G, Hpg,
      Ht + 2 * lattice::PAD, Xs, N, H, W, CW, KS, keys_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// `pitched` is scratch of G * Hpg * (Ht + 2 PAD) * Xs bf16 (Xs a multiple
// of 8) for the pitched copy of the table.
extern "C" int lattice_bias_wide_prefetch_launch(
    const void* table, void* pitched, const void* ys, const void* ms,
    const void* wy, const void* fx, const void* u0, const void* gcomb,
    void* out, int B, int G, int Hpg, int Ht, int Wt, int Xs, int N, int H,
    int W, int CW, int KS, int keys_per_block, void* stream) {
  if (Xs % 8 || CW % 8 || KS < 1) return (int)cudaErrorInvalidValue;
  auto fn = (H * W) % 8 == 0 ? launch<8> : launch<1>;
  return fn(table, pitched, ys, ms, wy, fx, u0, gcomb, out, B, G, Hpg, Ht,
            Wt, Xs, N, H, W, CW, KS, keys_per_block, (cudaStream_t)stream);
}
