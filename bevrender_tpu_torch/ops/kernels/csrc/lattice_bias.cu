// Lattice rpe bias, n-major: out[b, g, h, n, iy * W + ix] in bf16.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/lattice_bias.py
// ::_fwd_call_sh / _fwd_kernel_sh (shift-replicated staging). The TPU
// staging (8 pre-shifted table replicas, 8-row alignment, 64-key padding,
// packed window starts) exists for VMEM and sublanes and is not carried
// over: here the zero-padded bf16 table of one group (all its heads, 2 x 64
// x 357 x 2 B = 91 KB for the flagship's SCA) sits whole in shared memory
// and each output is two x-lerps and one y-lerp straight from it.
//
// Bound: bytes. The output (B * G * Hpg * N * M * 2 bytes) dominates; the
// inputs are the table and 16 bytes of geometry per key. A block takes one
// (b, g) and a run of keys and loads the group's table once; each thread
// computes VEC = 8 consecutive outputs of one (key, head) row and stores
// them as one 16-byte vector where M = H * W is a multiple of 8, and one
// output with a 2-byte store otherwise (the pyramid's M = 196 and 49, at
// BEV 14 and 7). The group's table must fit in shared memory; the sites
// whose table does not take lattice_bias_wide.cu
// (bevrender_tpu_torch/ops/deform_attn.py::bias_route).

#include "lattice_common.cuh"

namespace {

template <int VEC>
__global__ void lattice_bias_kernel(
    const __nv_bfloat16* __restrict__ table,  // (G, Hpg, Ht, Wt)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    __nv_bfloat16* __restrict__ out,  // (B, G, Hpg, N, H * W)
    int G, int Hpg, int Ht, int Wt, int Xp, int N, int H, int W,
    int keys_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tsize = (Ht + 2 * lattice::PAD) * Xp;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  lattice::stage_padded(st, table + (size_t)g * Hpg * Ht * Wt, Hpg, Ht, Wt,
                        Xp);
  __syncthreads();

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
    const __nv_bfloat16* t = st + h * tsize + ys[key] * Xp + ms[key];
    int iy = m / W;
    int ix = m - iy * W;
    float vals[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      vals[e] = lattice::bias_at(t + iy * Xp + u0[ix], Xp, gcomb[ix], w_y, f);
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
           int B, int G, int Hpg, int Ht, int Wt, int Xp, int N, int H, int W,
           int keys_per_block, cudaStream_t stream) {
  const size_t smem =
      (size_t)Hpg * (Ht + 2 * lattice::PAD) * Xp * sizeof(__nv_bfloat16);
  int rc = lattice::set_smem((const void*)lattice_bias_kernel<VEC>, smem);
  if (rc) return rc;
  dim3 grid((N + keys_per_block - 1) / keys_per_block, G, B);
  lattice_bias_kernel<VEC><<<grid, 256, smem, stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (__nv_bfloat16*)out, G, Hpg, Ht, Wt, Xp, N, H, W,
      keys_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lattice_bias_launch(const void* table, const void* ys,
                                   const void* ms, const void* wy,
                                   const void* fx, const void* u0,
                                   const void* gcomb, void* out, int B, int G,
                                   int Hpg, int Ht, int Wt, int Xp, int N,
                                   int H, int W, int keys_per_block,
                                   void* stream) {
  auto fn = (H * W) % 8 == 0 ? launch<8> : launch<1>;
  return fn(table, ys, ms, wy, fx, u0, gcomb, out, B, G, Hpg, Ht, Wt, Xp, N,
            H, W, keys_per_block, (cudaStream_t)stream);
}
