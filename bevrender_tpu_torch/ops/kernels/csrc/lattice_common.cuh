// Shared pieces of the lattice rpe-bias kernels.
//
// The bias of key n at query (iy, ix) for head h is a bilinear read of the
// rpe table (Ht x Wt, bf16) zero-padded by PAD rows above and below, PAD
// columns on the left and max(PAD, m_max) on the right: rows ys + iy and
// ys + iy + 1, columns c and c + 1 with c = u0[ix] + ms (+1 where the
// column fraction crossed into the next cell), fractions wx = frac(g[ix] +
// f) and wy. The per-key starts ys, ms are clipped into the padded table
// (bevrender_tpu_torch/ops/deform_attn.py::lattice_geometry), so every read
// lands inside it: the padding replaces bounds checks. Every lerp is
// (1 - w) * a + w * b with each operation rounded on its own (no FMA
// contraction), which is what the plain PyTorch version computes in
// float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lattice {

constexpr int PAD = 4;

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), a), __fmul_rn(w, b));
}

// Bias for one (key, query) pair. `p0` points into the padded table (row
// pitch Xp) at row ys + iy, column u0[ix] + ms.
__device__ __forceinline__ float bias_at(const __nv_bfloat16* p0, int Xp,
                                         float g, float wy, float f) {
  const float phi = __fadd_rn(g, f);
  const float cross = floorf(phi);
  const float wx = __fsub_rn(phi, cross);
  const __nv_bfloat16* p = p0 + (cross > 0.5f ? 1 : 0);
  const float x0 =
      lerp_rn(__bfloat162float(p[0]), __bfloat162float(p[1]), wx);
  const float x1 =
      lerp_rn(__bfloat162float(p[Xp]), __bfloat162float(p[Xp + 1]), wx);
  return lerp_rn(x0, x1, wy);
}

// Copy `heads` consecutive (Ht, Wt) tables into shared memory as zero-padded
// (Ht + 2 PAD, Xp) tables, with the whole block: one warp per padded row,
// its lanes along the row.
__device__ __forceinline__ void stage_padded(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             int heads, int Ht, int Wt,
                                             int Xp) {
  const int Yp = Ht + 2 * PAD;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int row = threadIdx.x >> 5; row < heads * Yp; row += blockDim.x >> 5) {
    const int h = row / Yp;
    const int r = row - h * Yp - PAD;
    __nv_bfloat16* d = dst + (size_t)row * Xp;
    if (r < 0 || r >= Ht) {
      for (int c = lane; c < Xp; c += 32) d[c] = zero;
      continue;
    }
    const __nv_bfloat16* s = src + ((size_t)h * Ht + r) * Wt;
    for (int c = lane; c < Xp; c += 32) {
      const int sc = c - PAD;
      d[c] = (sc >= 0 && sc < Wt) ? s[sc] : zero;
    }
  }
}

inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace lattice
