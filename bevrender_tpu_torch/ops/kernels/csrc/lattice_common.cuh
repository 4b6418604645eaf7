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

// The four table entries that one (key, query) pair reads, as floats, and its
// column fraction: what the backward kernels keep between the bias and its
// cotangent. `window_bias(load_window(p0, ...), wy)` is `bias_at(p0, ...)`.
struct Window {
  float t00, t01, t10, t11, wx;
  int cross;  // 1 where the column fraction crossed into the next cell
};

__device__ __forceinline__ Window load_window(const __nv_bfloat16* p0, int Xp,
                                              float g, float f) {
  Window w;
  const float phi = __fadd_rn(g, f);
  const float cross = floorf(phi);
  w.wx = __fsub_rn(phi, cross);
  w.cross = cross > 0.5f ? 1 : 0;
  const __nv_bfloat16* p = p0 + w.cross;
  w.t00 = __bfloat162float(p[0]);
  w.t01 = __bfloat162float(p[1]);
  w.t10 = __bfloat162float(p[Xp]);
  w.t11 = __bfloat162float(p[Xp + 1]);
  return w;
}

__device__ __forceinline__ float window_bias(const Window& w, float wy) {
  return lerp_rn(lerp_rn(w.t00, w.t01, w.wx), lerp_rn(w.t10, w.t11, w.wx), wy);
}

// Cotangent tail of one pair: spread `go` (the cotangent of the bias) over
// the four entries with the forward's weights into the float32 gradient
// table in shared memory (`g0` is that table at the offset `p0` had in the
// bf16 one), and add the pair's share of the cotangents of wy and of f
// (d wx / d f = 1; floor carries no gradient).
__device__ __forceinline__ void window_tail(const Window& w, float* g0, int Xp,
                                            float wy, float go, float& dwy,
                                            float& df) {
  const float x0 = lerp_rn(w.t00, w.t01, w.wx);
  const float x1 = lerp_rn(w.t10, w.t11, w.wx);
  dwy = fmaf(go, x1 - x0, dwy);
  const float d0 = go * (1.0f - wy);
  const float d1 = go * wy;
  df += d0 * (w.t01 - w.t00) + d1 * (w.t11 - w.t10);
  float* gp = g0 + w.cross;
  const float ux = 1.0f - w.wx;
  atomicAdd(gp, d0 * ux);
  atomicAdd(gp + 1, d0 * w.wx);
  atomicAdd(gp + Xp, d1 * ux);
  atomicAdd(gp + Xp + 1, d1 * w.wx);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Add the (Ht, Wt) interior of a padded float32 gradient table in shared
// memory into the table gradient in device memory, with the whole block.
// Gradient that landed in the padding is dropped: the padding is constant.
__device__ __forceinline__ void flush_gradient(float* dtable, const float* sg,
                                               int Ht, int Wt, int Xp) {
  for (int i = threadIdx.x; i < Ht * Wt; i += blockDim.x) {
    const int r = i / Wt;
    const float val = sg[(r + PAD) * Xp + (i - r * Wt) + PAD];
    if (val != 0.0f) atomicAdd(dtable + i, val);
  }
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

// Entry (r, c) of the zero-padded table (padded coordinates: PAD rows above,
// PAD columns on the left), read from the raw (Ht, Wt) table in device
// memory: the bounds checks stand in for the padding.
__device__ __forceinline__ float padded_at(const __nv_bfloat16* __restrict__ t,
                                           int Ht, int Wt, int r, int c) {
  r -= PAD;
  c -= PAD;
  if ((unsigned)r >= (unsigned)Ht || (unsigned)c >= (unsigned)Wt) return 0.0f;
  return __bfloat162float(__ldg(t + (size_t)r * Wt + c));
}

// two floats -> two round-to-nearest bf16 in one word, lower address first
__device__ __forceinline__ unsigned pack2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// Store VEC consecutive outputs as bf16: one 16-byte vector for VEC = 8
// (`dst` 16-byte aligned), one 2-byte store for VEC = 1.
template <int VEC>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst,
                                           const float* vals) {
  static_assert(VEC == 8 || VEC == 1, "VEC is 8 or 1");
  if constexpr (VEC == 8) {
    uint4 pk;
    pk.x = pack2(vals[0], vals[1]);
    pk.y = pack2(vals[2], vals[3]);
    pk.z = pack2(vals[4], vals[5]);
    pk.w = pack2(vals[6], vals[7]);
    *reinterpret_cast<uint4*>(dst) = pk;
  } else {
    dst[0] = __float2bfloat16_rn(vals[0]);
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
