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

#include <mutex>
#include <unordered_map>

namespace lattice {

constexpr int PAD = 4;

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), a), __fmul_rn(w, b));
}

// What every head shares of one (key, query) pair's bias: the column
// fraction wx = frac(g + f) and whether the column crossed into the next
// cell.
struct Column {
  float wx;
  int cross;
};

__device__ __forceinline__ Column column(float g, float f) {
  const float phi = __fadd_rn(g, f);
  const float cross = floorf(phi);
  return {__fsub_rn(phi, cross), cross > 0.5f ? 1 : 0};
}

// Bias for one (key, query) pair whose column is `col`. `p0` points into the
// padded table (row pitch Xp) at row ys + iy, column u0[ix] + ms.
__device__ __forceinline__ float bias_col(const __nv_bfloat16* p0, int Xp,
                                          Column col, float wy) {
  const __nv_bfloat16* p = p0 + col.cross;
  const float x0 =
      lerp_rn(__bfloat162float(p[0]), __bfloat162float(p[1]), col.wx);
  const float x1 =
      lerp_rn(__bfloat162float(p[Xp]), __bfloat162float(p[Xp + 1]), col.wx);
  return lerp_rn(x0, x1, wy);
}

// Bias for one (key, query) pair, `p0` as for `bias_col`.
__device__ __forceinline__ float bias_at(const __nv_bfloat16* p0, int Xp,
                                         float g, float wy, float f) {
  return bias_col(p0, Xp, column(g, f), wy);
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

// `bias_at` for the raw table in device memory: (r, c) is the padded-table
// position that `p0` would point at (row ys + iy, column u0[ix] + ms). Each
// of the four entries is read with __ldg where it lies in the raw table and
// is 0 where it lies in the padding (one bounds check per row and per
// column). Same arithmetic, same result.
__device__ __forceinline__ float bias_at_raw(const __nv_bfloat16* __restrict__ t,
                                             int Ht, int Wt, int r, int c,
                                             float g, float wy, float f) {
  const Column col = column(g, f);
  r -= PAD;
  c += col.cross - PAD;
  const bool r0 = (unsigned)r < (unsigned)Ht;
  const bool r1 = (unsigned)(r + 1) < (unsigned)Ht;
  const bool c0 = (unsigned)c < (unsigned)Wt;
  const bool c1 = (unsigned)(c + 1) < (unsigned)Wt;
  const __nv_bfloat16* p = t + (r * Wt + c);  // read only where in the table
  const float t00 = r0 && c0 ? __bfloat162float(__ldg(p)) : 0.0f;
  const float t01 = r0 && c1 ? __bfloat162float(__ldg(p + 1)) : 0.0f;
  const float t10 = r1 && c0 ? __bfloat162float(__ldg(p + Wt)) : 0.0f;
  const float t11 = r1 && c1 ? __bfloat162float(__ldg(p + Wt + 1)) : 0.0f;
  return lerp_rn(lerp_rn(t00, t01, col.wx), lerp_rn(t10, t11, col.wx), wy);
}

// two floats -> two round-to-nearest bf16 in one word, lower address first
__device__ __forceinline__ unsigned pack2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// Let `kernel` take `bytes` of dynamic shared memory (the attribute is
// needed above 48 KB). The call is host time on every launch of paths that
// are host-bound, so each kernel's largest size set so far is remembered
// and the attribute set again only for a larger one; the lock keeps two
// threads from recording a size that was not the last set.
inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  static std::mutex lock;
  static std::unordered_map<const void*, size_t> largest;
  std::lock_guard<std::mutex> guard(lock);
  size_t& done = largest[kernel];
  if (bytes <= done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  done = bytes;
  return 0;
}

}  // namespace lattice
