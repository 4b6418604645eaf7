// Per-key window extraction from the column-rearranged rpe table, and its
// backward: the windowed lattice bias (ops/deform_attn.py::
// lattice_bias_windowed, ModelConfig.bias_windows).
//
//   out[b, g, n, m, y, :] = t3[g, ys[b, g, n] + y, ms[b, g, n] + m, :]
//
// for m < 3 and y < h1 (= H + 1), with t3 (G, Y, m_max, WH) bf16 the
// zero-padded table with its columns rearranged per query column
// (ops/deform_attn.py::lattice_t3) and ys, ms (B, G, N) int32 the clipped
// window starts of each key (lattice_geometry): every read lands inside t3,
// so the kernels check no bounds. The backward adds each window's
// cotangent back: dt3[g, ys + y, ms + m, :] += gout[b, g, n, m, y, :] over
// all keys, in float32, then casts to bf16.
//
// Replaces the TPU kernels bevrender_tpu/ops/pallas/lattice_win.py
// ::_lattice_windows_fwd_impl (:169, _win_kernel :34) and
// ::_lattice_windows_bwd (:113, _win_bwd_kernel :58). Those pad the keys to
// 128, read an 8-row-aligned block and resolve the row shift with an 8-way
// switch, keep a y-padded table resident in VMEM and take the starts
// packed as ys << 16 | ms by scalar prefetch: all of it exists for Mosaic's
// tiling and is left out here.
//
// Bound: bytes. The forward reads t3 (7.6 MB at the pyramid's SCA 56, which
// stays in the 50 MB L2) and writes every window once (600 MB there); the
// backward reads every window's cotangent once. A block takes one key and
// walks its 3 * h1 output rows of WH values in vectors of VEC bf16, VEC the
// widest of 8, 4, 2, 1 that divides WH: a row starts on a multiple of WH * 2
// bytes in both tensors, so that is the alignment every row has (56 B rows
// at Hpg = 1, W = 28 take 8-byte vectors). Neighbouring threads take
// neighbouring vectors of the key's contiguous output, so every store is
// coalesced; the row of t3 a vector comes from is contiguous as well.
// Element offsets are 64-bit: the pyramid's SCA 56 output has 3e8 of them.
//
// The backward adds through float atomics into a zeroed float32 buffer that
// the L2 holds (15 MB at the pyramid's SCA 56): the order of the sums, and
// so the last bits of the result, vary from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

template <int VEC>
struct Vec;
template <>
struct Vec<8> {
  using T = uint4;
};
template <>
struct Vec<4> {
  using T = uint2;
};
template <>
struct Vec<2> {
  using T = unsigned int;
};
template <>
struct Vec<1> {
  using T = unsigned short;
};

// Where vector j of key `key`'s output comes from: the row of t3 (as an
// index of (G * Y * m_max) rows of WH values) and the vector in that row.
struct Src {
  size_t row;
  int v;
};

__device__ __forceinline__ Src source(int j, int vpr, int h1, int y0, int m0,
                                      size_t gbase, int m_max) {
  const int r = j / vpr;  // output row of the key: m * h1 + y
  const int v = j - r * vpr;
  const int m = r / h1;
  const int y = r - m * h1;
  return {(gbase + y0 + y) * m_max + m0 + m, v};
}

template <int VEC>
__global__ void __launch_bounds__(THREADS) lattice_windows_kernel(
    const typename Vec<VEC>::T* __restrict__ t3,  // (G, Y, m_max, WH)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    typename Vec<VEC>::T* __restrict__ out,  // (B, G, N, 3, h1, WH)
    int G, int N, int Y, int m_max, int h1, int vpr) {
  const int key = blockIdx.x;  // (b * G + g) * N + n
  const size_t gbase = (size_t)((key / N) % G) * Y;
  const int y0 = ys[key];
  const int m0 = ms[key];
  const int per_key = 3 * h1 * vpr;
  typename Vec<VEC>::T* dst = out + (size_t)key * per_key;
  for (int j = threadIdx.x; j < per_key; j += THREADS) {
    const Src s = source(j, vpr, h1, y0, m0, gbase, m_max);
    dst[j] = t3[s.row * vpr + s.v];
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS) lattice_windows_bwd_kernel(
    const __nv_bfloat16* __restrict__ gout,  // (B, G, N, 3, h1, WH)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    float* __restrict__ acc,  // (G, Y, m_max, WH), zeroed
    int G, int N, int Y, int m_max, int h1, int vpr) {
  using T = typename Vec<VEC>::T;
  const int key = blockIdx.x;
  const size_t gbase = (size_t)((key / N) % G) * Y;
  const int y0 = ys[key];
  const int m0 = ms[key];
  const int per_key = 3 * h1 * vpr;
  const T* src = reinterpret_cast<const T*>(gout) + (size_t)key * per_key;
  for (int j = threadIdx.x; j < per_key; j += THREADS) {
    const Src s = source(j, vpr, h1, y0, m0, gbase, m_max);
    const T raw = src[j];
    const __nv_bfloat16* vals = reinterpret_cast<const __nv_bfloat16*>(&raw);
    float* dst = acc + (s.row * vpr + s.v) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) atomicAdd(dst + e, __bfloat162float(vals[e]));
  }
}

__global__ void __launch_bounds__(256) windows_cast_kernel(
    const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
    size_t count) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < count;
       i += (size_t)gridDim.x * 256)
    out[i] = __float2bfloat16(acc[i]);
}

int vector_width(int WH) {
  return WH % 8 == 0 ? 8 : WH % 4 == 0 ? 4 : WH % 2 == 0 ? 2 : 1;
}

template <int VEC>
void forward(const void* t3, const void* ys, const void* ms, void* out,
             int keys, int G, int N, int Y, int m_max, int h1, int WH,
             cudaStream_t stream) {
  using T = typename Vec<VEC>::T;
  lattice_windows_kernel<VEC><<<keys, THREADS, 0, stream>>>(
      (const T*)t3, (const int*)ys, (const int*)ms, (T*)out, G, N, Y, m_max,
      h1, WH / VEC);
}

template <int VEC>
void backward(const void* gout, const void* ys, const void* ms, float* acc,
              int keys, int G, int N, int Y, int m_max, int h1, int WH,
              cudaStream_t stream) {
  lattice_windows_bwd_kernel<VEC><<<keys, THREADS, 0, stream>>>(
      (const __nv_bfloat16*)gout, (const int*)ys, (const int*)ms, acc, G, N,
      Y, m_max, h1, WH / VEC);
}

}  // namespace

// t3 (G, Y, m_max, WH) bf16, ys and ms (B, G, N) int32 with keys = B * G * N
// -> out (B, G, N, 3, h1, WH) bf16. t3 and out 16-byte aligned.
extern "C" int lattice_windows_launch(const void* t3, const void* ys,
                                      const void* ms, void* out, int keys,
                                      int G, int N, int Y, int m_max, int h1,
                                      int WH, void* stream) {
  auto fn = forward<1>;
  switch (vector_width(WH)) {
    case 8: fn = forward<8>; break;
    case 4: fn = forward<4>; break;
    case 2: fn = forward<2>; break;
  }
  fn(t3, ys, ms, out, keys, G, N, Y, m_max, h1, WH, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// gout (B, G, N, 3, h1, WH) bf16, ys and ms (B, G, N) int32 -> acc (G, Y,
// m_max, WH) float32, the sum of the windows' cotangents (zeroed here
// first); with `cast`, also out (the same shape) in bf16.
extern "C" int lattice_windows_bwd_launch(const void* gout, const void* ys,
                                          const void* ms, void* acc, void* out,
                                          int keys, int G, int N, int Y,
                                          int m_max, int h1, int WH, int cast,
                                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t count = (size_t)G * Y * m_max * WH;
  cudaError_t e = cudaMemsetAsync(acc, 0, count * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  auto fn = backward<1>;
  switch (vector_width(WH)) {
    case 8: fn = backward<8>; break;
    case 4: fn = backward<4>; break;
    case 2: fn = backward<2>; break;
  }
  fn(gout, ys, ms, (float*)acc, keys, G, N, Y, m_max, h1, WH, s);
  if (cast) {
    const size_t blocks = (count + 255) / 256;
    windows_cast_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                          s>>>((const float*)acc, (__nv_bfloat16*)out, count);
  }
  return (int)cudaGetLastError();
}
