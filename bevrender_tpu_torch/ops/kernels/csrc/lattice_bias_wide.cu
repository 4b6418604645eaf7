// Lattice rpe bias of a wide site, n-major: out[b, g, h, n, iy * W + ix] in
// bf16, for a table of any size, read from device memory through L1.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/lattice_bias.py
// ::_fwd_call / _fwd_kernel (the resolve staging, which the JAX package
// takes where the shift-replicated table block is over 12 MB: the pyramid's
// 56 x 56 sites). That staging (a table rearranged per key shift class,
// `_fill_xres` and `_mix_resolve`, 64-key padding) is how a TPU kernel gets
// windows out of VMEM and is not carried over; its one x-lerp a window row
// (`xres`) is.
//
// Bound: bytes; the output (B * G * Hpg * N * M * 2 bytes, 197 MB for the
// pyramid's SCA at BEV 56, B = 2, 0.059 ms) dominates. This kernel is the
// raw-table instance of the row-walking template
// of bias_fwd_rows.cuh (see there for the design): a lane walks a strip of
// a key's output rows, x-lerping each table row once through L1 with the
// padding's bounds checks hoisted (a column's once a key, a row's once a
// row); a block holds one head, so that the SM's L1 holds one head's table.
// No shared memory, so any table size launches. The launch comes from
// lattice_bias.py::fwd_plan. Its output equals lattice_bias_wide_prefetch.cu's
// and lattice_bias.cu's bit for bit.

#include "bias_fwd_rows.cuh"

namespace {

template <int P, int K>
__global__ void __launch_bounds__(bias_fwd_rows::THREADS, 1)
    lattice_bias_wide_kernel(const bias_fwd_rows::Args a) {
  bias_fwd_rows::rows<bias_fwd_rows::L1, P, K>(a);
}

// the instance for W query columns: segments of 8, 16 or 32 lanes, one
// column a lane, or two where W > 32
const void* kernel_for(int W) {
  if (W <= 8) return (const void*)lattice_bias_wide_kernel<8, 1>;
  if (W <= 16) return (const void*)lattice_bias_wide_kernel<8, 2>;
  if (W <= 32) return (const void*)lattice_bias_wide_kernel<16, 2>;
  return (const void*)lattice_bias_wide_kernel<32, 2>;
}

}  // namespace

extern "C" int lattice_bias_wide_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, void* out, int B,
    int G, int Hpg, int Ht, int Wt, int N, int H, int W, int runs, int keys,
    int strips, int rows, void* stream) {
  if (W < 1 || W > 64) return (int)cudaErrorInvalidValue;
  const bias_fwd_rows::Args a{
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (__nv_bfloat16*)out, B, G, Hpg, Ht, Wt, 0, N, H,
      W, runs, keys, strips, rows};
  return bias_fwd_rows::launch(kernel_for(W), bias_fwd_rows::L1, a, stream);
}

// Blocks one SM holds of the instance for W at `smem` bytes of shared memory.
extern "C" int lattice_bias_wide_occupancy(int W, int smem) {
  if (W < 1 || W > 64) return -(int)cudaErrorInvalidValue;
  return bias_fwd_rows::occupancy(kernel_for(W), smem);
}
