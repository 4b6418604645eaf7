// Lattice rpe bias, n-major: out[b, g, h, n, iy * W + ix] in bf16, at the
// sites whose group of padded tables fits a block
// (bevrender_tpu_torch/ops/deform_attn.py::bias_route): every flagship site
// and every pyramid site but SCA at BEV 56.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/lattice_bias.py
// ::_fwd_call_sh / _fwd_kernel_sh (shift-replicated staging). The TPU
// staging (8 pre-shifted table replicas, 8-row alignment, 64-key padding,
// packed window starts) exists for VMEM and sublanes and is not carried
// over.
//
// Bound: bytes; the output (B * G * Hpg * N * M * 2 bytes, 49 MB at the
// flagship's SCA G=2, 0.0148 ms) dominates. This kernel is the third
// instance of the row-walking template of bias_fwd_rows.cuh (see there for
// the design): a lane walks a strip of a key's output rows, x-lerping each
// table row once, a block one head and a run of keys. Its table comes from
// either of two paths, which lattice_bias.py::fwd_plan picks by what a
// staging is worth:
// - "whole" (RAW), where the block's run of keys repays staging: the block
//   copies its head's raw table into shared memory as the zero-padded table
//   itself (63 x 287 bf16, 36 KB, at the flagship's SCA), in the same launch,
//   by 16-byte cp.async (bias_fwd_rows.cuh::stage_raw: each staged row at
//   its raw row's 16-byte phase), and reads it with no bounds check;
// - "l1", where the run is too short (the TSA sites, a few keys a block,
//   and BEV 7's SCA, a few outputs a key): the lane reads the raw table
//   through L1, as lattice_bias_wide.cu does.
// One 1024-thread block an SM (blocks of 256 threads were no faster at the
// TSA sites, PERF.md §6). Its output equals lattice_bias_wide.cu's,
// lattice_bias_wide_prefetch.cu's and the float32 plain version's rounded
// to bf16, bit for bit.

#include "bias_fwd_rows.cuh"

namespace {

template <int SRC, int P, int K>
__global__ void __launch_bounds__(bias_fwd_rows::THREADS, 1)
    lattice_bias_kernel(const bias_fwd_rows::Args a) {
  bias_fwd_rows::rows<SRC, P, K>(a);
}

template <int SRC>
const void* instance(int W) {
  if (W <= 8) return (const void*)lattice_bias_kernel<SRC, 8, 1>;
  if (W <= 16) return (const void*)lattice_bias_kernel<SRC, 8, 2>;
  if (W <= 32) return (const void*)lattice_bias_kernel<SRC, 16, 2>;
  return (const void*)lattice_bias_kernel<SRC, 32, 2>;
}

// the instance of a path for W query columns, as lattice_bias_wide.cu's
const void* kernel_for(bool whole, int W) {
  return whole ? instance<bias_fwd_rows::RAW>(W)
               : instance<bias_fwd_rows::L1>(W);
}

}  // namespace

// On path "whole" (`whole` 1) a block stages its head's padded table at row
// pitch Xs = Wt + 8 (lattice_bias.py::staged_pitch); on "l1" Xs is not
// read.
extern "C" int lattice_bias_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, void* out, int B,
    int G, int Hpg, int Ht, int Wt, int Xs, int N, int H, int W, int whole,
    int runs, int keys, int strips, int rows, void* stream) {
  if (W < 1 || W > 64 || (whole && Xs != Wt + 8))
    return (int)cudaErrorInvalidValue;
  const bias_fwd_rows::Args a{
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (__nv_bfloat16*)out, B, G, Hpg, Ht, Wt, Xs, N, H,
      W, runs, keys, strips, rows};
  return bias_fwd_rows::launch(kernel_for(whole, W),
                               whole ? bias_fwd_rows::RAW : bias_fwd_rows::L1,
                               a, stream);
}

// Blocks one SM holds of the instance of a path for W at `smem` bytes of
// shared memory.
extern "C" int lattice_bias_occupancy(int whole, int W, int smem) {
  if (W < 1 || W > 64) return -(int)cudaErrorInvalidValue;
  return bias_fwd_rows::occupancy(kernel_for(whole, W), smem);
}
