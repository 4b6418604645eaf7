// lattice_bias_wide.cu with the table staged in shared memory by
// asynchronous copies: the n-major rpe bias out[b, g, h, n, iy * W + ix] in
// bf16, for a table of any size.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/lattice_bias.py
// ::_fwd_call(dma=True) / _fwd_kernel_dma, the resolve-staged bias forward
// with tile t+1's windows drained by pltpu.make_async_copy while tile t
// computes (the JAX package's BEVRENDER_BIAS_DMA=1; here
// ModelConfig.bias_forward="prefetch"). What it keeps out of device memory
// is the point, not its per-tile windows: a window of H + 1 rows x ~W Wt /
// (2 W - 2) columns serves only one key's H x W outputs, so copying windows
// key by key moves five times the output's bytes from L2 (PERF.md §6).
//
// Bound: bytes; the output dominates, as for lattice_bias_wide.cu. This
// kernel is the staged instance of bias_fwd_rows.cuh (see there for the
// design). Where one head's zero-padded table fits a block (path "whole":
// 119 x 567 bf16, 135 KB, at the pyramid's SCA 56; 63 x 287, 36 KB, at the
// flagship's SCA), each block stages its head's table once, straight from
// the raw table by 16-byte cp.async (bias_fwd_rows.cuh::stage_raw, in the
// same launch, as lattice_bias.cu does), then walks a run of about 240
// keys with no bounds check. Where it does not fit (path "l1"; no shipped
// model has such a site) it reads the raw table through L1 as
// lattice_bias_wide.cu does. The plan, and so the
// path, comes from lattice_bias.py::fwd_plan. Its output equals
// lattice_bias_wide.cu's and lattice_bias.cu's bit for bit.

#include "bias_fwd_rows.cuh"

namespace {

template <bool WHOLE, int P, int K>
__global__ void __launch_bounds__(bias_fwd_rows::THREADS, 1)
    lattice_bias_wide_prefetch_kernel(const bias_fwd_rows::Args a) {
  bias_fwd_rows::rows<WHOLE ? bias_fwd_rows::RAW : bias_fwd_rows::L1, P, K>(
      a);
}

template <bool WHOLE>
const void* instance(int W) {
  if (W <= 8)
    return (const void*)lattice_bias_wide_prefetch_kernel<WHOLE, 8, 1>;
  if (W <= 16)
    return (const void*)lattice_bias_wide_prefetch_kernel<WHOLE, 8, 2>;
  if (W <= 32)
    return (const void*)lattice_bias_wide_prefetch_kernel<WHOLE, 16, 2>;
  return (const void*)lattice_bias_wide_prefetch_kernel<WHOLE, 32, 2>;
}

// the instance of a path for W query columns, as lattice_bias_wide.cu's
const void* kernel_for(bool whole, int W) {
  return whole ? instance<true>(W) : instance<false>(W);
}

}  // namespace

// On path "whole" (`whole` 1) a block stages its head's padded table at row
// pitch Xs = Wt + 8 (lattice_bias.py::staged_pitch); on "l1" Xs is not
// read.
extern "C" int lattice_bias_wide_prefetch_launch(
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
extern "C" int lattice_bias_wide_prefetch_occupancy(int whole, int W,
                                                    int smem) {
  if (W < 1 || W > 64) return -(int)cudaErrorInvalidValue;
  return bias_fwd_rows::occupancy(kernel_for(whole, W), smem);
}
