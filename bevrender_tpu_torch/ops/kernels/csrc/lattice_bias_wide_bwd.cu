// Backward of the lattice rpe bias at a wide site: from the cotangent of the
// n-major bias gout[b, g, h, n, m] (bf16) to the gradient of the raw table
// (float32) and the cotangents of the per-key fractions, dwy[b, g, n] and
// df[b, g, n], for a table whose forward does not fit lattice_bias.cu's
// shared memory (ops.deform_attn.bias_route).
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/lattice_bias.py
// ::_bwd_call / _bwd_kernel (with `_bias_cotangent_tail`), the VJP of the
// resolve-staged forward that the pyramid's 56 x 56 sites take. That kernel
// scatters into the gradient of the staged table, rounds it to bf16 and
// leaves the un-staging to XLA; this one writes the float32 gradient of the
// raw table directly.
//
// The kernel is an instance of the row-owned, atomic-free template of
// bias_bwd_rows.cuh, as is lattice_bias_bwd.cu: see there for what bounds
// it and how its design answers that. At the pyramid's SCA 56 (one head's
// padded table 119 x 565 at the template's pitch) the plan
// (lattice_bias_bwd.py::plan) takes eight bands of 15 rows, 52 KB a block,
// four blocks an SM.

#include "bias_bwd_rows.cuh"

namespace {

template <int P, int K>
__global__ void __launch_bounds__(bias_bwd_rows::THREADS,
                                  bias_bwd_rows::MIN_BLOCKS)
    lattice_bias_wide_bwd_kernel(const bias_bwd_rows::Args a) {
  bias_bwd_rows::rows<P, K>(a);
}

// the instance for W query columns: segments of 8, 16 or 32 lanes, one
// column a lane, or two where W > 32
const void* kernel_for(int W) {
  if (W <= 8) return (const void*)lattice_bias_wide_bwd_kernel<8, 1>;
  if (W <= 16) return (const void*)lattice_bias_wide_bwd_kernel<16, 1>;
  if (W <= 32) return (const void*)lattice_bias_wide_bwd_kernel<32, 1>;
  return (const void*)lattice_bias_wide_bwd_kernel<32, 2>;
}

}  // namespace

extern "C" int lattice_bias_wide_bwd_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* gout,
    void* part_t, void* part_k, void* dtable, void* dwy, void* df, int B,
    int G, int Hpg, int Ht, int Wt, int Xa, int N, int H, int W, int R,
    int bands, int runs, int kpr, void* stream) {
  if (W < 1 || W > 64) return (int)cudaErrorInvalidValue;
  const bias_bwd_rows::Args a{
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)gout, (float*)part_t,
      (float*)part_k, (float*)dtable, (float*)dwy, (float*)df, B, G, Hpg, Ht,
      Wt, Xa, N, H, W, R, bands, runs, kpr};
  return bias_bwd_rows::launch(kernel_for(W), a, stream);
}

// Blocks one SM holds of the instance for W at `smem` bytes of shared memory.
extern "C" int lattice_bias_wide_bwd_occupancy(int W, int smem) {
  if (W < 1 || W > 64) return -(int)cudaErrorInvalidValue;
  return bias_bwd_rows::occupancy(kernel_for(W), smem);
}
