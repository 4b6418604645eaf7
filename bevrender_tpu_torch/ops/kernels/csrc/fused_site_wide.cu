// Fused lattice attention site for narrow heads (ch 4 or 8) on a table of
// any size: fused_site.cu as an instance of the whole-table template
// (site_whole.cuh), one head a block.
//   out[b, g, h, m, :] = sum_n softmax_n(bias[n, m] + scale * q[m] . k[n]) v[n]
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/fused_attn.py
// ::_fused_site_pallas_call (_site_kernel, _site_fwd_body; public
// fused_site_call), the fused site on the plain ("resolve") staging, which
// the JAX package takes where the shift-replicated table block is too
// large or shift replication is switched off. That staging (a table
// rearranged per key shift class, 64-key padding, packed starts) is how a
// TPU kernel gets windows out of VMEM and is not carried over. With a
// non-null `lse` it is the instance of fused_attn.py::fused_site_call_lse
// (_site_kernel_lse), the forward of the fused training site.
//
// Two table sources, chosen by the wrapper (ops/kernels/fused_site_wide.py
// ::wide_plan) from the shapes alone:
//
// - "whole" (site_whole::WHOLE): the block stages its head's zero-padded
//   table once, so a pair's bias is four reads of shared memory. Every
//   site of the supported models takes it (63 x 429 x 2 B + 3 KB = 57 KB a
//   block at the flagship's SCA, four blocks an SM).
// - "raw" (site_whole::RAW): each thread reads a pair's four entries from
//   the raw bf16 table in device memory through L1, with bounds checks in
//   place of the zero padding (lattice_common.cuh::bias_at_raw), where one
//   head's padded table overflows a block; shared memory holds only the
//   key stages, so a table of any size launches, as this kernel's contract
//   has it (ops/deform_attn.py::site_route sends a narrow-head table over
//   ~224 KB here).
//
// On both, K, V and the key geometry are double-buffered by cp.async with
// one __syncthreads a tile, and a thread's tiles, their order and the
// online softmax are fused_site.cu's (site_common.cuh), so the output and
// the logsumexp equal fused_site.cu's bit for bit.
//
// Bound: operations per (query, key) pair (the bias, an exp2, 2 ch
// multiply-adds). Before this layout each block staged every key tile
// synchronously in float32 between two barriers and read every bias from
// the raw table (1.2279 ms at SCA B*V=12 G=4 ch 8 against 0.7550 for the
// template's whole path, PERF.md §6). The strip S comes from the wrapper
// (fused_site_fold.wave_strip), which fills whole waves of the card.
//
// Head widths: 4 and 8, as fused_site.cu.

#include "site_whole.cuh"

namespace {

// threads of a block at most, and the blocks an SM the compiler is asked to
// fit (fused_site_wide.py::WIDE_THREADS, WIDE_MIN_BLOCKS)
constexpr int THREADS = 160;
constexpr int MIN_BLOCKS = 4;

template <int CH, int SRC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fused_site_wide_kernel(SITE_WHOLE_PARAMS) {
  site_whole::site_block<CH, 1, SRC>(SITE_WHOLE_ARGS);
}

// The kernel of one table source and head width, or null where there is
// none.
site_whole::Kernel kernel_of(int raw, int ch) {
#define KERNEL_CASE(C)                                      \
  if (ch == C)                                              \
    return raw ? fused_site_wide_kernel<C, site_whole::RAW> \
               : fused_site_wide_kernel<C, site_whole::WHOLE>;
  KERNEL_CASE(4)
  KERNEL_CASE(8)
#undef KERNEL_CASE
  return nullptr;
}

int dispatch(const void* table, const void* ys, const void* ms,
             const void* wy, const void* fx, const void* u0,
             const void* gcomb, const void* q, const void* k, const void* v,
             void* out, void* lse, int B, int G, int Hpg, int Ht, int Wt,
             int Xp, int N, int H, int W, int S, int raw, int ch, float scale,
             void* stream) {
  const site_whole::Kernel kernel = kernel_of(raw, ch);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const site_whole::Args a{table, ys, ms, wy, fx, u0, gcomb, q, k, v, out,
                           lse, G, Hpg, Ht, Wt, Xp, N, H, W, S, scale};
  using site_whole::launch_kernel;
  using site_whole::RAW;
  using site_whole::WHOLE;
  auto* fn = ch == 4 ? (raw ? launch_kernel<4, 1, RAW>
                            : launch_kernel<4, 1, WHOLE>)
                     : (raw ? launch_kernel<8, 1, RAW>
                            : launch_kernel<8, 1, WHOLE>);
  return fn(kernel, THREADS, a, B, (cudaStream_t)stream);
}

}  // namespace

// S queries a block (a multiple of 32, at most THREADS); `raw` non-zero
// reads the raw table (Xp is then not read), zero stages the head's padded
// table at row pitch Xp; k and v on a 2 ch-byte boundary.
extern "C" int fused_site_wide_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* q,
    const void* k, const void* v, void* out, int B, int G, int Hpg, int Ht,
    int Wt, int Xp, int N, int H, int W, int S, int raw, int ch, float scale,
    void* stream) {
  return dispatch(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, nullptr, B,
                  G, Hpg, Ht, Wt, Xp, N, H, W, S, raw, ch, scale, stream);
}

// The instance that also writes the logsumexp, `lse` (B, G, Hpg, M) float32.
extern "C" int fused_site_wide_lse_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* q,
    const void* k, const void* v, void* out, void* lse, int B, int G, int Hpg,
    int Ht, int Wt, int Xp, int N, int H, int W, int S, int raw, int ch,
    float scale, void* stream) {
  return dispatch(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, lse, B, G,
                  Hpg, Ht, Wt, Xp, N, H, W, S, raw, ch, scale, stream);
}

// Blocks of `threads` threads with `smem` bytes of dynamic shared memory that
// one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for
// the kernel of the table source (`raw` non-zero: "raw") and head width ch.
// A negative CUDA error code where the query fails.
extern "C" int fused_site_wide_occupancy(int raw, int ch, int threads,
                                         int smem) {
  const site_whole::Kernel f = kernel_of(raw, ch);
  if (f == nullptr) return -(int)cudaErrorInvalidValue;
  return site_whole::occupancy((const void*)f, threads, smem);
}
