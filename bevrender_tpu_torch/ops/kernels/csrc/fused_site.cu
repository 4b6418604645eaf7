// Fused lattice attention site for narrow heads (ch 4 or 8):
//   out[b, g, h, m, :] = sum_n softmax_n(bias[n, m] + scale * q[m] . k[n]) v[n]
// with the rpe bias built in registers, an online softmax over key tiles,
// and neither bias nor scores written to device memory, as an instance of
// the whole-table template (site_whole.cuh) on its staged table, one head a
// block.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/fused_attn.py
// ::fused_site_call_sh / _site_kernel_sh. The TPU staging (shift replicas,
// 8-row alignment, g-major grid order, 64-key padding, packed starts) is not
// carried over. It keeps the Pallas kernel's roundings: q . k from bf16
// inputs with float32 sums, the bias lerped in float32 from the bf16 table,
// and p = exp(s - running max) rounded to bf16 before it multiplies V.
//
// With a non-null `lse` the kernel also writes the softmax's logsumexp per
// (head, query) in natural-log units, the residual of the training backward
// (fused_site_bwd.cu). That instance replaces fused_attn.py
// ::fused_site_call_lse / _site_kernel_lse; its output equals the plain
// instance's bit for bit.
//
// A block owns one (b, g, h) and a strip of S queries, one thread a query,
// with the head's zero-padded table staged once in shared memory and each
// key tile (K and V in bf16, the key geometry) double-buffered by cp.async
// with one __syncthreads a tile (site_whole.cuh). At the
// flagship's SCA a block takes 63 x 429 x 2 B of table and 3 KB of key
// stages, so four 160-thread blocks share an SM; the strip S comes from
// the wrapper (ops/kernels/fused_site.py::site_plan, fused_site_fold
// .wave_strip), which fills whole waves of the card. The kernel this
// replaced staged every key tile synchronously in float32 between two
// barriers, in 128-thread blocks of 107 registers (0.8714 ms at SCA B*V=12
// G=4 ch 8 against 0.7420 for this instance, PERF.md §6). Its arithmetic a
// (query, key) pair is unchanged, so the output equals every other instance
// of the template (fused_site_wide.cu, fused_site_fold_rows.cu) bit for
// bit.
//
// Bound: operations per (query, key) pair, not bytes: the bias (three lerps
// from four shared-memory reads), the exp and 2 * ch multiply-adds for QK
// and AV.
//
// Head widths: 4 and 8, the two the supported models give it.

#include "site_whole.cuh"

namespace {

// threads of a block at most and the blocks an SM the compiler is asked to
// fit (fused_site.py::SITE_THREADS, SITE_MIN_BLOCKS)
constexpr int THREADS = 160;
constexpr int MIN_BLOCKS = 4;

template <int CH>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fused_site_kernel(SITE_WHOLE_PARAMS) {
  site_whole::site_block<CH, 1, site_whole::WHOLE>(SITE_WHOLE_ARGS);
}

int dispatch(const void* table, const void* ys, const void* ms,
             const void* wy, const void* fx, const void* u0,
             const void* gcomb, const void* q, const void* k, const void* v,
             void* out, void* lse, int B, int G, int Hpg, int Ht, int Wt,
             int Xp, int N, int H, int W, int S, int ch, float scale,
             void* stream) {
  const site_whole::Args a{table, ys, ms, wy, fx, u0, gcomb, q, k, v, out,
                           lse, G, Hpg, Ht, Wt, Xp, N, H, W, S, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  using site_whole::launch_kernel;
  using site_whole::WHOLE;
  if (ch == 4)
    return launch_kernel<4, 1, WHOLE>(fused_site_kernel<4>, THREADS, a, B, s);
  if (ch == 8)
    return launch_kernel<8, 1, WHOLE>(fused_site_kernel<8>, THREADS, a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// S queries a block (a multiple of 32, at most THREADS), Xp the row pitch
// of the head's staged padded table; k and v on a 2 ch-byte boundary.
extern "C" int fused_site_launch(const void* table, const void* ys,
                                 const void* ms, const void* wy,
                                 const void* fx, const void* u0,
                                 const void* gcomb, const void* q,
                                 const void* k, const void* v, void* out,
                                 int B, int G, int Hpg, int Ht, int Wt,
                                 int Xp, int N, int H, int W, int S, int ch,
                                 float scale, void* stream) {
  return dispatch(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, nullptr, B,
                  G, Hpg, Ht, Wt, Xp, N, H, W, S, ch, scale, stream);
}

// The instance that also writes the logsumexp, `lse` (B, G, Hpg, M) float32.
extern "C" int fused_site_lse_launch(const void* table, const void* ys,
                                     const void* ms, const void* wy,
                                     const void* fx, const void* u0,
                                     const void* gcomb, const void* q,
                                     const void* k, const void* v, void* out,
                                     void* lse, int B, int G, int Hpg, int Ht,
                                     int Wt, int Xp, int N, int H, int W,
                                     int S, int ch, float scale,
                                     void* stream) {
  return dispatch(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, lse, B, G,
                  Hpg, Ht, Wt, Xp, N, H, W, S, ch, scale, stream);
}

// Blocks of `threads` threads with `smem` bytes of dynamic shared memory that
// one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for
// the instance of head width ch; a negative CUDA error code where the query
// fails.
extern "C" int fused_site_occupancy(int ch, int threads, int smem) {
  if (ch != 4 && ch != 8) return -(int)cudaErrorInvalidValue;
  return site_whole::occupancy(ch == 4 ? (const void*)fused_site_kernel<4>
                                       : (const void*)fused_site_kernel<8>,
                               threads, smem);
}
