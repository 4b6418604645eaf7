// The row-folded fused site, the counterpart of the JAX package's site
// with the Hpg heads of a (b, g) cell folded into each query row:
//   out[b, g, h, m, :] = sum_n softmax_n(bias[h, n, m] + scale q[h, m] . k[h, n]) v[h, n]
// for every head h of the cell, as an instance of the whole-table template
// (site_whole.cuh) with the heads' padded tables staged in shared memory.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/experimental.py
// ::fused_site_call_sh2 / _site_kernel_sh2, the row-folded shift-replica
// site: one kernel instance per (b, g) cell for all Hpg heads, its scores in
// one (keys, H x 64 lanes) tile whose column iy * 64 + h * W + x folds the
// heads into each query row, and QK and AV as one block-diagonal product.
// That lane layout is how a TPU fills its 128 lanes from rows of W <= 64
// and is not carried over: a CUDA thread owns one (head, query) whatever W
// is. What the fold keeps is its contract: a site folds where Hpg x W <= 128
// and every head's padded table fits one block (ops/kernels/
// fused_site_fold.py::rows_fit, the JAX package's shape rule).
//
// A block owns HB = ROWS_HEADS heads of a cell and a strip of S queries,
// one thread per (head, query) (site_whole.cuh). One head a block
// (ROWS_HEADS = 1), as fused_site_wide_prefetch.cu's whole path: at the
// flagship's SCA its 57 KB let four 160-thread blocks share an SM, where
// both heads a block (113 KB, fused_site_fold_heads.cu's fold) let two
// 224-thread blocks, and the fold read 0.8758 ms at SCA B*V=12 G=4 ch 8
// against 0.7550 for one head a block (PERF.md §6). The
// kernel this replaced carried both heads' states in one thread and
// staged every key tile synchronously in float32 (1.4188 ms there).
//
// Per (head, query) the tiles, their order and every rounding are
// fused_site.cu's, so the output equals fused_site.cu's bit for bit.
//
// Bound: operations per (query, key) pair, as fused_site.cu. The strip S
// comes from the wrapper (fused_site_fold.py::rows_plan, wave_strip),
// which fills whole waves of the card.
//
// Head widths 4 and 8; the wrapper takes Hpg 1 and 2 (every supported
// model has two).

#include "site_whole.cuh"

namespace {

// heads a block, threads of a block at most and the blocks an SM the
// compiler is asked to fit (fused_site_fold.py::ROWS_HEADS, ROWS_THREADS,
// ROWS_MIN_BLOCKS)
constexpr int ROWS_HEADS = 1;
constexpr int THREADS = 160;
constexpr int MIN_BLOCKS = 4;

template <int CH>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fused_site_fold_rows_kernel(SITE_WHOLE_PARAMS) {
  site_whole::site_block<CH, ROWS_HEADS, site_whole::WHOLE>(SITE_WHOLE_ARGS);
}

}  // namespace

// S queries a head (ROWS_HEADS x S threads, a multiple of 32, at most
// THREADS), Xp the row pitch of the padded tables; k and v on a 2 ch-byte
// boundary.
extern "C" int fused_site_fold_rows_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* q,
    const void* k, const void* v, void* out, int B, int G, int Hpg, int Ht,
    int Wt, int Xp, int N, int H, int W, int S, int ch, float scale,
    void* stream) {
  const site_whole::Args a{table, ys, ms, wy, fx, u0, gcomb, q, k, v, out,
                           nullptr, G, Hpg, Ht, Wt, Xp, N, H, W, S, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  using site_whole::launch_kernel;
  using site_whole::WHOLE;
  if (ch == 4)
    return launch_kernel<4, ROWS_HEADS, WHOLE>(fused_site_fold_rows_kernel<4>,
                                               THREADS, a, B, s);
  if (ch == 8)
    return launch_kernel<8, ROWS_HEADS, WHOLE>(fused_site_fold_rows_kernel<8>,
                                               THREADS, a, B, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of `threads` threads with `smem` bytes of dynamic shared memory that
// one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for
// the instance of head width ch; a negative CUDA error code where the query
// fails.
extern "C" int fused_site_fold_rows_occupancy(int ch, int threads, int smem) {
  if (ch != 4 && ch != 8) return -(int)cudaErrorInvalidValue;
  return site_whole::occupancy(
      ch == 4 ? (const void*)fused_site_fold_rows_kernel<4>
              : (const void*)fused_site_fold_rows_kernel<8>,
      threads, smem);
}
