// The lattice rpe bias forward as one row-walking template: the n-major
// bias out[b, g, h, n, iy * W + ix] in bf16 from the bf16 table.
// lattice_bias_wide.cu and lattice_bias_wide_prefetch.cu each instantiate
// it under their own kernel name; they differ only in where the table comes
// from.
//
// Per (key, query, head) the bias is two x-lerps and one y-lerp over a
// 2 x 2 window of the zero-padded table: rows ys + iy (weight 1 - wy) and
// ys + iy + 1 (weight wy), columns c and c + 1 with c = ms + u0[ix] (+1
// where the column fraction crossed into the next cell) and weight wx =
// frac(g[ix] + f) (lattice_common.cuh::column). The x-lerp of table row r
// at column ix is the lower row of output row r - ys - 1 and the upper row
// of output row r - ys. So, as the TPU kernel's `xres` and the plain
// version's `lattice_mix` have it, a (key, head) needs H + 1 x-lerped rows
// for its H output rows, not 2 H.
//
// Bound: bytes, the output above all (B G Hpg N H W bf16: 197 MB at the
// pyramid's SCA 56, 0.059 ms at 3.35 TB/s). What stands between a kernel
// and that bound is instructions an output, table reads, and copies of
// table windows, which serve one key each and so move several times the
// output's bytes from L2 (PERF.md §6). So:
//
// - A warp task is (key, strip group): the warp's SEG = 32 / P segments of
//   P lanes each walk one strip of `rows` output rows of the key, a lane K
//   adjacent query columns (P = 8, 16 or 32, the fewest that hold W columns
//   at K = 2; K = 1 where W <= 8; lattice_bias.py::lanes). Two columns a
//   lane halve the store instructions of W = 28 (4-byte stores), which
//   made lattice_bias_wide.cu 7% faster there and the staged instance 5%
//   slower (more bank conflicts; PERF.md §6). The key's geometry is loaded
//   once a task, its columns
//   (fraction, crossing, column, comb) once a (task, lane): shared by every
//   row. Walking its strip, a lane x-lerps each table row once and keeps it
//   in a register as the next output row's upper row; an output is then one
//   y-lerp and a share of one store (bf16 pairs in one 4-byte store where K
//   = 2 and W is even). No integer division in the row loop.
// - A block owns one head and a run of keys ((b, n) pairs); its 32 warps
//   take the run's tasks in turn. The plan (lattice_bias.py::fwd_plan)
//   sizes runs for one block an SM over the launch, one wave, and strips so
//   that the warps finish together.
// - WHOLE (lattice_bias_wide_prefetch.cu, where one head's padded table
//   fits a block): the block stages its head's zero-padded table once into
//   shared memory by 16-byte cp.async, from the pitched copy the launch
//   makes first (lattice_ring.cuh::pitch_table), at a row pitch Xs that
//   holds every column a window reaches, and reads it with no bounds check.
//   119 x 568 bf16 (135 KB) at SCA 56, so one copy from L2 serves about 240
//   keys. Lanes read columns about 5 apart, which spreads them over the
//   shared memory banks.
// - Otherwise (lattice_bias_wide.cu, and the prefetch kernel where a head's
//   table overflows a block) the lane reads the raw table from device
//   memory through L1, with the padding's zeros by bounds checks hoisted out
//   of the loads: a column's once a task, a row's once a row. A block's one
//   head keeps the SM's L1 on one head's table (124 KB at SCA 56; walking
//   both heads of the group in a block was 7% slower there, PERF.md §6), and
//   the kernel asks for the largest L1.
//
// Each lerp is lattice_common.cuh::lerp_rn with 1 - w hoisted, the same
// rounded operations in the same order, so both instances equal each other,
// lattice_bias.cu and the float32 plain version rounded to bf16, bit for bit.
#pragma once

#include "lattice_ring.cuh"

namespace bias_fwd_rows {

constexpr int THREADS = 1024;  // FWD_THREADS in lattice_bias.py
constexpr int WARPS = THREADS / 32;

struct Args {
  // WHOLE: the pitched zero-padded copy (G Hpg, Ht + 2 PAD, Xs); else the
  // raw table (G, Hpg, Ht, Wt)
  const __nv_bfloat16* table;
  const int* ys;  // (B, G, N) clipped window starts in the padded table
  const int* ms;
  const float* wy;  // (B, G, N) fractions
  const float* fx;
  const int* u0;       // (W,)
  const float* gcomb;  // (W,)
  __nv_bfloat16* out;  // (B, G, Hpg, N, H * W)
  int B, G, Hpg, Ht, Wt, Xs, N, H, W;
  int runs, keys;    // key runs of `keys` (b, n) keys (the last may hold fewer)
  int strips, rows;  // row strips a key of `rows` output rows (the last fewer)
};

// bf16 in the high half of a float
__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <bool WHOLE, int P, int K>
__device__ __forceinline__ void rows(const Args& a) {
  constexpr int SEG = 32 / P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int run = blockIdx.x % a.runs;
  const int head = blockIdx.x / a.runs;  // g * Hpg + h
  const int g = head / a.Hpg;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = lane / P;  // this lane's strip among the warp's SEG
  const int sl = lane % P;   // lane in the segment
  const int M = a.H * a.W;
  const int Yp = a.Ht + 2 * lattice::PAD;

  // the lane's query columns, adjacent
  int cx[K];
  int cu[K];
  float cg[K];
  bool live[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    cx[j] = sl * K + j;
    live[j] = cx[j] < a.W;
    cu[j] = live[j] ? a.u0[cx[j]] : 0;
    cg[j] = live[j] ? a.gcomb[cx[j]] : 0.0f;
  }
  const bool packed = K == 2 && (a.W & 1) == 0;  // 4-byte aligned pairs
  const int k_begin = run * a.keys;
  const int nk = min(a.B * a.N - k_begin, a.keys);
  const int groups = (a.strips + SEG - 1) / SEG;  // a warp task's strips
  const int tasks = nk * groups;

  const __nv_bfloat16* t;
  if constexpr (WHOLE) {
    // the head's padded table, Yp x Xs (Xs a multiple of 8), in 16-byte
    // chunks
    const __nv_bfloat16* src = a.table + (size_t)head * Yp * a.Xs;
    const int chunks = Yp * a.Xs / 8;
    for (int i = threadIdx.x; i < chunks; i += THREADS)
      lattice::cp_async16(tab + 8 * i, src + 8 * i);
    lattice::cp_async_commit();
    lattice::cp_async_wait<0>();
    __syncthreads();
    t = tab;
  } else {
    t = a.table + (size_t)head * a.Ht * a.Wt;
  }
  for (int task = warp; task < tasks; task += WARPS) {
    const int kl = task / groups;
    const int strip = (task - kl * groups) * SEG + seg;
    const int iy0 = strip * a.rows;
    const int iy1 = min(a.H, iy0 + a.rows);
    const int k = k_begin + kl;  // b N + n
    const int b = k / a.N;
    const int n = k - b * a.N;
    const size_t key = ((size_t)b * a.G + g) * a.N + n;
    const int y0 = __ldg(a.ys + key);
    const int x0 = __ldg(a.ms + key);
    const float w_y = __ldg(a.wy + key);
    const float u_y = __fsub_rn(1.0f, w_y);
    const float f = __ldg(a.fx + key);
    // per column: the weights, the column in the padded table and, for
    // the raw table, whether c and c + 1 lie in it
    float wx[K], ux[K];
    int c[K];
    bool in0[K], in1[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const lattice::Column col = lattice::column(cg[j], f);
      wx[j] = col.wx;
      ux[j] = __fsub_rn(1.0f, col.wx);
      c[j] = x0 + cu[j] + col.cross;
      if constexpr (WHOLE) {
        in0[j] = in1[j] = true;
      } else {
        c[j] -= lattice::PAD;  // a column of the raw table
        in0[j] = live[j] && (unsigned)c[j] < (unsigned)a.Wt;
        in1[j] = live[j] && (unsigned)(c[j] + 1) < (unsigned)a.Wt;
      }
    }
    // the x-lerps of table row r (padded) at the lane's columns
    auto xlerp = [&](int r, float (&x)[K]) {
      const __nv_bfloat16* row;
      bool in = true;
      if constexpr (WHOLE) {
        row = t + r * a.Xs;
      } else {
        r -= lattice::PAD;
        in = (unsigned)r < (unsigned)a.Ht;
        row = t + r * a.Wt;  // read only where in the table
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float t0, t1;
        if constexpr (WHOLE) {
          t0 = bf(row[c[j]]);
          t1 = bf(row[c[j] + 1]);
        } else {
          t0 = in && in0[j] ? bf(__ldg(row + c[j])) : 0.0f;
          t1 = in && in1[j] ? bf(__ldg(row + c[j] + 1)) : 0.0f;
        }
        x[j] = __fadd_rn(__fmul_rn(ux[j], t0), __fmul_rn(wx[j], t1));
      }
    };
    __nv_bfloat16* dst =
        a.out + (((size_t)b * a.G * a.Hpg + head) * a.N + n) * M + iy0 * a.W;
    float up[K];
    if (iy0 < iy1) xlerp(y0 + iy0, up);
    for (int iy = iy0; iy < iy1; ++iy, dst += a.W) {
      float lo[K], v[K];
      xlerp(y0 + iy + 1, lo);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        v[j] = __fadd_rn(__fmul_rn(u_y, up[j]), __fmul_rn(w_y, lo[j]));
        up[j] = lo[j];
      }
      if (packed) {
        if (live[0])
          *reinterpret_cast<unsigned*>(dst + cx[0]) =
              lattice::pack2(v[0], v[K - 1]);
      } else {
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (live[j]) dst[cx[j]] = __float2bfloat16_rn(v[j]);
      }
    }
  }
}

// Shared memory of a block: the head's padded table where WHOLE, else none.
inline size_t smem_bytes(bool whole, int Ht, int Xs) {
  return whole ? (size_t)(Ht + 2 * lattice::PAD) * Xs * sizeof(__nv_bfloat16)
               : 0;
}

// Give `kernel` all of the SM's shared memory as L1, once an instance: the
// attribute call is host time, and the paths that launch these kernels are
// host-bound. A race between two threads only repeats the call.
inline int prefer_l1(const void* kernel) {
  static const void* done[16] = {};
  int i = 0;
  for (; i < 16 && done[i]; ++i)
    if (done[i] == kernel) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxL1);
  if (e != cudaSuccess) return (int)e;
  if (i < 16) done[i] = kernel;
  return 0;
}

// Launch `kernel` (an instance for W) with the plan in `a`; where `pitched`
// is not null (WHOLE), first copy the raw table `raw` into it as the
// pitched zero-padded table the kernel stages from. Returns the first CUDA
// error, 0 when everything was launched.
inline int launch(const void* kernel, bool whole, Args a, const void* raw,
                  void* pitched, void* stream) {
  const size_t smem = smem_bytes(whole, a.Ht, a.Xs);
  int rc;
  if (whole) {
    rc = lattice::pitch_table(pitched, raw, a.G * a.Hpg, a.Ht, a.Wt, a.Xs,
                              (cudaStream_t)stream);
    if (rc) return rc;
    a.table = (const __nv_bfloat16*)pitched;
    rc = lattice::set_smem(kernel, smem);
  } else {
    a.table = (const __nv_bfloat16*)raw;
    rc = prefer_l1(kernel);  // no shared memory: all of it to L1
  }
  if (rc) return rc;
  void* args[] = {&a};
  const unsigned blocks = (unsigned)(a.G * a.Hpg) * a.runs;
  cudaError_t e = cudaLaunchKernel(kernel, dim3(blocks), dim3(THREADS), args,
                                   smem, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Blocks of `kernel` one SM holds at `smem` bytes of shared memory (a
// negative CUDA error code where the query fails).
inline int occupancy(const void* kernel, int smem) {
  int rc = lattice::set_smem(kernel, smem);
  if (rc) return -rc;
  int n = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace bias_fwd_rows
