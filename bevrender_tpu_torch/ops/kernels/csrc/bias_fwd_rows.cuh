// The lattice rpe bias forward as one row-walking template: the n-major
// bias out[b, g, h, n, iy * W + ix] in bf16 from the bf16 table.
// lattice_bias.cu, lattice_bias_wide.cu and lattice_bias_wide_prefetch.cu
// each instantiate it under their own kernel name; they differ only in
// where the table comes from and in their plans.
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
// - A unit is (key, strip of `rows` output rows), walked by a segment of P
//   lanes, a lane K adjacent query columns (P = 8, 16 or 32, the fewest
//   that hold W columns at K = 2; K = 1 where W <= 8; lattice_bias.py::
//   lanes). A warp task is SEG = 32 / P units side by side: consecutive
//   strips of one key, or, where a key has fewer strips than SEG (the
//   narrow BEV 14 and 7 sites), whole keys, so that no segment idles on a
//   short row. Two columns a lane halve the store instructions of W = 28
//   (4-byte stores), which made lattice_bias_wide.cu 7% faster there and
//   the staged instance 5% slower (more bank conflicts; PERF.md §6). The
//   key's geometry is loaded once a unit, its columns (fraction, crossing,
//   column, comb) once a (unit, lane): shared by every row. Walking its
//   strip, a lane x-lerps each table row once and keeps it in a register as
//   the next output row's upper row; an output is then one y-lerp and a
//   share of one store (bf16 pairs in one 4-byte store where K = 2 and W is
//   even). No integer division in the row loop.
// - A block owns one head and a run of keys ((b, n) pairs); its 32 warps
//   take the run's tasks in turn. The plan (lattice_bias.py::fwd_plan)
//   sizes runs for one block an SM over the launch, one wave, and strips so
//   that the warps finish together.
// - Staged (SRC RAW, where one head's padded table fits a block): the
//   block stages its head's zero-padded table once into shared memory,
//   straight from the raw table by 16-byte cp.async (`stage_raw`), so a
//   launch is one kernel, at a row pitch Xs that holds every column a
//   window reaches, and reads it with no bounds check. 119 x 567 bf16 (135
//   KB) at SCA 56, so one copy serves about 240 keys. Lanes read columns
//   about 5 apart, which spreads them over the shared memory banks.
//   lattice_bias.cu and lattice_bias_wide_prefetch.cu take this path.
// - Otherwise (SRC L1: lattice_bias_wide.cu, and the other two where a
//   head's table overflows a block, and lattice_bias.cu where a block's run
//   of keys is too short to repay staging it) the lane reads the raw table
//   from device memory
//   through L1, with the padding's zeros by bounds checks hoisted out of
//   the loads: a column's once a unit, a row's once a row. A block's one
//   head keeps the SM's L1 on one head's table (124 KB at SCA 56; walking
//   both heads of the group in a block was 7% slower there, PERF.md §6),
//   and the kernel asks for the largest L1.
//
// Each lerp is lattice_common.cuh::lerp_rn with 1 - w hoisted, the same
// rounded operations in the same order, so every instance equals every
// other and the float32 plain version rounded to bf16, bit for bit.
#pragma once

#include "lattice_ring.cuh"

namespace bias_fwd_rows {

constexpr int THREADS = 1024;  // FWD_THREADS in lattice_bias.py
constexpr int WARPS = THREADS / 32;

// Where a block's table comes from
enum Source : int {
  L1 = 0,   // the raw table (G, Hpg, Ht, Wt), read through L1
  RAW = 1,  // staged from the raw table by 16-byte cp.async
};

struct Args {
  const __nv_bfloat16* table;  // the raw table (G, Hpg, Ht, Wt)
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

// Stage one head's raw table `src` (Ht, Wt) into shared memory as the
// zero-padded (Ht + 2 PAD, Xs) table, with the whole block; returns where
// it starts: `dst` plus e < 8 entries. Xs = Wt + 8, and e puts every staged
// row at the 16-byte phase of its raw row in device memory, so a warp
// copies a row's whole 16-byte chunks by 16-byte cp.async and the rest of
// the staged row (its zeros and the fewer than 8 entries before and after
// the chunks: 22 at most) a lane an entry. A warp takes its rows four at a
// time, so that the loads of their rests overlap. The padding is written as
// zeros and no entry twice, so the staging needs no barrier of its own. The
// caller syncs the block.
__device__ __forceinline__ __nv_bfloat16* stage_raw(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int Ht, int Wt,
    int Xs) {
  constexpr int PAD = lattice::PAD;
  const int s = (int)((reinterpret_cast<size_t>(src) >> 1) & 7);
  __nv_bfloat16* t = dst + ((s - PAD * (Xs + 1)) & 7);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  // the PAD rows above the table and the PAD rows below it
  for (int i = threadIdx.x; i < 2 * PAD * Xs; i += THREADS)
    t[i < PAD * Xs ? i : i + Ht * Xs] = zero;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r0 = warp; r0 < Ht; r0 += 4 * WARPS) {
    __nv_bfloat16 v[4];
    int at[4];  // where v goes, -1 for nothing
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = r0 + k * WARPS;
      at[k] = -1;
      if (r >= Ht) continue;
      const __nv_bfloat16* a = src + (size_t)r * Wt;
      const int d = (r + PAD) * Xs;  // the staged row's first entry
      // entries before a 16-byte boundary, then whole 16-byte chunks
      const int h = min(Wt, (8 - ((s + r * Wt) & 7)) & 7);
      const int q = (Wt - h) >> 3;
      for (int i = lane; i < q; i += 32)
        lattice::cp_async16(t + d + PAD + h + 8 * i, a + h + 8 * i);
      // the rest by padded column c: the PAD zeros and the h entries, then
      // the entries after the chunks and the zeros to Xs
      if (lane < Xs - 8 * q) {
        const int c = lane < PAD + h ? lane : lane + 8 * q;
        at[k] = d + c;
        v[k] = c >= PAD && c < PAD + Wt ? a[c - PAD] : zero;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (at[k] >= 0) t[at[k]] = v[k];
  }
  lattice::cp_async_commit();
  lattice::cp_async_wait<0>();
  return t;
}

template <int SRC, int P, int K>
__device__ __forceinline__ void rows(const Args& a) {
  constexpr int SEG = 32 / P;
  constexpr bool STAGED = SRC == RAW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int run = blockIdx.x % a.runs;
  const int head = blockIdx.x / a.runs;  // g * Hpg + h
  const int g = head / a.Hpg;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = lane / P;  // this lane's segment of the warp
  const int sl = lane % P;   // lane in the segment
  const int M = a.H * a.W;

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
  const int units = nk * a.strips;  // (key, strip) pairs of the run
  const int tasks = (units + SEG - 1) / SEG;

  const __nv_bfloat16* t;
  if constexpr (STAGED) {
    t = stage_raw(tab, a.table + (size_t)head * a.Ht * a.Wt, a.Ht, a.Wt,
                  a.Xs);
    __syncthreads();
  } else {
    t = a.table + (size_t)head * a.Ht * a.Wt;
  }
  // A warp task is SEG units, one a segment: consecutive strips of one key
  // where a key has SEG strips or more, else whole keys side by side.
  for (int task = warp; task < tasks; task += WARPS) {
    const int unit = task * SEG + seg;
    if (unit >= units) continue;  // past the run: this segment idles
    const int kl = unit / a.strips;
    const int strip = unit - kl * a.strips;
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
      if constexpr (STAGED) {
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
      if constexpr (STAGED) {
        row = t + r * a.Xs;
      } else {
        r -= lattice::PAD;
        in = (unsigned)r < (unsigned)a.Ht;
        row = t + r * a.Wt;  // read only where in the table
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float t0, t1;
        if constexpr (STAGED) {
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
    // a unit's strip always holds a row; the test is kept in the staged
    // instance of W > 32 only, whose row loop the compiler unrolls by three
    // without it, 4.6% slower at SCA 56, while it slows the other
    // instances (PERF.md §6)
    if (!STAGED || P < 32 || iy0 < iy1) xlerp(y0 + iy0, up);
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

// Shared memory of a block: the head's padded table where staged (up to 7
// entries further in, whole 16-byte chunks), else none.
inline size_t smem_bytes(Source src, int Ht, int Xs) {
  const size_t entries = (size_t)(Ht + 2 * lattice::PAD) * Xs;
  return src == L1 ? 0 : ((entries + 7) * 2 + 15) / 16 * 16;
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

// Launch `kernel` (an instance of `src` for W) with the plan and the raw
// table in `a`. Returns the CUDA error, 0 when it was launched.
inline int launch(const void* kernel, Source src, Args a, void* stream) {
  const size_t smem = smem_bytes(src, a.Ht, a.Xs);
  const int rc = src == L1 ? prefer_l1(kernel)  // all shared memory to L1
                           : lattice::set_smem(kernel, smem);
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
