// Per-key window extraction from the column-rearranged rpe table, and its
// backward: the windowed lattice bias (ops/deform_attn.py::
// lattice_bias_windowed, ModelConfig.bias_forward="windows").
//
//   out[b, g, n, m, y, :] = t3[g, ys[b, g, n] + y, ms[b, g, n] + m, :]
//
// for m < 3 and y < h1 (= H + 1), with t3 (G, Y, m_max, WH) bf16 the
// zero-padded table with its columns rearranged per query column
// (ops/deform_attn.py::lattice_t3) and ys, ms (B, G, N) int32 the clipped
// window starts of each key (lattice_geometry): every read lands inside t3,
// so the kernels check no bounds. The backward adds each window's
// cotangent back: dt3[g, ys + y, ms + m, :] += gout[b, g, n, m, y, :] over
// all keys, in float32, then casts to bf16 where asked.
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
// The backward gathers instead of scattering: every row (g, y, m) of dt3 is
// owned by L lanes of one warp (L the power of two that covers its WH / VEC
// vectors, at most 32), which add up in registers the cotangent rows that
// land on it and write it once, in float32 or bf16. A scatter pays one L2
// operation per 4-byte add (float atomics, or plain stores, into a float32
// buffer: ~85 G a second on an H100 either way) and sums in another order
// every run. The rows that land on (g, y, m) are those of the keys with ms
// = m - mm (mm = 0, 1, 2) and ys in [y - h1 + 1, y], row mm * h1 + y - ys
// of each; so the keys are first bucketed by start: a stable counting sort
// by (g, ms, ys), each key placed at its bin's start (an exclusive scan of
// a histogram) plus its rank among the earlier keys of its bin. Then a
// row's keys for one mm are one contiguous range of the sorted keys, and
// the row adds them mm by mm in sorted order, one add at a time from 0.0:
// the same order, and the same bits, on every run (ops/kernels/
// lattice_windows.py::lattice_windows_bwd_ordered repeats it in PyTorch).
// No float atomic is left; the bucketing counts with integer shared-memory
// atomics, which are native on sm_90a. Each cotangent row is read once, as
// a run of WH * 2 bytes; dt3 is written once and nothing is zeroed first.
// A group of at most SMALL_KEYS keys (the flagship's smallest TSA sites)
// skips the bucketing launch: each block of its gather sorts the group's
// keys in shared memory, in the same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

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

// ---- backward: bucketing ------------------------------------------------

constexpr int BUCKET_THREADS = 1024;
constexpr int BUCKET_WARPS = BUCKET_THREADS / 32;
// a bucketing block's count table holds, per bin it owns, one counter per
// warp at stride WARP_STRIDE: bins one apart fall in other banks
constexpr int WARP_STRIDE = BUCKET_WARPS + 1;
// dynamic shared memory of a bucketing block: with its static arrays, under
// the 48 KB a block may take without opting in
constexpr size_t BUCKET_TABLE_BYTES = 45 * 1024;
// runs of 32 keys whose starts a lane loads together
constexpr int RUNS = 4;

// the i-th key of group g in key order: b-major, then n
__device__ __forceinline__ int key_of(int i, int g, int G, int N) {
  const int b = i / N;
  return (b * G + g) * N + (i - b * N);
}

// Block (j, g) sorts the keys of group g whose ms lies in [j * msb, (j + 1)
// * msb) into their bins (ms, ys), stably, and writes where each of its
// bins starts. Warp w owns the keys [w * chunk, (w + 1) * chunk) of the
// group; table[bin * WARP_STRIDE + w] first counts its keys in each bin,
// then, scanned in (bin, warp) order, holds where they go. So warp w
// places its keys with no other warp's help: in key order, 32 at a time,
// each after the keys of its bin in the earlier lanes (__match_any_sync).
// sorted[p] = key * 3 * h1 - ys: the index of the key's cotangent row for
// mm = 0, y = 0, less ys, so that a row (mm, y) adds mm * h1 + y.
__global__ void __launch_bounds__(BUCKET_THREADS) windows_bwd_bucket_kernel(
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    int* __restrict__ sorted,   // (B * G * N,): group-major, then by bin
    int* __restrict__ offsets,  // (G * nm * ny + 1,): start of each bin
    int B, int G, int N, int ny, int nm, int h1, int msb) {
  extern __shared__ int table[];
  __shared__ int warp_sums[BUCKET_WARPS];
  __shared__ int warp_below[BUCKET_WARPS];
  const int g = blockIdx.y;
  const int lo = blockIdx.x * msb;
  const int hi = min(nm, lo + msb);
  const int nb = (hi - lo) * ny;  // bins of this block
  const int per = B * N;          // keys of a group
  const int chunk = (per + BUCKET_WARPS - 1) / BUCKET_WARPS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = min(per, warp * chunk);
  const int k1 = min(per, k0 + chunk);
  for (int i = threadIdx.x; i < nb * WARP_STRIDE; i += BUCKET_THREADS)
    table[i] = 0;
  // (ms, ys) of the keys i0 + 32 r + lane, r < RUNS; ms -1 past the chunk
  auto load = [&](int i0, int* mv, int* yv) {
#pragma unroll
    for (int r = 0; r < RUNS; ++r) {
      const int i = i0 + 32 * r + lane;
      const int key = key_of(min(i, k1 - 1), g, G, N);
      mv[r] = i < k1 ? ms[key] : -1;
      yv[r] = i < k1 ? ys[key] : 0;
    }
  };
  __syncthreads();

  // histogram per warp, and the keys of the group before this block's bins
  int below = 0;
  for (int i0 = k0; i0 < k1; i0 += 32 * RUNS) {
    int mv[RUNS], yv[RUNS];
    load(i0, mv, yv);
#pragma unroll
    for (int r = 0; r < RUNS; ++r) {
      if (mv[r] < 0) continue;
      if (mv[r] < lo)
        ++below;
      else if (mv[r] < hi)
        atomicAdd(&table[((mv[r] - lo) * ny + yv[r]) * WARP_STRIDE + warp], 1);
    }
  }
  below = __reduce_add_sync(0xffffffffu, below);
  if (lane == 0) warp_below[warp] = below;
  __syncthreads();

  // exclusive scan of the counts in (bin, warp) order: each thread a run
  const int total = nb * BUCKET_WARPS;
  const int run = (total + BUCKET_THREADS - 1) / BUCKET_THREADS;
  const int t0 = min(total, threadIdx.x * run);
  const int t1 = min(total, t0 + run);
  int sum = 0;
  for (int t = t0; t < t1; ++t)
    sum += table[(t / BUCKET_WARPS) * WARP_STRIDE + t % BUCKET_WARPS];
  int incl = sum;  // inclusive scan of the runs' sums within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, base = g * per;
  for (int w = 0; w < BUCKET_WARPS; ++w) {
    if (w < warp) before += warp_sums[w];
    base += warp_below[w];
  }
  int at = before + incl - sum;
  for (int t = t0; t < t1; ++t) {
    int* c = &table[(t / BUCKET_WARPS) * WARP_STRIDE + t % BUCKET_WARPS];
    const int n = *c;
    *c = at;
    at += n;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += BUCKET_THREADS)
    offsets[(size_t)g * nm * ny + lo * ny + b] = base + table[b * WARP_STRIDE];
  if (g == G - 1 && blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    offsets[(size_t)G * nm * ny] = G * per;

  // placement: warp by warp independent, key order within a warp
  const unsigned lower = (1u << lane) - 1;
  for (int i0 = k0; i0 < k1; i0 += 32 * RUNS) {
    int mv[RUNS], yv[RUNS];
    load(i0, mv, yv);
#pragma unroll
    for (int r = 0; r < RUNS; ++r) {
      const bool mine = mv[r] >= lo && mv[r] < hi;
      const int bin = mine ? (mv[r] - lo) * ny + yv[r] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      int start = 0;
      if (mine) {
        const int key = key_of(i0 + 32 * r + lane, g, G, N);
        start = table[bin * WARP_STRIDE + warp];
        sorted[base + start + __popc(peers & lower)] = key * 3 * h1 - yv[r];
      }
      __syncwarp();
      if (mine && lane == __ffs(peers) - 1)
        table[bin * WARP_STRIDE + warp] = start + __popc(peers);
      __syncwarp();
    }
  }
}

// ---- backward: gather ----------------------------------------------------

constexpr int GATHER_THREADS = 256;
constexpr int UNROLL = 8;  // cotangent rows in flight per lane
// a group of at most SMALL_KEYS keys takes one launch, which sorts them in
// each block (windows_bwd_small_kernel)
constexpr int SMALL_KEYS = 256;

// The column of dt3 that the ci-th column of the schedule takes: the first
// three and the last three first (the clipped starts pile there, so their
// rows add the most), then the rest in order.
__device__ __forceinline__ int column(int ci, int m_max) {
  if (m_max < 6 || ci < 3) return ci;
  return ci < 6 ? m_max + 2 - ci : ci - 3;
}

template <int VEC>
__device__ __forceinline__ void add_row(float* acc,
                                        const typename Vec<VEC>::T& raw) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    acc[e] += __uint_as_float((unsigned)h[e] << 16);  // bf16 -> float, exact
}

template <int VEC>
__device__ __forceinline__ void store_row(float* out, const float* acc) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(out + e) =
          make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(acc[0], acc[1]);
  } else {
    out[0] = acc[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(__nv_bfloat16* out,
                                          const float* acc) {
  typename Vec<VEC>::T raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC; ++e) h[e] = __float2bfloat16(acc[e]);
  *reinterpret_cast<typename Vec<VEC>::T*>(out) = raw;
}

// A row's list of keys: the ranges [lo[mm], hi[mm]) of the sorted keys for
// mm = 0, 1, 2, one after the other. Entry k < end0 is sorted[first0 + k],
// then sorted[first1 + k] up to end1, then sorted[first2 + k] up to total;
// its cotangent row is that + mm * h1 + y.
struct RowList {
  int first0, first1, first2, end0, end1, total;
};

__device__ __forceinline__ RowList row_list(const int* lo, const int* hi) {
  RowList r;
  r.first0 = lo[0];
  r.end0 = hi[0] - lo[0];
  r.first1 = lo[1] - r.end0;
  r.end1 = r.end0 + hi[1] - lo[1];
  r.first2 = lo[2] - r.end1;
  r.total = r.end1 + hi[2] - lo[2];
  return r;
}

// The bins that row (y, m) reads for mm = 0, 1, 2: start column c = m - mm,
// starts ys in [y - h1 + 1, y], bins [c * ny + ylo, c * ny + yhi + 1); an
// empty [0, 0) where c falls outside the columns of starts.
__device__ __forceinline__ void row_bins(int m, int y, int nm, int ny, int h1,
                                         int* blo, int* bhi) {
  const int ylo = max(0, y - h1 + 1);
  const int yhi = min(y, ny - 1);
#pragma unroll
  for (int mm = 0; mm < 3; ++mm) {
    const int c = m - mm;
    const bool in = c >= 0 && c < nm;
    blo[mm] = in ? c * ny + ylo : 0;
    bhi[mm] = in ? c * ny + yhi + 1 : 0;
  }
}

// L lanes add up one row of dt3 from its list and write it: lane l its
// vectors l, l + L, ... of VEC values. The entries are taken UNROLL at a
// time: their cotangent rows load together, and the next UNROLL entries
// (from `sorted`, in device or shared memory) load while those rows are on
// their way. The sum runs in list order, one add at a time, from 0.0.
template <int VEC, typename OutT>
__device__ __forceinline__ void gather_row(
    const typename Vec<VEC>::T* __restrict__ gout, const int* sorted,
    const RowList& r, int y, int h1, int vpr, int lane, int L, OutT* dst) {
  using T = typename Vec<VEC>::T;
  auto key_row = [&](int k) -> int {  // cotangent row of entry k
    if (k < r.end0) return sorted[r.first0 + k] + y;
    if (k < r.end1) return sorted[r.first1 + k] + h1 + y;
    return sorted[r.first2 + k] + 2 * h1 + y;
  };
  for (int v = lane; v - lane < vpr; v += L) {
    const bool on = v < vpr;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    int next[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) next[u] = u < r.total ? key_row(u) : 0;
    for (int k = 0; k < r.total; k += UNROLL) {
      T raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (on && k + u < r.total)
          raw[u] = __ldg(gout + ((size_t)next[u] * vpr + v));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        next[u] = k + UNROLL + u < r.total ? key_row(k + UNROLL + u) : 0;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (on && k + u < r.total) add_row<VEC>(acc, raw[u]);
    }
    if (on) store_row<VEC>(dst + (size_t)v * VEC, acc);
  }
}

// L lanes own a row (g, y, m) of dt3. Rows go y-fastest, so a warp's rows
// are neighbours in y and read neighbouring cotangent rows of the same
// keys; its list comes from the bucketing's offsets.
template <int VEC, typename OutT>
__global__ void __launch_bounds__(GATHER_THREADS) windows_bwd_gather_kernel(
    const typename Vec<VEC>::T* __restrict__ gout,  // (B, G, N, 3, h1, WH)
    const int* __restrict__ sorted, const int* __restrict__ offsets,
    OutT* __restrict__ out,  // (G, Y, m_max, WH)
    int G, int Y, int m_max, int h1, int vpr, int L) {
  const size_t slot = ((size_t)blockIdx.x * GATHER_THREADS + threadIdx.x) / L;
  if (slot >= (size_t)G * Y * m_max) return;
  const int y = (int)(slot % Y);
  const int g = (int)((slot / Y) % G);
  const int m = column((int)(slot / ((size_t)Y * G)), m_max);
  const int ny = Y - h1 + 1;
  const int nm = m_max - 2;
  const int* starts = offsets + (size_t)g * nm * ny;
  int blo[3], bhi[3], lo[3], hi[3];
  row_bins(m, y, nm, ny, h1, blo, bhi);
#pragma unroll
  for (int mm = 0; mm < 3; ++mm) {
    lo[mm] = starts[blo[mm]];
    hi[mm] = starts[bhi[mm]];
  }
  gather_row<VEC>(gout, sorted, row_list(lo, hi), y, h1, vpr,
                  threadIdx.x % L, L,
                  out + (((size_t)g * Y + y) * m_max + m) * vpr * VEC);
}

// A group of at most SMALL_KEYS keys in one launch: block (j, g) sorts the
// group's keys by bin itself, each key placed after the keys of smaller bins
// and the earlier keys of its own (the bucketing's order), then gathers its
// rows of group g as windows_bwd_gather_kernel does, their lists found by
// binary search in the sorted bins, the six bounds of a row side by side.
template <int VEC, typename OutT>
__global__ void __launch_bounds__(GATHER_THREADS) windows_bwd_small_kernel(
    const typename Vec<VEC>::T* __restrict__ gout,  // (B, G, N, 3, h1, WH)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    OutT* __restrict__ out,  // (G, Y, m_max, WH)
    int B, int G, int N, int Y, int m_max, int h1, int vpr, int L) {
  __shared__ __align__(16) int key_bin[SMALL_KEYS];  // key order
  __shared__ int key_row0[SMALL_KEYS];
  __shared__ int bins[SMALL_KEYS], sorted[SMALL_KEYS];  // bin order
  const int g = blockIdx.y;
  const int per = B * N;
  const int quads = (per + 3) / 4;
  const int ny = Y - h1 + 1;
  const int nm = m_max - 2;
  for (int i = threadIdx.x; i < 4 * quads; i += GATHER_THREADS) {
    if (i >= per) {
      key_bin[i] = INT_MAX;  // after every bin, equal to none
      continue;
    }
    const int key = key_of(i, g, G, N);
    const int y0 = ys[key];
    key_bin[i] = ms[key] * ny + y0;
    key_row0[i] = key * 3 * h1 - y0;
  }
  __syncthreads();
  // rank of key i: the keys of smaller bins, then the earlier ones of its bin
  for (int i = threadIdx.x; i < per; i += GATHER_THREADS) {
    const int b = key_bin[i];
    int rank = 0;
#pragma unroll 4
    for (int q = 0; q < quads; ++q) {
      const int4 k = reinterpret_cast<const int4*>(key_bin)[q];
      const int j = 4 * q;
      rank += (k.x < b) + (k.y < b) + (k.z < b) + (k.w < b);
      rank += ((k.x == b) & (j < i)) + ((k.y == b) & (j + 1 < i)) +
              ((k.z == b) & (j + 2 < i)) + ((k.w == b) & (j + 3 < i));
    }
    bins[rank] = b;
    sorted[rank] = key_row0[i];
  }
  __syncthreads();
  const int slot = blockIdx.x * (GATHER_THREADS / L) + threadIdx.x / L;
  if (slot >= Y * m_max) return;
  const int y = slot % Y;
  const int m = column(slot / Y, m_max);
  // where each of the row's six bin bounds falls in the sorted bins (the
  // number of bins below it), searched side by side
  int blo[3], bhi[3], lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
  row_bins(m, y, nm, ny, h1, blo, bhi);
  for (int step = 1 << (31 - __clz(per)); step > 0; step >>= 1) {
#pragma unroll
    for (int mm = 0; mm < 3; ++mm) {
      if (lo[mm] + step <= per && bins[lo[mm] + step - 1] < blo[mm])
        lo[mm] += step;
      if (hi[mm] + step <= per && bins[hi[mm] + step - 1] < bhi[mm])
        hi[mm] += step;
    }
  }
  gather_row<VEC>(gout, sorted, row_list(lo, hi), y, h1, vpr,
                  threadIdx.x % L, L,
                  out + (((size_t)g * Y + y) * m_max + m) * vpr * VEC);
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

int lanes(int vpr) {  // lanes a row: the power of two over vpr, at most 32
  int L = 1;
  while (L < vpr && L < 32) L *= 2;
  return L;
}

template <int VEC, typename OutT>
void backward(const void* gout, const int* ys, const int* ms, int* sorted,
              int* offsets, void* out, int B, int G, int N, int Y, int m_max,
              int h1, int WH, int msb, cudaStream_t stream) {
  using T = typename Vec<VEC>::T;
  const int vpr = WH / VEC;
  const int L = lanes(vpr);
  const int per_block = GATHER_THREADS / L;
  const int ny = Y - h1 + 1;
  const int nm = m_max - 2;
  if (B * N <= SMALL_KEYS) {
    const dim3 grid((Y * m_max + per_block - 1) / per_block, G);
    windows_bwd_small_kernel<VEC, OutT><<<grid, GATHER_THREADS, 0, stream>>>(
        (const T*)gout, ys, ms, (OutT*)out, B, G, N, Y, m_max, h1, vpr, L);
    return;
  }
  const dim3 grid((nm + msb - 1) / msb, G);
  const size_t smem = (size_t)msb * ny * WARP_STRIDE * sizeof(int);
  windows_bwd_bucket_kernel<<<grid, BUCKET_THREADS, smem, stream>>>(
      ys, ms, sorted, offsets, B, G, N, ny, nm, h1, msb);
  const size_t rows = (size_t)G * Y * m_max;
  windows_bwd_gather_kernel<VEC, OutT>
      <<<(unsigned)((rows + per_block - 1) / per_block), GATHER_THREADS, 0,
         stream>>>((const T*)gout, sorted, offsets, (OutT*)out, G, Y, m_max,
                   h1, vpr, L);
}

template <typename OutT>
void backward_any(int WH, const void* gout, const int* ys, const int* ms,
                  int* sorted, int* offsets, void* out, int B, int G, int N,
                  int Y, int m_max, int h1, int msb, cudaStream_t stream) {
  auto fn = backward<1, OutT>;
  switch (vector_width(WH)) {
    case 8: fn = backward<8, OutT>; break;
    case 4: fn = backward<4, OutT>; break;
    case 2: fn = backward<2, OutT>; break;
  }
  fn(gout, ys, ms, sorted, offsets, out, B, G, N, Y, m_max, h1, WH, msb,
     stream);
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

// gout (B, G, N, 3, h1, WH) bf16, ys and ms (B, G, N) int32 -> out (G, Y,
// m_max, WH), the sum of the windows' cotangents, float32 or (with `bf16`)
// those sums rounded to bf16. Groups of at most SMALL_KEYS keys take one
// launch; larger ones the bucketing and the gather, with scratch sorted (B
// * G * N) and offsets (G * (m_max - 2) * (Y - h1 + 1) + 1) int32. A
// bucketing block takes msb columns of starts: its table of msb * ny *
// WARP_STRIDE ints must stay within BUCKET_TABLE_BYTES
// (ops/kernels/lattice_windows.py::bucket_columns).
extern "C" int lattice_windows_bwd_launch(const void* gout, const void* ys,
                                          const void* ms, void* sorted,
                                          void* offsets, void* out, int B,
                                          int G, int N, int Y, int m_max,
                                          int h1, int WH, int msb, int bf16,
                                          void* stream) {
  const size_t smem = (size_t)msb * (Y - h1 + 1) * WARP_STRIDE * sizeof(int);
  if (msb < 1 || smem > BUCKET_TABLE_BYTES) return (int)cudaErrorInvalidValue;
  auto fn = bf16 ? backward_any<__nv_bfloat16> : backward_any<float>;
  fn(WH, gout, (const int*)ys, (const int*)ms, (int*)sorted, (int*)offsets,
     out, B, G, N, Y, m_max, h1, msb, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
