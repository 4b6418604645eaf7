// Fused lattice attention site for wide heads (ch 16 or 32), eval only:
//   out[b, g, h, m, :] = sum_n softmax_n(bias[n, m] + scale * q[m] . k[n]) v[n]
// with the rpe bias built in registers, scores and AV on the tensor cores,
// an online softmax over key tiles, and nothing of size N x M written to
// device memory.
//
// Replaces no TPU kernel. The JAX package fuses a site only at head widths
// up to 8 (bevrender_tpu/ops/deform_attn.py:881) and runs wider heads
// through _site_xla, which writes the bias, the scores and p of every
// (key, query) pair to memory; the port did the same (the bias kernel
// lattice_bias.cu, then ops/deform_attn.py::site_consumer in float32). This
// kernel is that site in one pass, for the head widths of the flagship's
// stages 0, 1, 5 and 6 and of every pyramid stage.
//
// Layout, FlashAttention-2 style on mma.sync.m16n8k16 (bf16 operands,
// float32 sums). A block owns one head (b, g, h) and NW warps (the wrapper's
// plan, ops/kernels/fused_site_mma.py::plan); a warp owns 16 queries, the
// rows of its mma tiles, and keeps their Q in A fragments for the whole key
// loop. The 16 rows are 8 vertical pairs of queries: row r < 8 is query
// (iy, ix) and row r + 8 the one below it, (iy + 1, ix), where pair P of
// the head is row pair P / W (iy = 2 (P / W)), column P % W. An mma thread
// holds rows r and r + 8, so its two queries read the same table column
// and share a table row: the three rows ys + iy .. ys + iy + 2 give both
// biases, three x-lerps where two queries would take four, and one column
// fraction. On an odd H the last row's lower query is masked, and its
// third row is read from the second, inside the table.
//
// Per block: the head's zero-padded bf16 table staged once
// (lattice_common.cuh::stage_padded), and key tiles of KT keys (K and V in
// bf16, each row's 16-byte chunks XOR-swizzled by the row so that ldmatrix
// is free of bank conflicts, and the keys' ys, ms, wy, f) in two stages
// filled by cp.async while the block works on the other, one __syncthreads
// a tile. At the flagship's SCA (a 63 x 429 padded table) a block takes
// 54 KB of table and 18 KB (ch 32) of stages, so three blocks share an SM. Per step of SK keys
// a warp:
//   S = Q K^T        one mma k-step at ch 16, two at ch 32, K fragments by
//                    ldmatrix;
//   bias             each thread lerps the bias of its own accumulator
//                    elements from the staged table (lattice::bias_col's
//                    arithmetic: every float32 step rounded on its own), so
//                    the bias equals every other site kernel's bit for bit;
//   s                (scale * qk + bias) * log2 e, fmaf then one rounded
//                    multiply, as site_common.cuh::score;
//   online softmax   in base 2, the row max by quad shuffles, p = exp2(s -
//                    running max), l summed from the unrounded p, as the
//                    other fused sites;
//   O += P V         P repacked from the S accumulators into bf16 A
//                    fragments in registers, V fragments by ldmatrix.trans.
// Only the sums differ from ops/deform_attn.py::site_consumer_online, which
// the other fused sites equal bit for bit: q . k on the tensor cores (their
// order, not an fmaf chain), l and O summed a thread's keys at a time and
// across the quad at the end.
//
// Bound: operations per (query, key) pair on the CUDA cores, not bytes and
// not the tensor cores (4 ch bf16 FLOP a pair: 128 at ch 32, a 7.7 ps a
// pair floor at 989 TFLOP/s over the whole card would be 0.13 ps). A pair
// costs the bias (half of three table-row x-lerps from six shared-memory
// reads, a y-lerp, a column fraction shared by two pairs), the score, and
// the softmax's exp, max and sum: about 30 instructions. The design answers
// that with the shared-row pairs (a quarter fewer bias instructions than
// one query a thread), with the products moved onto the tensor cores (the
// SIMT instances spend 2 ch fmaf a pair on them), and with P and Q kept in
// registers, so a pair touches shared memory only for its table reads.
//
// Head widths: 16 and 32, the two wide ones the supported models give it.

#include <math_constants.h>

#include "lattice_ring.cuh"

namespace {

constexpr int KT = 64;        // keys a stage
constexpr int SK = 32;        // keys an online-softmax step
constexpr int MAX_WARPS = 8;  // fused_site_mma.py::MAX_WARPS
constexpr int MIN_BLOCKS = 3;  // three blocks of the flagship's SCA an SM
constexpr float LOG2E = 1.4426950408889634f;

// One stage: K rows then V rows of a key tile, bf16, (KT, CH) each, then
// the tile's ys, ms, wy and f (KT words each). Key j's 16-byte chunk c lies
// at chunk c ^ swizzle(j): the 8 rows an ldmatrix reads for one chunk then
// fall on 8 distinct quarters of the 32 banks.
template <int CH>
struct Stage {
  static constexpr int CHUNKS = CH / 8;  // 16-byte chunks a row
  static constexpr int KV = KT * CH;
  static constexpr int BYTES = 2 * KV * 2 + 4 * KT * 4;  // a multiple of 16
  // rows that fill 128 bytes: 2 at ch 32, 4 at ch 16
  __device__ static int swizzle(int j) { return (j / (8 / CHUNKS)) % CHUNKS; }
};

// Shared memory of a block: two stages, then the padded table
// (fused_site_mma.py::smem_bytes).
template <int CH>
size_t smem_bytes(int Ht, int Xp) {
  return (size_t)2 * Stage<CH>::BYTES +
         (size_t)(Ht + 2 * lattice::PAD) * Xp * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans gives each thread a column pair.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += A B: A (16 x 16) in a, B (16 x 8) in b0 b1, bf16 pairs with the lower
// index in the low half.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The largest of x over the four threads of a quad (one mma row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The block's NW = blockDim.x / 32 warps own pairs blockIdx.x 8 NW .. of the
// head blockIdx.y = (b G + g) Hpg + h.
template <int CH>
__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_BLOCKS)
    fused_site_mma_kernel(
        const __nv_bfloat16* __restrict__ table,  // (G, Hpg, Ht, Wt)
        const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
        const float* __restrict__ wy, const float* __restrict__ fx,
        const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
        const __nv_bfloat16* __restrict__ q,  // (B, G, Hpg, M, CH)
        const __nv_bfloat16* __restrict__ k,  // (B, G, Hpg, N, CH)
        const __nv_bfloat16* __restrict__ v,  // (B, G, Hpg, N, CH)
        float* __restrict__ out,              // (B, G, Hpg, M, CH)
        int G, int Hpg, int Ht, int Wt, int Xp, int N, int H, int W,
        float scale) {
  using St = Stage<CH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* st =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * St::BYTES);

  const int bgh = blockIdx.y;
  const int bg = bgh / Hpg;
  const int g = bg % G;
  const int M = H * W;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int npairs = ((H + 1) >> 1) * W;
  const int task = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool live = task * 8 < npairs;  // the warp has a query
  const int pair_raw = task * 8 + gid;
  const bool top_ok = pair_raw < npairs;
  const int pair = top_ok ? pair_raw : npairs - 1;  // idle rows read in range
  const int ix = pair % W;
  const int iy = 2 * (pair / W);
  const bool bot_ok = top_ok && iy + 1 < H;
  const int m_top = iy * W + ix;
  const int m_bot = iy + 1 < H ? m_top + W : m_top;
  const float gcol = gcomb[ix];
  const __nv_bfloat16* tq = st + iy * Xp + u0[ix];  // the pair's corner
  // the third row's offset; the second again where the lower query is past
  // the last row
  const int r3 = iy + 1 < H ? 2 * Xp : Xp;
  // this lane's ldmatrix rows are keys = lane (mod 8) of their tile
  const int swz = St::swizzle(lane & 7);

  const size_t row0 = (size_t)bgh * M;
  const __nv_bfloat16* kb = k + (size_t)bgh * N * CH;
  const __nv_bfloat16* vb = v + (size_t)bgh * N * CH;
  const size_t geo = (size_t)bg * N;

  // start the copies of the tile from key n0 into stage `buf`; one commit
  // group a tile, empty past the last key. Rows past N are zeros (their p
  // is 0, and 0 times stale bits could be NaN), their geometry 0 (an
  // address inside the table).
  auto issue = [&](int n0, int buf) {
    if (n0 < N) {
      __nv_bfloat16* sk =
          reinterpret_cast<__nv_bfloat16*>(smem_raw + buf * St::BYTES);
      int* sg = reinterpret_cast<int*>(sk + 2 * St::KV);
      const int nk = min(KT, N - n0);
      constexpr int CHUNKS = St::CHUNKS;
      for (int i = threadIdx.x; i < 2 * KT * CHUNKS; i += blockDim.x) {
        const int r = i / CHUNKS;  // K rows, then V rows
        const int c = i - r * CHUNKS;
        const int j = r < KT ? r : r - KT;
        __nv_bfloat16* dst = sk + (r < KT ? 0 : St::KV) + j * CH +
                             8 * (c ^ St::swizzle(j));
        if (j < nk)
          lattice::cp_async16(dst,
                              (r < KT ? kb : vb) + (size_t)(n0 + j) * CH + 8 * c);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
      for (int i = threadIdx.x; i < 4 * KT; i += blockDim.x) {
        const int a = i / KT;
        const int j = i - a * KT;
        if (j < nk) {
          const void* src = a == 0   ? (const void*)(ys + geo + n0 + j)
                            : a == 1 ? (const void*)(ms + geo + n0 + j)
                            : a == 2 ? (const void*)(wy + geo + n0 + j)
                                     : (const void*)(fx + geo + n0 + j);
          lattice::cp_async<4>(sg + a * KT + j, src);
        } else {
          sg[a * KT + j] = 0;
        }
      }
    }
    lattice::cp_async_commit();
  };

  // Q of the warp's 16 rows as A fragments, one k-step of 16 channels each
  unsigned qa[CH / 16][4];
  {
    const __nv_bfloat16* qt = q + (row0 + m_top) * CH + 2 * tig;
    const __nv_bfloat16* qb = q + (row0 + m_bot) * CH + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {
      qa[kk][0] = ld32(qt + 16 * kk);
      qa[kk][1] = ld32(qb + 16 * kk);
      qa[kk][2] = ld32(qt + 16 * kk + 8);
      qa[kk][3] = ld32(qb + 16 * kk + 8);
    }
  }

  issue(0, 0);
  lattice::stage_padded(
      st, table + ((size_t)g * Hpg + bgh - bg * Hpg) * Ht * Wt, 1, Ht, Wt, Xp);

  float o[CH / 8][4] = {};  // rows gid (0, 1) and gid + 8 (2, 3)
  float m_t = -1e30f, m_b = -1e30f, l_t = 0.0f, l_b = 0.0f;
  for (int n0 = 0, t = 0; n0 < N; n0 += KT, ++t) {
    lattice::cp_async_wait<0>();  // this thread's copies of tile t landed
    __syncthreads();  // every thread's; tile t-1 consumed; table staged
    issue(n0 + KT, (t + 1) & 1);
    if (!live) continue;
    const __nv_bfloat16* sk =
        reinterpret_cast<const __nv_bfloat16*>(smem_raw + (t & 1) * St::BYTES);
    const __nv_bfloat16* sv = sk + St::KV;
    const int* sys = reinterpret_cast<const int*>(sk + 2 * St::KV);
    const int* sms = sys + KT;
    const float* swy = reinterpret_cast<const float*>(sms + KT);
    const float* sf = swy + KT;
    for (int s0 = 0; s0 < KT && n0 + s0 < N; s0 += SK) {
      // S = Q K^T, n-tile j: keys s0 + 8 j .. + 7
      float s[SK / 8][4];
#pragma unroll
      for (int j = 0; j < SK / 8; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      if constexpr (CH == 32) {
#pragma unroll
        for (int j = 0; j < SK / 8; ++j) {
          unsigned b[4];  // channels 0-7, 8-15 (k-step 0), 16-23, 24-31
          ldsm4(b, sk + (s0 + 8 * j + (lane & 7)) * CH +
                       8 * ((lane >> 3) ^ swz));
          mma(s[j], qa[0], b[0], b[1]);
          mma(s[j], qa[1], b[2], b[3]);
        }
      } else {
        static_assert(CH == 16, "head widths 16 and 32");
#pragma unroll
        for (int j = 0; j < SK / 8; j += 2) {
          unsigned b[4];  // n-tile j channels 0-7, 8-15, then n-tile j + 1
          ldsm4(b, sk + (s0 + 8 * (j + (lane >> 4)) + (lane & 7)) * CH +
                       8 * (((lane >> 3) & 1) ^ swz));
          mma(s[j], qa[0], b[0], b[1]);
          mma(s[j + 1], qa[0], b[2], b[3]);
        }
      }
      // the bias of each element and the base-2 scores; keys past N -inf
#pragma unroll
      for (int j = 0; j < SK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = s0 + 8 * j + 2 * tig + e;
          if (n0 + key < N) {
            const lattice::Column col = lattice::column(gcol, sf[key]);
            const float wk = swy[key];
            const __nv_bfloat16* p =
                tq + sys[key] * Xp + sms[key] + col.cross;
            const float x0 = lattice::lerp_rn(bf(p[0]), bf(p[1]), col.wx);
            const float x1 =
                lattice::lerp_rn(bf(p[Xp]), bf(p[Xp + 1]), col.wx);
            const float x2 =
                lattice::lerp_rn(bf(p[r3]), bf(p[r3 + 1]), col.wx);
            s[j][e] = __fmul_rn(
                __fmaf_rn(scale, s[j][e], lattice::lerp_rn(x0, x1, wk)),
                LOG2E);
            s[j][2 + e] = __fmul_rn(
                __fmaf_rn(scale, s[j][2 + e], lattice::lerp_rn(x1, x2, wk)),
                LOG2E);
          } else {
            s[j][e] = s[j][2 + e] = -CUDART_INF_F;
          }
        }
      }
      // online softmax of the two rows
      float mx_t = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < SK / 8; ++j) {
        mx_t = fmaxf(mx_t, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
      const float mn_t = fmaxf(m_t, quad_max(mx_t));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float a_t = exp2f(__fsub_rn(m_t, mn_t));
      const float a_b = exp2f(__fsub_rn(m_b, mn_b));
      m_t = mn_t;
      m_b = mn_b;
      l_t = __fmul_rn(l_t, a_t);
      l_b = __fmul_rn(l_b, a_b);
#pragma unroll
      for (int nn = 0; nn < CH / 8; ++nn) {
        o[nn][0] = __fmul_rn(o[nn][0], a_t);
        o[nn][1] = __fmul_rn(o[nn][1], a_t);
        o[nn][2] = __fmul_rn(o[nn][2], a_b);
        o[nn][3] = __fmul_rn(o[nn][3], a_b);
      }
      // p, l, and P as A fragments: k-step kk holds n-tiles 2 kk, 2 kk + 1
      unsigned pa[SK / 16][4];
#pragma unroll
      for (int j = 0; j < SK / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = exp2f(__fsub_rn(s[j][e], e < 2 ? mn_t : mn_b));
        l_t = __fadd_rn(__fadd_rn(l_t, p[0]), p[1]);
        l_b = __fadd_rn(__fadd_rn(l_b, p[2]), p[3]);
        pa[j >> 1][(j & 1) * 2] = lattice::pack2(p[0], p[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = lattice::pack2(p[2], p[3]);
      }
      // O += P V: V fragments of keys s0 + 16 kk .., channel n-tiles nn,
      // nn + 1
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk) {
#pragma unroll
        for (int nn = 0; nn < CH / 8; nn += 2) {
          unsigned b[4];
          ldsm4_trans(b, sv + (s0 + 16 * kk + 8 * ((lane >> 3) & 1) +
                               (lane & 7)) * CH +
                              8 * ((nn + (lane >> 4)) ^ swz));
          mma(o[nn], pa[kk], b[0], b[1]);
          mma(o[nn + 1], pa[kk], b[2], b[3]);
        }
      }
    }
  }
  if (!live) return;
  const float lt = fmaxf(quad_sum(l_t), 1e-30f);
  const float lb = fmaxf(quad_sum(l_b), 1e-30f);
#pragma unroll
  for (int nn = 0; nn < CH / 8; ++nn) {
    const int c = 8 * nn + 2 * tig;
    if (top_ok)
      *reinterpret_cast<float2*>(out + (row0 + m_top) * CH + c) =
          make_float2(__fdiv_rn(o[nn][0], lt), __fdiv_rn(o[nn][1], lt));
    if (bot_ok)
      *reinterpret_cast<float2*>(out + (row0 + m_bot) * CH + c) =
          make_float2(__fdiv_rn(o[nn][2], lb), __fdiv_rn(o[nn][3], lb));
  }
}

template <int CH>
int launch(const void* table, const void* ys, const void* ms, const void* wy,
           const void* fx, const void* u0, const void* gcomb, const void* q,
           const void* k, const void* v, void* out, int B, int G, int Hpg,
           int Ht, int Wt, int Xp, int N, int H, int W, int warps,
           float scale, cudaStream_t stream) {
  if (warps < 1 || warps > MAX_WARPS || (size_t)q % 16 || (size_t)k % 16 ||
      (size_t)v % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<CH>(Ht, Xp);
  const int rc = lattice::set_smem((const void*)fused_site_mma_kernel<CH>, smem);
  if (rc) return rc;
  const int tasks = (((H + 1) / 2) * W + 7) / 8;  // warps a head
  const dim3 grid((tasks + warps - 1) / warps, B * G * Hpg);
  fused_site_mma_kernel<CH><<<grid, warps * 32, smem, stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (float*)out, G, Hpg, Ht, Wt, Xp, N, H, W,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// `warps` warps a block (at most MAX_WARPS), Xp the row pitch of the staged
// padded table; q, k and v on a 16-byte boundary.
extern "C" int fused_site_mma_launch(const void* table, const void* ys,
                                     const void* ms, const void* wy,
                                     const void* fx, const void* u0,
                                     const void* gcomb, const void* q,
                                     const void* k, const void* v, void* out,
                                     int B, int G, int Hpg, int Ht, int Wt,
                                     int Xp, int N, int H, int W, int warps,
                                     int ch, float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (ch == 16)
    return launch<16>(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, B, G,
                      Hpg, Ht, Wt, Xp, N, H, W, warps, scale, s);
  if (ch == 32)
    return launch<32>(table, ys, ms, wy, fx, u0, gcomb, q, k, v, out, B, G,
                      Hpg, Ht, Wt, Xp, N, H, W, warps, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of `warps` warps with `smem` bytes of dynamic shared memory that one
// SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for the
// instance of head width ch; a negative CUDA error code where the query
// fails.
extern "C" int fused_site_mma_occupancy(int ch, int warps, int smem) {
  const void* kernel = ch == 16   ? (const void*)fused_site_mma_kernel<16>
                       : ch == 32 ? (const void*)fused_site_mma_kernel<32>
                                  : nullptr;
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  int rc = lattice::set_smem(kernel, smem);
  int blocks = 0;
  if (!rc)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                            warps * 32, smem);
  return rc ? -rc : blocks;
}
