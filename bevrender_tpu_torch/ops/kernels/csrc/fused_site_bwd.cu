// Backward of the fused lattice attention site for narrow heads (ch 4 or 8),
// flash style: from q, k, v, the forward's logsumexp and the cotangent dO to
// dq, dk, dv, the gradient of the raw rpe table and the cotangents of the
// per-key fractions (dwy, df). Neither bias, scores nor probabilities touch
// device memory.
//
// Replaces the TPU kernel bevrender_tpu/ops/pallas/fused_attn.py
// ::site_bwd_call / _site_bwd_kernel. Per (key n, query m) pair of one
// (b, g, h), with the forward kernel's roundings (fused_site.cu):
//   s  = scale * q[m] . k[n] + bias[n, m]       (fmaf chain, float32)
//   p  = exp(s - lse[m])                        (in base 2, as the forward)
//   dv[n] += bf16(p) * bf16(dO[m])              dp = v[n] . bf16(dO[m])
//   ds = p * (dp - D[m])                        D = rowsum(dO * O)
//   dk[n] += bf16(ds) * q[m]                    dq[m] += bf16(ds) * k[n]
// with dk and dq scaled by `scale` at the end, and the unrounded ds fed to
// the bias cotangent. s and dp stay fmaf chains on the CUDA cores, in the
// order ops/deform_attn.py::site_bwd_online repeats: ds is rounded to bf16
// before it multiplies, so a last-bit change of s or dp (a tensor-core sum
// in another order) would flip some bf16(ds) and move dk and dq by a bf16
// ulp of a pair's term. The three products that only sum (dV += P dO,
// dK += dS Q, dQ += dS^T K) take bf16 factors with float32 sums on the
// tensor cores (mma.sync m16n8k8 / m16n8k16): exact products, sums in
// another order than the mirror's.
//
// A block owns one head (b, g, h), 16 keys per warp (warps per block, key
// blocks per head and a split of the query walk chosen by
// ops/kernels/fused_site_bwd.py::tiling so that a training step's shapes
// launch at least 2 x 132 blocks), and
// walks its share of the queries in strips of 32, column-major (query
// (iy, ix) is slot ix * H + iy). A warp's 16 keys are the rows of the mma
// tiles; a strip is 4 tiles of 8 query columns, placed so that each thread
// holds 8 consecutive slots (mostly consecutive rows iy of one column ix)
// for its two keys. Along such a run the pair (iy, ix) reads rows ys + iy
// and ys + iy + 1 of the window, so the thread carries the lower row's
// x-lerp to the next pair (one new table row a pair) and adds the bias
// cotangent of each table row once, merged from the two pairs that share
// it: about 2.25 shared-memory adds a pair in place of 4. The lanes of one
// add are 8 keys at 4 runs 8 rows apart, so they rarely hit one word (a
// shared float atomicAdd is a compare-and-swap loop on sm_90a, which
// retries on every collision).
//
// Bound: the float adds into the table gradient in shared memory. At the
// flagship's training SCA they take about half the kernel's time on an
// H100: the 32 lanes of one add land on random banks (8 keys, random
// starts), so each compare-and-swap takes several passes; the same adds at
// bank-distinct addresses cost under a third as much (PERF.md §6). The rest is
// the per-pair bias and the two fmaf chains on the CUDA cores, 16 warps an
// SM.
//
// Shared memory: the head's zero-padded table in bf16 and its gradient in
// float32 (6 B an entry: 162 KB at the flagship's SCA, 63 x 429 entries),
// the strip's q and bf16-rounded dO in float32 with four words of geometry a
// query, and one float32 (32, ch) dq buffer a warp, into which the warp
// writes its strip's dq tile; after each strip the block sums the buffers
// into dq in device memory, one float atomic per (query, channel) and
// block. tiling launches as many warps as buffers fit (16 at the
// flagship's SCA); at one warp the layout has the size of the kernel before
// this design, so every site it took still fits
// (ops/deform_attn.py::_site_bwd_fits). Sums across blocks: dq over the
// key blocks, dk, dv, dwy and df over the query split (and dwy, df over the
// heads), the table gradient over the blocks of a (g, h) when its block
// ends, all by float atomics into zeroed buffers: their order, so their
// last bits, vary from run to run.
//
// Head widths: 4 and 8, as the forward (ch 4 pads the mma's 8 with zeros).

#include "lattice_common.cuh"

namespace {

constexpr int SLOTS = 32;  // queries a strip: 4 mma tiles of 8 columns
constexpr int MAX_THREADS = 512;
constexpr int INVALID = -2147483647 - 1;  // geometry word past the last query
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// d += A B on the tensor cores: A (16 x 8) in a0 a1, B (8 x 8) in b, bf16
// pairs, lower index in the low half.
__device__ __forceinline__ void mma_k8(float (&d)[4], unsigned a0, unsigned a1,
                                       unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ void mma_k16(float (&d)[4], unsigned a0,
                                        unsigned a1, unsigned a2, unsigned a3,
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The transpose of an 8 x 8 bf16 tile held one row pair a lane.
__device__ __forceinline__ unsigned transpose8(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ unsigned bits(__nv_bfloat16 x) {
  return (unsigned)__bfloat16_as_ushort(x);
}

// Strip slot of position `pos` (mma column): tile j = pos / 8 gives thread
// t = (pos % 8) / 2 the slots 8 t + 2 j and 8 t + 2 j + 1.
__device__ __forceinline__ int slot_of(int pos) {
  return ((pos & 7) >> 1) * 8 + 2 * (pos >> 3) + (pos & 1);
}

// Row-major query index of position `pos` of `strip`, -1 past the last.
__device__ __forceinline__ int query_of(int strip, int pos, int H, int W,
                                        int M, int* iy_out) {
  const int mp = strip * SLOTS + slot_of(pos);
  if (mp >= M) return -1;
  const int ix = mp / H;
  const int iy = mp - ix * H;
  *iy_out = iy;
  return iy * W + ix;
}

// One key of a thread: its K and V, fractions, and the state of its current
// run of consecutive rows (the lower row's x-lerp, its x-difference, the
// part of that row's cotangent the previous pair left).
template <int CH>
struct Key {
  float kf[CH], vf[CH];
  float f, wy, omwy;
  int base;  // ys * Xp + ms
  int row;   // padded-table offset of the run's current row and column
  float wx, ux, x0, dx0, pend;
  float a_wy, a_f;
  bool valid, open;
};

template <int CH>
__device__ __forceinline__ void load_key(Key<CH>& K, int n, int N, size_t bg,
                                         size_t bgh, const int* ys,
                                         const int* ms, const float* wy,
                                         const float* fx,
                                         const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, int Xp) {
  K.valid = n < N;
  K.open = false;
  K.a_wy = 0.0f;
  K.a_f = 0.0f;
  const int nn = K.valid ? n : N - 1;
  const size_t key = bg * N + nn;
  K.f = fx[key];
  K.wy = wy[key];
  K.omwy = 1.0f - K.wy;
  K.base = ys[key] * Xp + ms[key];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    K.kf[c] = bf(k[(bgh * N + nn) * CH + c]);
    K.vf[c] = bf(v[(bgh * N + nn) * CH + c]);
  }
}

// Add the pending cotangent of the run's last row.
template <int CH>
__device__ __forceinline__ void close_run(Key<CH>& K, float* sg) {
  if (K.open) {
    float* gp = sg + K.row;
    atomicAdd(gp, K.pend * K.ux);
    atomicAdd(gp + 1, K.pend * K.wx);
    K.a_f = fmaf(K.pend, K.dx0, K.a_f);
    K.open = false;
  }
}

// Start a run at the query row whose padded-table offset is `off` (iy * Xp +
// u0[ix]), column fraction g[ix] = gc.
template <int CH>
__device__ __forceinline__ void open_run(Key<CH>& K,
                                         const __nv_bfloat16* st, int off,
                                         float gc) {
  const lattice::Column col = lattice::column(gc, K.f);
  K.wx = col.wx;
  K.ux = 1.0f - col.wx;
  K.row = K.base + off + col.cross;
  const float a = bf(st[K.row]), b = bf(st[K.row + 1]);
  K.x0 = lattice::lerp_rn(a, b, K.wx);
  K.dx0 = b - a;
  K.pend = 0.0f;
  K.open = true;
}

// One pair: the next row of the run, p and ds, the merged cotangent of the
// run's current row.
template <int CH>
__device__ __forceinline__ void pair(Key<CH>& K, const float* qf,
                                     const float* dof, float lse2, float D,
                                     const __nv_bfloat16* st, float* sg,
                                     int Xp, float scale, float& p_out,
                                     float& ds_out) {
  const __nv_bfloat16* t1 = st + K.row + Xp;
  const float a = bf(t1[0]), b = bf(t1[1]);
  const float x1 = lattice::lerp_rn(a, b, K.wx);
  const float dx1 = b - a;
  const float bias = lattice::lerp_rn(K.x0, x1, K.wy);
  float qk = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) qk = __fmaf_rn(qf[c], K.kf[c], qk);
  const float s = __fmul_rn(__fmaf_rn(scale, qk, bias), LOG2E);
  const float p = exp2f(s - lse2);
  float dp = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) dp = fmaf(K.vf[c], dof[c], dp);
  const float ds = p * (dp - D);
  K.a_wy = fmaf(ds, x1 - K.x0, K.a_wy);
  const float gy = K.pend + ds * K.omwy;  // the row's share of both pairs
  K.pend = ds * K.wy;
  float* gp = sg + K.row;
  atomicAdd(gp, gy * K.ux);
  atomicAdd(gp + 1, gy * K.wx);
  K.a_f = fmaf(gy, K.dx0, K.a_f);
  K.row += Xp;
  K.x0 = x1;
  K.dx0 = dx1;
  p_out = p;
  ds_out = ds;
}

// One slot of a thread for one key: p and ds, zero where the key or the
// query does not exist. `ov` is the slot's geometry word (iy * Xp + u0[ix],
// complemented where iy = 0, INVALID past the last query).
template <int CH>
__device__ __forceinline__ void slot(Key<CH>& K, bool first, int ov, float gc,
                                     const float* qf, const float* dof,
                                     float lse2, float D,
                                     const __nv_bfloat16* st, float* sg,
                                     int Xp, float scale, float& p, float& ds) {
  p = 0.0f;
  ds = 0.0f;
  if (!K.valid) return;
  if (ov == INVALID) {
    close_run(K, sg);
    return;
  }
  if (first || ov < 0) {
    close_run(K, sg);
    open_run(K, st, ov < 0 ? ~ov : ov, gc);
  }
  pair(K, qf, dof, lse2, D, st, sg, Xp, scale, p, ds);
}

template <int CH>
__global__ void __launch_bounds__(MAX_THREADS, 1) fused_site_bwd_kernel(
    const __nv_bfloat16* __restrict__ table,  // (G, Hpg, Ht, Wt)
    const int* __restrict__ ys, const int* __restrict__ ms,  // (B, G, N)
    const float* __restrict__ wy, const float* __restrict__ fx,  // (B, G, N)
    const int* __restrict__ u0, const float* __restrict__ gcomb,  // (W,)
    const __nv_bfloat16* __restrict__ q,  // (B, G, Hpg, M, CH)
    const __nv_bfloat16* __restrict__ k,  // (B, G, Hpg, N, CH)
    const __nv_bfloat16* __restrict__ v,  // (B, G, Hpg, N, CH)
    const float* __restrict__ dout,       // (B, G, Hpg, M, CH)
    const float* __restrict__ lse,        // (B, G, Hpg, M), natural log
    const float* __restrict__ dsum,       // (B, G, Hpg, M): rowsum(dO * O)
    float* __restrict__ dq,               // (B, G, Hpg, M, CH), zeroed
    float* __restrict__ dk,               // (B, G, Hpg, N, CH), zeroed
    float* __restrict__ dv,               // (B, G, Hpg, N, CH), zeroed
    float* __restrict__ dtable,           // (G, Hpg, Ht, Wt), zeroed
    float* __restrict__ dwy, float* __restrict__ df,  // (B, G, N), zeroed
    int G, int Hpg, int Ht, int Wt, int Xp, int N, int H, int W, int nkb,
    int qsplit, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NQ = SLOTS * CH;
  float* sq = reinterpret_cast<float*>(smem_raw);  // (SLOTS, CH) by position
  float* sdo = sq + NQ;                            // (SLOTS, CH) bf16-rounded
  float4* smeta = reinterpret_cast<float4*>(sdo + NQ);  // lse2, D, g, word
  float* sdq = reinterpret_cast<float*>(smeta + SLOTS);  // (warps, SLOTS, CH)
  const int warps = blockDim.x >> 5;
  float* sg = sdq + warps * NQ;                          // (Yp, Xp) gradient
  const int tsize = (Ht + 2 * lattice::PAD) * Xp;
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(sg + tsize);  // table

  const int bgh = blockIdx.y;  // (b * G + g) * Hpg + h
  const int bg = bgh / Hpg;    // b * G + g
  const int g = bg % G;
  const int h = bgh - bg * Hpg;
  const int M = H * W;
  const int kb = blockIdx.x % nkb;
  const int chunk = blockIdx.x / nkb;
  const int strips = (M + SLOTS - 1) / SLOTS;
  const int s_begin = chunk * strips / qsplit;
  const int s_end = (chunk + 1) * strips / qsplit;
  const size_t tab = ((size_t)g * Hpg + h) * Ht * Wt;
  lattice::stage_padded(st, table + tab, 1, Ht, Wt, Xp);
  for (int i = threadIdx.x; i < tsize; i += blockDim.x) sg[i] = 0.0f;
  for (int i = threadIdx.x; i < warps * NQ; i += blockDim.x) sdq[i] = 0.0f;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // mma row group: keys gq and gq + 8
  const int tq = lane & 3;   // mma column pair: slots 8 tq .. 8 tq + 7
  const int key0 = kb * 16 * warps + warp * 16;
  const bool active = key0 < N;  // warp-uniform
  Key<CH> ka, kb8;
  load_key(ka, key0 + gq, N, bg, bgh, ys, ms, wy, fx, k, v, Xp);
  load_key(kb8, key0 + gq + 8, N, bg, bgh, ys, ms, wy, fx, k, v, Xp);
  // K as the B operand of dQ = dS^T K: keys 2 tq, 2 tq + 1 (and + 8), ch gq
  unsigned kfrag[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    unsigned lo = 0, hi = 0;
    const int n0 = key0 + 8 * r + 2 * tq;
    if (gq < CH && n0 < N) lo = bits(k[((size_t)bgh * N + n0) * CH + gq]);
    if (gq < CH && n0 + 1 < N)
      hi = bits(k[((size_t)bgh * N + n0 + 1) * CH + gq]);
    kfrag[r] = lo | (hi << 16);
  }
  float dkc[4] = {}, dvc[4] = {};
  float* mydq = sdq + warp * NQ;

  for (int s = s_begin; s <= s_end; ++s) {
    __syncthreads();  // the previous strip is consumed and its dq added
    for (int i = threadIdx.x; i < NQ; i += blockDim.x) {
      const int pos = i / CH;
      const int c = i - pos * CH;
      int iy;
      if (s > s_begin) {  // the previous strip's dq, summed over the warps
        float acc = 0.0f;
        for (int b = 0; b < warps; ++b) {
          acc += sdq[b * NQ + i];
          sdq[b * NQ + i] = 0.0f;
        }
        const int m = query_of(s - 1, pos, H, W, M, &iy);
        if (m >= 0) atomicAdd(dq + ((size_t)bgh * M + m) * CH + c, scale * acc);
      }
      if (s < s_end) {
        const int m = query_of(s, pos, H, W, M, &iy);
        const size_t e = ((size_t)bgh * M + (m < 0 ? 0 : m)) * CH + c;
        sq[i] = m < 0 ? 0.0f : bf(q[e]);
        sdo[i] = m < 0 ? 0.0f : round_bf16(dout[e]);
      }
    }
    if (s == s_end) break;
    for (int pos = threadIdx.x; pos < SLOTS; pos += blockDim.x) {
      int iy = 0;
      const int m = query_of(s, pos, H, W, M, &iy);
      float4 mt = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(INVALID));
      if (m >= 0) {
        const int ix = m - iy * W;
        const int off = iy * Xp + u0[ix];
        mt = make_float4(lse[(size_t)bgh * M + m] * LOG2E,
                         dsum[(size_t)bgh * M + m], gcomb[ix],
                         __int_as_float(iy == 0 ? ~off : off));
      }
      smeta[pos] = mt;
    }
    __syncthreads();
    if (!active) continue;

    unsigned dsa_prev = 0, dsb_prev = 0;
#pragma unroll
    for (int j = 0; j < SLOTS / 8; ++j) {
      float pr[2][2], dr[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = 8 * j + 2 * tq + e;
        const float4 mt = smeta[pos];
        const int ov = __float_as_int(mt.w);
        float qf[CH], dof[CH];
#pragma unroll
        for (int c = 0; c < CH; c += 4) {
          const float4 a = *reinterpret_cast<const float4*>(sq + pos * CH + c);
          const float4 b = *reinterpret_cast<const float4*>(sdo + pos * CH + c);
          qf[c] = a.x; qf[c + 1] = a.y; qf[c + 2] = a.z; qf[c + 3] = a.w;
          dof[c] = b.x; dof[c + 1] = b.y; dof[c + 2] = b.z; dof[c + 3] = b.w;
        }
        const bool first = j == 0 && e == 0;
        slot(ka, first, ov, mt.z, qf, dof, mt.x, mt.y, st, sg, Xp, scale,
             pr[0][e], dr[0][e]);
        slot(kb8, first, ov, mt.z, qf, dof, mt.x, mt.y, st, sg, Xp, scale,
             pr[1][e], dr[1][e]);
      }
      __syncwarp();
      // B operands: q and dO at this tile's columns 2 tq, 2 tq + 1, ch gq
      unsigned bq = 0, bdo = 0;
      if (gq < CH) {
        const int p0 = (8 * j + 2 * tq) * CH + gq;
        bq = lattice::pack2(sq[p0], sq[p0 + CH]);
        bdo = lattice::pack2(sdo[p0], sdo[p0 + CH]);
      }
      const unsigned pa = lattice::pack2(pr[0][0], pr[0][1]);
      const unsigned pb = lattice::pack2(pr[1][0], pr[1][1]);
      const unsigned dsa = lattice::pack2(dr[0][0], dr[0][1]);
      const unsigned dsb = lattice::pack2(dr[1][0], dr[1][1]);
      mma_k8(dvc, pa, pb, bdo);
      mma_k8(dkc, dsa, dsb, bq);
      if (j & 1) {  // dQ of tiles j - 1 and j: 16 query rows, 16 keys
        float c4[4] = {};
        mma_k16(c4, transpose8(dsa_prev), transpose8(dsa),
                transpose8(dsb_prev), transpose8(dsb), kfrag[0], kfrag[1]);
        if (2 * tq < CH) {
          float* d0 = mydq + (8 * (j - 1) + gq) * CH + 2 * tq;
          float* d1 = mydq + (8 * j + gq) * CH + 2 * tq;
          *reinterpret_cast<float2*>(d0) = make_float2(c4[0], c4[1]);
          *reinterpret_cast<float2*>(d1) = make_float2(c4[2], c4[3]);
        }
      }
      dsa_prev = dsa;
      dsb_prev = dsb;
    }
    close_run(ka, sg);
    close_run(kb8, sg);
  }

  // dk, dv: C tiles (keys gq, gq + 8; channels 2 tq, 2 tq + 1)
  if (active && 2 * tq < CH) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = key0 + gq + 8 * r;
      if (n < N) {
        const size_t o = ((size_t)bgh * N + n) * CH + 2 * tq;
        atomicAdd(dk + o, scale * dkc[2 * r]);
        atomicAdd(dk + o + 1, scale * dkc[2 * r + 1]);
        atomicAdd(dv + o, dvc[2 * r]);
        atomicAdd(dv + o + 1, dvc[2 * r + 1]);
      }
    }
  }
  // dwy, df: each key's sums over the four threads of its row group
  float sums[4] = {ka.a_wy, ka.a_f, kb8.a_wy, kb8.a_f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sums[i] += __shfl_xor_sync(0xffffffffu, sums[i], 1);
    sums[i] += __shfl_xor_sync(0xffffffffu, sums[i], 2);
  }
  if (tq == 0) {
    if (ka.valid) {
      atomicAdd(dwy + (size_t)bg * N + key0 + gq, sums[0]);
      atomicAdd(df + (size_t)bg * N + key0 + gq, sums[1]);
    }
    if (kb8.valid) {
      atomicAdd(dwy + (size_t)bg * N + key0 + gq + 8, sums[2]);
      atomicAdd(df + (size_t)bg * N + key0 + gq + 8, sums[3]);
    }
  }
  __syncthreads();
  lattice::flush_gradient(dtable + tab, sg, Ht, Wt, Xp);
}

template <int CH>
int launch(const void* table, const void* ys, const void* ms, const void* wy,
           const void* fx, const void* u0, const void* gcomb, const void* q,
           const void* k, const void* v, const void* dout, const void* lse,
           const void* dsum, void* dq, void* dk, void* dv, void* dtable,
           void* dwy, void* df, int B, int G, int Hpg, int Ht, int Wt, int Xp,
           int N, int H, int W, int warps, int nkb, int qsplit, float scale,
           cudaStream_t stream) {
  // every key in exactly one block: nkb blocks of 16 * warps keys, none empty
  if (warps < 1 || warps * 32 > MAX_THREADS || qsplit < 1 || nkb < 1 ||
      (size_t)nkb * 16 * warps < (size_t)N || (nkb - 1) * 16 * warps >= N)
    return (int)cudaErrorInvalidValue;
  const size_t tsize = (size_t)(Ht + 2 * lattice::PAD) * Xp;
  const size_t smem = tsize * (sizeof(float) + sizeof(__nv_bfloat16)) +
                      (size_t)SLOTS * (2 * CH + 4 + warps * CH) * sizeof(float);
  int rc = lattice::set_smem((const void*)fused_site_bwd_kernel<CH>, smem);
  if (rc) return rc;
  dim3 grid(nkb * qsplit, B * G * Hpg);
  fused_site_bwd_kernel<CH><<<grid, warps * 32, smem, stream>>>(
      (const __nv_bfloat16*)table, (const int*)ys, (const int*)ms,
      (const float*)wy, (const float*)fx, (const int*)u0,
      (const float*)gcomb, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)dout, (const float*)lse,
      (const float*)dsum, (float*)dq, (float*)dk, (float*)dv, (float*)dtable,
      (float*)dwy, (float*)df, G, Hpg, Ht, Wt, Xp, N, H, W, nkb, qsplit,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_site_bwd_launch(
    const void* table, const void* ys, const void* ms, const void* wy,
    const void* fx, const void* u0, const void* gcomb, const void* q,
    const void* k, const void* v, const void* dout, const void* lse,
    const void* dsum, void* dq, void* dk, void* dv, void* dtable, void* dwy,
    void* df, int B, int G, int Hpg, int Ht, int Wt, int Xp, int N, int H,
    int W, int ch, int warps, int nkb, int qsplit, float scale,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SITE_CASE(C)                                                        \
  case C:                                                                   \
    return launch<C>(table, ys, ms, wy, fx, u0, gcomb, q, k, v, dout, lse, \
                     dsum, dq, dk, dv, dtable, dwy, df, B, G, Hpg, Ht, Wt, \
                     Xp, N, H, W, warps, nkb, qsplit, scale, s);
  switch (ch) {
    SITE_CASE(4)
    SITE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SITE_CASE
}
