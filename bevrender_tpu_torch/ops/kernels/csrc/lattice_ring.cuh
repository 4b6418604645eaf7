// Shared pieces of the window-prefetch kernels (fused_site_wide_prefetch.cu,
// lattice_bias_wide_prefetch.cu): a pitched zero-padded copy of the rpe
// table, and the cp.async instructions that fill a ring of key windows in
// shared memory from it.
//
// Raw table rows are Wt = 2 W d - 1 bf16 long (odd), so a key's window may
// start at any 2-byte offset and a 16-byte copy at a table edge would pick
// up the neighbouring row. The launch therefore first copies the table into
// a zero-padded one (PAD rows above and below, PAD columns on the left,
// zeros to the right) whose row pitch Xs is a multiple of 8 elements: a
// window row then starts in the 16-byte chunk that holds column ms & ~7,
// every chunk is aligned, and the padding replaces the bounds checks. The
// copy is the JAX package's _stage_table in spirit: 0.05-0.9 MB a call.
#pragma once

#include "lattice_common.cuh"

namespace lattice {

// One 16-byte copy from device memory into shared memory that completes
// asynchronously (cached in L2 only); both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// One copy of BYTES (4, 8 or 16) from device memory into shared memory that
// completes asynchronously (cached in L1 and L2); both addresses aligned to
// BYTES.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "4, 8 or 16 bytes");
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(BYTES)
               : "memory");
}

// Close this thread's copies issued since the last commit into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in
// flight. The block still needs a __syncthreads before it reads what the
// other threads copied.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst (heads, Ht + 2 PAD, Xs) = the zero-padded src (heads, Ht, Wt).
__global__ void pitch_table_kernel(__nv_bfloat16* __restrict__ dst,
                                   const __nv_bfloat16* __restrict__ src,
                                   int heads, int Ht, int Wt, int Xs) {
  const int Yp = Ht + 2 * PAD;
  const size_t total = (size_t)heads * Yp * Xs;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / Xs;
    const int c = (int)(i - row * Xs) - PAD;
    const int h = (int)(row / Yp);
    const int r = (int)(row - (size_t)h * Yp) - PAD;
    dst[i] = ((unsigned)r < (unsigned)Ht && (unsigned)c < (unsigned)Wt)
                 ? src[((size_t)h * Ht + r) * Wt + c]
                 : __float2bfloat16_rn(0.0f);
  }
}

inline int pitch_table(void* dst, const void* src, int heads, int Ht, int Wt,
                       int Xs, cudaStream_t stream) {
  const size_t total = (size_t)heads * (Ht + 2 * PAD) * Xs;
  const int blocks = (int)((total + 255) / 256 < 2048 ? (total + 255) / 256
                                                       : 2048);
  pitch_table_kernel<<<blocks, 256, 0, stream>>>(
      (__nv_bfloat16*)dst, (const __nv_bfloat16*)src, heads, Ht, Wt, Xs);
  return (int)cudaGetLastError();
}

// Start, with the whole block, the copies of the windows of `nk` keys whose
// starts are ys[j], ms[j] (padded coordinates, device memory): for key j,
// `rows` rows of the pitched table `tp` (pitch Xs) from row ys[j] + y_off,
// each the CW / 8 chunks from the one that holds column ms[j], into
// dst + j * key_pitch (row pitch CW). Key j's column ms[j] + c then sits at
// column (ms[j] & 7) + c of its window. The caller commits and waits.
__device__ __forceinline__ void copy_windows(
    __nv_bfloat16* dst, int key_pitch, const __nv_bfloat16* __restrict__ tp,
    int Xs, const int* __restrict__ ys, const int* __restrict__ ms, int nk,
    int y_off, int rows, int CW) {
  const int nch = CW >> 3;
  const int per_key = rows * nch;
  for (int i = threadIdx.x; i < nk * per_key; i += blockDim.x) {
    const int j = i / per_key;
    const int rem = i - j * per_key;
    const int r = rem / nch;
    const int c = (rem - r * nch) << 3;
    const __nv_bfloat16* src =
        tp + (size_t)(__ldg(ys + j) + y_off + r) * Xs + (__ldg(ms + j) & ~7) + c;
    cp_async16(dst + j * key_pitch + r * CW + c, src);
  }
}

}  // namespace lattice
