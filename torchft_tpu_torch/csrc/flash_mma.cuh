// Register-tile helpers of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_kv.cu, flash_bwd_q.cu): warp-level mma.sync products, ldmatrix
// fragment loads and cp.async copies, written as PTX inline assembly for
// sm_90a.
//
// Fragments of mma.sync.m16n8k16 (bf16 in, f32 accumulate), per lane with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), four bf16x2 registers:
//     a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//     a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9];
//   B (16 x 8, K x N), two bf16x2 registers:
//     b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   C (16 x 8, f32): c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// The C layout of two neighbouring 8-column tiles is the A layout of one
// 16-column tile, so a score tile becomes the A operand of the next product
// without leaving registers (pack_bf16).
//
// Shared-memory tiles are rows of DP bf16 (DP = 64, 128 or 256) cut into
// 16-byte chunks; chunk c of row r is stored at chunk c ^ (r % 8) of that
// row.  The eight row addresses of one ldmatrix phase (eight rows at one
// logical chunk) then fall on eight distinct bank groups, and so do the
// bf16x2 stores of a C fragment.

#pragma once

#include "flash_common.cuh"

namespace tft_flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
// whose rows hold DP bf16.
template <int DP>
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
  return static_cast<uint32_t>((row * (DP / 8) + (chunk ^ (row & 7))) * 16);
}

// Byte offset of element (row, col) in the same tile.
template <int DP>
__device__ __forceinline__ uint32_t elem_off(int row, int col) {
  return tile_off<DP>(row, col >> 3) + static_cast<uint32_t>((col & 7) * 2);
}

// 16-byte asynchronous copy; with valid = false nothing is read and the
// 16 bytes are filled with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy ROWS rows of a [*, d] bf16 array (row stride d) into a swizzled
// tile of DP-wide rows; chunks at or past d / 8 are zero-filled.  All
// kThreads threads take part: thread i copies chunk i % (DP / 8) of rows
// i / (DP / 8) + it * kThreads / (DP / 8).  That step is a multiple of 8
// rows, so all of a thread's copies share one swizzle and one zero-fill
// test, and their destinations differ by immediates: the compiler holds a
// few registers for the copies, not one address per chunk.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int d) {
  constexpr int kChunks = DP / 8;
  constexpr int kStep = kThreads / kChunks;  // rows per pass
  static_assert(kStep % 8 == 0 && ROWS % kStep == 0, "tile not a pass multiple");
  const int row = threadIdx.x / kChunks, c = threadIdx.x % kChunks;
  const bool ok = c < (d >> 3);
  const uint32_t to = dst + tile_off<DP>(row, c);
  const bf16* from = src + row * d + c * 8;
#pragma unroll
  for (int it = 0; it < ROWS / kStep; ++it)
    cp_async16(to + it * kStep * DP * 2, ok ? from + it * kStep * d : src, ok);
}

// Copy the first d columns of ROWS rows of a swizzled tile out to a
// [*, d] bf16 array (row stride d), 16 bytes per thread per step.
template <int ROWS, int DP>
__device__ __forceinline__ void store_tile(bf16* dst, const unsigned char* src,
                                           int d, int tid, int nthreads) {
  const int valid = d >> 3;
  for (int idx = tid; idx < ROWS * valid; idx += nthreads) {
    const int row = idx / valid, c = idx % valid;
    *reinterpret_cast<uint4*>(dst + row * d + c * 8) =
        *reinterpret_cast<const uint4*>(src + tile_off<DP>(row, c));
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b for one 16 x 8 f32 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to nearest bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane addresses of the ldmatrix loads, for a 16 x 16 block at (r0, chunk
// c0) of a tile (c0 counts 16-byte chunks, i.e. 8 columns):
//   A operand, rows = M, cols = K (ldsm_x4):          a0..a3
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_chunk(int lane) { return lane >> 4; }
//   B operand of two 8-wide N tiles stored [N][K] (ldsm_x4): b0 b1 of the
//   first N tile, then b0 b1 of the second
__device__ __forceinline__ int bn_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int bn_chunk(int lane) { return (lane >> 3) & 1; }
//   B operand of two 8-wide N tiles stored [K][N] (ldsm_x4_t): the same
//   order
__device__ __forceinline__ int bk_row(int lane) {
  return (lane & 7) + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int bk_chunk(int lane) { return lane >> 4; }
//   A operand stored as its transpose [K][M] (ldsm_x4_t): a0..a3
__device__ __forceinline__ int at_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int at_chunk(int lane) { return (lane >> 3) & 1; }

// The head-dim width a kernel is instantiated at for a given d.
inline int padded_head_dim(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

}  // namespace tft_flash
