// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_kv.cu, flash_bwd_q.cu).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B*H, T, D] bf16, row-major and
// contiguous; lse and delta are [B*H, T] f32.  T is a multiple of 128 and D
// a multiple of 16 of at most 256 (the Python wrappers check both).
//
// The WMMA helpers below (16x16x16 bf16 tiles with f32 accumulation,
// staged through shared memory) are kernel C's; kernels A and B keep their
// tiles in registers with the helpers of flash_mma.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tft_flash {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// Masked score, as the JAX kernels' _NEG_INF.
constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Copy `rows` contiguous rows of `d` bf16 from device memory into shared
// memory, 16 bytes per thread per step (d % 8 == 0, 16-byte aligned).
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int rows,
                                          int d) {
  const int total = rows * d / 8;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* t = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < total; i += blockDim.x) t[i] = s[i];
}

__device__ __forceinline__ void fill(float* dst, int n, float value) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = value;
}

// Write an f32 shared tile out as bf16 rows.
__device__ __forceinline__ void store_rows(bf16* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

// C[rows x cols] (f32, ld ldc) = A[rows x kdim] . B^T where A is row-major
// bf16 (ld lda) and B is [cols x kdim] row-major bf16 (ld ldb): the
// "q k^T" shape.  Each warp takes whole 16x16 output tiles.
__device__ __forceinline__ void mm_abt(float* c, int ldc, const bf16* a,
                                       int lda, const bf16* b, int ldb,
                                       int rows, int cols, int kdim) {
  const int warp = threadIdx.x / 32;
  const int tiles_n = cols / 16;
  for (int t = warp; t < (rows / 16) * tiles_n; t += kWarps) {
    const int tm = t / tiles_n, tn = t % tiles_n;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < kdim; kk += 16) {
      FragA fa;
      FragBT fb;
      wmma::load_matrix_sync(fa, a + tm * 16 * lda + kk, lda);
      wmma::load_matrix_sync(fb, b + tn * 16 * ldb + kk, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + tm * 16 * ldc + tn * 16, acc, ldc,
                            wmma::mem_row_major);
  }
}

// C[rows x cols] (f32 in shared memory, ld ldc) += A . B where A is
// [rows x kdim] bf16, row-major (ld lda) or, with kTransA, stored as its
// transpose [kdim x rows] (ld lda); B is [kdim x cols] row-major (ld ldb).
template <bool kTransA>
__device__ __forceinline__ void mm_acc(float* c, int ldc, const bf16* a,
                                       int lda, const bf16* b, int ldb,
                                       int rows, int cols, int kdim) {
  const int warp = threadIdx.x / 32;
  const int tiles_n = cols / 16;
  for (int t = warp; t < (rows / 16) * tiles_n; t += kWarps) {
    const int tm = t / tiles_n, tn = t % tiles_n;
    FragC acc;
    wmma::load_matrix_sync(acc, c + tm * 16 * ldc + tn * 16, ldc,
                           wmma::mem_row_major);
    for (int kk = 0; kk < kdim; kk += 16) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + kk * ldb + tn * 16, ldb);
      if (kTransA) {
        FragAT fa;
        wmma::load_matrix_sync(fa, a + kk * lda + tm * 16, lda);
        wmma::mma_sync(acc, fa, fb, acc);
      } else {
        FragA fa;
        wmma::load_matrix_sync(fa, a + tm * 16 * lda + kk, lda);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(c + tm * 16 * ldc + tn * 16, acc, ldc,
                            wmma::mem_row_major);
  }
}

// Set the dynamic shared-memory ceiling, then report the launch's error.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace tft_flash
