// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_kv.cu, flash_bwd_q.cu).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B*H, T, D] bf16, row-major and
// contiguous; lse and delta are [B*H, T] f32.  T is a multiple of 128 and D
// a multiple of 16 of at most 256 (the Python wrappers check both).
//
// The register-tile helpers the three kernels build on (mma.sync, ldmatrix,
// cp.async, swizzled tiles) are in flash_mma.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tft_flash {

using bf16 = __nv_bfloat16;

// Masked score, as the JAX kernels' _NEG_INF.
constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Set the dynamic shared-memory ceiling, then report the launch's error.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace tft_flash
