// Shared pieces of the int8 quantization kernels (quant_int8.cu,
// dequant_int8.cu, reduce_int8.cu): kernels D, E and F of the port.
//
// Wire semantics, those of torchft_tpu/ops/pallas_quant.py:64-97 and of the
// host codec: one f32 scale per row, scale = absmax / 127 (1 for a row whose
// absmax is not > 0), payload = clip(rint(x / scale), -127, 127) as int8.
//
// Bitwise agreement with the plain PyTorch twins (ops/pallas_quant.py) rests
// on IEEE arithmetic, so every operation is spelled as a correctly rounded
// intrinsic: __fdiv_rn for the divisions (never a reciprocal), __fmul_rn and
// __fadd_rn for the products and sums, which nvcc never contracts into an
// FMA.  rintf rounds half to even.  Build without --use_fast_math, so that
// denormals are neither flushed nor treated as zero.
//
// Layout: rows of `cols` contiguous elements, one CTA of kThreads threads
// per row (kernel F's one-pass branch: one warp per row).  The TPU kernels'
// 32-row tiles and 128-lane padding are layout artefacts of that machine
// and are not carried over: padding with zeros changes no absmax.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tft_quant {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInt8Max = 127.f;

// max that propagates NaN, like jnp.max (fmaxf would drop it)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Max of `v` over the CTA, returned to every thread.  `red` holds
// kWarps + 1 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
}

__device__ __forceinline__ float row_scale(float absmax) {
  return absmax > 0.f ? __fdiv_rn(absmax, kInt8Max) : 1.f;
}

__device__ __forceinline__ signed char q8(float x, float scale) {
  float v = rintf(__fdiv_rn(x, scale));
  v = fminf(fmaxf(v, -kInt8Max), kInt8Max);
  return static_cast<signed char>(static_cast<int>(v));
}

__host__ __device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace tft_quant
