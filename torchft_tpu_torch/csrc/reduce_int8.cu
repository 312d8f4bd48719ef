// Kernel F: fused dequantize, sum, average and requantize of n int8 shards
// for Hopper (sm_90a).
//
// Replaces torchft_tpu/ops/pallas_quant.py::_reduce_kernel (the Pallas
// kernel launched by _reduce_2d).  Per row r and column c:
//   acc = sum over k = 0..n-1, in that order, of float(p[k, r, c]) * s[k, r]
//   acc = acc * inv          (inv = 1 / average_by, or 1)
// then acc is requantized by kernel D's rule into (scale[r], payload[r, :]).
// Each product and each sum is rounded on its own (__fmul_rn, __fadd_rn),
// as the plain twin computes them, so the two agree bit for bit.
//
// Design: one CTA of 256 threads per row; the n shard scales of the row sit
// in shared memory and the shards are summed in a loop inside the thread
// (the replica world is small).  Pass 1 forms acc and reduces |acc| across
// the CTA; pass 2 forms acc again, with the same operations in the same
// order, from the rows now in L1/L2, and stores four codes at a time.
//
// Bound on the H100: bytes.  n B read and 1 B written per element, plus
// 4(n + 1) B of scales per row: at n = 2 and a (25 348, 2048) matrix,
// 156 MB, ~47 us at 3.35 TB/s.

#include "quant_common.cuh"

namespace tft_quant {

__device__ __forceinline__ float acc_at(const signed char* __restrict__ p,
                                        const float* sc, int n,
                                        int64_t stride, int64_t idx,
                                        float inv) {
  float a = __fmul_rn(static_cast<float>(p[idx]), sc[0]);
  for (int k = 1; k < n; ++k)
    a = __fadd_rn(a, __fmul_rn(static_cast<float>(p[k * stride + idx]), sc[k]));
  return __fmul_rn(a, inv);
}

__device__ __forceinline__ float4 acc4_at(const signed char* __restrict__ p,
                                          const float* sc, int n,
                                          int64_t stride, int64_t idx,
                                          float inv) {
  char4 c = *reinterpret_cast<const char4*>(p + idx);
  float4 a = make_float4(__fmul_rn(static_cast<float>(c.x), sc[0]),
                         __fmul_rn(static_cast<float>(c.y), sc[0]),
                         __fmul_rn(static_cast<float>(c.z), sc[0]),
                         __fmul_rn(static_cast<float>(c.w), sc[0]));
  for (int k = 1; k < n; ++k) {
    c = *reinterpret_cast<const char4*>(p + k * stride + idx);
    a.x = __fadd_rn(a.x, __fmul_rn(static_cast<float>(c.x), sc[k]));
    a.y = __fadd_rn(a.y, __fmul_rn(static_cast<float>(c.y), sc[k]));
    a.z = __fadd_rn(a.z, __fmul_rn(static_cast<float>(c.z), sc[k]));
    a.w = __fadd_rn(a.w, __fmul_rn(static_cast<float>(c.w), sc[k]));
  }
  return make_float4(__fmul_rn(a.x, inv), __fmul_rn(a.y, inv),
                     __fmul_rn(a.z, inv), __fmul_rn(a.w, inv));
}

__global__ void __launch_bounds__(kThreads)
    reduce_int8_kernel(const float* __restrict__ scales,
                       const signed char* __restrict__ payloads,
                       float* __restrict__ out_scales,
                       signed char* __restrict__ out_payload, int n,
                       int64_t rows, int64_t cols, float inv) {
  __shared__ float red[kWarps + 1];
  extern __shared__ float sc[];  // the n shard scales of this row
  const int64_t r = blockIdx.x;
  for (int k = threadIdx.x; k < n; k += kThreads) sc[k] = scales[k * rows + r];
  __syncthreads();

  const int64_t stride = rows * cols;  // between shards
  const signed char* p = payloads + r * cols;
  signed char* out = out_payload + r * cols;
  const bool vec = aligned(payloads, 4) && aligned(out_payload, 4) &&
                   cols % 4 == 0;
  const int64_t n4 = vec ? cols / 4 : 0;

  float m = 0.f;
  for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
    const float4 a = acc4_at(p, sc, n, stride, 4 * i, inv);
    m = nanmax(m, fabsf(a.x));
    m = nanmax(m, fabsf(a.y));
    m = nanmax(m, fabsf(a.z));
    m = nanmax(m, fabsf(a.w));
  }
  for (int64_t i = 4 * n4 + threadIdx.x; i < cols; i += kThreads)
    m = nanmax(m, fabsf(acc_at(p, sc, n, stride, i, inv)));
  const float scale = row_scale(block_max(m, red));
  if (threadIdx.x == 0) out_scales[r] = scale;

  char4* out4 = reinterpret_cast<char4*>(out);
  for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
    const float4 a = acc4_at(p, sc, n, stride, 4 * i, inv);
    out4[i] = make_char4(q8(a.x, scale), q8(a.y, scale), q8(a.z, scale),
                         q8(a.w, scale));
  }
  for (int64_t i = 4 * n4 + threadIdx.x; i < cols; i += kThreads)
    out[i] = q8(acc_at(p, sc, n, stride, i, inv), scale);
}

}  // namespace tft_quant

extern "C" int tft_reduce_int8(const void* scales, const void* payloads,
                               void* out_scales, void* out_payload, int n,
                               int64_t rows, int64_t cols, float inv,
                               void* stream) {
  using namespace tft_quant;
  if (n < 1 || n > 4096 || rows < 0 || cols < 0 || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  reduce_int8_kernel<<<static_cast<unsigned>(rows), kThreads,
                       static_cast<size_t>(n) * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scales),
      static_cast<const signed char*>(payloads),
      static_cast<float*>(out_scales), static_cast<signed char*>(out_payload),
      n, rows, cols, inv);
  return static_cast<int>(cudaGetLastError());
}
