// Kernel D: per-row absmax and int8 quantization for Hopper (sm_90a).
//
// Replaces torchft_tpu/ops/pallas_quant.py::_quantize_kernel (the Pallas
// kernel launched by _quantize_2d).  Per row of an f32 (rows, cols) matrix:
// scale = absmax / 127 (1 for an all-zero row), payload =
// clip(rint(x / scale), -127, 127) as int8.  The scales and the payload are
// the host wire format's, byte for byte, so a chunk of them is copied
// straight into a packed wire buffer.
//
// Design: one CTA of 256 threads per row.  Pass 1 reads the row (float4
// loads where the row is 16-byte aligned, scalar otherwise) and reduces
// |x| with warp shuffles and then across the eight warps in shared memory;
// thread 0 writes the scale.  Pass 2 reads the row again, now from L1/L2
// (a flagship row is 8 KB), and stores four int8 codes per thread per step.
//
// Bound on the H100: bytes.  Each element is read once (4 B) and written
// once (1 B), plus 4 B of scale per row: at the flagship DiLoCo fragment,
// a (25 348, 2048) matrix, that is 260 MB, ~78 us at 3.35 TB/s.  The
// second read of a row hits the cache and does not count against device
// memory.

#include "quant_common.cuh"

namespace tft_quant {

__global__ void __launch_bounds__(kThreads)
    quant_int8_kernel(const float* __restrict__ x, float* __restrict__ scales,
                      signed char* __restrict__ payload, int64_t cols) {
  __shared__ float red[kWarps + 1];
  const int64_t r = blockIdx.x;
  const float* row = x + r * cols;
  signed char* out = payload + r * cols;
  const bool vec = aligned(row, 16) && aligned(out, 4);
  const int64_t n4 = vec ? cols / 4 : 0;
  const float4* row4 = reinterpret_cast<const float4*>(row);

  float m = 0.f;
  for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
    const float4 v = row4[i];
    m = nanmax(m, fabsf(v.x));
    m = nanmax(m, fabsf(v.y));
    m = nanmax(m, fabsf(v.z));
    m = nanmax(m, fabsf(v.w));
  }
  for (int64_t i = 4 * n4 + threadIdx.x; i < cols; i += kThreads)
    m = nanmax(m, fabsf(row[i]));
  const float scale = row_scale(block_max(m, red));
  if (threadIdx.x == 0) scales[r] = scale;

  char4* out4 = reinterpret_cast<char4*>(out);
  for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
    const float4 v = row4[i];
    out4[i] = make_char4(q8(v.x, scale), q8(v.y, scale), q8(v.z, scale),
                         q8(v.w, scale));
  }
  for (int64_t i = 4 * n4 + threadIdx.x; i < cols; i += kThreads)
    out[i] = q8(row[i], scale);
}

}  // namespace tft_quant

extern "C" int tft_quant_int8(const void* x, void* scales, void* payload,
                              int64_t rows, int64_t cols, void* stream) {
  using namespace tft_quant;
  if (rows < 0 || cols < 0 || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  quant_int8_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(scales),
      static_cast<signed char*>(payload), cols);
  return static_cast<int>(cudaGetLastError());
}
