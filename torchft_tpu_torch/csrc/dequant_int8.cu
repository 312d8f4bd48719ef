// Kernel E: int8 dequantization for Hopper (sm_90a).
//
// Replaces torchft_tpu/ops/pallas_quant.py::_dequantize_kernel (the Pallas
// kernel launched by _dequantize_2d): out[r, c] = float(payload[r, c]) *
// scale[r], one correctly rounded product per element.
//
// Design: one CTA of 256 threads per row; each thread loads four codes at
// a time (char4) and stores four floats (float4) where the row is aligned,
// element by element where it is not.
//
// Bound on the H100: bytes.  1 B read and 4 B written per element, plus
// 4 B of scale per row: at the flagship DiLoCo fragment, a (25 348, 2048)
// matrix, 260 MB, ~78 us at 3.35 TB/s.

#include "quant_common.cuh"

namespace tft_quant {

__global__ void __launch_bounds__(kThreads)
    dequant_int8_kernel(const float* __restrict__ scales,
                        const signed char* __restrict__ payload,
                        float* __restrict__ out, int64_t cols) {
  const int64_t r = blockIdx.x;
  const float s = scales[r];
  const signed char* prow = payload + r * cols;
  float* orow = out + r * cols;
  const bool vec = aligned(prow, 4) && aligned(orow, 16);
  const int64_t n4 = vec ? cols / 4 : 0;
  const char4* p4 = reinterpret_cast<const char4*>(prow);
  float4* o4 = reinterpret_cast<float4*>(orow);
  for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
    const char4 c = p4[i];
    o4[i] = make_float4(__fmul_rn(static_cast<float>(c.x), s),
                        __fmul_rn(static_cast<float>(c.y), s),
                        __fmul_rn(static_cast<float>(c.z), s),
                        __fmul_rn(static_cast<float>(c.w), s));
  }
  for (int64_t i = 4 * n4 + threadIdx.x; i < cols; i += kThreads)
    orow[i] = __fmul_rn(static_cast<float>(prow[i]), s);
}

}  // namespace tft_quant

extern "C" int tft_dequant_int8(const void* scales, const void* payload,
                                void* out, int64_t rows, int64_t cols,
                                void* stream) {
  using namespace tft_quant;
  if (rows < 0 || cols < 0 || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || cols == 0) return 0;
  dequant_int8_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scales),
      static_cast<const signed char*>(payload), static_cast<float*>(out),
      cols);
  return static_cast<int>(cudaGetLastError());
}
