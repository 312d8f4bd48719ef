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
// Bound on the H100: bytes.  n B read and 1 B written per element, plus
// 4(n + 1) B of scales per row: at n = 2 and a (25 348, 2048) matrix,
// 156 MB, ~47 us at 3.35 TB/s.  The first version read every shard twice
// (once for the absmax, once to requantize), four bytes a thread at a
// time; and per element it spent four conversions (two int-to-float, a
// rint and a float-to-int), which the SM issues at a fraction of its f32
// rate.
//
// Design, one pass: one warp per row, eight rows a CTA, and a grid of a
// few CTAs an SM whose warps walk the rows (r, r + step, ...).  Each lane
// reads its 16-byte chunks (16 codes each) of the row in every shard once,
// two shards in flight at a time, and keeps its acc values in registers:
// at most kLaneChunks chunks a lane, rows of up to 2048 codes (64 f32 a
// lane).  The absmax is a warp-shuffle max with nanmax, which does not
// depend on the order, so no shared memory and no barrier; lane 0 writes
// the scale, and each lane requantizes from its registers and stores 16
// codes at a time, while the next row's first two shards are already in
// flight.  Codes become floats, and rounded quotients codes, through
// exact f32 additions with 2^23-scale constants instead of the conversion
// unit (add_chunks, q8_low_byte).
//
// Rows wider than that, or rows whose codes are not 16-byte aligned, take
// the two-pass branch of the same kernel: one CTA of 256 threads per row,
// the n shard scales in shared memory; pass 1 forms acc and reduces |acc|
// across the CTA, pass 2 forms acc again, with the same operations in the
// same order, from the rows now in L1/L2, and stores four codes at a time.
// The host picks the branch for the whole launch; both give the twin's
// bits.

#include "quant_common.cuh"

namespace tft_quant {

constexpr int kLaneChunks = 4;  // 16-byte chunks of a row a lane holds
constexpr int64_t kOnePassCols = 32 * 16 * kLaneChunks;
constexpr int64_t kCtasPerSm = 8;  // of the one-pass grid: four waves of two

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

// The 16-byte chunks of a row that this lane holds (chunk lane + 32 c).
__device__ __forceinline__ void load_chunks(int4 (&buf)[kLaneChunks],
                                            const int4* __restrict__ src,
                                            int chunks, int lane) {
#pragma unroll
  for (int c = 0; c < kLaneChunks; ++c)
    if (lane + 32 * c < chunks) buf[c] = __ldcs(src + lane + 32 * c);
}

// acc (+)= float(code) * s for the 16 codes of each chunk.  A code is
// converted without the conversion unit: its byte, offset by 128, becomes
// the low mantissa bits of 2^23 (__byte_perm), and subtracting 2^23 + 128
// leaves float(code) exactly.
__device__ __forceinline__ void add_chunks(float (&acc)[kLaneChunks][16],
                                           const int4 (&buf)[kLaneChunks],
                                           float s, bool first, int chunks,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < kLaneChunks; ++c) {
    if (lane + 32 * c >= chunks) continue;
    const int w[4] = {buf[c].x ^ 0x80808080, buf[c].y ^ 0x80808080,
                      buf[c].z ^ 0x80808080, buf[c].w ^ 0x80808080};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float code = __fadd_rn(
          __int_as_float(__byte_perm(w[e >> 2], 0x4B000000, 0x7440 + (e & 3))),
          -8388736.0f);
      const float x = __fmul_rn(code, s);
      acc[c][e] = first ? x : __fadd_rn(acc[c][e], x);
    }
  }
}

// q8's code as the low byte of an int: x / scale clamped to +-127, then
// rounded half to even by adding 1.5 * 2^23 (exact for |v| < 2^22).
// Clamping before rounding gives rint-then-clamp's result, NaN included.
__device__ __forceinline__ int q8_low_byte(float x, float scale) {
  const float v = fminf(fmaxf(__fdiv_rn(x, scale), -kInt8Max), kInt8Max);
  return __float_as_int(__fadd_rn(v, 12582912.0f));
}

// Rows r, r + step, ... one per warp, every shard read once (the fast
// branch).  While a row is requantized, the first two shards of the next
// one are already in flight.
__device__ __forceinline__ void reduce_rows_one_pass(
    const float* __restrict__ scales, const signed char* __restrict__ payloads,
    float* __restrict__ out_scales, signed char* __restrict__ out_payload,
    int n, int64_t rows, int64_t cols, float inv, int64_t r, int64_t step,
    int lane) {
  const int chunks = static_cast<int>(cols / 16);
  const int64_t shard = rows * chunks;  // int4 units between shards
  const int4* base = reinterpret_cast<const int4*>(payloads);
  float acc[kLaneChunks][16];
  int4 b0[kLaneChunks], b1[kLaneChunks];  // shards k and k + 1
  float s0 = scales[r], s1 = 0.f;
  load_chunks(b0, base + r * chunks, chunks, lane);
  if (n > 1) {
    s1 = scales[rows + r];
    load_chunks(b1, base + shard + r * chunks, chunks, lane);
  }
  while (true) {
    const int4* p = base + r * chunks;
    for (int k = 0; k < n; k += 2) {
      add_chunks(acc, b0, s0, k == 0, chunks, lane);
      if (k + 2 < n) {
        s0 = scales[(k + 2) * rows + r];
        load_chunks(b0, p + (k + 2) * shard, chunks, lane);
      }
      if (k + 1 < n) {
        add_chunks(acc, b1, s1, false, chunks, lane);
        if (k + 3 < n) {
          s1 = scales[(k + 3) * rows + r];
          load_chunks(b1, p + (k + 3) * shard, chunks, lane);
        }
      }
    }
    const int64_t next = r + step;
    if (next < rows) {
      s0 = scales[next];
      load_chunks(b0, base + next * chunks, chunks, lane);
      if (n > 1) {
        s1 = scales[rows + next];
        load_chunks(b1, base + shard + next * chunks, chunks, lane);
      }
    }
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < kLaneChunks; ++c) {
      if (lane + 32 * c >= chunks) continue;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        acc[c][e] = __fmul_rn(acc[c][e], inv);
        m = nanmax(m, fabsf(acc[c][e]));
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float scale = row_scale(m);
    if (lane == 0) out_scales[r] = scale;
    int4* out = reinterpret_cast<int4*>(out_payload) + r * chunks;
#pragma unroll
    for (int c = 0; c < kLaneChunks; ++c) {
      if (lane + 32 * c >= chunks) continue;
      int w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* a = &acc[c][4 * i];
        w[i] = __byte_perm(
            __byte_perm(q8_low_byte(a[0], scale), q8_low_byte(a[1], scale), 0x0040),
            __byte_perm(q8_low_byte(a[2], scale), q8_low_byte(a[3], scale), 0x0040),
            0x5410);
      }
      out[lane + 32 * c] = make_int4(w[0], w[1], w[2], w[3]);
    }
    if (next >= rows) return;
    r = next;
  }
}

// One row per CTA, every shard read twice (the branch for wide or
// unaligned rows).
__device__ __forceinline__ void reduce_row_two_pass(
    const float* __restrict__ scales, const signed char* __restrict__ payloads,
    float* __restrict__ out_scales, signed char* __restrict__ out_payload,
    int n, int64_t rows, int64_t cols, float inv, int64_t r, float* sc,
    float* red) {
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

__global__ void __launch_bounds__(kThreads, 2)
    reduce_int8_kernel(const float* __restrict__ scales,
                       const signed char* __restrict__ payloads,
                       float* __restrict__ out_scales,
                       signed char* __restrict__ out_payload, int n,
                       int64_t rows, int64_t cols, float inv, int one_pass) {
  if (one_pass) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (r < rows)
      reduce_rows_one_pass(scales, payloads, out_scales, out_payload, n, rows,
                           cols, inv, r, static_cast<int64_t>(gridDim.x) * kWarps,
                           threadIdx.x & 31);
    return;
  }
  __shared__ float red[kWarps + 1];
  extern __shared__ float sc[];  // the n shard scales of this row
  reduce_row_two_pass(scales, payloads, out_scales, out_payload, n, rows, cols,
                      inv, blockIdx.x, sc, red);
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
  const bool one_pass = cols <= kOnePassCols && cols % 16 == 0 &&
                        aligned(payloads, 16) && aligned(out_payload, 16);
  int64_t blocks = rows;
  if (one_pass) {
    // a few CTAs an SM, each warp walking several rows
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * kCtasPerSm;
    blocks = (rows + kWarps - 1) / kWarps;
    if (blocks > cap) blocks = cap;
  }
  const size_t smem = one_pass ? 0 : static_cast<size_t>(n) * sizeof(float);
  reduce_int8_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scales),
      static_cast<const signed char*>(payloads),
      static_cast<float*>(out_scales), static_cast<signed char*>(out_payload),
      n, rows, cols, inv, one_pass ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
