// Kernel A: FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces torchft_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// kernel launched by _fwd).  Computes, per (batch*head, query row):
//   s = (q . k^T) * scale, with causal masking at GLOBAL positions
//       (q_off + row >= k_off + col) to _NEG_INF = -1e30;
//   online softmax over key tiles with running m and l in f32, p cast to
//   the input type before p . v; a row with no live key so far gets p = 0,
//   so an all-masked row ends with O = 0 and lse ~ -inf;
//   O = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// Design: one CTA owns (b*h, a 64-row query block) and loops over 64-row
// key/value blocks in order (the TPU kernel's sequential grid axis becomes
// this loop), stopping at the first block that is fully masked.  Tiles:
// Q, K, V 64 x D bf16, the O accumulator 64 x D f32 and the score tile
// 64 x 64 f32 all live in shared memory: 185 KB at D = 256, one CTA per SM,
// eight warps.  Products are WMMA bf16 16x16x16 tiles with f32
// accumulation.
//
// Bound on the H100: at the flagship shape (B*H = 48, T = 1024, D = 256,
// causal) the kernel must read q, k, v and write o (~100 MB of bf16) and
// does ~26 GFLOP of tensor-core work, so bytes bound it (~30 us at
// 3.35 TB/s).  This version is far from that: each product goes through
// shared memory and the accumulator is rescaled there, so it is bound by
// shared-memory traffic and WMMA issue; the O tile stays on chip across
// the whole key loop, so device memory sees each q row once.

#include "flash_common.cuh"

namespace tft_flash {

constexpr int kFwdBQ = 64;
constexpr int kFwdBK = 64;

inline size_t fwd_smem_bytes(int d) {
  return static_cast<size_t>(kFwdBQ + 2 * kFwdBK) * d * sizeof(bf16)  // Q K V
         + static_cast<size_t>(kFwdBQ) * d * sizeof(float)              // O acc
         + static_cast<size_t>(kFwdBQ) * kFwdBK * sizeof(float)         // S
         + static_cast<size_t>(kFwdBQ) * kFwdBK * sizeof(bf16)          // P
         + 3 * kFwdBQ * sizeof(float);                                  // m l corr
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, int d,
                     float scale, int causal, int q_off, int k_off) {
  constexpr int BQ = kFwdBQ, BK = kFwdBK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BQ * d;
  bf16* vs = ks + BK * d;
  float* os = reinterpret_cast<float*>(vs + BK * d);
  float* ss = os + BQ * d;
  bf16* ps = reinterpret_cast<bf16*>(ss + BQ * BK);
  float* m_s = reinterpret_cast<float*>(ps + BQ * BK);
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int bh = blockIdx.y;
  const int qb = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_row0 = static_cast<size_t>(bh) * tq + static_cast<size_t>(qb) * BQ;
  const bf16* kg = k + static_cast<size_t>(bh) * tk * d;
  const bf16* vg = v + static_cast<size_t>(bh) * tk * d;

  load_rows(qs, q + q_row0 * d, BQ, d);
  fill(os, BQ * d, 0.0f);
  fill(m_s, BQ, kNegInf);
  fill(l_s, BQ, 0.0f);
  __syncthreads();

  const int q_first = q_off + qb * BQ;
  const int q_last = q_first + BQ - 1;
  const int nk = tk / BK;
  for (int j = 0; j < nk; ++j) {
    const int k_first = k_off + j * BK;
    // every key of this block (and of each later one) follows every query
    if (causal && k_first > q_last) break;
    load_rows(ks, kg + static_cast<size_t>(j) * BK * d, BK, d);
    load_rows(vs, vg + static_cast<size_t>(j) * BK * d, BK, d);
    __syncthreads();

    mm_abt(ss, BK, qs, d, ks, d, BQ, BK, d);  // S = Q K^T
    __syncthreads();

    // Online softmax: a warp takes whole rows, a lane two columns.
    for (int r = warp; r < BQ; r += kWarps) {
      const int rq = q_first + r;
      float s0 = ss[r * BK + lane] * scale;
      float s1 = ss[r * BK + lane + 32] * scale;
      if (causal) {
        if (rq < k_first + lane) s0 = kNegInf;
        if (rq < k_first + lane + 32) s1 = kNegInf;
      }
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      // a row with zero live keys so far keeps p = 0 (not exp(0) = 1)
      const bool live = m_new > kNegInf * 0.5f;
      const float p0 = live ? expf(s0 - m_new) : 0.0f;
      const float p1 = live ? expf(s1 - m_new) : 0.0f;
      float psum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      ps[r * BK + lane] = __float2bfloat16(p0);
      ps[r * BK + lane + 32] = __float2bfloat16(p1);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < BQ * d; i += blockDim.x) os[i] *= c_s[i / d];
    __syncthreads();

    mm_acc<false>(os, d, ps, BK, vs, d, BQ, d, BK);  // O += P V
    __syncthreads();
  }

  bf16* og = o + q_row0 * d;
  for (int i = threadIdx.x; i < BQ * d; i += blockDim.x)
    og[i] = __float2bfloat16(os[i] / fmaxf(l_s[i / d], 1e-30f));
  for (int r = threadIdx.x; r < BQ; r += blockDim.x)
    lse[q_row0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

}  // namespace tft_flash

extern "C" int tft_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk, int d,
                             float scale, int causal, int q_off, int k_off,
                             void* stream) {
  using namespace tft_flash;
  if (d % 16 != 0 || d > 256 || tq % kFwdBQ != 0 || tk % kFwdBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || tq == 0) return 0;
  const size_t smem = fwd_smem_bytes(d);
  cudaError_t err = prepare(flash_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(tq / kFwdBQ, bh);
  flash_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), tq, tk, d, scale, causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}
