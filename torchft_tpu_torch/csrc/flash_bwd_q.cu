// Kernel C: FlashAttention-2 backward, dQ, for Hopper (sm_90a).
//
// Replaces torchft_tpu/ops/flash_attention.py::_bwd_q_kernel (the second
// Pallas kernel launched by _bwd).  For one query block it walks the
// key/value blocks and accumulates
//   p  = exp(q . k^T * scale - lse)      (0 where the causal mask, at GLOBAL
//                                          positions, hides the pair)
//   dP = dO . v^T
//   dS = p * (dP - delta) * scale        (delta = rowsum(dO * O), given)
//   dQ += dS . k                         (dS cast to the input type)
//
// Design: one CTA owns (b*h, a 64-row query block) and loops over 32-row
// key/value blocks in order, stopping at the first fully masked one (the
// TPU kernel's sequential grid axis becomes this loop).  No atomics, so
// the result is deterministic.  Shared memory holds Q, dO (64 x D) and
// K, V (32 x D) in bf16, the dQ accumulator (64 x D f32) and the 64 x 32
// score tiles: 181 KB at D = 256, one CTA per SM, eight warps, WMMA bf16
// 16x16x16 products.
//
// Bound on the H100: three D-long products per live (q, k) pair (s, dP,
// dQ): ~39 GFLOP against ~126 MB at the flagship shape, so tensor-core
// operations bound it in principle; this simple version is bound by
// shared-memory traffic and WMMA issue instead, and re-reads each key
// block once per query block.

#include "flash_common.cuh"

namespace tft_flash {

constexpr int kQBQ = 64;
constexpr int kQBK = 32;

inline size_t bwd_q_smem_bytes(int d) {
  return static_cast<size_t>(2 * kQBQ + 2 * kQBK) * d * sizeof(bf16)  // Q dO K V
         + static_cast<size_t>(kQBQ) * d * sizeof(float)              // dQ
         + static_cast<size_t>(2 * kQBQ) * kQBK * sizeof(float)       // S dP
         + static_cast<size_t>(kQBQ) * kQBK * sizeof(bf16)            // dS
         + 2 * kQBQ * sizeof(float);                                  // lse delta
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_q_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int tq, int tk, int d, float scale, int causal,
                       int q_off, int k_off) {
  constexpr int BQ = kQBQ, BK = kQBK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + BQ * d;
  bf16* ks = dos + BQ * d;
  bf16* vs = ks + BK * d;
  float* dqs = reinterpret_cast<float*>(vs + BK * d);
  float* ss = dqs + BQ * d;
  float* dps = ss + BQ * BK;
  bf16* dsb = reinterpret_cast<bf16*>(dps + BQ * BK);
  float* lse_s = reinterpret_cast<float*>(dsb + BQ * BK);
  float* dl_s = lse_s + BQ;

  const int bh = blockIdx.y;
  const int qb = blockIdx.x;
  const size_t q_row0 = static_cast<size_t>(bh) * tq + static_cast<size_t>(qb) * BQ;
  const bf16* kg = k + static_cast<size_t>(bh) * tk * d;
  const bf16* vg = v + static_cast<size_t>(bh) * tk * d;

  load_rows(qs, q + q_row0 * d, BQ, d);
  load_rows(dos, dout + q_row0 * d, BQ, d);
  fill(dqs, BQ * d, 0.0f);
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    lse_s[r] = lse[q_row0 + r];
    dl_s[r] = delta[q_row0 + r];
  }

  const int q_first = q_off + qb * BQ;
  const int q_last = q_first + BQ - 1;
  const int nk = tk / BK;
  for (int j = 0; j < nk; ++j) {
    const int k_first = k_off + j * BK;
    if (causal && k_first > q_last) break;
    __syncthreads();  // the previous block's tiles are no longer read
    load_rows(ks, kg + static_cast<size_t>(j) * BK * d, BK, d);
    load_rows(vs, vg + static_cast<size_t>(j) * BK * d, BK, d);
    __syncthreads();

    mm_abt(ss, BK, qs, d, ks, d, BQ, BK, d);    // S  = Q K^T
    mm_abt(dps, BK, dos, d, vs, d, BQ, BK, d);  // dP = dO V^T
    __syncthreads();

    for (int idx = threadIdx.x; idx < BQ * BK; idx += blockDim.x) {
      const int r = idx / BK, c = idx % BK;
      const bool masked = causal && (q_first + r < k_first + c);
      const float p = masked ? 0.0f : expf(ss[idx] * scale - lse_s[r]);
      dsb[idx] = __float2bfloat16(p * (dps[idx] - dl_s[r]) * scale);
    }
    __syncthreads();

    mm_acc<false>(dqs, d, dsb, BK, ks, d, BQ, d, BK);  // dQ += dS K
  }
  __syncthreads();

  store_rows(dq + q_row0 * d, dqs, BQ * d);
}

}  // namespace tft_flash

extern "C" int tft_flash_bwd_q(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int tq,
                               int tk, int d, float scale, int causal,
                               int q_off, int k_off, void* stream) {
  using namespace tft_flash;
  if (d % 16 != 0 || d > 256 || tq % kQBQ != 0 || tk % kQBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || tq == 0) return 0;
  const size_t smem = bwd_q_smem_bytes(d);
  cudaError_t err = prepare(flash_bwd_q_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(tq / kQBQ, bh);
  flash_bwd_q_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), tq, tk, d, scale, causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}
