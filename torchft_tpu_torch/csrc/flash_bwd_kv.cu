// Kernel B: FlashAttention-2 backward, dK and dV, for Hopper (sm_90a).
//
// Replaces torchft_tpu/ops/flash_attention.py::_bwd_kv_kernel (the first
// Pallas kernel launched by _bwd).  For one key/value block it walks the
// query blocks and accumulates
//   p  = exp(q . k^T * scale - lse)      (0 where the causal mask, at GLOBAL
//                                          positions, hides the pair)
//   dV += p^T . dO                       (p cast to the input type)
//   dP  = dO . v^T
//   dS  = p * (dP - delta) * scale       (delta = rowsum(dO * O), given)
//   dK += dS^T . q                       (dS cast to the input type)
//
// Design: one CTA owns (b*h, a 32-row key/value block) and loops over the
// 64-row query blocks in order, starting at the first one the causal mask
// leaves live (the TPU kernel's sequential grid axis becomes this loop).
// No atomics: every dK/dV row is summed by exactly one CTA in a fixed
// order, so the result is deterministic, as the JAX pair is.  Shared
// memory holds K, V (32 x D), Q, dO (64 x D) in bf16, the dK and dV
// accumulators (32 x D f32) and the 64 x 32 score tiles: 185 KB at
// D = 256, one CTA per SM, eight warps, WMMA bf16 16x16x16 products.
//
// Bound on the H100: per live (q, k) pair this kernel does four D-long
// products (s, dV, dP, dK), so at the flagship shape it is bound by
// tensor-core operations in principle (~52 GFLOP against ~151 MB read and
// written); this simple version is bound by shared-memory traffic and
// WMMA issue instead, and re-reads each query block once per key block.

#include "flash_common.cuh"

namespace tft_flash {

constexpr int kKvBQ = 64;
constexpr int kKvBK = 32;

inline size_t bwd_kv_smem_bytes(int d) {
  return static_cast<size_t>(2 * kKvBK + 2 * kKvBQ) * d * sizeof(bf16)  // K V Q dO
         + static_cast<size_t>(2 * kKvBK) * d * sizeof(float)           // dK dV
         + static_cast<size_t>(2 * kKvBQ) * kKvBK * sizeof(float)       // S dP
         + static_cast<size_t>(2 * kKvBQ) * kKvBK * sizeof(bf16)        // P dS
         + 2 * kKvBQ * sizeof(float);                                   // lse delta
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int tq, int tk, int d,
                        float scale, int causal, int q_off, int k_off) {
  constexpr int BQ = kKvBQ, BK = kKvBK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BK * d;
  bf16* qs = vs + BK * d;
  bf16* dos = qs + BQ * d;
  float* dks = reinterpret_cast<float*>(dos + BQ * d);
  float* dvs = dks + BK * d;
  float* ss = dvs + BK * d;
  float* dps = ss + BQ * BK;
  bf16* pb = reinterpret_cast<bf16*>(dps + BQ * BK);
  bf16* dsb = pb + BQ * BK;
  float* lse_s = reinterpret_cast<float*>(dsb + BQ * BK);
  float* dl_s = lse_s + BQ;

  const int bh = blockIdx.y;
  const int kb = blockIdx.x;
  const size_t k_row0 = static_cast<size_t>(bh) * tk + static_cast<size_t>(kb) * BK;
  const size_t q_base = static_cast<size_t>(bh) * tq;

  load_rows(ks, k + k_row0 * d, BK, d);
  load_rows(vs, v + k_row0 * d, BK, d);
  fill(dks, BK * d, 0.0f);
  fill(dvs, BK * d, 0.0f);

  const int k_first = k_off + kb * BK;
  const int nq = tq / BQ;
  for (int i = 0; i < nq; ++i) {
    const int q_first = q_off + i * BQ;
    // every query of this block precedes every key of ours: nothing live
    if (causal && q_first + BQ - 1 < k_first) continue;
    __syncthreads();  // the previous block's tiles are no longer read
    const size_t q_row0 = q_base + static_cast<size_t>(i) * BQ;
    load_rows(qs, q + q_row0 * d, BQ, d);
    load_rows(dos, dout + q_row0 * d, BQ, d);
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      lse_s[r] = lse[q_row0 + r];
      dl_s[r] = delta[q_row0 + r];
    }
    __syncthreads();

    mm_abt(ss, BK, qs, d, ks, d, BQ, BK, d);    // S  = Q K^T
    mm_abt(dps, BK, dos, d, vs, d, BQ, BK, d);  // dP = dO V^T
    __syncthreads();

    for (int idx = threadIdx.x; idx < BQ * BK; idx += blockDim.x) {
      const int r = idx / BK, c = idx % BK;
      const bool masked = causal && (q_first + r < k_first + c);
      const float p = masked ? 0.0f : expf(ss[idx] * scale - lse_s[r]);
      pb[idx] = __float2bfloat16(p);
      dsb[idx] = __float2bfloat16(p * (dps[idx] - dl_s[r]) * scale);
    }
    __syncthreads();

    mm_acc<true>(dvs, d, pb, BK, dos, d, BK, d, BQ);  // dV += P^T dO
    mm_acc<true>(dks, d, dsb, BK, qs, d, BK, d, BQ);  // dK += dS^T Q
  }
  __syncthreads();

  store_rows(dk + k_row0 * d, dks, BK * d);
  store_rows(dv + k_row0 * d, dvs, BK * d);
}

}  // namespace tft_flash

extern "C" int tft_flash_bwd_kv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int tq, int tk, int d, float scale, int causal,
                                int q_off, int k_off, void* stream) {
  using namespace tft_flash;
  if (d % 16 != 0 || d > 256 || tq % kKvBQ != 0 || tk % kKvBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || tk == 0) return 0;
  const size_t smem = bwd_kv_smem_bytes(d);
  cudaError_t err = prepare(flash_bwd_kv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(tk / kKvBK, bh);
  flash_bwd_kv_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq, tk, d, scale, causal,
      q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}
