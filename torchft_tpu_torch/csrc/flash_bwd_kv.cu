// Kernel B: FlashAttention-2 backward, dK and dV, for Hopper (sm_90a).
//
// Replaces torchft_tpu/ops/flash_attention.py::_bwd_kv_kernel (the first
// Pallas kernel launched by _bwd).  For one key/value block it walks the
// query blocks and accumulates
//   p  = exp(q . k^T * scale - lse)      (0 where the causal mask, at GLOBAL
//                                          positions, hides the pair)
//   dV += p^T . dO                       (p rounded to bf16)
//   dP  = dO . v^T
//   dS  = p * (dP - delta) * scale       (delta = rowsum(dO * O), given)
//   dK += dS^T . q                       (dS rounded to bf16)
//
// Bound on the H100: four D-long products per live (q, k) pair (s, dP,
// dV, dK), 51.6 GFLOP against ~151 MB read and written at the flagship
// shape (B*H = 48, T = 1024, D = 256, causal), so tensor-core operations
// bound it (~52 us at 989 TFLOP/s).  The first version was bound by
// shared memory instead: every product and both accumulators went through
// it in f32, with eight barriers per query block.
//
// Design: one CTA of 8 warps owns (b*h, a 64-row key/value block) and
// walks the 64-row query blocks in order from the first one the causal
// mask leaves live.  K and V are loaded once.  The dK and dV accumulators
// stay in registers for the whole walk: warp w owns key rows
// 16 * (w % 4) .. +15 and head-dim columns (w / 4) * DP / 2 .. +DP / 2 of
// both (128 registers a thread at DP = 256).  Q and dO blocks, with their
// lse and delta, are double-buffered with cp.async.  For each query block
// a warp computes S = Q K^T and dP = dO V^T for 16 queries x 32 keys in
// registers, forms P and dS there, and writes them once, as bf16, to
// swizzled shared memory: they are the transposed A operands of
// dV += P^T dO and dK += dS^T Q and are read back with ldmatrix.trans.
// Three barriers per query block.  209 KB of shared memory at DP = 256,
// one CTA per SM.  The first key blocks, which under the causal mask have
// the most live query blocks, launch first.
//
// No atomics: every dK/dV row is summed by one CTA in a fixed order, so
// the result is deterministic, as the JAX pair is.
//
// Head dim: DP is a template parameter, instantiated at 64, 128 and 256;
// a d below one of them runs the next one up, with the extra columns
// zero-filled on load and never stored.  p is formed as
// exp2f(s * scale * log2(e) - lse * log2(e)): a few f32 ulps of the
// exponent's argument, far below the bf16 rounding of p and dS.

#include "flash_mma.cuh"

namespace tft_flash {

constexpr int kKvBQ = 64;  // query rows per step
constexpr int kKvBK = 64;  // key rows per CTA

template <int DP>
constexpr size_t bwd_kv_smem_bytes() {
  return static_cast<size_t>(2 * kKvBK + 4 * kKvBQ) * DP * sizeof(bf16)  // K V, 2 x (Q dO)
         + 2 * static_cast<size_t>(kKvBQ) * kKvBK * sizeof(bf16)         // P dS
         + 2 * 2 * static_cast<size_t>(kKvBQ) * sizeof(float);           // 2 x (lse delta)
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int tq, int tk, int d,
                        float scale, float scale_log2, int causal, int q_off,
                        int k_off) {
  constexpr int BQ = kKvBQ, BK = kKvBK;
  constexpr int kSteps = DP / 16;   // 16-wide slices of the head dim
  constexpr int kNbD = DP / 16;     // 8-wide column tiles of a warp's dK, dV
  constexpr uint32_t kKvTile = BK * DP * sizeof(bf16);
  constexpr uint32_t kQTile = BQ * DP * sizeof(bf16);
  constexpr uint32_t kPTile = BQ * BK * sizeof(bf16);
  constexpr uint32_t kStat = 2 * BQ * sizeof(float);  // lse, then delta
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_k = smem_u32(smem);
  const uint32_t s_v = s_k + kKvTile;
  const uint32_t s_qd = s_v + kKvTile;         // [buffer][Q, dO]
  const uint32_t s_p = s_qd + 4 * kQTile;
  const uint32_t s_ds = s_p + kPTile;
  const uint32_t s_st = s_ds + kPTile;         // [buffer][lse, delta]
  const float* st_f = reinterpret_cast<const float*>(smem + (s_st - s_k));

  const int bh = blockIdx.x;
  const int kb = blockIdx.y;  // the first key blocks carry the most work
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // S and dP phase: 16 queries x 32 keys; dK and dV phase: 16 keys x DP/2
  const int wq = (warp & 3) * 16, wk = (warp >> 2) * 32;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * (DP / 2);

  const size_t k_row0 = static_cast<size_t>(bh) * tk + static_cast<size_t>(kb) * BK;
  const size_t q_base = static_cast<size_t>(bh) * tq;
  const int k_first = k_off + kb * BK;
  const int nq = tq / BQ;
  int i_start = 0;
  if (causal) {
    // the first query block whose last query reaches this block's first key
    const int need = k_first - q_off - (BQ - 1);
    i_start = need <= 0 ? 0 : min(nq, (need + BQ - 1) / BQ);
  }

  auto load_q_block = [&](int i, int buf) {
    const size_t row = q_base + static_cast<size_t>(i) * BQ;
    const uint32_t dst = s_qd + buf * 2 * kQTile;
    load_tile<BQ, DP>(dst, q + row * d, d);
    load_tile<BQ, DP>(dst + kQTile, dout + row * d, d);
    if (threadIdx.x < 2 * BQ / 4) {  // 16-byte chunks of lse, then delta
      const int c = threadIdx.x % (BQ / 4);
      const float* src = (threadIdx.x < BQ / 4 ? lse : delta) + row + 4 * c;
      cp_async16(s_st + buf * kStat + (threadIdx.x / (BQ / 4)) * BQ * 4 + 16 * c,
                 src, true);
    }
  };

  load_tile<BK, DP>(s_k, k + k_row0 * d, d);
  load_tile<BK, DP>(s_v, v + k_row0 * d, d);
  if (i_start < nq) load_q_block(i_start, 0);
  cp_async_commit();

  float acc_dk[kNbD][4], acc_dv[kNbD][4];
#pragma unroll
  for (int nb = 0; nb < kNbD; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[nb][e] = acc_dv[nb][e] = 0.0f;

  for (int i = i_start; i < nq; ++i) {
    const int buf = (i - i_start) & 1;
    if (i + 1 < nq) {
      load_q_block(i + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t s_q = s_qd + buf * 2 * kQTile;
    const uint32_t s_do = s_q + kQTile;

    // S = Q K^T and dP = dO V^T, 16 queries x 32 keys per warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a, s_q + tile_off<DP>(wq + a_row(lane), 2 * kk + a_chunk(lane)));
#pragma unroll
      for (int nb = 0; nb < 4; nb += 2) {
        ldsm_x4(b, s_k + tile_off<DP>(wk + 8 * nb + bn_row(lane), 2 * kk + bn_chunk(lane)));
        mma_bf16(s[nb], a, b[0], b[1]);
        mma_bf16(s[nb + 1], a, b[2], b[3]);
      }
      ldsm_x4(a, s_do + tile_off<DP>(wq + a_row(lane), 2 * kk + a_chunk(lane)));
#pragma unroll
      for (int nb = 0; nb < 4; nb += 2) {
        ldsm_x4(b, s_v + tile_off<DP>(wk + 8 * nb + bn_row(lane), 2 * kk + bn_chunk(lane)));
        mma_bf16(dp[nb], a, b[0], b[1]);
        mma_bf16(dp[nb + 1], a, b[2], b[3]);
      }
    }

    // P and dS in registers, written once to shared memory as bf16
    const int q_first = q_off + i * BQ;
    const bool mask = causal && q_first + wq < k_first + wk + 31;
    const float* st = st_f + buf * (kStat / sizeof(float));
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = st[wq + g + 8 * r] * kLog2e;
      dl[r] = st[BQ + wq + g + 8 * r];
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wq + g + (e >> 1) * 8;
        const int col = wk + nb * 8 + 2 * t + (e & 1);
        const bool hidden = mask && q_first + row < k_first + col;
        p[e] = hidden ? 0.0f : exp2f(s[nb][e] * scale_log2 - lse2[e >> 1]);
        ds[e] = p[e] * (dp[nb][e] - dl[e >> 1]) * scale;
      }
      const int col = wk + nb * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(smem + (s_p - s_k) + elem_off<BK>(wq + g, col)) =
          pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(smem + (s_p - s_k) + elem_off<BK>(wq + g + 8, col)) =
          pack_bf16(p[2], p[3]);
      *reinterpret_cast<uint32_t*>(smem + (s_ds - s_k) + elem_off<BK>(wq + g, col)) =
          pack_bf16(ds[0], ds[1]);
      *reinterpret_cast<uint32_t*>(smem + (s_ds - s_k) + elem_off<BK>(wq + g + 8, col)) =
          pack_bf16(ds[2], ds[3]);
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the block's 64 queries
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t a[4], b[4];
      ldsm_x4_t(a, s_p + tile_off<BK>(16 * kq + at_row(lane), wm / 8 + at_chunk(lane)));
#pragma unroll
      for (int nd = 0; nd < kNbD; nd += 2) {
        ldsm_x4_t(b, s_do + tile_off<DP>(16 * kq + bk_row(lane), wn / 8 + nd + bk_chunk(lane)));
        mma_bf16(acc_dv[nd], a, b[0], b[1]);
        mma_bf16(acc_dv[nd + 1], a, b[2], b[3]);
      }
      ldsm_x4_t(a, s_ds + tile_off<BK>(16 * kq + at_row(lane), wm / 8 + at_chunk(lane)));
#pragma unroll
      for (int nd = 0; nd < kNbD; nd += 2) {
        ldsm_x4_t(b, s_q + tile_off<DP>(16 * kq + bk_row(lane), wn / 8 + nd + bk_chunk(lane)));
        mma_bf16(acc_dk[nd], a, b[0], b[1]);
        mma_bf16(acc_dk[nd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // P, dS and this buffer are rewritten next
  }
  cp_async_wait<0>();  // K and V's copy, when no query block was live
  __syncthreads();

  // stage dK, dV (bf16) over K and V, then store whole chunks
  unsigned char* s_dk = smem;
  unsigned char* s_dv = smem + kKvTile;
#pragma unroll
  for (int nb = 0; nb < kNbD; ++nb) {
    const int col = wn + nb * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(s_dk + elem_off<DP>(wm + g, col)) =
        pack_bf16(acc_dk[nb][0], acc_dk[nb][1]);
    *reinterpret_cast<uint32_t*>(s_dk + elem_off<DP>(wm + g + 8, col)) =
        pack_bf16(acc_dk[nb][2], acc_dk[nb][3]);
    *reinterpret_cast<uint32_t*>(s_dv + elem_off<DP>(wm + g, col)) =
        pack_bf16(acc_dv[nb][0], acc_dv[nb][1]);
    *reinterpret_cast<uint32_t*>(s_dv + elem_off<DP>(wm + g + 8, col)) =
        pack_bf16(acc_dv[nb][2], acc_dv[nb][3]);
  }
  __syncthreads();
  store_tile<BK, DP>(dk + k_row0 * d, s_dk, d, threadIdx.x, kThreads);
  store_tile<BK, DP>(dv + k_row0 * d, s_dv, d, threadIdx.x, kThreads);
}

template <int DP>
int launch_bwd_kv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv,
                  int bh, int tq, int tk, int d, float scale, int causal,
                  int q_off, int k_off, cudaStream_t stream) {
  constexpr size_t smem = bwd_kv_smem_bytes<DP>();
  cudaError_t err = prepare(flash_bwd_kv_kernel<DP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, tk / kKvBK);
  flash_bwd_kv_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq, tk, d, scale,
      scale * kLog2e, causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tft_flash

extern "C" int tft_flash_bwd_kv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int tq, int tk, int d, float scale, int causal,
                                int q_off, int k_off, void* stream) {
  using namespace tft_flash;
  if (d <= 0 || d % 16 != 0 || d > 256 || tq % kKvBQ != 0 || tk % kKvBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || tk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(d)) {
    case 64:
      return launch_bwd_kv<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, causal, q_off, k_off, s);
    case 128:
      return launch_bwd_kv<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, causal, q_off, k_off, s);
    default:
      return launch_bwd_kv<256>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, causal, q_off, k_off, s);
  }
}
