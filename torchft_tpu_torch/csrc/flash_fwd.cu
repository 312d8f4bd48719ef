// Kernel A: FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces torchft_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// kernel launched by _fwd).  Computes, per (batch*head, query row):
//   s = (q . k^T) * scale, with causal masking at GLOBAL positions
//       (q_off + row >= k_off + col) to _NEG_INF = -1e30;
//   online softmax over key blocks with running m and l in f32, p rounded
//   to bf16 before p . v; a row with no live key so far gets p = 0, so an
//   all-masked row ends with O = 0 and lse = -1e30;
//   O = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// Bound on the H100: at the flagship shape (B*H = 48, T = 1024, D = 256,
// causal) the kernel reads q, k, v and writes o and lse (~100 MB) and does
// 25.8 GFLOP of tensor-core work, so bytes bound it (~30 us at 3.35 TB/s);
// the products, at the rate mma.sync reaches, come next.  What held the
// first version back was shared memory: every product went through it in
// f32, and the O tile was rescaled there.
//
// Design: one CTA of 8 warps owns (b*h, a 128-row query block); each warp
// owns 16 query rows.  Q is copied once into shared memory; K and V blocks
// of 64 keys are double-buffered with cp.async, so block j+1 is in flight
// while block j is computed.  S = Q K^T (16 x 64 per warp) accumulates in
// registers through mma.sync m16n8k16; the row max and sum are reduced
// across the four lanes that share a row; the O accumulator (16 x DP f32
// per warp, 128 registers at DP = 256) is rescaled in registers; P is
// packed to bf16 in registers and fed straight into P V, with V read by
// ldmatrix.trans.  Tiles are XOR-swizzled (flash_mma.cuh), so ldmatrix and
// cp.async are free of bank conflicts.  192 KB of shared memory at
// DP = 256, one CTA per SM.  The largest query blocks launch first, so the
// short ones fill the tail of the causal grid.  Under the causal mask only
// the blocks that straddle a warp's diagonal are masked element by
// element, and the loop stops at the first fully masked block.
//
// Head dim: DP is a template parameter, instantiated at 64, 128 and 256;
// a d below one of them runs the next one up, with the extra columns
// zero-filled on load and never stored.
//
// Exponentials: exp2f of s * scale * log2(e) - m, with scale * log2(e)
// folded into one factor; m and l are kept in base-2 units and lse is
// returned in natural-log units.  This changes the rounding of the
// exponent's argument by a few f32 ulps (relative error ~1e-6 in p),
// far below the bf16 rounding of p (2^-9) that the tolerances allow for.

#include "flash_mma.cuh"

namespace tft_flash {

constexpr int kFwdBQ = 128;  // query rows per CTA: 8 warps x 16
constexpr int kFwdBK = 64;   // keys per step

template <int DP>
constexpr size_t fwd_smem_bytes() {
  // Q, then two buffers of K and V
  return static_cast<size_t>(kFwdBQ + 4 * kFwdBK) * DP * sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, int d,
                     float scale_log2, int causal, int q_off, int k_off) {
  constexpr int BQ = kFwdBQ, BK = kFwdBK;
  constexpr int kSteps = DP / 16;      // 16-wide slices of the head dim
  constexpr int kNbS = BK / 8;         // 8-key column tiles of S
  constexpr int kNbO = DP / 8;         // 8-wide column tiles of O
  constexpr uint32_t kTile = BK * DP * sizeof(bf16);  // one K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_kv = s_q + BQ * DP * sizeof(bf16);  // [buffer][K, V]

  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // largest blocks first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;  // this warp's first row in the block

  const size_t q_row0 = static_cast<size_t>(bh) * tq + static_cast<size_t>(qb) * BQ;
  const bf16* kg = k + static_cast<size_t>(bh) * tk * d;
  const bf16* vg = v + static_cast<size_t>(bh) * tk * d;

  const int q_first = q_off + qb * BQ;
  const int w_first = q_first + row0;  // global position of row0
  const int nk = tk / BK;
  int n_iter = nk;
  if (causal) {
    // key blocks whose first key does not follow the block's last query
    const int span = q_first + BQ - 1 - k_off;
    n_iter = span < 0 ? 0 : min(nk, span / BK + 1);
  }

  load_tile<BQ, DP>(s_q, q + q_row0 * d, d);
  if (n_iter > 0) {
    load_tile<BK, DP>(s_kv, kg, d);
    load_tile<BK, DP>(s_kv + kTile, vg, d);
  }
  cp_async_commit();

  float acc[kNbO][4];
#pragma unroll
  for (int nb = 0; nb < kNbO; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;
  // rows g and g + 8 of this warp: running max (base 2) and this lane's
  // part of the running sum
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.0f, 0.0f};

  for (int j = 0; j < n_iter; ++j) {
    const uint32_t s_k = s_kv + (j & 1) * 2 * kTile;
    const uint32_t s_v = s_k + kTile;
    if (j + 1 < n_iter) {
      const uint32_t s_next = s_kv + ((j + 1) & 1) * 2 * kTile;
      const size_t off = static_cast<size_t>(j + 1) * BK * d;
      load_tile<BK, DP>(s_next, kg + off, d);
      load_tile<BK, DP>(s_next + kTile, vg + off, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T, 16 x 64 per warp
    float s[kNbS][4];
#pragma unroll
    for (int nb = 0; nb < kNbS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, s_q + tile_off<DP>(row0 + a_row(lane), 2 * kk + a_chunk(lane)));
#pragma unroll
      for (int nb = 0; nb < kNbS; nb += 2) {
        uint32_t b[4];
        ldsm_x4(b, s_k + tile_off<DP>(nb * 8 + bn_row(lane), 2 * kk + bn_chunk(lane)));
        mma_bf16(s[nb], a, b[0], b[1]);
        mma_bf16(s[nb + 1], a, b[2], b[3]);
      }
    }

    // scale to base 2, mask, online softmax
    const int k_first = k_off + j * BK;
#pragma unroll
    for (int nb = 0; nb < kNbS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] *= scale_log2;
    if (causal && w_first < k_first + BK - 1) {  // straddles the diagonal
#pragma unroll
      for (int nb = 0; nb < kNbS; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = w_first + g + (e >> 1) * 8;
          const int col = k_first + nb * 8 + 2 * t + (e & 1);
          if (row < col) s[nb][e] = kNegInf;
        }
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nb = 0; nb < kNbS; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
    }
    float corr[2], sub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      // a row with no live key so far: every s is exactly kNegInf, and
      // subtracting 0 instead of the max makes every p exactly 0
      sub[r] = mx[r] > kNegInf * 0.5f ? mx[r] : 0.0f;
    }
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nb = 0; nb < kNbS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - sub[e >> 1]);
        psum[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + psum[r];
#pragma unroll
    for (int nb = 0; nb < kNbO; ++nb) {
      acc[nb][0] *= corr[0];
      acc[nb][1] *= corr[0];
      acc[nb][2] *= corr[1];
      acc[nb][3] *= corr[1];
    }

    // O += P V: P from registers (bf16), V through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int nd = 0; nd < kNbO; nd += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, s_v + tile_off<DP>(16 * kc + bk_row(lane), nd + bk_chunk(lane)));
        mma_bf16(acc[nd], a, b[0], b[1]);
        mma_bf16(acc[nd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two steps on
  }
  cp_async_wait<0>();  // Q's copy, when no key block was live
  __syncthreads();

  // l = max(l, 1e-30) over the whole row; O = acc / l
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    l_r[r] = fmaxf(l_r[r], 1e-30f);
    inv[r] = 1.0f / l_r[r];
  }
  // stage O (bf16) in this warp's own Q rows, then store whole chunks
  unsigned char* s_o = smem;
#pragma unroll
  for (int nb = 0; nb < kNbO; ++nb) {
    const int col = nb * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(s_o + elem_off<DP>(row0 + g, col)) =
        pack_bf16(acc[nb][0] * inv[0], acc[nb][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(s_o + elem_off<DP>(row0 + g + 8, col)) =
        pack_bf16(acc[nb][2] * inv[1], acc[nb][3] * inv[1]);
  }
  __syncwarp();
  store_tile<16, DP>(o + (q_row0 + row0) * d, s_o + tile_off<DP>(row0, 0), d,
                     lane, 32);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_nat = m_r[r] > kNegInf * 0.5f ? m_r[r] * kLn2 : kNegInf;
      lse[q_row0 + row0 + g + 8 * r] = m_nat + logf(l_r[r]);
    }
  }
}

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int bh, int tq, int tk, int d, float scale_log2, int causal,
               int q_off, int k_off, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<DP>();
  cudaError_t err = prepare(flash_fwd_kernel<DP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, tq / kFwdBQ);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), tq, tk, d, scale_log2, causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tft_flash

extern "C" int tft_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk, int d,
                             float scale, int causal, int q_off, int k_off,
                             void* stream) {
  using namespace tft_flash;
  if (d <= 0 || d % 16 != 0 || d > 256 || tq % kFwdBQ != 0 || tk % kFwdBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || tq == 0) return 0;
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(d)) {
    case 64:
      return launch_fwd<64>(q, k, v, o, lse, bh, tq, tk, d, scale_log2, causal, q_off, k_off, s);
    case 128:
      return launch_fwd<128>(q, k, v, o, lse, bh, tq, tk, d, scale_log2, causal, q_off, k_off, s);
    default:
      return launch_fwd<256>(q, k, v, o, lse, bh, tq, tk, d, scale_log2, causal, q_off, k_off, s);
  }
}
