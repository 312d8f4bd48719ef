// Kernel C: FlashAttention-2 backward, dQ, for Hopper (sm_90a).
//
// Replaces torchft_tpu/ops/flash_attention.py::_bwd_q_kernel (the second
// Pallas kernel launched by _bwd).  For one query block it walks the
// key/value blocks in order and accumulates
//   p  = exp(q . k^T * scale - lse)      (0 where the causal mask, at GLOBAL
//                                          positions, hides the pair)
//   dP = dO . v^T
//   dS = p * (dP - delta) * scale        (delta = rowsum(dO * O), given)
//   dQ += dS . k                         (dS rounded to bf16)
//
// Bound on the H100: three D-long products per live (q, k) pair (s, dP,
// dQ), 38.7 GFLOP against ~126 MB read and written at the flagship shape
// (B*H = 48, T = 1024, D = 256, causal), so tensor-core operations bound
// it (~39 us at 989 TFLOP/s).  The first version was bound by shared
// memory instead: WMMA tiles sent S and dP out to shared memory in f32,
// and the 64 x D f32 dQ accumulator was loaded and stored there on every
// key block.
//
// Design: kernel A's with the roles of O and dQ swapped.  One CTA of 8
// warps owns (b*h, a 128-row query block); warp w owns query rows
// 16w .. 16w + 15 and the whole DP-wide dQ accumulator of those rows in
// registers (16 x DP f32 a warp, 128 registers a thread at DP = 256).  Q
// and dO are copied once into swizzled shared memory with cp.async and
// their A-operand fragments are reloaded with ldmatrix at each 16-wide
// slice of the head dim.  K and V come in blocks of 32 keys,
// double-buffered with cp.async.  For each key block a warp computes
// S = Q K^T and dP = dO V^T for its 16 x 32 tile through mma.sync
// m16n8k16, forms p and dS there, packs dS to bf16 in registers (the C
// layout of two 8-key tiles is the A layout of one 16-key slice) and
// feeds it straight into dQ += dS K, with K read by ldmatrix.trans as the
// B operand.  dS never goes through shared memory: one barrier per key
// block, for the buffer swap.  Q, dO and two buffers of K and V take
// 192 KB of shared memory at DP = 256, one CTA per SM.
//
// Registers: the dQ accumulator takes 128 of a thread's 255 at DP = 256
// and S and dP 32 more, so the addresses are kept few: each lane holds
// its swizzled ldmatrix offsets for four chunk pairs per operand layout
// (the rest are immediates), and each thread's share of a K or V block
// copy is worked out once (load_tile).  ptxas then fits the DP = 256
// kernel in 247 registers with no spill (every variant that kept one
// address per chunk spilled).
//
// Causal mask: only a warp whose 16 rows straddle the key block's
// diagonal at the global offsets masks element by element; a warp whose
// rows all precede the block's first key skips the block's products; the
// loop stops at the first key block that the whole query block precedes.
// A row that sees no key has every p exactly 0 and so dQ exactly 0.  The
// query blocks with the most live key blocks (the last ones) launch
// first, so the short ones fill the tail of the grid.
//
// No atomics: each dQ row is summed by one warp in a fixed order, so two
// launches on the same inputs give the same bits.
//
// Head dim: DP is a template parameter, instantiated at 64, 128 and 256;
// a d below one of them runs the next one up, with the extra columns
// zero-filled on load and never stored.  p is formed as
// exp2f(s * scale * log2(e) - lse * log2(e)), as in A and B: a few f32
// ulps of the exponent's argument, far below the bf16 rounding of dS.

#include "flash_mma.cuh"

namespace tft_flash {

constexpr int kQBQ = 128;  // query rows per CTA: 8 warps x 16
constexpr int kQBK = 32;   // keys per step

template <int DP>
constexpr size_t bwd_q_smem_bytes() {
  // Q and dO, then two buffers of K and V
  return static_cast<size_t>(2 * kQBQ + 4 * kQBK) * DP * sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_q_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int tq, int tk, int d, float scale, float scale_log2,
                       int causal, int q_off, int k_off) {
  constexpr int BQ = kQBQ, BK = kQBK;
  constexpr int kSteps = DP / 16;  // 16-wide slices of the head dim
  constexpr int kNbS = BK / 8;     // 8-key column tiles of S and dP
  constexpr int kNbQ = DP / 8;     // 8-wide column tiles of dQ
  constexpr uint32_t kRow = DP * sizeof(bf16);          // one tile row
  constexpr uint32_t kQTile = BQ * kRow;                // Q or dO
  constexpr uint32_t kTile = BK * kRow;                 // one K or V block
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_do = s_q + kQTile;
  const uint32_t s_kv = s_do + kQTile;  // [buffer][K, V]

  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // most live key blocks first
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
  load_tile<BQ, DP>(s_do, dout + q_row0 * d, d);
  if (n_iter > 0) {
    load_tile<BK, DP>(s_kv, kg, d);
    load_tile<BK, DP>(s_kv + kTile, vg, d);
  }
  cp_async_commit();

  // rows g and g + 8 of this warp: lse in base-2 units, and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse[q_row0 + row0 + g + 8 * r] * kLog2e;
    dl[r] = delta[q_row0 + row0 + g + 8 * r];
  }

  // This lane's ldmatrix addresses.  Every 16 x 16 block it loads starts
  // on a row that is a multiple of 8, so the swizzle acts on the low three
  // bits of the chunk index only: chunk 8m + c (c < 8) of the lane's row
  // is stored at 8m + (c ^ lane % 8).  The byte offsets of c = 2i and
  // 2i + 1 within the block's rows are held for i = 0..3 (A operand, B
  // operand stored [N][K], B operand stored [K][N]); 8m is an immediate.
  // Otherwise the compiler keeps one address per chunk in registers.
  uint32_t a_off[4], b_off[4], bt_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a_off[i] = a_row(lane) * kRow + 16 * ((2 * i + a_chunk(lane)) ^ (lane & 7));
    b_off[i] = bn_row(lane) * kRow + 16 * ((2 * i + bn_chunk(lane)) ^ (lane & 7));
    bt_off[i] = bk_row(lane) * kRow + 16 * ((2 * i + bk_chunk(lane)) ^ (lane & 7));
  }

  float acc[kNbQ][4];
#pragma unroll
  for (int nb = 0; nb < kNbQ; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;

  for (int j = 0; j < n_iter; ++j) {
    // block j has landed, and every warp is done with block j - 1, whose
    // buffer now takes block j + 1
    cp_async_wait<0>();
    __syncthreads();
    const uint32_t s_k = s_kv + (j & 1) * 2 * kTile;
    const uint32_t s_v = s_k + kTile;
    if (j + 1 < n_iter) {
      const uint32_t s_next = s_kv + ((j + 1) & 1) * 2 * kTile;
      const size_t off = static_cast<size_t>(j + 1) * BK * d;
      load_tile<BK, DP>(s_next, kg + off, d);
      load_tile<BK, DP>(s_next + kTile, vg + off, d);
      cp_async_commit();
    }

    const int k_first = k_off + j * BK;
    if (causal && w_first + 15 < k_first) continue;  // no row sees a key

    // S = Q K^T and dP = dO V^T, 16 x 32 per warp
    float s[kNbS][4], dp[kNbS][4];
#pragma unroll
    for (int nb = 0; nb < kNbS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t a_at = row0 * kRow + a_off[kk & 3] + (kk >> 2) * 128;
      const uint32_t b_at = b_off[kk & 3] + (kk >> 2) * 128;
      uint32_t a[4], b[4];
      ldsm_x4(a, s_q + a_at);
#pragma unroll
      for (int nb = 0; nb < kNbS; nb += 2) {
        ldsm_x4(b, s_k + nb * 8 * kRow + b_at);
        mma_bf16(s[nb], a, b[0], b[1]);
        mma_bf16(s[nb + 1], a, b[2], b[3]);
      }
      ldsm_x4(a, s_do + a_at);
#pragma unroll
      for (int nb = 0; nb < kNbS; nb += 2) {
        ldsm_x4(b, s_v + nb * 8 * kRow + b_at);
        mma_bf16(dp[nb], a, b[0], b[1]);
        mma_bf16(dp[nb + 1], a, b[2], b[3]);
      }
    }

    // p and dS in registers; dS packed to bf16 as the A operand of dS K
    const bool mask = causal && w_first < k_first + BK - 1;  // straddles
    uint32_t ds_a[BK / 16][4];
#pragma unroll
    for (int nb = 0; nb < kNbS; ++nb) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = w_first + g + (e >> 1) * 8;
        const int col = k_first + nb * 8 + 2 * t + (e & 1);
        const bool hidden = mask && row < col;
        const float p = hidden ? 0.0f : exp2f(s[nb][e] * scale_log2 - lse2[e >> 1]);
        ds[e] = p * (dp[nb][e] - dl[e >> 1]) * scale;
      }
      ds_a[nb >> 1][(nb & 1) * 2] = pack_bf16(ds[0], ds[1]);
      ds_a[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K: K through ldmatrix.trans as the B operand
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int nd = 0; nd < kNbQ; nd += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, s_k + 16 * kc * kRow + bt_off[(nd >> 1) & 3] + (nd >> 3) * 128);
        mma_bf16(acc[nd], ds_a[kc], b[0], b[1]);
        mma_bf16(acc[nd + 1], ds_a[kc], b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();  // Q's and dO's copy, when no key block was live
  __syncthreads();

  // stage dQ (bf16) in this warp's own Q rows, then store whole chunks
  unsigned char* s_o = smem;
#pragma unroll
  for (int nb = 0; nb < kNbQ; ++nb) {
    const int col = nb * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(s_o + elem_off<DP>(row0 + g, col)) =
        pack_bf16(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<uint32_t*>(s_o + elem_off<DP>(row0 + g + 8, col)) =
        pack_bf16(acc[nb][2], acc[nb][3]);
  }
  __syncwarp();
  store_tile<16, DP>(dq + (q_row0 + row0) * d, s_o + tile_off<DP>(row0, 0), d,
                     lane, 32);
}

template <int DP>
int launch_bwd_q(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int bh, int tq,
                 int tk, int d, float scale, int causal, int q_off, int k_off,
                 cudaStream_t stream) {
  constexpr size_t smem = bwd_q_smem_bytes<DP>();
  cudaError_t err = prepare(flash_bwd_q_kernel<DP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, tq / kQBQ);
  flash_bwd_q_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), tq, tk, d, scale, scale * kLog2e, causal, q_off,
      k_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tft_flash

extern "C" int tft_flash_bwd_q(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int tq,
                               int tk, int d, float scale, int causal,
                               int q_off, int k_off, void* stream) {
  using namespace tft_flash;
  if (d <= 0 || d % 16 != 0 || d > 256 || tq % kQBQ != 0 || tk % kQBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || tq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(d)) {
    case 64:
      return launch_bwd_q<64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, causal, q_off, k_off, s);
    case 128:
      return launch_bwd_q<128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, causal, q_off, k_off, s);
    default:
      return launch_bwd_q<256>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, causal, q_off, k_off, s);
  }
}
