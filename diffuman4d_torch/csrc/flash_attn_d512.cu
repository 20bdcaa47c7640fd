// Flash attention forward at head dim 512, written for Hopper (sm_90a): TMA
// loads, warpgroup MMA (wgmma), warp specialisation, and the scores of each
// key tile computed once.
//
// Replaces the TPU Pallas kernel flash_attention (v1) -> _flash_kernel of
// diffuman4d_tpu/ops/flash_attention.py: the VAE mid-block attention (one
// head of 512 channels). O = softmax(Q K^T / sqrt(512)) V per (batch, head)
// on contiguous (B, S, H, 512) bf16 tensors, non-causal, unmasked: fp32
// scores times the exact log2(e)/sqrt(512), running max and normaliser in
// base 2 and fp32, P rounded to bf16 for the PV product, fp32 accumulation.
//
// What bounds it: 4 B H Sq Sk 512 tensor-core FLOPs against O(B H S 512)
// bytes, so the tensor cores. The 64 x 512 fp32 output of a 64-row query
// tile is 128 registers a thread over two warpgroups, and the Q tile and one
// 64-key K and V tile fill 192 KB of shared memory. Design (one block per
// 64 query rows of one (batch, head); warpgroup 0 produces, warpgroups 1 and
// 2 consume):
//   * The producer (one thread, registers given back with setmaxnreg) loads
//     Q once and, per 64-key tile, K and V as eight 64-column slices each
//     (a (B, S, H, 512) tensor is the (B, S, 8H, 64) tensor that PR 5's
//     (64, H, S, B) tensor map describes: 128-byte rows, 128-byte swizzle,
//     rows past a batch's S read as zeros). K and V have a barrier pair each,
//     so the next K tile loads while this tile's softmax and P V run, and
//     the next V tile while the next scores run.
//   * Scores once: consumer c computes the partial scores of all 64 keys
//     over its half of the depth (columns 256c .. 256c + 255: 16 wgmma
//     m64n64k16 steps, Q and K from shared memory). The two partials meet in
//     shared memory: each consumer hands the other the half of its partial
//     that the other owns and adds the half it receives, so consumer c holds
//     the full scores of keys 32c .. 32c + 31. Row maxima are exchanged the
//     same way, both take the same new maximum, and each writes bf16 P of
//     its 32 keys into one 64 x 64 P tile (K-major, 128-byte swizzle). Named
//     barriers over the 256 consumer threads order the three exchanges.
//   * P V: consumer c accumulates its 256 output columns, O_c += P V_c, as
//     four wgmma m64n64k16 per 16 keys with P from shared memory (K-major)
//     and V's slices as MN-major B operands. The normalisers of the two
//     halves add up at the end.
//   So the tensor cores do the minimal 2 products of 2 Sq Sk 512 FLOPs per
//   (batch, head); the form it replaces recomputed the scores for each of
//   four 128-column output slices (2.5x).
// Ragged edges: keys >= Sk score -inf, query rows >= Sq arrive as zeros and
// are not stored.

#include "hopper_common.cuh"

namespace {

constexpr int HD = 512;            // head dim
constexpr int NSL = HD / 64;       // 64-column slices of a row
constexpr int BM = 64;             // query rows per block
constexpr int BN = 64;             // keys per tile
constexpr int SLICE = 64 * 128;    // bytes of one 64-row, 64-column slice
constexpr int TILE = NSL * SLICE;  // bytes of a 64 x 512 tile
constexpr int NCONS = 256;         // consumer threads
constexpr int ERR_TENSOR_MAP = 1000;  // returned when the driver refuses a TMA map

// Shared memory: Q, K, V tiles, the P tile, the partial-score exchange
// (16 fp32 per consumer thread), the row max / normaliser exchange (2 per
// consumer thread), then the barriers.
constexpr int Q_OFF = 0, K_OFF = TILE, V_OFF = 2 * TILE, P_OFF = 3 * TILE;
constexpr int XS_OFF = P_OFF + BM * 128;
constexpr int XM_OFF = XS_OFF + NCONS * 16 * 4;
constexpr int BAR_OFF = XM_OFF + NCONS * 2 * 4;
constexpr int SMEM = BAR_OFF + 5 * 8 + 1024;  // + alignment slack

__global__ void __launch_bounds__(384, 1)
    flash_fwd_d512_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out, int H,
                          int Sq, int Sk, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = q_full + 2;
  uint64_t* v_full = q_full + 3;
  uint64_t* v_empty = q_full + 4;

  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = blockIdx.x * BM, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nt = (Sk + BN - 1) / BN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, NCONS);
    mbar_init(v_empty, NCONS);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy; slice s of head h is "head"
    // 8h + s of the (64, 8H, S, B) view
    warpgroup_reg_dealloc<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_full, TILE);
      for (int s = 0; s < NSL; ++s)
        tma_load_4d(sm + Q_OFF + s * SLICE, &tm_q, q_full, 0, h * NSL + s, q0, b);
      for (int j = 0; j < nt; ++j) {
        if (j > 0) mbar_wait(k_empty, (j - 1) & 1);
        mbar_arrive_expect_tx(k_full, TILE);
        for (int s = 0; s < NSL; ++s)
          tma_load_4d(sm + K_OFF + s * SLICE, &tm_k, k_full, 0, h * NSL + s, j * BN, b);
        if (j > 0) mbar_wait(v_empty, (j - 1) & 1);
        mbar_arrive_expect_tx(v_full, TILE);
        for (int s = 0; s < NSL; ++s)
          tma_load_4d(sm + V_OFF + s * SLICE, &tm_v, v_full, 0, h * NSL + s, j * BN, b);
      }
    }
    return;
  }

  warpgroup_reg_alloc<240>();
  const int c = wg - 1, t = tid % 128, warp = t / 32, lane = t % 32, tq = lane % 4;
  const int other = 1 - c;
  float* xs = reinterpret_cast<float*>(sm + XS_OFF);  // [consumer][16][128]
  float* xm = reinterpret_cast<float*>(sm + XM_OFF);  // [consumer][2][128]
  unsigned char* ptile = sm + P_OFF;
  const int row[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};

  // accumulator register i of m64n64: row row[(i >> 1) & 1], column
  // (i / 4) * 8 + 2 tq + (i & 1); consumer c owns the score registers
  // 16c .. 16c + 15 (keys 32c .. 32c + 31 of the tile)
  float o[4][32], s[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) o[sl][i] = 0.f;
  }
  mbar_wait(q_full, 0);

  for (int j = 0; j < nt; ++j) {
    const uint32_t par = j & 1;
    // partial scores over depth columns 256c .. 256c + 255, all 64 keys
    mbar_wait(k_full, par);
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      const uint64_t dq = desc_sw128(sm + Q_OFF + (4 * c + sl) * SLICE);
      const uint64_t dk = desc_sw128(sm + K_OFF + (4 * c + sl) * SLICE);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(s, dq + 2 * kk, dk + 2 * kk, sl + kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(k_empty);

    // hand over the other consumer's keys, take in the partial of mine
#pragma unroll
    for (int u = 0; u < 16; ++u) xs[(c * 16 + u) * 128 + t] = c ? s[u] : s[16 + u];
    named_bar_sync(1, NCONS);
    float e[16], mx[2] = {-INFINITY, -INFINITY};
    const int key0 = j * BN + 32 * c;
    const bool ragged = j * BN + BN > Sk;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      e[u] = (c ? s[16 + u] : s[u]) + xs[(other * 16 + u) * 128 + t];
      if (ragged && key0 + (u / 4) * 8 + 2 * tq + (u & 1) >= Sk) e[u] = -INFINITY;
      mx[(u >> 1) & 1] = fmaxf(mx[(u >> 1) & 1], e[u]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      xm[(c * 2 + r) * 128 + t] = mx[r];
    }
    named_bar_sync(2, NCONS);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // finite: every tile has a key < Sk in one of the two halves
      const float mn = fmaxf(m[r], fmaxf(mx[r], xm[(other * 2 + r) * 128 + t]) * scale);
      alpha[r] = ex2(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int u = 0; u < 16; u += 2) {
      const int r = (u >> 1) & 1;
      const float p0 = ex2(fmaf(e[u], scale, -m[r])), p1 = ex2(fmaf(e[u + 1], scale, -m[r]));
      l[r] += p0 + p1;
      const int R = row[r], chunk = 4 * c + u / 4;
      *reinterpret_cast<uint32_t*>(ptile + R * 128 + ((chunk ^ (R & 7)) << 4) + 4 * tq) =
          pack_bf16(p0, p1);
    }
    fence_proxy_async();
    named_bar_sync(3, NCONS);  // both halves of P are in the tile

#pragma unroll
    for (int sl = 0; sl < 4; ++sl)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[sl][i] *= alpha[(i >> 1) & 1];
    mbar_wait(v_full, par);
    fence_regs(o[0]);
    fence_regs(o[1]);
    fence_regs(o[2]);
    fence_regs(o[3]);
    wgmma_fence();
    const uint64_t dp = desc_sw128(ptile);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int sl = 0; sl < 4; ++sl)
        wgmma_m64n64k16_ss_tb(o[sl], dp + 2 * kk,
                              desc_sw128(sm + V_OFF + (4 * c + sl) * SLICE) + 128 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o[0]);
    fence_regs(o[1]);
    fence_regs(o[2]);
    fence_regs(o[3]);
    mbar_arrive(v_empty);
  }

  // the normaliser: this consumer's keys plus the other's
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
    xm[(c * 2 + r) * 128 + t] = l[r];
  }
  named_bar_sync(1, NCONS);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / (l[r] + xm[(other * 2 + r) * 128 + t]);

  bf16* ob = out + ((long)b * Sq * H + h) * HD + 256 * c;
  const long rs = (long)H * HD;  // elements between consecutive tokens
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q0 + row[r] >= Sq) continue;
    bf16* orow = ob + (q0 + row[r]) * rs;
#pragma unroll
    for (int sl = 0; sl < 4; ++sl)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * sl + 8 * jj + 2 * tq) = __floats2bfloat162_rn(
            o[sl][4 * jj + 2 * r] * inv[r], o[sl][4 * jj + 2 * r + 1] * inv[r]);
  }
}

}  // namespace

// q: (B, Sq, H, 512), k/v: (B, Sk, H, 512), o: (B, Sq, H, 512); contiguous
// bf16, 16-byte aligned. Returns a cudaError_t code (0 on success), or
// ERR_TENSOR_MAP when the driver refuses a tensor map.
extern "C" int flash_attn_fwd_d512(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int Sq, int Sk, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd64(&tq, q, B, Sq, H * NSL, BM) || !encode_bshd64(&tk, k, B, Sk, H * NSL, BN) ||
      !encode_bshd64(&tv, v, B, Sk, H * NSL, BN))
    return ERR_TENSOR_MAP;
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_d512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_fwd_d512_kernel<<<grid, 384, SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(o), H, Sq, Sk, 1.4426950408889634f / sqrtf(512.f));
  return (int)cudaGetLastError();
}
