// Flash attention forward at head dim 64, written for Hopper (sm_90a): TMA
// loads, warpgroup MMA (wgmma) and warp specialisation.
//
// Replaces two TPU Pallas kernels that compute the same function:
//   * _flash_kernel_v2 (flash_attention_v2, two-level KV blocking) of
//     diffuman4d_tpu/ops/flash_attention.py: the sampling path's d = 64
//     attention (entry flash_attn_fwd_two_level);
//   * _fwd_kernel (_fwd) of diffuman4d_tpu/ops/flash_backward.py: the
//     training forward, which also stores the base-2 logsumexp (entry
//     flash_attn_fwd_lse).
// O = softmax(Q K^T / sqrt(64)) V per (batch, head) on contiguous
// (B, S, H, 64) bf16 tensors, non-causal, unmasked: fp32 scores, running max
// and normaliser in base 2, P rounded to bf16 for the PV product, fp32
// accumulation. The sampling entry multiplies the fp32 scores by the exact
// log2(e)/8; the training entry scores Q pre-scaled by log2(e)/8 and rounded
// to bf16 (scale 1, so the backward kernels of flash_attn_bwd.cu recompute
// the same scores) and stores L2 = m + log2(sum 2^(s - m)) as (B, H, Sq) fp32.
//
// What bounds it: 4 B H Sq Sk 64 tensor-core FLOPs against O(B H S 64)
// bytes, so the tensor cores, and how much of the softmax between the two
// products hides under them. Design (one block per query tile of one
// (batch, head); warpgroup 0 produces, warpgroups 1..NC consume):
//   * The producer (one thread, registers given back with setmaxnreg) loads
//     the block_q x 64 Q tile once by TMA and keeps a ring of STAGES K and V
//     tiles of block_k_major keys in flight, each stage with a full barrier
//     for K, one for V and an empty barrier the consumers arrive on. The
//     tensor maps view each tensor as (64, H, S, B), so a tile past a
//     batch's last token reads zeros, never the next batch.
//   * Each consumer warpgroup owns 64 query rows. S = Q K^T runs as
//     wgmma m64n{block_k}k16 with Q and K read from shared memory through
//     128-byte-swizzled descriptors; the online softmax works on the
//     accumulator fragments (a row lives in 4 threads: 2 shuffles); P is
//     packed to bf16 in registers and is the A operand of O += P V
//     (wgmma m64n64k16, V from shared memory as an MN-major B operand).
//   * Software pipelining inside the warpgroup: chunk c's Q K^T is issued
//     before chunk c-1's P V, and c's softmax runs while that P V is on the
//     tensor cores; c's P is packed from fp32 exponentials only after that
//     P V has completed (see softmax_chunk). A stage goes back to the
//     producer once the P V of its last chunk has completed. With three
//     consumer warpgroups (block_q 192) the warpgroups' softmaxes also
//     overlap one another's products.
// Ragged edges: keys >= Sk score -inf (chunks wholly past Sk are not
// visited), query rows >= Sq arrive as zeros and are not stored.

#include "hopper_common.cuh"

namespace {

constexpr int HD = 64;       // head dim
constexpr int ROW = HD * 2;  // bytes of one token row: one 128-byte swizzle row
// Error code (not a cudaError_t) returned when the driver refuses a TMA map.
constexpr int ERR_TENSOR_MAP = 1000;

// K/V ring depth of each staging: as many stages as keep the block within
// the shared memory of one block (two blocks per SM at block_q 64,
// block_k_major 128)
constexpr int stages_for(int nc, int kmaj) {
  return nc == 1 ? (kmaj == 128 ? 3 : 2) : (kmaj == 128 ? 4 : 3);
}

// Shared memory of one block: Q, then STAGES K tiles, STAGES V tiles, then
// the barriers; every tile starts on a 1024-byte boundary (the swizzle atom).
template <int NC, int KMAJ>
struct Layout {
  static constexpr int STAGES = stages_for(NC, KMAJ);
  static constexpr int BQ = 64 * NC;
  static constexpr int Q_BYTES = BQ * ROW;
  static constexpr int KV_BYTES = KMAJ * ROW;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // Q full; per stage K full, V full, empty
  static constexpr int SMEM = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;  // + alignment slack
};

// S (64 x KIN) = Q (64 x 64) K_chunk^T: four 16-deep steps along d
template <int KIN>
__device__ __forceinline__ void qk(float (&s)[KIN / 2], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (KIN == 128)
      wgmma_m64n128k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
    else
      wgmma_m64n64k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
  }
}

// O (64 x 64) += P (64 x KIN, bf16 A fragments) V_chunk (KIN x 64)
template <int KIN>
__device__ __forceinline__ void pv(float (&o)[32], const uint32_t (&p)[KIN / 4], uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < KIN / 16; ++kk)
    wgmma_m64n64k16_rs_tb(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                          dv + 128 * kk, 1);
}

// Online softmax in base 2 of one chunk of scores for this thread's two rows
// (r = 0: row lane/4 of its warp's 16, r = 1: row lane/4 + 8). Keys >= Sk
// score -inf; m (running max of the scaled scores) and l (this thread's
// part of the normaliser) are updated, alpha gets the factor that rescales
// the rows' earlier output, and e the chunk's exponentials in fp32. The
// scores are only read, and P is packed from e only once the P V that reads
// the previous P has completed: a wgmma input register that a plain
// instruction rewrites while that wgmma may be in flight makes ptxas
// serialise the whole pipeline.
template <int KIN>
__device__ __forceinline__ void softmax_chunk(const float (&s)[KIN / 2], float (&e)[KIN / 2],
                                              float (&m)[2], float (&l)[2], float (&alpha)[2],
                                              int key0, int Sk, float scale, int tq) {
  const bool ragged = key0 + KIN > Sk;
  auto score = [&](int i) {
    return ragged && key0 + (i / 4) * 8 + 2 * tq + (i & 1) >= Sk ? -INFINITY : s[i];
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < KIN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], score(i));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * scale);  // finite: every chunk has a key < Sk
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < KIN / 2; ++i) {
    e[i] = ex2(fmaf(score(i), scale, -m[(i >> 1) & 1]));
    l[(i >> 1) & 1] += e[i];
  }
}

// P as the A fragments of the P V product: registers 2i, 2i + 1 of the
// score layout (one row, two neighbouring keys) rounded to bf16 and packed
template <int KIN>
__device__ __forceinline__ void pack_p(const float (&e)[KIN / 2], uint32_t (&p)[KIN / 4]) {
#pragma unroll
  for (int i = 0; i < KIN / 4; ++i) p[i] = pack_bf16(e[2 * i], e[2 * i + 1]);
}

// NC consumer warpgroups (block_q = 64 NC), K/V tiles of KMAJ keys, Q K^T
// chunks of KIN keys; LSE: also store L2.
template <int NC, int KMAJ, int KIN, bool LSE>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 1 ? 2 : 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                           float* __restrict__ l2, int H, int Sq, int Sk, float scale) {
  using L = Layout<NC, KMAJ>;
  constexpr int ST = L::STAGES;
  constexpr int CPB = KMAJ / KIN;  // chunks per staged tile
  static_assert(KMAJ % KIN == 0 && (KIN == 64 || KIN == 128), "tile shapes");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;

  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = blockIdx.x * L::BQ, bh = blockIdx.y, b = bh / H, h = bh % H;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 128 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy
    warpgroup_reg_dealloc<24>();
    if (tid == 0) {
      const int nblk = (Sk + KMAJ - 1) / KMAJ;
      mbar_arrive_expect_tx(q_full, L::Q_BYTES);
      tma_load_4d(sm, &tm_q, q_full, 0, h, q0, b);
      for (int blk = 0; blk < nblk; ++blk) {
        const int st = blk % ST;
        mbar_wait(empty + st, ((blk / ST) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(k_full + st, L::KV_BYTES);
        tma_load_4d(sm + L::K_OFF + st * L::KV_BYTES, &tm_k, k_full + st, 0, h, blk * KMAJ, b);
        mbar_arrive_expect_tx(v_full + st, L::KV_BYTES);
        tma_load_4d(sm + L::V_OFF + st * L::KV_BYTES, &tm_v, v_full + st, 0, h, blk * KMAJ, b);
      }
    }
  } else {
    // consumers: 64 query rows per warpgroup
    warpgroup_reg_alloc<NC == 1 ? 232 : NC == 2 ? 240 : 160>();
    const int cw = wg - 1, t = tid % 128, warp = t / 32, lane = t % 32, tq = lane % 4;
    const uint64_t dq = desc_sw128(sm + cw * 64 * ROW);
    const int nch = (Sk + KIN - 1) / KIN;
    // chunk c lies in staged tile c / CPB: stage, phase parity, byte offset
    auto stage = [](int c) { return (c / CPB) % ST; };
    auto parity = [](int c) { return uint32_t((c / CPB / ST) & 1); };
    auto offset = [](int c) { return ((c / CPB) % ST) * L::KV_BYTES + (c % CPB) * KIN * ROW; };

    float acc[32], s[KIN / 2], e[KIN / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float alpha[2];
    uint32_t p[KIN / 4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);

    mbar_wait(k_full, 0);
    wgmma_fence();
    qk<KIN>(s, dq, desc_sw128(sm + L::K_OFF + offset(0)));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_chunk<KIN>(s, e, m, l, alpha, 0, Sk, scale, tq);
    pack_p<KIN>(e, p);

    for (int c = 1; c < nch; ++c) {
      const int pc = c - 1;
      const uint64_t dk = desc_sw128(sm + L::K_OFF + offset(c));
      const uint64_t dv = desc_sw128(sm + L::V_OFF + offset(pc));
      if (c % CPB == 0) mbar_wait(k_full + stage(c), parity(c));
      if (pc % CPB == 0) mbar_wait(v_full + stage(pc), parity(pc));
      // every register the MMAs below read is final before the fence, and no
      // branch separates them (else ptxas serialises the wgmma pipeline)
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
      qk<KIN>(s, dq, dk);
      wgmma_commit();
      pv<KIN>(acc, p, dv);
      wgmma_commit();
      wgmma_wait<1>();  // S of chunk c is in
      fence_regs(s);
      softmax_chunk<KIN>(s, e, m, l, alpha, c * KIN, Sk, scale, tq);
      wgmma_wait<0>();  // P V of chunk c-1 is in
      fence_regs(acc);
      fence_regs(p);
      if (pc % CPB == CPB - 1) mbar_arrive(empty + stage(pc));
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p<KIN>(e, p);
    }
    const int lc = nch - 1;
    if (lc % CPB == 0) mbar_wait(v_full + stage(lc), parity(lc));
    fence_regs(acc);
    fence_regs(p);
    wgmma_fence();
    pv<KIN>(acc, p, desc_sw128(sm + L::V_OFF + offset(lc)));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
    }
    const int row[2] = {q0 + cw * 64 + warp * 16 + lane / 4, q0 + cw * 64 + warp * 16 + lane / 4 + 8};
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    if constexpr (LSE) {
      if (tq == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row[r] < Sq) l2[(long)bh * Sq + row[r]] = m[r] + log2f(l[r]);
      }
    }
    bf16* ob = o + ((long)b * Sq * H + h) * HD;
    const long rs = (long)H * HD;  // elements between consecutive tokens
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + row[r] * rs + 8 * j + 2 * tq) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int NC, int KMAJ, int KIN, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, void* l2, float scale, int B,
           int H, int Sq, int Sk, cudaStream_t stream) {
  using L = Layout<NC, KMAJ>;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd64(&tq, q, B, Sq, H, L::BQ) || !encode_bshd64(&tk, k, B, Sk, H, KMAJ) ||
      !encode_bshd64(&tv, v, B, Sk, H, KMAJ))
    return ERR_TENSOR_MAP;
  auto kern = flash_fwd_wgmma_kernel<NC, KMAJ, KIN, LSE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + L::BQ - 1) / L::BQ, B * H);
  kern<<<grid, 128 * (NC + 1), L::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(o),
                                                  static_cast<float*>(l2), H, Sq, Sk, scale);
  return (int)cudaGetLastError();
}

// The pieces of the kernel above on one tile, for the card tests: TMA loads
// of Q (64 rows), K and V (128 rows each) with the 128-byte swizzle, then
// S = Q K^T (wgmma m64n128k16, both operands from shared memory) and
// O = bf16(S) V (wgmma m64n64k16, A from registers, V MN-major).
__global__ void __launch_bounds__(128)
    wgmma_probe_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, float* __restrict__ s_out,
                       float* __restrict__ o_out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char *sq = sm, *sk = sm + 64 * ROW, *sv = sk + 128 * ROW;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sv + 128 * ROW);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, tq = lane % 4;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, (64 + 2 * 128) * ROW);
    tma_load_4d(sq, &tm_q, bar, 0, 0, 0, 0);
    tma_load_4d(sk, &tm_k, bar, 0, 0, 0, 0);
    tma_load_4d(sv, &tm_v, bar, 0, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float s[64], acc[32];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
  qk<128>(s, desc_sw128(sq), desc_sw128(sk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 64; ++i)
    s_out[(r0 + 8 * ((i >> 1) & 1)) * 128 + (i / 4) * 8 + 2 * tq + (i & 1)] = s[i];
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  wgmma_fence();
  pv<128>(acc, p, desc_sw128(sv));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    o_out[(r0 + 8 * ((i >> 1) & 1)) * 64 + (i / 4) * 8 + 2 * tq + (i & 1)] = acc[i];
}

// The training forward's one staging (block_q, block_k_major, block_k);
// FWD_LSE_BLOCKS of diffuman4d_torch/ops/flash_backward.py names the same.
constexpr int LSE_BLOCK_Q = 192, LSE_BLOCK_K_MAJOR = 256, LSE_BLOCK_K = 64;

bool bad_sizes(int B, int H, int Sq, int Sk) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535;
}

}  // namespace

// q: (B, Sq, H, 64), k/v: (B, Sk, H, 64), o: (B, Sq, H, 64); contiguous
// bf16, 16-byte aligned. block_q query rows per block (64, 128 or 192: one
// to three consumer warpgroups), K/V staged block_k_major keys per TMA stage
// (128 or 256), Q K^T in chunks of block_k keys (64 or 128). Exact fp32
// scale log2(e)/8. The (block_q, block_k_major, block_k) triples built here
// are TWO_LEVEL_CONFIGS of diffuman4d_torch/ops/flash_attention.py.
// Returns a cudaError_t code (0 on success), or ERR_TENSOR_MAP.
extern "C" int flash_attn_fwd_two_level(const void* q, const void* k, const void* v, void* o,
                                        int B, int H, int Sq, int Sk, int block_q,
                                        int block_k_major, int block_k, void* stream) {
  if (bad_sizes(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl = 1.4426950408889634f / 8.f;
  switch (block_q * 1000000 + block_k_major * 1000 + block_k) {
    case 64128064: return launch<1, 128, 64, false>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 64256064: return launch<1, 256, 64, false>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 64256128: return launch<1, 256, 128, false>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 128128064: return launch<2, 128, 64, false>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 128256064: return launch<2, 256, 64, false>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 128256128: return launch<2, 256, 128, false>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 192128064: return launch<3, 128, 64, false>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 192256064: return launch<3, 256, 64, false>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The training forward. qs: Q already scaled by log2(e)/8 and rounded to
// bf16; l2: (B, H, Sq) fp32 output, the base-2 logsumexp of each query's
// scores. Other arguments as flash_attn_fwd_two_level; one staging.
extern "C" int flash_attn_fwd_lse(const void* qs, const void* k, const void* v, void* o, void* l2,
                                  int B, int H, int Sq, int Sk, void* stream) {
  if (bad_sizes(B, H, Sq, Sk) || l2 == nullptr) return (int)cudaErrorInvalidValue;
  return launch<LSE_BLOCK_Q / 64, LSE_BLOCK_K_MAJOR, LSE_BLOCK_K, true>(
      qs, k, v, o, l2, 1.f, B, H, Sq, Sk, static_cast<cudaStream_t>(stream));
}

// Card-test probe of the TMA / wgmma pieces: q (1, 64, 1, 64), k and v
// (1, 128, 1, 64) bf16; s_out (64, 128) and o_out (64, 64) fp32.
extern "C" int flash_attn_hopper_probe(const void* q, const void* k, const void* v, void* s_out,
                                       void* o_out, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_bshd64(&tq, q, 1, 64, 1, 64) || !encode_bshd64(&tk, k, 1, 128, 1, 128) ||
      !encode_bshd64(&tv, v, 1, 128, 1, 128))
    return ERR_TENSOR_MAP;
  const int smem = (64 + 2 * 128) * ROW + 8 + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(wgmma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<float*>(s_out), static_cast<float*>(o_out));
  return (int)cudaGetLastError();
}
