// Flash attention forward at head dim 64 for Hopper (sm_90a) with the TPU
// kernels' skewed score pipeline: TMA loads, warpgroup MMA (wgmma), warp
// specialisation and two score register buffers.
//
// Replaces the TPU Pallas kernels of diffuman4d_tpu/ops/flash_attention.py
// that compute the UNet's d = 64 attention:
//   * _flash_kernel_v4 (:342, flash_attention_v4 :403): the 3D window
//     attention; the normaliser comes from a ones-row of V^T;
//   * _flash_kernel_v3 (:199, flash_attention_v3 :279): the per-frame
//     attention; the normaliser from a sum.
// Both keep two score blocks (s_a, s_b): the Q K^T of step j runs while step
// j-1's exp runs. Entry flash_attn_fwd_skew. O = softmax(Q K^T / sqrt(64)) V
// per (batch, head) on contiguous (B, S, H, 64) bf16 tensors, non-causal,
// unmasked: the exact log2(e)/8 applied to fp32 scores, fp32 running max and
// normaliser in base 2, P rounded to bf16 for the P V product, fp32
// accumulation (the function of attention_plain). The normaliser is a sum
// of the fp32 exponentials, as in v3: v4's ones-row would be an extra
// wgmma m64n8k16 per 16 keys, and the FADDs it replaces run under the
// in-flight products here (not built).
//
// What bounds it: 4 B H Sq Sk 64 tensor-core FLOPs against O(B H S 64)
// bytes, so the tensor cores, and how much of the softmax between the two
// products hides under them. The two-level kernel (flash_attn_hopper.cu)
// issues chunk c's Q K^T and chunk c-1's P V together and runs c's softmax
// under the P V only; its one score buffer is busy until the softmax ends,
// so the next Q K^T waits for it.
// Design (one block per query tile of one (batch, head); warpgroup 0
// produces, warpgroups 1..NC consume):
//   * The producer (one thread, registers given back with setmaxnreg) loads
//     the block_q x 64 Q tile once by TMA and keeps a ring of K and V tiles
//     of block_k_major keys in flight (full barriers for K and V, an empty
//     barrier the consumers arrive on), as in the two-level kernel. Tiles
//     past a batch's last token arrive as zeros.
//   * Each consumer warpgroup owns 64 query rows and two score buffers, sa
//     and sb, of block_k keys. The skew: step c issues chunk c-1's P V and
//     chunk c+1's Q K^T (into the buffer chunk c-1's P was packed from),
//     then runs chunk c's softmax, in place on its buffer, while both run
//     on the tensor cores; it then waits for both, rescales the output and
//     packs chunk c's P. So every Q K^T after the first and every P V runs
//     under a softmax, and no product is in flight across a step's end
//     (ptxas serialises a wgmma pipeline whose products span the loop's
//     back edge, C7514). The loop takes two chunks per turn so that each
//     buffer is a fixed set of registers; a last turn past the end works
//     on a chunk whose keys all score -inf (its P is zero), so no branch
//     separates a product from its wait.
// Ragged edges: keys >= Sk score -inf, query rows >= Sq arrive as zeros and
// are not stored.

#include "hopper_common.cuh"

namespace {

constexpr int HD = 64;       // head dim
constexpr int ROW = HD * 2;  // bytes of one token row: one 128-byte swizzle row
// Error code (not a cudaError_t) returned when the driver refuses a TMA map.
constexpr int ERR_TENSOR_MAP = 1000;

// K/V ring depth: as many stages as keep the block within the shared
// memory of one block (two blocks per SM at block_q 64, block_k_major 128)
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
  static_assert(SMEM <= 232448, "a block's shared memory");
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
// (r = 0: row lane/4 of its warp's 16, r = 1: row lane/4 + 8), in place: s
// ends holding the chunk's fp32 exponentials. Keys >= Sk score -inf (a
// chunk wholly past Sk leaves m and l as they were and gives zeros); m
// (running max of the scaled scores) and l (this thread's part of the
// normaliser) are updated, alpha gets the factor that rescales the rows'
// earlier output.
template <int KIN>
__device__ __forceinline__ void softmax_chunk(float (&s)[KIN / 2], float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], int key0, int Sk, float scale,
                                              int tq) {
  if (key0 + KIN > Sk) {
#pragma unroll
    for (int i = 0; i < KIN / 2; ++i)
      if (key0 + (i / 4) * 8 + 2 * tq + (i & 1) >= Sk) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < KIN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
    // finite from the first chunk on: chunk 0 holds a key < Sk
    const float mn = fmaxf(m[r], mx[r] * scale);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < KIN / 2; ++i) {
    s[i] = ex2(fmaf(s[i], scale, -m[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
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
// chunks of KIN keys.
template <int NC, int KMAJ, int KIN>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 1 ? 2 : 1)
    flash_fwd_skew_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int H,
                          int Sq, int Sk, float scale) {
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
    const int nch = (Sk + KIN - 1) / KIN, last = nch - 1;
    // chunk c (clamped to the last one: a chunk past the end reads the last
    // staged tile, and its keys score -inf) lies in staged tile c / CPB
    auto stage = [](int c) { return (c / CPB) % ST; };
    auto parity = [](int c) { return uint32_t((c / CPB / ST) & 1); };
    auto offset = [](int c) { return ((c / CPB) % ST) * L::KV_BYTES + (c % CPB) * KIN * ROW; };
    auto wait_k = [&](int c) {
      c = min(c, last);
      if (c % CPB == 0) mbar_wait(k_full + stage(c), parity(c));
    };
    auto wait_v = [&](int c) {
      c = min(c, last);
      if (c % CPB == 0) mbar_wait(v_full + stage(c), parity(c));
    };
    auto dk = [&](int c) { return desc_sw128(sm + L::K_OFF + offset(min(c, last))); };
    auto dv = [&](int c) { return desc_sw128(sm + L::V_OFF + offset(min(c, last))); };

    float acc[32], sa[KIN / 2], sb[KIN / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float alpha[2];
    uint32_t p[KIN / 4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);

    // chunk 0's scores; then chunk 1's Q K^T runs under chunk 0's softmax
    wait_k(0);
    wait_k(1);
    wgmma_fence();
    qk<KIN>(sa, dq, dk(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    wgmma_fence();
    qk<KIN>(sb, dq, dk(1));
    wgmma_commit();
    softmax_chunk<KIN>(sa, m, l, alpha, 0, Sk, scale, tq);
    wgmma_wait<0>();
    fence_regs(sb);
    pack_p<KIN>(sa, p);

    // step c: cur holds chunk c's scores, nxt held chunk c-1's (packed into
    // p); issue P V of c-1 and Q K^T of c+1 into nxt, run c's softmax under
    // both, then wait for both, rescale and pack c's P. Nothing is in flight
    // across a step's end (ptxas serialises a pipeline whose products span
    // the loop's back edge).
    auto step = [&](float (&cur)[KIN / 2], float (&nxt)[KIN / 2], int c) {
      const int pc = c - 1;
      wait_v(pc);
      wait_k(c + 1);
      // every register the MMAs below read is final before the fence, and
      // no branch separates them
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
      pv<KIN>(acc, p, dv(pc));
      wgmma_commit();
      qk<KIN>(nxt, dq, dk(c + 1));
      wgmma_commit();
      softmax_chunk<KIN>(cur, m, l, alpha, c * KIN, Sk, scale, tq);
      wgmma_wait<0>();  // P V of chunk c-1 and S of chunk c+1 are in
      fence_regs(acc);
      fence_regs(p);
      fence_regs(nxt);
      if (pc % CPB == CPB - 1) mbar_arrive(empty + stage(pc));
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p<KIN>(cur, p);
    };
    for (int c = 1; c < nch; c += 2) {
      step(sb, sa, c);
      step(sa, sb, c + 1);  // c + 1 == nch: a chunk past the end, all -inf
    }
    // the last step's chunk: nch - 1 if nch is odd, else the one past the end
    wait_v(2 * (nch / 2));
    fence_regs(acc);
    fence_regs(p);
    wgmma_fence();
    pv<KIN>(acc, p, dv(2 * (nch / 2)));
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

template <int NC, int KMAJ, int KIN>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
           cudaStream_t stream) {
  using L = Layout<NC, KMAJ>;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd64(&tq, q, B, Sq, H, L::BQ) || !encode_bshd64(&tk, k, B, Sk, H, KMAJ) ||
      !encode_bshd64(&tv, v, B, Sk, H, KMAJ))
    return ERR_TENSOR_MAP;
  auto kern = flash_fwd_skew_kernel<NC, KMAJ, KIN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + L::BQ - 1) / L::BQ, B * H);
  kern<<<grid, 128 * (NC + 1), L::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(o), H, Sq, Sk,
                                                  1.4426950408889634f / 8.f);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, 64), k/v: (B, Sk, H, 64), o: (B, Sq, H, 64); contiguous
// bf16, 16-byte aligned. block_q query rows per block (64, 128 or 192: one
// to three consumer warpgroups), K/V staged block_k_major keys per TMA stage
// (128 or 256), Q K^T in chunks of block_k keys (64 or 128), two chunks'
// scores in registers. The (block_q, block_k_major, block_k) triples built
// here are SKEW_CONFIGS of diffuman4d_torch/ops/flash_attention.py.
// Returns a cudaError_t code (0 on success), or ERR_TENSOR_MAP.
extern "C" int flash_attn_fwd_skew(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int Sq, int Sk, int block_q, int block_k_major,
                                   int block_k, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_q * 1000000 + block_k_major * 1000 + block_k) {
    case 64128064: return launch<1, 128, 64>(q, k, v, o, B, H, Sq, Sk, s);
    case 128128064: return launch<2, 128, 64>(q, k, v, o, B, H, Sq, Sk, s);
    case 128256064: return launch<2, 256, 64>(q, k, v, o, B, H, Sq, Sk, s);
    case 128256128: return launch<2, 256, 128>(q, k, v, o, B, H, Sq, Sk, s);
    case 192128064: return launch<3, 128, 64>(q, k, v, o, B, H, Sq, Sk, s);
    case 192256064: return launch<3, 256, 64>(q, k, v, o, B, H, Sq, Sk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
