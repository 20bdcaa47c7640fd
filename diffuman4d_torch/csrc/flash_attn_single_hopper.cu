// Single-pass attention at head dim 64 for Hopper (sm_90a): TMA loads,
// warpgroup MMA (wgmma), warp specialisation, and each (batch, head) row's
// K and V loaded once for all of its query tiles.
//
// Replaces the TPU Pallas kernels of diffuman4d_tpu/ops/flash_attention.py:
//   * _flash_kernel_v5 (:463, flash_attention_v5 :489), one (batch, head)
//     row per program -> block_b = 1;
//   * _flash_kernel_v6 (:530, flash_attention_v6 :555), block_b rows per
//     program -> block_b rows per block, walked in turn.
// Entry flash_attn_single_pass. O = softmax(Q K^T / sqrt(64)) V per
// (batch, head) on contiguous (B, S, H, 64) bf16 tensors, non-causal,
// unmasked: the exact log2(e)/8 applied to fp32 scores (the plain version's
// function; the TPU kernels scale a bf16-rounded Q), fp32 max and sum, P
// rounded to bf16 for the P V product, fp32 accumulation. Up to 256 keys
// this is the TPU kernels' single pass: one Q K^T over all keys, one max,
// one exp2, one sum, one P V, one divide. Above 256 keys the scores come in
// chunks of 256 (the 128 fp32 registers per thread of one 64 x 256 score
// tile), with one rescale of the output per further chunk.
//
// What bounds it: at the per-frame 16^2 mid block (B32 S256 H20) the work is
// 4 S^2 64 FLOPs per row against 4 S 64 x 2 bytes (Q, K, V read once, O
// written once): 0.011 ms of tensor-core time against 0.025 ms of HBM time,
// so the bytes. What it does about that: K and V of a row cross HBM once
// and stay in shared memory for every query tile of the row, and a ring of
// slots lets the next row's loads run while this row computes. At S 1,024
// the FLOPs bound it (0.174 ms against 0.100 ms of bytes).
//
// Design (warpgroup 0 produces, warpgroups 1..NC consume; block_q = 64 NC
// query rows per pass; block_b rows per block):
//   * The block walks rows blockIdx.x * block_b .. + block_b - 1. For each
//     row it makes ceil(Sq / block_q) passes, one query tile each. The
//     producer (one thread) loads each pass's Q tile into one of two Q
//     slots, and the row's K and V in chunks of SKC keys (128 when Sk <=
//     128, else 256) into a ring of NSLOT chunk slots (a full barrier for
//     K and one for V, an empty barrier the consumers arrive on).
//   * Resident rows (chunks <= NSLOT, i.e. Sk <= 256 at block_q 64 and
//     <= 768 at block_q 128): the chunks are loaded once per row and read
//     by every pass; a slot goes back to the producer after the row's last
//     pass, so the next row's chunks (and Q tiles) load into the other
//     slots while this row computes. Longer rows stream their chunks
//     through the ring once per pass (again from L2 after the first pass).
//   * Each consumer warpgroup owns 64 query rows of the pass. Per chunk:
//     S = Q K^T as wgmma m64n128k16 (Q and K from 128-byte-swizzled shared
//     memory), the max, exp2 and sum on the accumulator fragments (a row
//     lives in 4 threads: 2 shuffles), P packed to bf16 in registers as the
//     A operand of O += P V (wgmma m64n64k16, V an MN-major B operand).
//     With two consumer warpgroups, one's softmax runs under the other's
//     products; with one, two blocks share an SM.
// Limits, independent of Sk: 128 score registers per thread and a fixed
// shared-memory layout per instance (Layout below, at most 230,504 bytes);
// Sk <= 4,096 (the reference's largest single-pass candidate) is the gate of
// single_pass_ok in diffuman4d_torch/ops/flash_attention.py. Ragged edges:
// keys >= Sk score -inf, Q rows >= Sq arrive as zeros and are not stored.

#include "hopper_common.cuh"

namespace {

constexpr int HD = 64;       // head dim
constexpr int ROW = HD * 2;  // bytes of one token row: one 128-byte swizzle row
constexpr int MAX_SK = 4096;
// Error code (not a cudaError_t) returned when the driver refuses a TMA map.
constexpr int ERR_TENSOR_MAP = 1000;

// K/V chunk slots: one consumer warpgroup keeps two blocks on an SM
// (at most ~113 KB each), two fill one block's shared memory
constexpr int slots_for(int nc, int skc) { return nc == 1 ? (skc == 128 ? 2 : 1) : (skc == 128 ? 4 : 3); }

// Shared memory of one block: two Q slots, NSLOT K chunks, NSLOT V chunks,
// then the barriers; every tile starts on a 1024-byte boundary.
template <int NC, int SKC>
struct Layout {
  static constexpr int NSLOT = slots_for(NC, SKC);
  static constexpr int BQ = 64 * NC;
  static constexpr int Q_BYTES = BQ * ROW;
  static constexpr int KV_BYTES = SKC * ROW;  // one K or V chunk
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + NSLOT * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + NSLOT * KV_BYTES;
  // per Q slot full, empty; per chunk slot K full, V full, empty
  static constexpr int SMEM = BAR_OFF + (4 + 3 * NSLOT) * 8 + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// S (64 x SKC) = Q (64 x 64) K_chunk^T, as SKC / 128 tiles of 128 keys
template <int SKC>
__device__ __forceinline__ void qk(float (&s)[SKC / 128][64], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int j = 0; j < SKC / 128; ++j)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_m64n128k16_ss(s[j], dq + 2 * kk, dk + 128 * 8 * j + 2 * kk, kk);
}

// O (64 x 64) += P (64 x SKC, bf16 A fragments) V_chunk (SKC x 64)
template <int SKC>
__device__ __forceinline__ void pv(float (&o)[32], const uint32_t (&p)[SKC / 128][32],
                                   uint64_t dv) {
#pragma unroll
  for (int j = 0; j < SKC / 128; ++j)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n64k16_rs_tb(o, p[j][4 * kk], p[j][4 * kk + 1], p[j][4 * kk + 2],
                            p[j][4 * kk + 3], dv + 128 * (8 * j + kk), 1);
}

// Softmax in base 2 of one chunk of SKC keys for this thread's two rows
// (r = 0: row lane/4 of its warp's 16, r = 1: row lane/4 + 8), in place.
// Register i of 128-key tile j holds key key0 + 128 j + (i / 4) 8 + 2 tq +
// (i & 1). Keys >= Sk score -inf. m and l (this thread's part of the sum)
// are updated; alpha rescales the rows' earlier output (0 on the first
// chunk, where m was -inf).
template <int SKC>
__device__ __forceinline__ void softmax_chunk(float (&s)[SKC / 128][64], float (&m)[2],
                                              float (&l)[2], float (&alpha)[2], int key0, int Sk,
                                              float scale, int tq) {
  if (key0 + SKC > Sk) {
#pragma unroll
    for (int j = 0; j < SKC / 128; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (key0 + 128 * j + (i / 4) * 8 + 2 * tq + (i & 1) >= Sk) s[j][i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < SKC / 128; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[j][i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * scale);  // finite: every chunk holds a key < Sk
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < SKC / 128; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      s[j][i] = ex2(fmaf(s[j][i], scale, -m[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[j][i];
    }
}

// NC consumer warpgroups (block_q = 64 NC), score chunks of SKC keys.
template <int NC, int SKC>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 1 ? 2 : 1)
    single_pass_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                             int BH, int H, int Sq, int Sk, int block_b, float scale) {
  using L = Layout<NC, SKC>;
  constexpr int NS = L::NSLOT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + NS;
  uint64_t* kv_empty = v_full + NS;

  const int tid = threadIdx.x, wg = tid / 128;
  const int nch = (Sk + SKC - 1) / SKC, npass = (Sq + L::BQ - 1) / L::BQ;
  const bool resident = nch <= NS;
  const int row0 = blockIdx.x * block_b, nrows = min(block_b, BH - row0);

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + s, 1);
      mbar_init(q_empty + s, 128 * NC);
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(kv_empty + s, 128 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy; g counts passes (Q loads), n
    // chunk loads, both over the block's rows
    warpgroup_reg_dealloc<24>();
    if (tid == 0) {
      int g = 0, n = 0;
      for (int i = 0; i < nrows; ++i) {
        const int bh = row0 + i, b = bh / H, h = bh % H;
        for (int ps = 0; ps < npass; ++ps, ++g) {
          const int qs = g & 1;
          mbar_wait(q_empty + qs, ((g >> 1) & 1) ^ 1);  // the first round passes at once
          mbar_arrive_expect_tx(q_full + qs, L::Q_BYTES);
          tma_load_4d(sm + qs * L::Q_BYTES, &tm_q, q_full + qs, 0, h, ps * L::BQ, b);
          if (resident && ps > 0) continue;
          for (int c = 0; c < nch; ++c, ++n) {
            const int s = n % NS;
            mbar_wait(kv_empty + s, ((n / NS) & 1) ^ 1);
            mbar_arrive_expect_tx(k_full + s, L::KV_BYTES);
            tma_load_4d(sm + L::K_OFF + s * L::KV_BYTES, &tm_k, k_full + s, 0, h, c * SKC, b);
            mbar_arrive_expect_tx(v_full + s, L::KV_BYTES);
            tma_load_4d(sm + L::V_OFF + s * L::KV_BYTES, &tm_v, v_full + s, 0, h, c * SKC, b);
          }
        }
      }
    }
  } else {
    // consumers: 64 query rows of each pass per warpgroup
    warpgroup_reg_alloc<NC == 1 ? 232 : 240>();
    const int cw = wg - 1, t = tid % 128, warp = t / 32, lane = t % 32, tq = lane % 4;
    const long rs = (long)H * HD;  // elements between consecutive tokens
    int g = 0, n0 = 0;             // passes and chunk loads of the earlier rows
    for (int i = 0; i < nrows; ++i) {
      const int bh = row0 + i, b = bh / H, h = bh % H;
      bf16* ob = o + ((long)b * Sq * H + h) * HD;
      for (int ps = 0; ps < npass; ++ps, ++g) {
        const int qs = g & 1;
        const uint64_t dq = desc_sw128(sm + qs * L::Q_BYTES + cw * 64 * ROW);
        float acc[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k] = 0.f;
        mbar_wait(q_full + qs, (g >> 1) & 1);
        for (int c = 0; c < nch; ++c) {
          const int ld = n0 + (resident ? c : ps * nch + c), s = ld % NS;
          const uint32_t par = (ld / NS) & 1;
          float sc[SKC / 128][64];
          uint32_t p[SKC / 128][32];
          mbar_wait(k_full + s, par);
          wgmma_fence();
          qk<SKC>(sc, dq, desc_sw128(sm + L::K_OFF + s * L::KV_BYTES));
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < SKC / 128; ++j) fence_regs(sc[j]);
          softmax_chunk<SKC>(sc, m, l, alpha, c * SKC, Sk, scale, tq);
#pragma unroll
          for (int k = 0; k < 32; ++k) acc[k] *= alpha[(k >> 1) & 1];
#pragma unroll
          for (int j = 0; j < SKC / 128; ++j)
#pragma unroll
            for (int k = 0; k < 32; ++k) p[j][k] = pack_bf16(sc[j][2 * k], sc[j][2 * k + 1]);
          mbar_wait(v_full + s, par);
          fence_regs(acc);
#pragma unroll
          for (int j = 0; j < SKC / 128; ++j) fence_regs(p[j]);
          wgmma_fence();
          pv<SKC>(acc, p, desc_sw128(sm + L::V_OFF + s * L::KV_BYTES));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          if (!resident || ps == npass - 1) mbar_arrive(kv_empty + s);
        }
        mbar_arrive(q_empty + qs);

        // one divide, then store this pass's rows
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
        }
        const int q0 = ps * L::BQ + cw * 64 + warp * 16 + lane / 4;
        const int row[2] = {q0, q0 + 8};
        const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (row[r] < Sq)
              *reinterpret_cast<__nv_bfloat162*>(ob + row[r] * rs + 8 * j + 2 * tq) =
                  __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r],
                                        acc[4 * j + 2 * r + 1] * inv[r]);
        }
      }
      n0 += resident ? nch : npass * nch;
    }
  }
}

template <int NC, int SKC>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
           int block_b, cudaStream_t stream) {
  using L = Layout<NC, SKC>;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd64(&tq, q, B, Sq, H, L::BQ) || !encode_bshd64(&tk, k, B, Sk, H, SKC) ||
      !encode_bshd64(&tv, v, B, Sk, H, SKC))
    return ERR_TENSOR_MAP;
  auto kern = single_pass_wgmma_kernel<NC, SKC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int bh = B * H;
  kern<<<(bh + block_b - 1) / block_b, 128 * (NC + 1), L::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), bh, H, Sq, Sk, block_b, 1.4426950408889634f / 8.f);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, 64), k/v: (B, Sk, H, 64), o: (B, Sq, H, 64); contiguous bf16,
// 16-byte aligned. block_q (64 or 128: SINGLE_PASS_BLOCK_Q of
// diffuman4d_torch/ops/flash_attention.py) query rows per pass; block_b
// (batch * head) rows per block, dividing B * H; 1 <= Sk <= 4,096.
// Returns a cudaError_t code (0 on success), or ERR_TENSOR_MAP.
extern "C" int flash_attn_single_pass(const void* q, const void* k, const void* v, void* o, int B,
                                      int H, int Sq, int Sk, int block_q, int block_b,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || Sk > MAX_SK || block_b <= 0 ||
      (B * H) % block_b != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool short_rows = Sk <= 128;
  switch (block_q) {
    case 64:
      return short_rows ? launch<1, 128>(q, k, v, o, B, H, Sq, Sk, block_b, s)
                        : launch<1, 256>(q, k, v, o, B, H, Sq, Sk, block_b, s);
    case 128:
      return short_rows ? launch<2, 128>(q, k, v, o, B, H, Sq, Sk, block_b, s)
                        : launch<2, 256>(q, k, v, o, B, H, Sq, Sk, block_b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
