// Flash attention backward for Hopper (sm_90a), head dim 64, non-causal, no mask.
//
// Replaces the TPU Pallas kernels of diffuman4d_tpu/ops/flash_backward.py:
//   * _dkdv_kernel (via _bwd_impl) -> flash_bwd_dkdv_kernel: one block owns a
//     64-key K/V tile and streams the queries;
//   * _dq_kernel (via _bwd_impl)   -> flash_bwd_dq_kernel: one block owns 64
//     query rows and streams the keys.
// The forward that also emits the per-query base-2 logsumexp L2 (_fwd_kernel)
// is flash_fwd_kernel<64, 64, 2> of flash_attn.cu with its L2 output on.
//
// Inputs are (B, S, H, 64) bf16: Qs (Q pre-scaled by log2(e)/sqrt(d) and
// rounded to bf16 by the wrapper, the same tensor the forward scored), K, V,
// dO; and (B, H, Sq) fp32: L2 and delta = rowsum(dO * O). With
// S2 = Qs K^T (fp32, base-2 logits):
//   P  = exp2(S2 - L2)             dV = bf16(P)^T  dO
//   dP = dO V^T                    dS = P * (dP - delta)
//   dQ = bf16(dS) K / sqrt(d)      dK = ln2 * bf16(dS)^T Qs
// P and dS are rounded to bf16 before their products, every product
// accumulates in fp32 registers, and each output is written once: there is
// no atomic accumulation, so the result is bit-repeatable.
//
// What bounds it: like the forward, 4*B*H*Sq*Sk*d tensor-core FLOPs per
// matrix product (five nominal products, seven executed: both kernels
// recompute S2 and dP) against O(B*H*S*d) bytes: the tensor cores and the
// exp2 / elementwise chain between the products. Design: 4 warps per block,
// each owning 16 rows of the block's tile; the streamed operand pair
// (K, V for dQ; Qs, dO for dK/dV) is double-buffered through shared memory
// with cp.async; products are mma.sync m16n8k16 bf16 with the owned tile's
// fragments and the accumulators in registers. dK/dV works on the transposed
// scores (keys as rows), so P^T and dS^T come out of the accumulators already
// in the A-fragment layout of the next product, as P does in the forward.
// Ragged S: out-of-range rows load as zeros; out-of-range keys get P = 0;
// out-of-range queries load L2 = +1e30 (P = 0) and delta = 0; out-of-range
// rows are not stored.

#include "mma_common.cuh"

namespace {

constexpr int T = 64;  // tile edge: 64 rows (queries or keys) of head dim 64
constexpr int NTHREADS = 128;
constexpr float LN2 = 0.6931471805599453f;

// rows row0 .. row0+63 of a (S, H, 64) slice -> swizzled 64 x 64 shared tile
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long rs, int row0, int nrows,
                                          int tid) {
  for (int i = tid; i < T * 8; i += NTHREADS) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = row0 + r < nrows;
    cp_async_16(dst + swz<64>(r, c), src + (long)(ok ? row0 + r : 0) * rs + c, ok);
  }
}

// A fragments (16 rows x 64 depth) of rows row0.. of a shared tile
__device__ __forceinline__ void load_a(uint32_t (&f)[4][4], const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(f[kk], tile + swz<64>(row0 + (lane & 15), kk * 16 + (lane >> 4) * 8));
}

// acc (16 x 64) += A (16 x 64) * Bt^T; Bt: shared tile whose 64 rows are the
// output columns and whose columns are the contraction index
__device__ __forceinline__ void mma_nt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       const bf16* bt, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldmatrix_x4(b, bt + swz<64>(p * 16 + (lane & 7) + (lane >> 4) * 8,
                                  kk * 16 + ((lane >> 3) & 1) * 8));
      mma_bf16(acc[2 * p], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x 64) += bf16(X) (16 x 64, accumulator layout) * Bm; Bm: shared
// tile whose 64 rows are the contraction index
__device__ __forceinline__ void mma_nn(float (&acc)[8][4], const float (&x)[8][4], const bf16* bm,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, bm + swz<64>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                        p * 16 + (lane >> 4) * 8));
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// rows r0 = row0 + g and r0 + 8 of a 16 x 64 accumulator -> bf16 global rows
__device__ __forceinline__ void store_rows(bf16* dst, long rs, const float (&acc)[8][4], int r0,
                                           int nrows, int t, float mul) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (r0 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long)r0 * rs + col) =
          __floats2bfloat162_rn(acc[dt][0] * mul, acc[dt][1] * mul);
    if (r0 + 8 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long)(r0 + 8) * rs + col) =
          __floats2bfloat162_rn(acc[dt][2] * mul, acc[dt][3] * mul);
  }
}

// ---------------------------------------------------------------- dQ
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ l2, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int Sq, int Sk, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // 64 x 64
  bf16* sDO = sQ + T * 64;                        // 64 x 64
  bf16* sK = sDO + T * 64;                        // 2 stages x 64 x 64
  bf16* sV = sK + 2 * T * 64;                     // 2 stages x 64 x 64

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * T;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long rs = (long)H * 64;
  const long qoff = ((long)b * Sq * H + h) * 64, koff = ((long)b * Sk * H + h) * 64;

  load_tile(sQ, qs + qoff, rs, q0, Sq, tid);
  load_tile(sDO, dout + qoff, rs, q0, Sq, tid);
  load_tile(sK, k + koff, rs, 0, Sk, tid);
  load_tile(sV, v + koff, rs, 0, Sk, tid);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g;
  float l2r[2], dlr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    l2r[i] = r < Sq ? l2[(long)bh * Sq + r] : 0.f;
    dlr[i] = r < Sq ? delta[(long)bh * Sq + r] : 0.f;
  }

  float acc[8][4];
  zero(acc);
  uint32_t qf[4][4], dof[4][4];
  const int nblk = (Sk + T - 1) / T;
  for (int j = 0; j < nblk; ++j) {
    const int st = j & 1;
    if (j + 1 < nblk) {
      load_tile(sK + (st ^ 1) * T * 64, k + koff, rs, (j + 1) * T, Sk, tid);
      load_tile(sV + (st ^ 1) * T * 64, v + koff, rs, (j + 1) * T, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      load_a(qf, sQ, warp * 16, lane);
      load_a(dof, sDO, warp * 16, lane);
    }
    const bf16* sk = sK + st * T * 64;
    const bf16* sv = sV + st * T * 64;

    float s[8][4], dp[8][4];
    zero(s);
    mma_nt(s, qf, sk, lane);  // S2 = Qs K^T
    zero(dp);
    mma_nt(dp, dof, sv, lane);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * T + nt * 8 + 2 * t + (e & 1);
        const float p = key < Sk ? exp2f(s[nt][e] - l2r[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dlr[e >> 1]);  // dS
      }
    }
    mma_nn(acc, s, sk, lane);  // dQ += bf16(dS) K
    __syncthreads();     // this stage may be refilled next iteration
  }
  store_rows(dq + qoff, rs, acc, r0, Sq, t, scale);
}

// ------------------------------------------------------------- dK, dV
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkdv_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ l2, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);        // 64 x 64
  bf16* sV = sK + T * 64;                               // 64 x 64
  bf16* sQ = sV + T * 64;                               // 2 stages x 64 x 64
  bf16* sDO = sQ + 2 * T * 64;                          // 2 stages x 64 x 64
  float* sL2 = reinterpret_cast<float*>(sDO + 2 * T * 64);  // 2 stages x 64
  float* sDl = sL2 + 2 * T;                             // 2 stages x 64

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * T;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long rs = (long)H * 64;
  const long qoff = ((long)b * Sq * H + h) * 64, koff = ((long)b * Sk * H + h) * 64;
  const float* l2b = l2 + (long)bh * Sq;
  const float* dlb = delta + (long)bh * Sq;

  auto load_q = [&](int blk, int stage) {
    const int q0 = blk * T;
    load_tile(sQ + stage * T * 64, qs + qoff, rs, q0, Sq, tid);
    load_tile(sDO + stage * T * 64, dout + qoff, rs, q0, Sq, tid);
    if (tid < T) {
      const bool ok = q0 + tid < Sq;
      sL2[stage * T + tid] = ok ? l2b[q0 + tid] : 1e30f;  // P = 0 for absent queries
      sDl[stage * T + tid] = ok ? dlb[q0 + tid] : 0.f;
    }
  };

  load_tile(sK, k + koff, rs, k0, Sk, tid);
  load_tile(sV, v + koff, rs, k0, Sk, tid);
  load_q(0, 0);
  cp_async_commit();

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  uint32_t kf[4][4], vf[4][4];
  const int nblk = (Sq + T - 1) / T;
  for (int i = 0; i < nblk; ++i) {
    const int st = i & 1;
    if (i + 1 < nblk) {
      load_q(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) {
      load_a(kf, sK, warp * 16, lane);
      load_a(vf, sV, warp * 16, lane);
    }
    const bf16* sq = sQ + st * T * 64;
    const bf16* sdo = sDO + st * T * 64;
    const float* sl2 = sL2 + st * T;
    const float* sdl = sDl + st * T;

    float s[8][4], dp[8][4];
    zero(s);
    mma_nt(s, kf, sq, lane);  // S2^T = K Qs^T: rows are keys, columns are queries
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l = *reinterpret_cast<const float2*>(sl2 + nt * 8 + 2 * t);
      s[nt][0] = exp2f(s[nt][0] - l.x);  // P^T
      s[nt][1] = exp2f(s[nt][1] - l.y);
      s[nt][2] = exp2f(s[nt][2] - l.x);
      s[nt][3] = exp2f(s[nt][3] - l.y);
    }
    mma_nn(dv_acc, s, sdo, lane);  // dV += bf16(P^T) dO
    zero(dp);
    mma_nt(dp, vf, sdo, lane);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 d = *reinterpret_cast<const float2*>(sdl + nt * 8 + 2 * t);
      s[nt][0] *= dp[nt][0] - d.x;  // dS^T
      s[nt][1] *= dp[nt][1] - d.y;
      s[nt][2] *= dp[nt][2] - d.x;
      s[nt][3] *= dp[nt][3] - d.y;
    }
    mma_nn(dk_acc, s, sq, lane);  // dK += bf16(dS^T) Qs
    __syncthreads();        // this stage may be refilled next iteration
  }
  const int r0 = k0 + warp * 16 + g;
  store_rows(dk + koff, rs, dk_acc, r0, Sk, t, LN2);
  store_rows(dv + koff, rs, dv_acc, r0, Sk, t, 1.f);
}

bool bad_sizes(int B, int H, int Sq, int Sk) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535;
}

}  // namespace

// qs, dout, dq: (B, Sq, H, 64); k, v: (B, Sk, H, 64); contiguous bf16, 16-byte
// aligned. l2, delta: (B, H, Sq) fp32. Returns a cudaError_t code (0 on success).
extern "C" int flash_attn_bwd_dq(const void* qs, const void* k, const void* v, const void* dout,
                                 const void* l2, const void* delta, void* dq, int B, int H, int Sq,
                                 int Sk, void* stream) {
  if (bad_sizes(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = (size_t)6 * T * 64 * sizeof(bf16);
  auto kern = flash_bwd_dq_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + T - 1) / T, B * H);
  kern<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qs), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(l2),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Sq, Sk, 0.125f);
  return (int)cudaGetLastError();
}

// dk, dv: (B, Sk, H, 64) bf16; the other arguments as flash_attn_bwd_dq.
extern "C" int flash_attn_bwd_dkdv(const void* qs, const void* k, const void* v, const void* dout,
                                   const void* l2, const void* delta, void* dk, void* dv, int B,
                                   int H, int Sq, int Sk, void* stream) {
  if (bad_sizes(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = (size_t)6 * T * 64 * sizeof(bf16) + 4 * T * sizeof(float);
  auto kern = flash_bwd_dkdv_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + T - 1) / T, B * H);
  kern<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qs), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(l2),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk);
  return (int)cudaGetLastError();
}
