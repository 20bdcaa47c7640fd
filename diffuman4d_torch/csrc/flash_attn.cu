// Flash attention forward for Hopper (sm_90a), non-causal, no mask.
//
// Replaces the TPU Pallas kernels flash_attention_v4 / _flash_kernel_v4 and
// flash_attention_v3 / _flash_kernel_v3 of
// diffuman4d_tpu/ops/flash_attention.py (head dim 64: the UNet's 3D window
// attention and its per-frame attention) -> flash_fwd_kernel<64, 64, 2>.
// Both compute O = softmax(Q K^T / sqrt(d)) V on (B, S, H, D) bf16 tensors
// with an fp32 running max and normaliser, P rounded to bf16 for the PV
// product and fp32 accumulation. The two-level forward (flash_attention_v2)
// and the training forward (_fwd_kernel) at d = 64 are the TMA / wgmma
// kernel of flash_attn_hopper.cu, the head-dim-512 forward (flash_attention
// v1) that of flash_attn_d512.cu. The template keeps the generality (head
// dim split over gridDim.z, one K/V stage, Q from shared memory) that its
// d = 512 instance used until that moved to flash_attn_d512.cu, so that the
// d = 64 instance compiles exactly as before: it is the clock control of
// bench_attention_fwd.py.
//
// What bounds it: at the slice's shapes (S = 1,024 to 65,536, d = 64) the
// work is 4*B*H*S^2*d tensor-core FLOPs against O(B*H*S*d) bytes, so it is
// bound by the tensor cores and by how well the softmax between the two
// products hides under them. Design: FA2-style. A block of 4 warps owns 64
// query rows (16 per warp) and streams 64-key K/V tiles through shared
// memory with cp.async (double-buffered at d = 64), both products run as
// mma.sync m16n8k16 bf16 with fp32 accumulators kept in registers, and the
// online softmax runs in base 2 on the accumulator fragments. Ragged S is
// masked: out-of-range rows load as zeros, out-of-range keys score -1e30,
// out-of-range query rows are not stored.

#include "mma_common.cuh"

namespace {

constexpr int BM = 64;  // query rows per block (16 per warp)
constexpr int BN = 64;  // keys per K/V tile
constexpr int NTHREADS = 128;
constexpr float NEG_BIG = -1e30f;

template <int D, int DV, int STAGES>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Sq, int Sk,
                     float scale_log2) {
  constexpr bool QREG = D <= 128;  // keep Q fragments in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BM x D
  bf16* sK = sQ + BM * D;                         // STAGES x BN x D
  bf16* sV = sK + STAGES * BN * D;                // STAGES x BN x DV

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int d0 = blockIdx.z * DV;  // this block's slice of the output head dim
  const long rs = (long)H * D;     // stride between consecutive tokens
  const bf16* qb = q + ((long)b * Sq * H + h) * D;
  const bf16* kb = k + ((long)b * Sk * H + h) * D;
  const bf16* vb = v + ((long)b * Sk * H + h) * D;
  bf16* ob = o + ((long)b * Sq * H + h) * D;

  for (int i = tid; i < BM * D / 8; i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = q0 + r < Sq;
    cp_async_16(sQ + swz<D>(r, c), qb + (long)(ok ? q0 + r : 0) * rs + c, ok);
  }
  auto load_kv = [&](int blk, int stage) {
    const int k0 = blk * BN;
    bf16* sk = sK + stage * BN * D;
    bf16* sv = sV + stage * BN * DV;
    for (int i = tid; i < BN * D / 8; i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = k0 + r < Sk;
      cp_async_16(sk + swz<D>(r, c), kb + (long)(ok ? k0 + r : 0) * rs + c, ok);
    }
    for (int i = tid; i < BN * DV / 8; i += NTHREADS) {
      const int r = i / (DV / 8), c = (i % (DV / 8)) * 8;
      const bool ok = k0 + r < Sk;
      cp_async_16(sv + swz<DV>(r, c), vb + (long)(ok ? k0 + r : 0) * rs + d0 + c, ok);
    }
  };

  const int nblk = (Sk + BN - 1) / BN;
  load_kv(0, 0);
  cp_async_commit();

  float m_r[2] = {NEG_BIG, NEG_BIG};  // running max (base 2) of rows g, g+8
  float l_r[2] = {0.f, 0.f};          // this thread's partial normaliser
  float acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  uint32_t qf[QREG ? D / 16 : 1][4];

  for (int j = 0; j < nblk; ++j) {
    const int st = STAGES == 2 ? (j & 1) : 0;
    if (STAGES == 2) {
      if (j + 1 < nblk) {
        load_kv(j + 1, (j + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (j > 0) {
        load_kv(j, 0);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[kk], sQ + swz<D>(warp * 16 + (lane & 15), kk * 16 + (lane >> 4) * 8));
      }
    }
    const bf16* sk = sK + st * BN * D;
    const bf16* sv = sV + st * BN * DV;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
        a[0] = qf[kk][0];
        a[1] = qf[kk][1];
        a[2] = qf[kk][2];
        a[3] = qf[kk][3];
      } else {
        ldmatrix_x4(a, sQ + swz<D>(warp * 16 + (lane & 15), kk * 16 + (lane >> 4) * 8));
      }
#pragma unroll
      for (int p = 0; p < BN / 16; ++p) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sk + swz<D>(p * 16 + (lane & 7) + (lane >> 4) * 8,
                                    kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * p], a, bk[0], bk[1]);
        mma_bf16(s[2 * p + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax in base 2 (scale_log2 = log2(e) / sqrt(d))
    const int kbase = j * BN;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kbase + nt * 8 + 2 * t + (e & 1);
        const float val = key < Sk ? s[nt][e] * scale_log2 : NEG_BIG;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 2));
    }
    const float alpha0 = exp2f(m_r[0] - mx[0]), alpha1 = exp2f(m_r[1] - mx[1]);
    m_r[0] = mx[0];
    m_r[1] = mx[1];
    l_r[0] *= alpha0;
    l_r[1] *= alpha1;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - mx[e >> 1]);
        s[nt][e] = p;
        l_r[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // O += P V (P from the score fragments, rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int p = 0; p < DV / 16; ++p) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sv + swz<DV>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                           p * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * p], a, bv[0], bv[1]);
        mma_bf16(acc[2 * p + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage may be refilled next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffff, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffff, l_r[i], 2);
  }
  const float inv0 = 1.f / l_r[0], inv1 = 1.f / l_r[1];
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < DV / 8; ++dt) {
    const int col = d0 + dt * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)r0 * rs + col) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)r1 * rs + col) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

template <int D, int DV, int STAGES>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
           cudaStream_t stream) {
  constexpr size_t smem = (size_t)(BM * D + STAGES * BN * D + STAGES * BN * DV) * sizeof(bf16);
  auto kern = flash_fwd_kernel<D, DV, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, B * H, D / DV);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kern<<<grid, NTHREADS, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                         static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Sq,
                                         Sk, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), o: (B, Sq, H, D); contiguous bf16,
// 16-byte aligned; D must be 64. Returns a cudaError_t code (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, int B, int H,
                              int Sq, int Sk, int D, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64, 64, 2>(q, k, v, o, B, H, Sq, Sk, s);
  return (int)cudaErrorInvalidValue;
}
