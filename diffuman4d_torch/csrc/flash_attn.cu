// Flash attention forward for Hopper (sm_90a), non-causal, no mask.
//
// Replaces the TPU Pallas kernels of diffuman4d_tpu/ops/flash_attention.py:
//   * flash_attention_v4 / _flash_kernel_v4 and flash_attention_v3 /
//     _flash_kernel_v3 (head dim 64: the UNet's 3D window attention and its
//     per-frame attention) -> flash_fwd_kernel<64, 64, 2, 4, 64, 64>
//   * flash_attention (v1) / _flash_kernel (head dim 512: the VAE mid-block
//     attention) -> flash_fwd_kernel<512, 128, 1, 4, 64, 64>
//   * flash_attention_v2 / _flash_kernel_v2 (two-level KV blocking) ->
//     flash_fwd_kernel<64, 64, 2, NW, KMAJ, KIN> with KMAJ > KIN
// All compute O = softmax(Q K^T / sqrt(d)) V on (B, S, H, D) bf16 tensors
// with an fp32 running max and normaliser, P rounded to bf16 for the PV
// product and fp32 accumulation. The scale log2(e)/sqrt(d) multiplies the
// fp32 scores (the function of the plain version, not the TPU v3/v4's
// bf16-prescaled Q), and the softmax runs in base 2.
//
// What bounds it: at the slice's shapes (S = 1,024 to 65,536, d = 64) the
// work is 4*B*H*S^2*d tensor-core FLOPs against O(B*H*S*d) bytes, so it is
// bound by the tensor cores and by how well the softmax between the two
// products hides under them. Design: FA2-style. A block of NW warps owns
// 16*NW query rows (16 per warp) and streams K/V through shared memory in
// k-major tiles of KMAJ keys with cp.async (double-buffered at d = 64); its
// warps walk each staged tile in inner chunks of KIN keys. Both products run
// as mma.sync m16n8k16 bf16 with fp32 accumulators kept in registers, and
// the online softmax runs in base 2 on the accumulator fragments. The
// default (B1/B2/B3/B5) stages one 64-key chunk per tile; B10 stages 128 or
// 256 keys per tile (one barrier pair and one copy batch per tile instead of
// per chunk, at the cost of shared memory and so of blocks per SM). At
// d = 512 the 64 x 512 output accumulator does not fit in registers, so the
// output head dim is split over gridDim.z blocks of 128 columns each; each
// of them recomputes the full-depth scores (2.5x the minimal FLOPs, small
// next to the UNet at the VAE's one-head shape). Ragged S is masked:
// out-of-range rows load as zeros, out-of-range keys score -1e30 (chunks
// wholly past Sk are skipped), out-of-range query rows are not stored.
//
// The training forward (TPU kernel _fwd_kernel of
// diffuman4d_tpu/ops/flash_backward.py) is the d = 64 instantiation with two
// differences chosen at launch: Q arrives pre-scaled by log2(e)/sqrt(d) and
// rounded to bf16 (scale_log2 = 1, so the backward kernels of
// flash_attn_bwd.cu recompute bit-identical scores), and the per-query base-2
// logsumexp L2 = m + log2(sum exp2(s - m)) is stored as (B, H, Sq) fp32.

#include "mma_common.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;

// NW warps (16 query rows each); K/V staged KMAJ keys per tile, walked in
// chunks of KIN keys
template <int D, int DV, int STAGES, int NW, int KMAJ, int KIN>
__global__ void __launch_bounds__(NW * 32)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ l2,
                     int H, int Sq, int Sk, float scale_log2) {
  static_assert(KMAJ % KIN == 0 && KIN % 16 == 0, "tile shapes");
  constexpr int BM = NW * 16;  // query rows per block
  constexpr int NTHREADS = NW * 32;
  constexpr bool QREG = D <= 128;  // keep Q fragments in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BM x D
  bf16* sK = sQ + BM * D;                         // STAGES x KMAJ x D
  bf16* sV = sK + STAGES * KMAJ * D;              // STAGES x KMAJ x DV

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
    const int k0 = blk * KMAJ;
    bf16* sk = sK + stage * KMAJ * D;
    bf16* sv = sV + stage * KMAJ * DV;
    for (int i = tid; i < KMAJ * D / 8; i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = k0 + r < Sk;
      cp_async_16(sk + swz<D>(r, c), kb + (long)(ok ? k0 + r : 0) * rs + c, ok);
    }
    for (int i = tid; i < KMAJ * DV / 8; i += NTHREADS) {
      const int r = i / (DV / 8), c = (i % (DV / 8)) * 8;
      const bool ok = k0 + r < Sk;
      cp_async_16(sv + swz<DV>(r, c), vb + (long)(ok ? k0 + r : 0) * rs + d0 + c, ok);
    }
  };

  const int nblk = (Sk + KMAJ - 1) / KMAJ;
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
    const bf16* sk = sK + st * KMAJ * D;
    const bf16* sv = sV + st * KMAJ * DV;

#pragma unroll 1
    for (int c = 0; c < KMAJ / KIN; ++c) {
      const int kbase = j * KMAJ + c * KIN;
      if (KMAJ > KIN && kbase >= Sk) break;  // the rest of a ragged last tile
      const int r0k = c * KIN;               // the chunk's first row in the tile

      // S = Q K^T for this warp's 16 rows x KIN keys
      float s[KIN / 8][4];
#pragma unroll
      for (int i = 0; i < KIN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
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
        for (int p = 0; p < KIN / 16; ++p) {
          uint32_t bk[4];
          ldmatrix_x4(bk, sk + swz<D>(r0k + p * 16 + (lane & 7) + (lane >> 4) * 8,
                                      kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * p], a, bk[0], bk[1]);
          mma_bf16(s[2 * p + 1], a, bk[2], bk[3]);
        }
      }

      // online softmax in base 2 (scale_log2 = log2(e) / sqrt(d))
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int nt = 0; nt < KIN / 8; ++nt) {
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
      for (int nt = 0; nt < KIN / 8; ++nt) {
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
      for (int kk = 0; kk < KIN / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int p = 0; p < DV / 16; ++p) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sv + swz<DV>(r0k + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                             p * 16 + (lane >> 4) * 8));
          mma_bf16(acc[2 * p], a, bv[0], bv[1]);
          mma_bf16(acc[2 * p + 1], a, bv[2], bv[3]);
        }
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
  if (l2 != nullptr && t == 0 && blockIdx.z == 0) {
    if (r0 < Sq) l2[(long)bh * Sq + r0] = m_r[0] + log2f(l_r[0]);
    if (r1 < Sq) l2[(long)bh * Sq + r1] = m_r[1] + log2f(l_r[1]);
  }
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

template <int D, int DV, int STAGES, int NW = 4, int KMAJ = 64, int KIN = 64>
int launch(const void* q, const void* k, const void* v, void* o, void* l2, float scale_log2, int B,
           int H, int Sq, int Sk, cudaStream_t stream) {
  constexpr int BM = NW * 16;
  constexpr size_t smem =
      (size_t)(BM * D + STAGES * KMAJ * D + STAGES * KMAJ * DV) * sizeof(bf16);
  auto kern = flash_fwd_kernel<D, DV, STAGES, NW, KMAJ, KIN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, B * H, D / DV);
  kern<<<grid, NW * 32, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                        static_cast<const bf16*>(v), static_cast<bf16*>(o),
                                        static_cast<float*>(l2), H, Sq, Sk, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), o: (B, Sq, H, D); contiguous bf16,
// 16-byte aligned. Returns a cudaError_t code (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, int B, int H,
                              int Sq, int Sk, int D, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  if (D == 64) return launch<64, 64, 2>(q, k, v, o, nullptr, scale_log2, B, H, Sq, Sk, s);
  if (D == 512) return launch<512, 128, 1>(q, k, v, o, nullptr, scale_log2, B, H, Sq, Sk, s);
  return (int)cudaErrorInvalidValue;
}

// The training forward at head dim 64. qs: Q already scaled by log2(e)/sqrt(d)
// and rounded to bf16; l2: (B, H, Sq) fp32 output, the base-2 logsumexp of
// each query's scores. Other arguments as flash_attn_fwd.
extern "C" int flash_attn_fwd_lse(const void* qs, const void* k, const void* v, void* o, void* l2,
                                  int B, int H, int Sq, int Sk, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535 || l2 == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch<64, 64, 2>(qs, k, v, o, l2, 1.f, B, H, Sq, Sk, static_cast<cudaStream_t>(stream));
}

// Two-level KV blocking at head dim 64 (TPU kernel _flash_kernel_v2):
// block_q query rows per block (64 or 128), k-major tiles of block_k_major
// keys staged per pipeline step (128 or 256), walked in chunks of block_k
// keys (64 or 128). Exact fp32 scale. Other arguments as flash_attn_fwd.
// The (block_q, block_k_major, block_k) triples built here are
// TWO_LEVEL_CONFIGS of diffuman4d_torch/ops/flash_attention.py.
extern "C" int flash_attn_fwd_two_level(const void* q, const void* k, const void* v, void* o,
                                        int B, int H, int Sq, int Sk, int block_q,
                                        int block_k_major, int block_k, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl = 1.4426950408889634f / sqrtf(64.f);
  const int cfg = block_q * 1000000 + block_k_major * 1000 + block_k;
  switch (cfg) {
    case 64128064: return launch<64, 64, 2, 4, 128, 64>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 64256064: return launch<64, 64, 2, 4, 256, 64>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 64256128: return launch<64, 64, 2, 4, 256, 128>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 128128064: return launch<64, 64, 2, 8, 128, 64>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 128256064: return launch<64, 64, 2, 8, 256, 64>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    case 128256128: return launch<64, 64, 2, 8, 256, 128>(q, k, v, o, nullptr, sl, B, H, Sq, Sk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
