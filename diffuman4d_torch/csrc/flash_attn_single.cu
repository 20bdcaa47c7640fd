// Single-pass attention for Hopper (sm_90a) at head dim 64, non-causal, no
// mask: the whole key sequence of a (batch, head) row in one block.
//
// Replaces the TPU Pallas kernels of diffuman4d_tpu/ops/flash_attention.py:
//   * flash_attention_v5 / _flash_kernel_v5 (one row per program) ->
//     single_pass_kernel with one row per block (block_b = 1)
//   * flash_attention_v6 / _flash_kernel_v6 (block_b rows per program) ->
//     the same kernel with block_b rows per block
// It computes O = softmax(Q K^T / sqrt(d)) V on (B, S, H, 64) bf16 tensors as
// the TPU kernels do, with no running max and no rescale of the accumulator:
// one product S = Q K^T over all keys, one max, one exp2, one sum (fp32),
// one product of the unnormalised P (rounded to bf16) with V, then one
// divide. Unlike the TPU kernels, the scale log2(e)/sqrt(d) multiplies the
// fp32 scores (the plain version's function) instead of a bf16-rounded Q.
//
// What bounds it: at the per-frame mid-block shape (S = 256, 640 rows) the
// work is 4*S^2*d FLOPs per row against 4*S*d bytes, still far above the
// card's FLOP/byte line, so the tensor cores bound it; what it removes is
// the online softmax's per-tile rescales and the K/V pipeline's barriers.
// What limits it on this card is registers and shared memory: a warp owns
// 16 query rows and keeps their 16 x SKMAX fp32 scores in registers
// (SKMAX/2 per thread: 128 of 255 at SKMAX = 256), and each row's whole K
// and V sit in shared memory (256 * SKMAX bytes: 64 KB at 256 keys). So it
// is built for Sk <= 256 only; single_pass_ok() in ops/flash_attention.py
// states exactly these limits, and the C entry refuses anything else.
//
// Design: a block holds block_b rows; each row gets WPR warps (16 * WPR
// query rows). All threads copy every row's Q tile and K to shared memory
// with cp.async, then every row's V as a second copy group (rows past Sk
// zero-filled); each warp runs S = Q K^T and the softmax once Q and K have
// landed, and P V once V has, with mma.sync m16n8k16 bf16 and fp32
// accumulators. Keys past Sk score -1e30 (exp2 gives 0), key tiles wholly
// past Sk are skipped, query rows past Sq are not stored.

#include "mma_common.cuh"

namespace {

constexpr int D = 64;
constexpr int MAX_THREADS = 256;  // WPR * block_b <= 8 warps
constexpr float NEG_BIG = -1e30f;

template <int SKMAX, int WPR>
__global__ void __launch_bounds__(MAX_THREADS)
    single_pass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Sq, int Sk,
                       float scale_log2) {
  constexpr int BQ = WPR * 16;                        // query rows per (batch, head) row
  constexpr int ROW_ELEMS = BQ * D + 2 * SKMAX * D;   // Q tile, K, V of one row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nthreads = blockDim.x;
  const int block_b = nthreads / (32 * WPR);
  const int q0 = blockIdx.x * BQ;
  const long rs = (long)H * D;  // stride between consecutive tokens

  // every row's Q tile and K into shared memory (copy group 0), then every
  // row's V (group 1): S = Q K^T and the softmax run while V arrives
  for (int r = 0; r < block_b; ++r) {
    const int bh = blockIdx.y * block_b + r, b = bh / H, h = bh % H;
    const bf16* qb = q + ((long)b * Sq * H + h) * D;
    const bf16* kb = k + ((long)b * Sk * H + h) * D;
    bf16* sQ = smem + r * ROW_ELEMS;
    bf16* sK = sQ + BQ * D;
    for (int i = tid; i < BQ * D / 8; i += nthreads) {
      const int row = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = q0 + row < Sq;
      cp_async_16(sQ + swz<D>(row, c), qb + (long)(ok ? q0 + row : 0) * rs + c, ok);
    }
    for (int i = tid; i < SKMAX * D / 8; i += nthreads) {
      const int row = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = row < Sk;
      cp_async_16(sK + swz<D>(row, c), kb + (long)(ok ? row : 0) * rs + c, ok);
    }
  }
  cp_async_commit();
  for (int r = 0; r < block_b; ++r) {
    const int bh = blockIdx.y * block_b + r, b = bh / H, h = bh % H;
    const bf16* vb = v + ((long)b * Sk * H + h) * D;
    bf16* sV = smem + r * ROW_ELEMS + BQ * D + SKMAX * D;
    for (int i = tid; i < SKMAX * D / 8; i += nthreads) {
      const int row = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = row < Sk;
      cp_async_16(sV + swz<D>(row, c), vb + (long)(ok ? row : 0) * rs + c, ok);
    }
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q and K have landed
  __syncthreads();

  // this warp: row r of the block, query rows w*16 .. w*16+15 of its tile
  const int r = warp / WPR, w = warp % WPR;
  const int bh = blockIdx.y * block_b + r, b = bh / H, h = bh % H;
  const bf16* sQ = smem + r * ROW_ELEMS;
  const bf16* sK = sQ + BQ * D;
  const bf16* sV = sK + SKMAX * D;
  const int ntiles = (Sk + 15) / 16;  // 16-key tiles that hold a key

  // S = Q K^T over all keys: 16 rows x SKMAX keys in fp32 registers
  float s[SKMAX / 8][4];
#pragma unroll
  for (int i = 0; i < SKMAX / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sQ + swz<D>(w * 16 + (lane & 15), kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int p = 0; p < SKMAX / 16; ++p) {
      if (p < ntiles) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sK + swz<D>(p * 16 + (lane & 7) + (lane >> 4) * 8,
                                    kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * p], a, bk[0], bk[1]);
        mma_bf16(s[2 * p + 1], a, bk[2], bk[3]);
      }
    }
  }

  // one max, one exp2, one sum (rows g and g + 8 of the warp's 16)
  float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
  for (int nt = 0; nt < SKMAX / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nt * 8 + 2 * t + (e & 1);
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
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < SKMAX / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[nt][e] - mx[e >> 1]);
      s[nt][e] = p;
      l[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffff, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffff, l[i], 2);
  }

  // one product: O = P V with the unnormalised P rounded to bf16
  cp_async_wait<0>();  // V has landed
  __syncthreads();
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < SKMAX / 16; ++kk) {
    if (kk < ntiles) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sV + swz<D>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          p * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * p], a, bv[0], bv[1]);
        mma_bf16(acc[2 * p + 1], a, bv[2], bv[3]);
      }
    }
  }

  // one divide, then store
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  const int r0 = q0 + w * 16 + g, r1 = r0 + 8;
  bf16* ob = o + ((long)b * Sq * H + h) * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)r0 * rs + col) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)r1 * rs + col) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

template <int SKMAX, int WPR>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
           int block_b, cudaStream_t stream) {
  constexpr int BQ = WPR * 16;
  const size_t smem = (size_t)block_b * (BQ * D + 2 * SKMAX * D) * sizeof(bf16);
  if (WPR * block_b > MAX_THREADS / 32 || smem > 232448) return (int)cudaErrorInvalidValue;
  auto kern = single_pass_kernel<SKMAX, WPR>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H / block_b);
  kern<<<grid, 32 * WPR * block_b, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Sq, Sk, 1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int SKMAX>
int launch_wpr(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
               int Sk, int block_q, int block_b, cudaStream_t s) {
  switch (block_q) {
    case 16: return launch<SKMAX, 1>(q, k, v, o, B, H, Sq, Sk, block_b, s);
    case 32: return launch<SKMAX, 2>(q, k, v, o, B, H, Sq, Sk, block_b, s);
    case 64: return launch<SKMAX, 4>(q, k, v, o, B, H, Sq, Sk, block_b, s);
    case 128: return launch<SKMAX, 8>(q, k, v, o, B, H, Sq, Sk, block_b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, 64), k/v: (B, Sk, H, 64), o: (B, Sq, H, 64); contiguous bf16,
// 16-byte aligned. block_q in {16, 32, 64, 128} query rows per row and
// block; block_b rows of (batch * head) per block, dividing B * H; Sk <= 256.
// Returns a cudaError_t code (0 on success).
extern "C" int flash_attn_single_pass(const void* q, const void* k, const void* v, void* o, int B,
                                      int H, int Sq, int Sk, int block_q, int block_b,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || Sk > 256 || block_b <= 0 ||
      (B * H) % block_b != 0 || B * H / block_b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sk <= 128) return launch_wpr<128>(q, k, v, o, B, H, Sq, Sk, block_q, block_b, s);
  return launch_wpr<256>(q, k, v, o, B, H, Sq, Sk, block_q, block_b, s);
}
