// Fused 3x3 convolution written for Hopper (sm_90a): TMA loads, warpgroup
// MMA (wgmma) and warp specialisation,
//   out = conv3x3(silu(x * scale + shift)) + bias (+ residual)
// stride 1, SAME zero padding applied AFTER the prologue, NHWC, bf16 in and
// out, fp32 prologue / accumulation / bias.
//
// Replaces the TPU Pallas kernel diffuman4d_tpu/ops/conv.py: conv3x3 ->
// _conv3x3_pallas -> _conv_kernel, used by the VAE's resnets and upsamplers
// (and the UNet's 128^2 x 640 upsampler in training).
//
// What bounds it: an implicit GEMM with M = output pixels, N = Cout and
// K = 9 Cin: 18 Cin FLOPs per output element against about 2 (Cin + Cout)
// bytes of unique traffic, so the tensor cores, once the prologue (an
// exponential and a reciprocal per element) stays off the products' way.
// Design, in the TPU kernel's order (transform a halo window once, then run
// the 9 taps from on-chip memory):
//   * A block owns TH x TW = 4 x 32 output pixels and BN = 128 output
//     channels; warpgroup 0 produces, consumer warpgroup c computes output
//     rows 2c and 2c + 1 (64 pixels, the M of one wgmma) x 128 channels in
//     64 fp32 registers a thread.
//   * For each chunk of 64 input channels the producer brings the
//     (TH + 2) x (TW + 2) x 64 halo window by one TMA box of a 4-D map over
//     (C, W, H, B) (128-byte rows, 128-byte swizzle; parts outside the image
//     and channels past Cin arrive as zeros) into one of two buffers, so the
//     next chunk's window lands while this one's products run; and the
//     chunk's 9 weight tiles (128 output channels x 64 input channels of one
//     tap, a box of a map over (Cin, 9, Cout)) through a ring of 4 stages.
//   * The prologue runs once per element of the window, in place in the raw
//     buffer: the 256 consumer threads apply affine + SiLU in fp32, round to
//     bf16 and, where the position lies outside the image, write 0 instead
//     -- TMA's zero fill would otherwise become silu(shift), and the padding
//     must be zero after the transform. Chunk k + 1's prologue runs in nine
//     slices, one after each tap's products of chunk k are issued, so its
//     exponentials overlap the tensor cores' work.
//   * Then each transformed element is copied into three copies of the
//     window, shifted by dx = 0, 1, 2 columns (TW lines per halo row): a
//     wgmma shared-memory descriptor cannot start one 128-byte row into a
//     swizzle atom, while a dy shift is a whole halo row of 32 lines (four
//     atoms) and stays aligned. Tap (dy, dx) of consumer c is then the
//     K-major A operand at halo row 2c + dy of copy dx.
//   * The products: per tap four wgmma m64n128k16, A from the copy, B the
//     weight tile (K-major), accumulating in registers across all taps and
//     chunks; a weight stage goes back to the producer once the next tap's
//     products are issued and its own have completed.
//   * Epilogue: bias (+ residual) in fp32, stored as bf16; pixels outside
//     the image and channels past Cout are not stored.
// Cin and Cout must be multiples of 8 (16-byte TMA strides); H and W any.

#include "hopper_common.cuh"

namespace {

constexpr int TH = 4, TW = 32;           // output rows and columns per block
constexpr int HR = TH + 2, HC = TW + 2;  // halo window rows and columns
constexpr int BN = 128;                  // output channels per block
constexpr int BK = 64;                   // input channels per chunk (one 128-byte row)
constexpr int WST = 4;                   // weight ring stages
constexpr int NCONS = 256;               // consumer threads
constexpr int ERR_TENSOR_MAP = 1000;     // returned when the driver refuses a TMA map

// Shared memory (1024-byte aligned pieces): two raw halo windows, the three
// dx-shifted copies of the transformed window, the weight ring, barriers.
constexpr int RAW_BYTES = HR * HC * 128;
constexpr int RAW_STRIDE = (RAW_BYTES + 1023) / 1024 * 1024;
constexpr int COPY_BYTES = HR * TW * 128;
constexpr int W_BYTES = BN * 128;
constexpr int RAW_OFF = 0;
constexpr int COPY_OFF = RAW_OFF + 2 * RAW_STRIDE;
constexpr int W_OFF = COPY_OFF + 3 * COPY_BYTES;
constexpr int BAR_OFF = W_OFF + WST * W_BYTES;
constexpr int SMEM = BAR_OFF + (4 + 2 * WST) * 8 + 1024;  // + alignment slack
static_assert(COPY_BYTES % 1024 == 0 && (TW * 128) % 1024 == 0, "aligned copies and rows");
constexpr int NVEC = HR * HC * 8;                 // 16-byte vectors of one window
constexpr int VPT = (NVEC + NCONS - 1) / NCONS;  // of them per consumer thread

// silu(x * a + s) of a 16-byte vector of 8 bf16, rounded back to bf16
__device__ __forceinline__ uint4 prologue8(uint4 val, const float (&a)[8], const float (&s)[8],
                                           bool silu) {
  uint32_t* w32 = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    __nv_bfloat162 pr = *reinterpret_cast<__nv_bfloat162*>(&w32[e]);
    float f0 = fmaf(__low2float(pr), a[2 * e], s[2 * e]);
    float f1 = fmaf(__high2float(pr), a[2 * e + 1], s[2 * e + 1]);
    if (silu) {
      f0 *= rcp_approx(1.f + __expf(-f0));
      f1 *= rcp_approx(1.f + __expf(-f1));
    }
    w32[e] = pack_bf16(f0, f1);
  }
  return val;
}

__global__ void __launch_bounds__(384, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                         const float* __restrict__ scale, const float* __restrict__ shift,
                         const bf16* __restrict__ res, bf16* __restrict__ out, int H, int W,
                         int Cin, int Cout, int n_blocks, int silu) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
  uint64_t* raw_empty = raw_full + 2;
  uint64_t* w_full = raw_full + 4;
  uint64_t* w_empty = w_full + WST;

  const int tid = threadIdx.x, wg = tid / 128;
  const int ox0 = blockIdx.x * TW, oy0 = blockIdx.y * TH;
  const int b = blockIdx.z / n_blocks, n0 = (blockIdx.z % n_blocks) * BN;
  const int nch = (Cin + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(raw_full + i, 1);
      mbar_init(raw_empty + i, NCONS);
    }
    for (int i = 0; i < WST; ++i) {
      mbar_init(w_full + i, 1);
      mbar_init(w_empty + i, NCONS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy; chunk k + 1's window is asked
    // for before chunk k's weights, so it lands while chunk k's products run
    warpgroup_reg_dealloc<24>();
    if (tid == 0) {
      auto load_raw = [&](int k) {
        const int rb = k & 1;
        mbar_wait(raw_empty + rb, ((k >> 1) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(raw_full + rb, RAW_BYTES);
        tma_load_4d(sm + RAW_OFF + rb * RAW_STRIDE, &tm_x, raw_full + rb, k * BK, ox0 - 1, oy0 - 1,
                    b);
      };
      load_raw(0);
      for (int k = 0; k < nch; ++k) {
        if (k + 1 < nch) load_raw(k + 1);
        for (int tap = 0; tap < 9; ++tap) {
          const int i = k * 9 + tap, st = i % WST;
          mbar_wait(w_empty + st, ((i / WST) & 1) ^ 1);
          mbar_arrive_expect_tx(w_full + st, W_BYTES);
          tma_load_4d(sm + W_OFF + st * W_BYTES, &tm_w, w_full + st, k * BK, tap, n0, 0);
        }
      }
    }
    return;
  }

  warpgroup_reg_alloc<240>();
  const int ct = tid - 128, c = ct / 128, t = ct % 128, warp = t / 32, lane = t % 32,
            tq = lane % 4;
  const int cj = ct & 7;  // the 16-byte chunk (8 channels) this thread transforms
  const float* sc = scale ? scale + (long)b * Cin : nullptr;
  const float* sh = shift ? shift + (long)b * Cin : nullptr;
  const bool prologue = sc != nullptr || silu;
  float a[8], s[8];  // the affine of this thread's 8 channels of one chunk
  auto load_affine = [&](int k) {
    const int ch = k * BK + cj * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // channels past Cin arrive as zeros and meet zero weights: any finite value does
      a[e] = sc && ch < Cin ? sc[ch + e] : (ch < Cin ? 1.f : 0.f);
      s[e] = sh && ch < Cin ? sh[ch + e] : 0.f;
    }
  };
  // The prologue of vectors i0 .. i1 - 1 of this thread (vector v = ct +
  // NCONS i of the window) in chunk k's raw window, in place: affine + SiLU
  // once per element, and zero outside the image (after the transform).
  auto transform = [&](int k, int i0, int i1) {
    unsigned char* raw = sm + RAW_OFF + (k & 1) * RAW_STRIDE;
    for (int i = i0; i < i1; ++i) {
      const int v = ct + NCONS * i;
      if (v >= NVEC) break;
      const int L = v >> 3, y = L / HC, X = L - y * HC;
      const int iy = oy0 - 1 + y, ix = ox0 - 1 + X;
      uint4* p = reinterpret_cast<uint4*>(raw + L * 128 + ((cj ^ (L & 7)) << 4));
      if (iy < 0 || iy >= H || ix < 0 || ix >= W)
        *p = make_uint4(0, 0, 0, 0);
      else if (prologue)
        *p = prologue8(*p, a, s, silu);
    }
  };
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  load_affine(0);
  mbar_wait(raw_full, 0);
  transform(0, 0, VPT);

  for (int k = 0; k < nch; ++k) {
    const int rb = k & 1;
    // both consumers are done with chunk k - 1's products and chunk k's prologue
    named_bar_sync(1, NCONS);
    const unsigned char* raw = sm + RAW_OFF + rb * RAW_STRIDE;
    for (int v = ct; v < NVEC; v += NCONS) {
      const int L = v >> 3, y = L / HC, X = L - y * HC;
      const uint4 val = *reinterpret_cast<const uint4*>(raw + L * 128 + ((cj ^ (L & 7)) << 4));
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int x = X - dx;
        if (x >= 0 && x < TW)
          *reinterpret_cast<uint4*>(sm + COPY_OFF + dx * COPY_BYTES + (y * TW + x) * 128 +
                                    ((cj ^ (x & 7)) << 4)) = val;
      }
    }
    fence_proxy_async();
    mbar_arrive(raw_empty + rb);
    named_bar_sync(2, NCONS);  // the three copies are complete

    const bool next = k + 1 < nch;
    if (next) load_affine(k + 1);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int i = k * 9 + tap, st = i % WST, dy = tap / 3, dx = tap % 3;
      mbar_wait(w_full + st, (i / WST) & 1);
      const uint64_t da =
          desc_sw128(sm + COPY_OFF + dx * COPY_BYTES + (2 * c + dy) * TW * 128);
      const uint64_t db = desc_sw128(sm + W_OFF + st * W_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_m64n128k16_ss(acc, da + 2 * kk, db + 2 * kk, 1);
      wgmma_commit();
      // a ninth of chunk k + 1's prologue while this tap's products run
      if (next) {
        if (tap == 0) mbar_wait(raw_full + (rb ^ 1), ((k + 1) >> 1) & 1);
        transform(k + 1, VPT * tap / 9, VPT * (tap + 1) / 9);
      }
      if (tap > 0) {
        wgmma_wait<1>();  // the previous tap's products are done with its weights
        mbar_arrive(w_empty + (i - 1) % WST);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(w_empty + (k * 9 + 8) % WST);
  }

  // epilogue: accumulator register i holds row m = 16 warp + lane / 4
  // (+ 8 for (i >> 1) & 1) of the consumer's 64 pixels, column
  // 8 (i / 4) + 2 tq + (i & 1)
  const long HW = (long)H * W;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = warp * 16 + lane / 4 + 8 * r;
    const int oy = oy0 + 2 * c + m / TW, ox = ox0 + m % TW;
    if (oy >= H || ox >= W) continue;
    const long pix = ((long)b * HW + (long)oy * W + ox) * Cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * tq;
      if (n >= Cout) continue;
      float v0 = acc[4 * j + 2 * r] + bias[n], v1 = acc[4 * j + 2 * r + 1] + bias[n + 1];
      if (res) {
        const __nv_bfloat162 rr = *reinterpret_cast<const __nv_bfloat162*>(res + pix + n);
        v0 += __low2float(rr);
        v1 += __high2float(rr);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + pix + n) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// A 4-D bf16 tensor map, innermost dimension first, with the 128-byte
// swizzle (box[0] must be 64); false if the driver refuses it.
bool encode_4d(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
               const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x: (B, H, W, Cin) bf16; wt: (Cout, 3, 3, Cin) bf16; bias: (Cout,) fp32;
// scale/shift: (B, Cin) fp32 or null; res/out: (B, H, W, Cout) bf16, res may
// be null. All contiguous and 16-byte aligned; Cin and Cout multiples of 8.
// Returns a cudaError_t code (0 on success), or ERR_TENSOR_MAP.
extern "C" int conv3x3_fwd(const void* x, const void* wt, const void* bias, const void* scale,
                           const void* shift, const void* res, void* out, int B, int H, int W,
                           int Cin, int Cout, int silu, void* stream) {
  const int n_blocks = (Cout + BN - 1) / BN;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 8 || Cout % 8 ||
      (long)B * n_blocks > 65535 || (H + TH - 1) / TH > 65535 ||
      (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  const cuuint64_t e = 2;  // bytes per element
  if (!encode_4d(&tx, x, {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B},
                 {Cin * e, (cuuint64_t)W * Cin * e, (cuuint64_t)H * W * Cin * e},
                 {BK, HC, HR, 1}) ||
      !encode_4d(&tw, wt, {(cuuint64_t)Cin, 9, (cuuint64_t)Cout, 1},
                 {Cin * e, 9 * Cin * e, (cuuint64_t)Cout * 9 * Cin * e}, {BK, 1, BN, 1}))
    return ERR_TENSOR_MAP;
  cudaError_t err =
      cudaFuncSetAttribute(conv3x3_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_blocks);
  conv3x3_wgmma_kernel<<<grid, 384, SMEM, static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const bf16*>(res), static_cast<bf16*>(out), H, W,
      Cin, Cout, n_blocks, silu);
  return (int)cudaGetLastError();
}
