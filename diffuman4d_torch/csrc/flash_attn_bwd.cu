// Flash attention backward at head dim 64, written for Hopper (sm_90a): one
// fused kernel with TMA loads, warpgroup MMA (wgmma), warp specialisation and
// a deterministic, ordered accumulation of dQ.
//
// Replaces both TPU Pallas kernels of _bwd_impl in
// diffuman4d_tpu/ops/flash_backward.py: _dkdv_kernel (one block owns a key
// tile and streams the queries) and _dq_kernel (one block owns a query tile
// and streams the keys). The forward that also emits the per-query base-2
// logsumexp L2 (_fwd_kernel) is flash_fwd_wgmma_kernel of
// flash_attn_hopper.cu with its L2 output on.
//
// Inputs are (B, S, H, 64) bf16: Qs (Q pre-scaled by log2(e)/sqrt(d) and
// rounded to bf16 by the wrapper, the tensor the forward scored), K, V, dO;
// and (B, H, Sq) fp32: L2 and delta = rowsum(dO * O). With
// S2 = Qs K^T (fp32, base-2 logits):
//   P  = exp2(S2 - L2)             dV = bf16(P)^T  dO
//   dP = dO V^T                    dS = P * (dP - delta)
//   dQ = bf16(dS) K / sqrt(d)      dK = ln2 * bf16(dS)^T Qs
// P and dS are rounded to bf16 before their products and every product
// accumulates in fp32.
//
// What bounds it on the H100: five products of 2 B H Sq Sk 64 FLOPs each
// against O(B H S 64) bytes, so the tensor cores (989 TFLOP/s: 1,280 clocks
// of products per 64 x 128 tile of queries x keys on one SM). Between the
// products each consumer warpgroup runs the exp2 / dS chain of its 64 x 64
// half (4,096 exp2 at 16 a clock per SM), stores bf16(dS^T) for the dQ
// product and hands fp32 dQ partials (one 64 x 64 tile per query block and
// key block) on to be added in L2 in key-block order.
//
// Design (FlashAttention-3's backward, in its deterministic mode):
//   * One block owns BK = 128 keys of one (batch, head): warpgroup 0
//     produces, warpgroups 1 and 2 consume 64 keys each. K and V arrive once
//     by TMA; dK and dV stay in fp32 registers for the block's life. The
//     queries stream in blocks of BQ = 64 (Qs and dO tiles by TMA, L2 and
//     delta by the producer warp's loads) through a ring of STAGES stages
//     with full / empty mbarriers. Rows past a batch's S arrive as zeros
//     (the (64, H, S, B) tensor maps); queries past Sq get L2 = +1e30 and
//     delta = 0, keys past Sk get P = 0, so both contribute nothing.
//   * Five wgmma products per query block, on the transposed scores (keys as
//     rows): S^T = K Qs^T and dP^T = V dO^T (both operands K-major in shared
//     memory); dV += P^T dO and dK += dS^T Qs with P^T and dS^T packed to
//     bf16 in registers (the accumulator layout is the A-fragment layout) and
//     dO, Qs MN-major; and dQ_partial = dS K (64 x 64, 128 keys deep) from
//     bf16(dS^T), which both consumers store to shared memory (128 key rows
//     of 64 queries, 128-byte swizzle), read back as an MN-major A operand
//     with K MN-major.
//   * The consumers do not meet at a barrier every query block (the earlier
//     form did, so both ran their exp2 chains at once while the tensor cores
//     idled). Consumer w makes the dQ partial of the query blocks m with
//     m % 2 == w. dS^T goes through a ring of NDS buffers: both consumers
//     arrive on ds_full[m % NDS] once their half is stored, the owner arrives
//     on ds_empty once its dQ product has read the buffer, and only the
//     other consumer waits on that before it stores again. The owner issues
//     block m's dQ product one query block later, after its own dV / dK of
//     block m + 1, so the other half is almost always there: the two
//     warpgroups drift apart and one's chain runs under the other's products.
//   * Within a warpgroup every product is awaited before the loop's back
//     edge (none in flight across it: ptxas would serialise the pipeline,
//     note C7514), no wgmma input register is written while it is in flight
//     (C7513), and the dQ product sits in a branch of its own behind its own
//     wgmma fence, with its wait and the hand-off: issued in the commit group
//     of dV / dK, ptxas inserted an arrive on that divergent path and
//     serialised every product (note C7520).
//   * Registers: the producer warpgroup keeps 40 (at 24 its warps spilled)
//     and the consumers take 232: no spill.
//   * Deterministic dQ: dq_accum (B H, Sq, 64) fp32 and one semaphore per
//     (batch, head, query block) in global memory. Blocks take their (head,
//     key block) tile from a counter (zeroed per call with the semaphores)
//     in the order they start, key block fastest, so key block n - 1's
//     block is resident or done when key block n's block waits on it. The
//     owner stores its partial into one of its two staging buffers in the
//     layout of the dq_accum tensor map's box (two 64 x 32 fp32 halves with
//     the 128-byte swizzle: each float2 store of a warp takes the two
//     wavefronts its 256 bytes need, where the earlier row-major tile took
//     eight); the producer warpgroup's second warp (the dQ writer) waits
//     until the semaphore of that query block reads n, adds the tile to
//     dq_accum with two TMA tensor reduce-adds (key block 0 stores it; rows
//     past Sq are clipped by the map), waits for them to complete and sets
//     the semaphore to n + 1. So every element of dQ gets its fp32 terms in
//     key-block order: the result is bit-repeatable, and it is the bits of
//     the earlier form. A second kernel writes dQ = bf16(dq_accum / sqrt(d))
//     in (B, Sq, H, 64).
//
// Tried on the H100 and dropped (ms at B1 S49,152 H10, turns within one
// call; this form 35.0-38.2 ms, the earlier lockstep form 43.4-43.9): K and
// V as register A operands of S^T and dP^T (loaded once with ldmatrix; off
// the shared-memory limit, but 32 more registers: 24-92 bytes spilled at
// 232, 37.1-57.2 ms); K alone in registers (36.7-39.6); the two consumers
// in ping-pong on named barriers (37.4-42.5); the dQ hand-off under the next
// block's S^T / dP^T (42.4, note C7518); the next block's S^T / dP^T issued
// behind dV / dK (108 bytes spilled, 50.6-53.0); S^T / dP^T in two halves of
// 32 queries, each half's chain under the other's products (39.6-45.9: the
// chain itself grew); the bf16 packs on the integer pipe (38.3-45.1); one
// elected arrival per warp, masking only a block that ends past Sk, two
// stages, two dS^T buffers (no change beyond the calls' spread). In all of
// them each consumer spends ~3,000 clocks per query block (a clock64 trace
// of one block): products ~1,150, the exp2 / dS chain and the dS^T store
// ~1,100, barrier waits and the dQ hand-off ~700.

#include "hopper_common.cuh"

namespace {

constexpr int HD = 64;       // head dim
constexpr int ROW = HD * 2;  // bytes of one token row: one 128-byte swizzle row
constexpr int BQ = 64;       // queries per streamed block (BWD_BLOCK_Q of ops/flash_backward.py)
constexpr int BK = 128;      // keys per block: two consumer warpgroups of 64
constexpr int STAGES = 3;    // depth of the Qs / dO ring
constexpr int NDS = 4;       // dS^T buffers (owner of buffer b: consumer b % 2)
constexpr int NDQ = 4;       // dQ staging buffers, two per consumer (owner of buffer x: x % 2)
constexpr int NCONS = 256;   // consumer threads
constexpr int PROD_REGS = 40, CONS_REGS = 232;  // 40 + 2 x 232 <= 512 (65,536 / 128)
constexpr float LN2 = 0.6931471805599453f;
// Error code (not a cudaError_t) returned when the driver refuses a TMA map.
constexpr int ERR_TENSOR_MAP = 1000;

// Shared memory of one block; every tile starts on a 1024-byte boundary.
struct Layout {
  static constexpr int TILE_Q = BQ * ROW;      // one Qs or dO block
  static constexpr int TILE_K = BK * ROW;      // K, V, or one dS^T buffer (BK keys x BQ queries)
  static constexpr int TILE_DQ = BQ * HD * 4;  // one fp32 dQ partial: two 64 x 32 halves
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = TILE_K;
  static constexpr int DS_OFF = 2 * TILE_K;
  static constexpr int Q_OFF = DS_OFF + NDS * TILE_K;
  static constexpr int DO_OFF = Q_OFF + STAGES * TILE_Q;
  static constexpr int DQ_OFF = DO_OFF + STAGES * TILE_Q;
  static constexpr int VEC_OFF = DQ_OFF + NDQ * TILE_DQ;  // per stage: L2[BQ], delta[BQ]
  static constexpr int BAR_OFF = VEC_OFF + STAGES * 2 * BQ * 4;
  // K/V full; per stage full, empty; per dS^T buffer full, empty; per dQ
  // buffer full, empty; then the block's tile index
  static constexpr int NBAR = 1 + 2 * STAGES + 2 * NDS + 2 * NDQ;
  static constexpr int TILE_IDX_OFF = BAR_OFF + NBAR * 8;
  static constexpr int SMEM = TILE_IDX_OFF + 16 + 1024;  // + alignment slack
};
static_assert(Layout::SMEM <= 232448, "more shared memory than a block may have");

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Order global accesses of the generic proxy (the semaphores) with those of
// the async proxy (the TMA stores and reduce-adds).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// TMA store of a shared-memory tile to the box at (c0, c1, c2) of a 3-D
// tensor map, or an fp32 add of the tile into what global memory holds.
// Parts of the box outside the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1),
               "r"(c2)
               : "memory");
}

__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group [%0, {%2, %3, %4}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Wait until this thread's bulk copies have completed (their writes made).
__device__ __forceinline__ void bulk_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group 0;\n" ::: "memory");
}

// d (64 x 64) = A (64 x 16) B (64 x 16)^T, both K-major (the first 16-deep step)
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x 64) [+]= A (64 x 16) B (16 x 64), both MN-major
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) = A (64 x 16) B (16 x 64), both MN-major (the first step)
__device__ __forceinline__ void wgmma_ss_tt_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D (64 x 64) = A (64 x 64) B^T with A, B K-major 64-wide tiles in shared memory
__device__ __forceinline__ void mma_kmajor(float (&d)[32], uint64_t da, uint64_t db) {
  wgmma_ss_first(d, da, db);
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk) wgmma_m64n64k16_ss(d, da + 2 * kk, db + 2 * kk, 1);
}

// D (64 x 64) += X (64 x 64, bf16 A fragments in registers) B; B: 64 rows
// of the contraction index, MN-major in shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&x)[16], uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    wgmma_m64n64k16_rs_tb(d, x[4 * kk], x[4 * kk + 1], x[4 * kk + 2], x[4 * kk + 3],
                          db + 128 * kk, 1);
}

// D (64 x 64) = A B, contraction over the BK rows of two MN-major tiles
// (A: BK rows of 64 M-columns, B: BK rows of 64 N-columns)
__device__ __forceinline__ void mma_mnmajor(float (&d)[32], uint64_t da, uint64_t db) {
  wgmma_ss_tt_first(d, da, db);
#pragma unroll
  for (int kk = 1; kk < BK / 16; ++kk) wgmma_ss_tt(d, da + 128 * kk, db + 128 * kk, 1);
}

// Store the bf16 A fragments x (rows row0 and row0 + 8 of this thread,
// columns 8j + 2tq) into a tile of 128-byte rows with the 128-byte swizzle.
__device__ __forceinline__ void store_frag(unsigned char* tile, const uint32_t (&x)[16], int row0,
                                           int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      *reinterpret_cast<uint32_t*>(tile + row * ROW + ((j ^ (row & 7)) << 4) + 4 * tq) =
          x[2 * j + r];
    }
  }
}

// Store a 64 x 64 fp32 accumulator (rows 16 warp + lane / 4 (+ 8), columns
// 8j + 2tq (+ 1)) as the staging tile of the dq_accum map: two halves of 64
// rows x 32 columns (128 bytes), each with the 128-byte swizzle. One store
// instruction of a warp covers 8 rows x 32 bytes: with the swizzle, two
// wavefronts.
__device__ __forceinline__ void store_dq_tile(unsigned char* tile, const float (&d)[32], int warp,
                                              int lane) {
  const int tq = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = 16 * warp + lane / 4 + 8 * r;
      const int chunk = 2 * (j & 3) + (tq >> 1);
      *reinterpret_cast<float2*>(tile + (j >> 2) * (BQ * 128) + q * 128 +
                                 ((chunk ^ (q & 7)) << 4) + (tq & 1) * 8) =
          make_float2(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
    }
  }
}

// P^T and dS^T of one query block from S^T and dP^T; register 4j + 2r + e is
// row (key) r0 + 8r, column (query) 8j + 2tq + e; keys past Sk (key_in
// false) get P = 0.
__device__ __forceinline__ void p_and_ds(const float (&s)[32], const float (&dp)[32],
                                         const float* l2s, const float* dls, int tq,
                                         const bool (&key_in)[2], uint32_t (&pt)[16],
                                         uint32_t (&dst)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(l2s + 8 * j + 2 * tq);
    const float2 d = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * tq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 4 * j + 2 * r;
      const float p0 = key_in[r] ? ex2(s[i] - l.x) : 0.f;
      const float p1 = key_in[r] ? ex2(s[i + 1] - l.y) : 0.f;
      pt[2 * j + r] = pack_bf16(p0, p1);
      dst[2 * j + r] = pack_bf16(p0 * (dp[i] - d.x), p1 * (dp[i + 1] - d.y));
    }
  }
}

// Hand the dQ partial of query block mq (this consumer's, in dq) to the dQ
// writer through staging buffer mq % NDQ, once the writer has emptied it.
__device__ __forceinline__ void hand_dq(unsigned char* staging, uint64_t* dq_full,
                                        uint64_t* dq_empty, const float (&dq)[32], int mq,
                                        int warp, int lane) {
  const int x = mq % NDQ;
  mbar_wait(dq_empty + x, ((mq / NDQ) & 1) ^ 1);  // the first round passes at once
  store_dq_tile(staging + x * Layout::TILE_DQ, dq, warp, lane);
  fence_proxy_async();
  mbar_arrive(dq_full + x);
}

__global__ void __launch_bounds__(384, 1)
    flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ l2,
                           const float* __restrict__ delta, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int* __restrict__ sems, int H, int Sq, int Sk) {
  using L = Layout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* ds_full = empty + STAGES;
  uint64_t* ds_empty = ds_full + NDS;
  uint64_t* dq_full = ds_empty + NDS;
  uint64_t* dq_empty = dq_full + NDQ;
  int* tile_idx = reinterpret_cast<int*>(sm + L::TILE_IDX_OFF);
  float* vec = reinterpret_cast<float*>(sm + L::VEC_OFF);

  const int tid = threadIdx.x, wg = tid / 128;
  const int nk = (Sk + BK - 1) / BK, nq = (Sq + BQ - 1) / BQ;
  if (tid == 0) {
    // the tile counter hands out (head, key block) tiles in the order the
    // blocks start, so a block never waits on one that has not started
    *tile_idx = atomicAdd(sems, 1);
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1 + 32);  // the TMA bytes' arrival + the producer warp's L2 / delta
      mbar_init(empty + s, NCONS);
    }
    for (int i = 0; i < NDS; ++i) {
      mbar_init(ds_full + i, NCONS);  // both consumers' halves
      mbar_init(ds_empty + i, 128);   // the owner's dQ product has read it
    }
    for (int x = 0; x < NDQ; ++x) {
      mbar_init(dq_full + x, 128);
      mbar_init(dq_empty + x, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int tile = *tile_idx;
  const int n = tile % nk, bh = tile / nk, b = bh / H, h = bh % H;
  const int k0 = n * BK;

  if (wg == 0) {
    // producer: lane 0 of warp 0 issues the copies, its warp loads L2 / delta
    warpgroup_reg_dealloc<PROD_REGS>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * L::TILE_K);
        tma_load_4d(sm + L::K_OFF, &tm_k, kv_full, 0, h, k0, b);
        tma_load_4d(sm + L::V_OFF, &tm_v, kv_full, 0, h, k0, b);
      }
      const float* l2b = l2 + (long)bh * Sq;
      const float* dlb = delta + (long)bh * Sq;
      for (int m = 0; m < nq; ++m) {
        const int st = m % STAGES;
        mbar_wait(empty + st, ((m / STAGES) & 1) ^ 1);  // the first round passes at once
        if (lane == 0) {
          mbar_arrive_expect_tx(full + st, 2 * L::TILE_Q);
          tma_load_4d(sm + L::Q_OFF + st * L::TILE_Q, &tm_q, full + st, 0, h, m * BQ, b);
          tma_load_4d(sm + L::DO_OFF + st * L::TILE_Q, &tm_do, full + st, 0, h, m * BQ, b);
        }
        float* v = vec + st * 2 * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const int q = m * BQ + i;
          v[i] = q < Sq ? l2b[q] : 1e30f;  // P = 0 for absent queries
          v[BQ + i] = q < Sq ? dlb[q] : 0.f;
        }
        mbar_arrive(full + st);
      }
    } else if (tid < 64) {
      // the dQ writer: adds each partial to dq_accum once key block n - 1
      // has added its own (key block 0 stores it), then hands the tile on
      const int lane = tid - 32;
      int* sem = sems + 1 + (long)bh * nq;
      for (int m = 0; m < nq; ++m) {
        const int x = m % NDQ;  // made by consumer m % 2
        mbar_wait(dq_full + x, (m / NDQ) & 1);
        if (lane == 0) {
          const unsigned char* src = sm + L::DQ_OFF + x * L::TILE_DQ;
          if (n > 0) {
            while (ld_acquire(sem + m) < n) {
            }
            fence_proxy_async_global();
            tma_reduce_add_3d(&tm_dq, src, 0, m * BQ, bh);
            tma_reduce_add_3d(&tm_dq, src + BQ * 128, 32, m * BQ, bh);
          } else {
            tma_store_3d(&tm_dq, src, 0, m * BQ, bh);
            tma_store_3d(&tm_dq, src + BQ * 128, 32, m * BQ, bh);
          }
          bulk_commit_and_wait();
          fence_proxy_async_global();
          st_release(sem + m, n + 1);
          mbar_arrive(dq_empty + x);
        }
        __syncwarp();
      }
    }
  } else {
    // consumers: 64 keys per warpgroup
    warpgroup_reg_alloc<CONS_REGS>();
    const int cw = wg - 1, t = tid % 128, warp = t / 32, lane = t % 32, tq = lane % 4;
    const uint64_t desc_kw = desc_sw128(sm + L::K_OFF + cw * 64 * ROW);
    const uint64_t desc_vw = desc_sw128(sm + L::V_OFF + cw * 64 * ROW);
    const uint64_t desc_k = desc_sw128(sm + L::K_OFF);  // all BK keys: B of dQ
    unsigned char* staging = sm + L::DQ_OFF;
    // this thread's accumulator rows: keys r0 and r0 + 8 of the block
    const int r0 = cw * 64 + warp * 16 + lane / 4;
    const bool key_in[2] = {k0 + r0 < Sk, k0 + r0 + 8 < Sk};

    float dk_acc[32], dv_acc[32], s[32], dp[32], dq[32];
    uint32_t pt[16], dst[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int m = 0; m < nq; ++m) {
      const int st = m % STAGES;
      const uint64_t desc_q = desc_sw128(sm + L::Q_OFF + st * L::TILE_Q);
      const uint64_t desc_do = desc_sw128(sm + L::DO_OFF + st * L::TILE_Q);
      mbar_wait(full + st, (m / STAGES) & 1);

      // S^T = K Qs^T and dP^T = V dO^T: rows are keys, columns queries
      wgmma_fence();
      mma_kmajor(s, desc_kw, desc_q);
      mma_kmajor(dp, desc_vw, desc_do);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const float* l2s = vec + st * 2 * BQ;
      p_and_ds(s, dp, l2s, l2s + BQ, tq, key_in, pt, dst);

      // this warpgroup's half of bf16(dS^T) into the ring; the owner's dQ
      // product of the buffer's last block must have read it
      const int bd = m % NDS;
      if ((m & 1) != cw) mbar_wait(ds_empty + bd, ((m / NDS) & 1) ^ 1);
      store_frag(sm + L::DS_OFF + bd * L::TILE_K, dst, r0, tq);
      fence_proxy_async();
      mbar_arrive(ds_full + bd);

      // dV += P^T dO, dK += dS^T Qs; then block m - 1's dQ if it is ours
      const bool mine = m >= 1 && ((m - 1) & 1) == cw;
      const int bq = (m + NDS - 1) % NDS;  // block m - 1's dS^T buffer
      if (mine) mbar_wait(ds_full + bq, ((m - 1) / NDS) & 1);  // both halves stored
      wgmma_fence();
      mma_rs(dv_acc, pt, desc_do);
      mma_rs(dk_acc, dst, desc_q);
      wgmma_commit();
      if (mine) {
        wgmma_fence();
        mma_mnmajor(dq, desc_sw128(sm + L::DS_OFF + bq * L::TILE_K), desc_k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pt);
        fence_regs(dst);
        fence_regs(dq);
        mbar_arrive(empty + st);
        mbar_arrive(ds_empty + bq);
        hand_dq(staging, dq_full, dq_empty, dq, m - 1, warp, lane);
      } else {
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pt);
        fence_regs(dst);
        mbar_arrive(empty + st);
      }
    }
    if (((nq - 1) & 1) == cw) {  // the last block's dQ
      const int bq = (nq - 1) % NDS;
      mbar_wait(ds_full + bq, ((nq - 1) / NDS) & 1);
      wgmma_fence();
      mma_mnmajor(dq, desc_sw128(sm + L::DS_OFF + bq * L::TILE_K), desc_k);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      hand_dq(staging, dq_full, dq_empty, dq, nq - 1, warp, lane);
    }

    const long rs = (long)H * HD;  // elements between consecutive tokens
    bf16* dkb = dk + ((long)b * Sk * H + h) * HD;
    bf16* dvb = dv + ((long)b * Sk * H + h) * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + r0 + 8 * r;
      if (!key_in[r]) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(dkb + key * rs + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(dk_acc[i] * LN2, dk_acc[i + 1] * LN2);
        *reinterpret_cast<__nv_bfloat162*>(dvb + key * rs + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

// dq (B, Sq, H, 64) bf16 = dq_accum (B H, Sq, 64) fp32 * scale, 8 values a thread
__global__ void dq_convert_kernel(const float* __restrict__ acc, bf16* __restrict__ dq, int H,
                                  int Sq, long n8, float scale) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n8;
       i += (long)gridDim.x * blockDim.x) {
    const long e = 8 * i, row = e / HD;
    const int d = (int)(e % HD), q = (int)(row % Sq);
    const long bh = row / Sq, b = bh / H, h = bh % H;
    const float4 a = __ldcs(reinterpret_cast<const float4*>(acc + e));
    const float4 c = __ldcs(reinterpret_cast<const float4*>(acc + e + 4));
    uint4 out;
    out.x = pack_bf16(a.x * scale, a.y * scale);
    out.y = pack_bf16(a.z * scale, a.w * scale);
    out.z = pack_bf16(c.x * scale, c.y * scale);
    out.w = pack_bf16(c.z * scale, c.w * scale);
    *reinterpret_cast<uint4*>(dq + ((b * Sq + q) * H + h) * HD + d) = out;
  }
}

// The five products of the kernel above on one tile, in the kernel's forms,
// for the card tests: TMA loads of Qs, dO (64 rows each), K and V (128 rows
// each), then (1) S^T = K[:64] Qs^T, (2) dP^T = V[:64] dO^T (shared-memory
// operands, K-major), (3) bf16(S^T) dO and (4) bf16(dP^T) Qs (A from
// registers, B MN-major), and (5) T^T K, where T (128 x 64) stacks bf16(S^T)
// over bf16(dP^T), stored to shared memory by the threads and read back as
// an MN-major A operand, then written out as the kernel writes a dQ partial:
// through the swizzled staging tile and two TMA tensor stores of its map.
// out: five 64 x 64 fp32 matrices.
__global__ void __launch_bounds__(128)
    bwd_probe_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_out5, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char *sq = sm, *sdo = sm + BQ * ROW, *sk = sdo + BQ * ROW, *sv = sk + BK * ROW;
  unsigned char* sds = sv + BK * ROW;
  unsigned char* sdq = sds + BK * ROW;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sdq + Layout::TILE_DQ);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, tq = lane % 4;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 2 * (BQ + BK) * ROW);
    tma_load_4d(sq, &tm_q, bar, 0, 0, 0, 0);
    tma_load_4d(sdo, &tm_do, bar, 0, 0, 0, 0);
    tma_load_4d(sk, &tm_k, bar, 0, 0, 0, 0);
    tma_load_4d(sv, &tm_v, bar, 0, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float s[32], dp[32], a3[32], a4[32], a5[32];
  uint32_t ps[16], pdp[16];
  const int r0 = warp * 16 + lane / 4;
  auto put = [&](int which, const float(&x)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      out[which * 4096 + (r0 + 8 * ((i >> 1) & 1)) * 64 + (i / 4) * 8 + 2 * tq + (i & 1)] = x[i];
  };
  wgmma_fence();
  mma_kmajor(s, desc_sw128(sk), desc_sw128(sq));
  mma_kmajor(dp, desc_sw128(sv), desc_sw128(sdo));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  put(0, s);
  put(1, dp);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    ps[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    pdp[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
  }
  store_frag(sds, ps, r0, tq);
  store_frag(sds, pdp, 64 + r0, tq);
  fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 32; ++i) a3[i] = a4[i] = 0.f;
  wgmma_fence();
  mma_rs(a3, ps, desc_sw128(sdo));
  mma_rs(a4, pdp, desc_sw128(sq));
  mma_mnmajor(a5, desc_sw128(sds), desc_sw128(sk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(a3);
  fence_regs(a4);
  fence_regs(a5);
  put(2, a3);
  put(3, a4);
  store_dq_tile(sdq, a5, warp, lane);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    tma_store_3d(&tm_out5, sdq, 0, 0, 0);
    tma_store_3d(&tm_out5, sdq + BQ * 128, 32, 0, 0);
    bulk_commit_and_wait();
  }
}

bool bad_sizes(int B, int H, int Sq, int Sk) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535;
}

// TMA map of a contiguous (BH, Sq, 64) fp32 tensor as the 3-D array (64, Sq,
// BH), innermost first, with boxes of 32 columns x 64 rows of one (batch,
// head): 128-byte rows, 128-byte swizzle. Rows past Sq are out of bounds.
bool encode_dq_accum(CUtensorMap* map, void* base, int BH, int Sq) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {HD, (cuuint64_t)Sq, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {HD * 4, (cuuint64_t)Sq * HD * 4};
  const cuuint32_t box[3] = {32, BQ, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// qs, dout, dq: (B, Sq, H, 64); k, v, dk, dv: (B, Sk, H, 64); contiguous bf16,
// 16-byte aligned. l2, delta: (B, H, Sq) fp32. Scratch: dq_accum
// (B H, Sq, 64) fp32 and sems, 1 + B H ceil(Sq / 64) int32 (zeroed here).
// dQ, dK and dV in one launch of the fused kernel plus dQ's conversion.
// Returns a cudaError_t code (0 on success), or ERR_TENSOR_MAP.
extern "C" int flash_attn_bwd_fused(const void* qs, const void* k, const void* v,
                                    const void* dout, const void* l2, const void* delta, void* dq,
                                    void* dk, void* dv, void* dq_accum, void* sems, int B, int H,
                                    int Sq, int Sk, void* stream) {
  if (bad_sizes(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tq, tdo, tk, tv, tdq;
  if (!encode_bshd64(&tq, qs, B, Sq, H, BQ) || !encode_bshd64(&tdo, dout, B, Sq, H, BQ) ||
      !encode_bshd64(&tk, k, B, Sk, H, BK) || !encode_bshd64(&tv, v, B, Sk, H, BK) ||
      !encode_dq_accum(&tdq, dq_accum, B * H, Sq))
    return ERR_TENSOR_MAP;
  const long nq = (Sq + BQ - 1) / BQ, nk = (Sk + BK - 1) / BK;
  cudaError_t err = cudaMemsetAsync(sems, 0, (1 + (size_t)B * H * nq) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout::SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_fused_kernel<<<(unsigned)(B * H * nk), 384, Layout::SMEM, st>>>(
      tq, tdo, tk, tv, tdq, static_cast<const float*>(l2), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<int*>(sems), H, Sq, Sk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n8 = (long)B * H * Sq * HD / 8;
  const long blocks = (n8 + 255) / 256 < 132 * 16 ? (n8 + 255) / 256 : 132 * 16;
  dq_convert_kernel<<<(unsigned)blocks, 256, 0, st>>>(static_cast<const float*>(dq_accum),
                                                      static_cast<bf16*>(dq), H, Sq, n8, 0.125f);
  return (int)cudaGetLastError();
}

// Card-test probe of the five products: qs, dout (1, 64, 1, 64), k, v
// (1, 128, 1, 64) bf16; out (5, 64, 64) fp32 (see bwd_probe_kernel).
extern "C" int flash_attn_bwd_probe(const void* qs, const void* k, const void* v,
                                    const void* dout, void* out, void* stream) {
  CUtensorMap tq, tdo, tk, tv, t5;
  if (!encode_bshd64(&tq, qs, 1, BQ, 1, BQ) || !encode_bshd64(&tdo, dout, 1, BQ, 1, BQ) ||
      !encode_bshd64(&tk, k, 1, BK, 1, BK) || !encode_bshd64(&tv, v, 1, BK, 1, BK) ||
      !encode_dq_accum(&t5, static_cast<float*>(out) + 4 * BQ * HD, 1, BQ))
    return ERR_TENSOR_MAP;
  const int smem = (2 * BQ + 3 * BK) * ROW + Layout::TILE_DQ + 8 + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(bwd_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tk, tv, t5, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
