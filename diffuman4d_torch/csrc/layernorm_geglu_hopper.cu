// LayerNorm and the GEGLU gate of the transformer blocks, over fp32, bf16 or
// fp16 rows, for Hopper (sm_90a): each reads its input once and writes its
// output once, in the input's type, with every intermediate in fp32
// registers.
//   layernorm: y = (x - mean) * rsqrt(var + eps) * w + b over the last dim C
//              of contiguous (rows, C) x; mean, then the mean of squared
//              deviations from it (the biased variance of F.layer_norm and
//              flax), in fp32; w and b upcast; one rounding.
//   geglu:     out[r, j] = T(h * float(T(gelu(g)))), h = p[r, j],
//              g = p[r, I + j], of the (rows, 2I) projection p; gelu is
//              the exact erf form x * 0.5 * (1 + erf(x * M_SQRT1_2)) in fp32.
//              Those are the two roundings of the plain version (and of the
//              JAX package's GEGLU), so the kernel gives its bits.
//
// Replaces no TPU kernel: the JAX package leaves both to XLA, which fuses
// them. Eager PyTorch does not. The plain LayerNorm makes an fp32 copy,
// normalises it in fp32 and casts back: 20 bytes moved per element where a
// bf16 read and a bf16 write need 4. The plain GEGLU copies the gate to
// fp32, applies GELU, casts back and multiplies by the strided hidden half:
// 26 bytes per output element where 6 do. Every transformer block runs 3 or
// 7 LayerNorms and 1 or 3 GEGLUs on every token of every UNet call.
//
// What bounds them: bytes. A few FLOPs an element, far below the card's ~295
// FLOP per byte. Both kernels take fp32, bf16 or fp16 (T), move it in 16-byte
// vectors of V = 16 / sizeof(T) values and compute in fp32. Design:
//   * layernorm: L lanes own a row, L the fewest (a power of two up to 32)
//     that hold it in TARGET_VPT vectors a lane, more only where 32 lanes do
//     not (the entry works it out from C); lane l holds vectors l, l + L, ...
//     of the row in registers (5 a lane at the UNet's widths in bf16: 8 / 16
//     / 32 lanes at C = 320 / 640 / 1280), so the row is read from HBM once
//     and never staged in shared memory. Each lane sums its values in order,
//     the L partials are combined by an xor butterfly (every lane ends with
//     the same bits), then the squared deviations the same way. Several rows
//     a block (256 / L) and all of a lane's loads issued before the first sum
//     keep a block's rows in flight at once (20 KB a block at C = 320 in
//     bf16). Rows past the end keep their lanes in the shuffles and store
//     nothing. w and b are of x's type.
//   * geglu: a block owns a run of whole rows; each thread takes UNROLL
//     16-byte vectors of the output, issues all 2 * UNROLL loads (hidden and
//     gate) before it uses one, and stores one vector each. No fast-math:
//     erff and the order of the products are the plain version's.
// Widths that are not a multiple of 8 are the wrapper's to refuse.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;   // threads a block
constexpr int MAX_LANES = 32;  // layernorm: lanes a row at most (one warp)
constexpr int TARGET_VPT = 8;  // layernorm: vectors a lane the layout aims for
constexpr int UNROLL = 4;      // geglu: output vectors a thread in flight
enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };  // the wrapper's dtype codes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// the values of T in a 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / (int)sizeof(T); }

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[vec<T>()]) {
  const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < vec<T>(); ++i) f[i] = to_f(h[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[vec<T>()]) {
  uint4 u;
  T* h = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < vec<T>(); ++i) h[i] = from_f<T>(f[i]);
  return u;
}

// the sum of v over the L lanes of a row's group (lanes l ^ off, off < L,
// lie in the group): each step adds the partner's partial, so every lane of
// the group holds the same bits
__device__ __forceinline__ float group_sum(float v, int L) {
  for (int off = L >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(THREADS) layernorm_kernel(
    const uint4* __restrict__ x, const uint4* __restrict__ w, const uint4* __restrict__ b,
    uint4* __restrict__ out, long rows, int nv, int lanes_log2, float eps) {
  constexpr int V = vec<T>();
  const int L = 1 << lanes_log2;
  const int lane = threadIdx.x & (L - 1);
  const long row = (long)blockIdx.x * (THREADS >> lanes_log2) + (threadIdx.x >> lanes_log2);
  const bool live = row < rows;
  const uint4* xr = x + row * nv;
  uint4 v[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int cv = k * L + lane;
    v[k] = live && cv < nv ? xr[cv] : make_uint4(0u, 0u, 0u, 0u);
  }
  const float inv_c = 1.f / (float)(nv * V);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (k * L + lane < nv) {
      float f[V];
      unpack<T>(v[k], f);
#pragma unroll
      for (int j = 0; j < V; ++j) s += f[j];
    }
  }
  const float mean = group_sum(s, L) * inv_c;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (k * L + lane < nv) {
      float f[V];
      unpack<T>(v[k], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = f[j] - mean;
        q = fmaf(d, d, q);
      }
    }
  }
  const float rstd = rsqrtf(group_sum(q, L) * inv_c + eps);
  if (!live) return;  // after the last shuffle
  uint4* orow = out + row * nv;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int cv = k * L + lane;
    if (cv < nv) {
      float f[V], wf[V], bf[V];
      unpack<T>(v[k], f);
      unpack<T>(__ldg(w + cv), wf);
      unpack<T>(__ldg(b + cv), bf);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = fmaf((f[j] - mean) * rstd, wf[j], bf[j]);
      orow[cv] = pack<T>(f);
    }
  }
}

// The row layout at C = nv * V (the fewest lanes that hold the row in
// TARGET_VPT vectors a lane) and the launch; VPT, the registers a lane
// reserves, is the smallest of 5, 8 and 16 that holds the row's vectors.
template <typename T>
cudaError_t layernorm_for(const void* x, const void* w, const void* b, void* out, long rows,
                          int C, float eps, cudaStream_t st) {
  const int nv = C / vec<T>();
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < MAX_LANES && (TARGET_VPT << lanes_log2) < nv) ++lanes_log2;
  const int vpt = (nv + (1 << lanes_log2) - 1) >> lanes_log2;
  const long per_block = THREADS >> lanes_log2;
  const dim3 grid((unsigned)((rows + per_block - 1) / per_block));
  const uint4 *xv = static_cast<const uint4*>(x), *wv = static_cast<const uint4*>(w),
              *bv = static_cast<const uint4*>(b);
  uint4* ov = static_cast<uint4*>(out);
  if (vpt <= 5)
    layernorm_kernel<T, 5><<<grid, THREADS, 0, st>>>(xv, wv, bv, ov, rows, nv, lanes_log2, eps);
  else if (vpt <= 8)
    layernorm_kernel<T, 8><<<grid, THREADS, 0, st>>>(xv, wv, bv, ov, rows, nv, lanes_log2, eps);
  else if (vpt <= 16)
    layernorm_kernel<T, 16><<<grid, THREADS, 0, st>>>(xv, wv, bv, ov, rows, nv, lanes_log2, eps);
  else
    return cudaErrorInvalidValue;  // a row above 32 lanes x 16 vectors (8 KB)
  return cudaGetLastError();
}

// the exact GELU in fp32, as PyTorch's CUDA kernel writes it
__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752440f));
}

template <typename T>
__device__ __forceinline__ uint4 geglu_vec(const uint4& hv, const uint4& gv) {
  float h[vec<T>()], g[vec<T>()];
  unpack<T>(hv, h);
  unpack<T>(gv, g);
#pragma unroll
  for (int j = 0; j < vec<T>(); ++j) h[j] *= to_f(from_f<T>(gelu_erf(g[j])));
  return pack<T>(h);
}

// Block blockIdx.x owns rows [r0, r0 + rpb); its rpb * nv output vectors are
// walked THREADS * UNROLL at a time.
template <typename T>
__global__ void __launch_bounds__(THREADS) geglu_kernel(const uint4* __restrict__ p,
                                                        uint4* __restrict__ out, long rows,
                                                        int nv, int rpb) {
  const long r0 = (long)blockIdx.x * rpb;
  const int n = (int)((rows - r0 < rpb ? rows - r0 : rpb) * nv);
  const uint4* pb = p + r0 * 2 * nv;
  uint4* ob = out + r0 * nv;
  for (int base = 0; base < n; base += THREADS * UNROLL) {
    uint4 hv[UNROLL], gv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS + threadIdx.x;
      if (i < n) {
        const int r = i / nv, c = i - r * nv;
        hv[u] = pb[(long)r * 2 * nv + c];
        gv[u] = pb[(long)r * 2 * nv + nv + c];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS + threadIdx.x;
      if (i < n) ob[i] = geglu_vec<T>(hv[u], gv[u]);
    }
  }
}

// A block takes whole rows, about THREADS * UNROLL output vectors (one at
// least).
template <typename T>
cudaError_t geglu_for(const void* p, void* out, long rows, int I, cudaStream_t st) {
  const int nv = I / vec<T>();
  const int rpb = nv >= THREADS * UNROLL ? 1 : THREADS * UNROLL / nv;
  geglu_kernel<T><<<dim3((unsigned)((rows + rpb - 1) / rpb)), THREADS, 0, st>>>(
      static_cast<const uint4*>(p), static_cast<uint4*>(out), rows, nv, rpb);
  return cudaGetLastError();
}

}  // namespace

// LayerNorm of contiguous x (rows, C) into out (rows, C), with w and b (C,)
// of x's type; dtype a Dtype code, eps_bits eps's fp32 pattern. C a multiple
// of 8 and at most 8 KB a row; every pointer 16-byte aligned; rows < 2^31
// (offsets are taken in 64 bits).
extern "C" int layernorm_fwd(const void* x, const void* w, const void* b, void* out, int rows,
                             int C, int dtype, int eps_bits, void* stream) {
  if (rows <= 0 || C <= 0 || C % 8) return (int)cudaErrorInvalidValue;
  float eps;
  memcpy(&eps, &eps_bits, sizeof eps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return (int)layernorm_for<float>(x, w, b, out, rows, C, eps, st);
    case BF16: return (int)layernorm_for<__nv_bfloat16>(x, w, b, out, rows, C, eps, st);
    case F16: return (int)layernorm_for<__half>(x, w, b, out, rows, C, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// GEGLU of the contiguous projection p (rows, 2 * I) into out (rows, I), of
// one type (dtype a Dtype code); I a multiple of 8.
extern "C" int geglu_fwd(const void* p, void* out, int rows, int I, int dtype, void* stream) {
  if (rows <= 0 || I <= 0 || I % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return (int)geglu_for<float>(p, out, rows, I, st);
    case BF16: return (int)geglu_for<__nv_bfloat16>(p, out, rows, I, st);
    case F16: return (int)geglu_for<__half>(p, out, rows, I, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
