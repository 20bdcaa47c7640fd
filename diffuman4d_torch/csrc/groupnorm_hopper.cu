// GroupNorm (+ SiLU) over NHWC as a pair of kernels for Hopper (sm_90a):
//   statistics: fp32 per-channel sum and sum of squares in one read of x,
//               reduced per group into the folded affine
//               scale = rstd * gamma, shift = beta - mean * scale   (fp32)
//   apply:      y = x * scale + shift, then SiLU, in fp32, stored in x's dtype
// x is (B, H*W, C), contiguous; bf16, fp16 or fp32 (gamma and beta likewise,
// in their own dtype: the model dtypes the port takes). mean and var = E[x^2] - mean^2 (clamped at 0) are the
// plain version's formula (and the JAX package's).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses its reductions and elementwise passes. Eager PyTorch does not: the
// plain version makes an fp32 copy, then some eight more full fp32 passes
// (square, two means, subtract, scale, weight, bias, cast), and SiLU one more,
// about 60 bytes moved per bf16 element. The port runs 61 GroupNorms in every
// UNet call (and the VAE's in every encode and decode), so they were kernels
// it could not do without.
//
// What bounds it: bytes. A normalisation does a few FLOPs per element, far
// below the card's ~295 FLOP per byte, so the least it can move is x read
// twice (statistics, then apply) and y written once: 6 bytes per bf16
// element. Design:
//   * Both kernels share one layout: block (TX, R) owns a contiguous run of
//     pixels (a chunk) of one image; thread (tx, ty) owns channel vector tx
//     (16 bytes: 8 bf16 or 4 fp32 channels) of pixels ty, ty + R, ... of the
//     chunk, so one block-wide step reads R whole consecutive pixels, fully
//     coalesced, and each thread keeps one channel vector's state in
//     registers (sums, or scale and shift) for the whole chunk. Four loads
//     are issued before their values are used.
//   * Statistics are kept per channel, not per group: C / G is 10, 20, 30 or
//     60 at the UNet's widths, so a vector of 8 channels crosses groups. Each
//     block sums its R rows in a fixed order through shared memory and
//     writes per-(b, chunk, channel) partials; a small finalize kernel sums a
//     group's partials (chunks, then channels) in double, in a fixed tree,
//     and writes the folded affine. No atomics: the same input gives the same
//     bits on every run.
//   * The chunk count (the wrapper's) keeps several blocks on every SM at
//     B2 x 1024^2 as at B32 x 16^2; the apply kernel reuses it.
//   * The apply reads one vector, applies the affine and SiLU in fp32 and
//     stores one vector in x's dtype: one read, one write.
// A channel count that is not a multiple of the vector width (or an x not
// 16-byte aligned) takes the same kernels with one channel per thread.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;      // threads a block aims for
constexpr int MAX_TX = 512;       // channel vectors a block covers in one pass
constexpr int UNROLL = 4;         // loads in flight per thread
constexpr int FIN_THREADS = 128;  // finalize: threads per (group, image)
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

// V consecutive channels, loaded and stored as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The block shape for nv channel vectors a pixel: TX vectors by R pixels.
struct Shape {
  int tx, r;
};
inline Shape block_shape(int nv) {
  const int tx = nv < MAX_TX ? nv : MAX_TX;
  const int r = THREADS / tx > 1 ? THREADS / tx : 1;
  return {tx, r};
}

// partial[b][chunk][0][c] = sum over the chunk's pixels of x[b, p, c],
// partial[b][chunk][1][c] = sum of squares (fp32).
template <typename T, int V>
__global__ void __launch_bounds__(MAX_TX) gn_stats_kernel(const T* __restrict__ x,
                                                          float* __restrict__ partial, int HW,
                                                          int C, int chunk_px) {
  extern __shared__ float red[];  // [2][R][TX * V]: the rows' sums, then squares
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, R = blockDim.y;
  const int b = blockIdx.y, chunk = blockIdx.x, nv = C / V, n_out = TX * V;
  const long p0 = (long)chunk * chunk_px;
  const long p1 = p0 + chunk_px < HW ? p0 + chunk_px : HW;
  const T* xb = x + (long)b * HW * C;
  float* out = partial + ((long)b * gridDim.x + chunk) * 2 * C;
  for (int cv0 = 0; cv0 < nv; cv0 += TX) {
    const int cv = cv0 + tx;
    float s[V], q[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
    if (cv < nv) {
      const T* col = xb + (long)cv * V;
      long p = p0 + ty;
      for (; p + (UNROLL - 1) * R < p1; p += UNROLL * R) {
        Pack<T, V> v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          v[u] = *reinterpret_cast<const Pack<T, V>*>(col + (p + (long)u * R) * C);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float f = to_f(v[u].v[k]);
            s[k] += f;
            q[k] = fmaf(f, f, q[k]);
          }
      }
      for (; p < p1; p += R) {
        const Pack<T, V> v = *reinterpret_cast<const Pack<T, V>*>(col + p * C);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float f = to_f(v.v[k]);
          s[k] += f;
          q[k] = fmaf(f, f, q[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[ty * n_out + tx * V + k] = s[k];
      red[(R + ty) * n_out + tx * V + k] = q[k];
    }
    __syncthreads();
    // each channel's R row sums added in row order by one thread
    for (int i = ty * TX + tx; i < 2 * n_out; i += TX * R) {
      const int which = i / n_out, j = i % n_out, c = cv0 * V + j;
      if (c < C) {
        float acc = 0.f;
        for (int r = 0; r < R; ++r) acc += red[(which * R + r) * n_out + j];
        out[which * C + c] = acc;
      }
    }
    __syncthreads();
  }
}

// One block per (group, image): the group's partials summed in double (each
// thread a fixed stride of (chunk, channel) pairs, then a fixed tree), mean
// and variance, and the folded affine of the group's channels.
template <typename P>
__global__ void __launch_bounds__(FIN_THREADS) gn_finalize_kernel(
    const float* __restrict__ partial, const P* __restrict__ gamma, const P* __restrict__ beta,
    float* __restrict__ scale, float* __restrict__ shift, int HW, int C, int G, int n_chunks,
    float eps) {
  __shared__ double red[2][FIN_THREADS];
  const int g = blockIdx.x, b = blockIdx.y, cpg = C / G, t = threadIdx.x;
  const float* pb = partial + (long)b * n_chunks * 2 * C + (long)g * cpg;
  double s = 0.0, q = 0.0;
  for (int i = t; i < n_chunks * cpg; i += FIN_THREADS) {
    const long off = (long)(i / cpg) * 2 * C + i % cpg;
    s += pb[off];
    q += pb[off + C];
  }
  red[0][t] = s;
  red[1][t] = q;
  __syncthreads();
  for (int w = FIN_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
      red[0][t] += red[0][t + w];
      red[1][t] += red[1][t + w];
    }
    __syncthreads();
  }
  const double n = (double)HW * cpg;
  const double mean = red[0][0] / n;
  const double var = fmax(red[1][0] / n - mean * mean, 0.0);
  const float rstd = (float)(1.0 / sqrt(var + (double)eps));
  const float meanf = (float)mean;
  for (int c = t; c < cpg; c += FIN_THREADS) {
    const int ch = g * cpg + c;
    const float sc = rstd * to_f(gamma[ch]);
    scale[(long)b * C + ch] = sc;
    shift[(long)b * C + ch] = to_f(beta[ch]) - meanf * sc;
  }
}

template <int V, bool SILU, typename T>
__device__ __forceinline__ Pack<T, V> affine(const Pack<T, V>& v, const float (&a)[V],
                                             const float (&s)[V]) {
  Pack<T, V> o;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float y = fmaf(to_f(v.v[k]), a[k], s[k]);
    if (SILU) y = y / (1.f + __expf(-y));
    o.v[k] = from_f<T>(y);
  }
  return o;
}

// out[b, p, c] = (silu)(x[b, p, c] * scale[b, c] + shift[b, c])
template <typename T, int V, bool SILU>
__global__ void __launch_bounds__(MAX_TX) gn_apply_kernel(const T* __restrict__ x,
                                                          const float* __restrict__ scale,
                                                          const float* __restrict__ shift,
                                                          T* __restrict__ out, int HW, int C,
                                                          int chunk_px) {
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, R = blockDim.y;
  const int b = blockIdx.y, nv = C / V;
  const long p0 = (long)blockIdx.x * chunk_px;
  const long p1 = p0 + chunk_px < HW ? p0 + chunk_px : HW;
  const long base = (long)b * HW * C;
  for (int cv = tx; cv < nv; cv += TX) {
    float a[V], s[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a[k] = scale[(long)b * C + cv * V + k];
      s[k] = shift[(long)b * C + cv * V + k];
    }
    const T* xc = x + base + (long)cv * V;
    T* oc = out + base + (long)cv * V;
    long p = p0 + ty;
    for (; p + (UNROLL - 1) * R < p1; p += UNROLL * R) {
      Pack<T, V> v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = *reinterpret_cast<const Pack<T, V>*>(xc + (p + (long)u * R) * C);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        *reinterpret_cast<Pack<T, V>*>(oc + (p + (long)u * R) * C) = affine<V, SILU>(v[u], a, s);
    }
    for (; p < p1; p += R)
      *reinterpret_cast<Pack<T, V>*>(oc + p * C) =
          affine<V, SILU>(*reinterpret_cast<const Pack<T, V>*>(xc + p * C), a, s);
  }
}

// 16-byte vectors where the channels and the pointers allow, else one channel
template <typename T>
bool vectorised(int C, const void* a, const void* b = nullptr) {
  constexpr int V = 16 / sizeof(T);
  return C % V == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
}

template <typename T, int V>
cudaError_t launch_stats(const void* x, float* partial, int B, int HW, int C, int n_chunks,
                         cudaStream_t stream) {
  const Shape sh = block_shape(C / V);
  const int chunk_px = (HW + n_chunks - 1) / n_chunks;
  const size_t smem = 2 * sizeof(float) * sh.r * sh.tx * V;
  gn_stats_kernel<T, V><<<dim3(n_chunks, B), dim3(sh.tx, sh.r), smem, stream>>>(
      static_cast<const T*>(x), partial, HW, C, chunk_px);
  return cudaGetLastError();
}

template <typename T>
cudaError_t stats_for(const void* x, float* partial, int B, int HW, int C, int n_chunks,
                      cudaStream_t stream) {
  return vectorised<T>(C, x) ? launch_stats<T, 16 / sizeof(T)>(x, partial, B, HW, C, n_chunks, stream)
                             : launch_stats<T, 1>(x, partial, B, HW, C, n_chunks, stream);
}

template <typename P>
cudaError_t finalize_for(const float* partial, const void* gamma, const void* beta,
                         float* scale, float* shift, int B, int HW, int C, int G, int n_chunks,
                         float eps, cudaStream_t stream) {
  gn_finalize_kernel<P><<<dim3(G, B), FIN_THREADS, 0, stream>>>(
      partial, static_cast<const P*>(gamma), static_cast<const P*>(beta), scale, shift, HW, C, G,
      n_chunks, eps);
  return cudaGetLastError();
}

template <typename T, int V, bool SILU>
cudaError_t launch_apply(const void* x, const float* scale, const float* shift, void* out, int B,
                         int HW, int C, int n_chunks, cudaStream_t stream) {
  const Shape sh = block_shape(C / V);
  const int chunk_px = (HW + n_chunks - 1) / n_chunks;
  gn_apply_kernel<T, V, SILU><<<dim3(n_chunks, B), dim3(sh.tx, sh.r), 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<T*>(out), HW, C, chunk_px);
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply_for(const void* x, const float* scale, const float* shift, void* out, int B,
                      int HW, int C, int n_chunks, bool silu, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vectorised<T>(C, x, out))
    return silu ? launch_apply<T, V, true>(x, scale, shift, out, B, HW, C, n_chunks, stream)
                : launch_apply<T, V, false>(x, scale, shift, out, B, HW, C, n_chunks, stream);
  return silu ? launch_apply<T, 1, true>(x, scale, shift, out, B, HW, C, n_chunks, stream)
              : launch_apply<T, 1, false>(x, scale, shift, out, B, HW, C, n_chunks, stream);
}

bool sizes_ok(int B, int HW, int C, int n_chunks) {
  return B > 0 && B <= 65535 && HW > 0 && C > 0 && n_chunks > 0 && n_chunks <= HW;
}

}  // namespace

// The statistics kernel and its finalize: per-(b, channel) folded affine
// (scale, shift), each (B, C) fp32. partial is (B, n_chunks, 2, C) fp32
// scratch. eps_bits is eps's fp32 bit pattern; dtypes are Dtype codes.
extern "C" int groupnorm_stats(const void* x, const void* gamma, const void* beta, void* partial,
                               void* scale, void* shift, int B, int HW, int C, int G,
                               int n_chunks, int x_dtype, int p_dtype, int eps_bits,
                               void* stream) {
  if (!sizes_ok(B, HW, C, n_chunks) || G <= 0 || G > 65535 || C % G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  switch (x_dtype) {
    case F32: err = stats_for<float>(x, part, B, HW, C, n_chunks, st); break;
    case BF16: err = stats_for<__nv_bfloat16>(x, part, B, HW, C, n_chunks, st); break;
    case F16: err = stats_for<__half>(x, part, B, HW, C, n_chunks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  float eps;
  memcpy(&eps, &eps_bits, sizeof eps);
  float* sc = static_cast<float*>(scale);
  float* sh = static_cast<float*>(shift);
  switch (p_dtype) {
    case F32:
      return (int)finalize_for<float>(part, gamma, beta, sc, sh, B, HW, C, G, n_chunks, eps, st);
    case BF16:
      return (int)finalize_for<__nv_bfloat16>(part, gamma, beta, sc, sh, B, HW, C, G, n_chunks,
                                              eps, st);
    case F16:
      return (int)finalize_for<__half>(part, gamma, beta, sc, sh, B, HW, C, G, n_chunks, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The apply kernel: out = (silu)(x * scale + shift), out in x's dtype.
extern "C" int groupnorm_apply(const void* x, const void* scale, const void* shift, void* out,
                               int B, int HW, int C, int n_chunks, int dtype, int silu,
                               void* stream) {
  if (!sizes_ok(B, HW, C, n_chunks)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  switch (dtype) {
    case F32: return (int)apply_for<float>(x, sc, sh, out, B, HW, C, n_chunks, silu, st);
    case BF16: return (int)apply_for<__nv_bfloat16>(x, sc, sh, out, B, HW, C, n_chunks, silu, st);
    case F16: return (int)apply_for<__half>(x, sc, sh, out, B, HW, C, n_chunks, silu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
