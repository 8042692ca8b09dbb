// SSIM map over 3x3 mean windows (NHWC), forward and closed-form backward.
//
// Replaces: unsupervised_depth_opticalflow_egomotion_tpu/ops/pallas/
//   ssim_fused.py:_fwd_kernel (reached through _ssim_fwd_pallas) and
//   ssim_fused.py:_bwd_kernel (reached through _ssim_bwd_pallas).
//
// What it computes. With P1..P5 the 3x3 zero-padded box means (divisor
// always 9) of x, y, x^2, y^2, xy, C1 = 1e-4, C2 = 9e-4:
//
//   A  = 2 (P5 - P1 P2) + C2        B1 = 2 P1 P2 + C1
//   C  = (P3 - P1^2) + (P4 - P2^2) + C2      E = P1^2 + P2^2 + C1
//   s  = (B1 A) / (E C)
//
// and, for a cotangent g of s (u = g / (E C), v = -g B1 A / (E C)^2):
//
//   dP1 = 2 P2 u (A - B1) + 2 P1 v (C - E)      dP3 = dP4 = v E
//   dP2 = 2 P1 u (A - B1) + 2 P2 v (C - E)      dP5 = 2 u B1
//   dx = pool(dP1) + 2 x pool(v E) + y pool(2 u B1)
//   dy = pool(dP2) + 2 y pool(v E) + x pool(2 u B1)
//
// (the box filter is its own adjoint). Every statistic and intermediate is
// f32 whatever the input type: bf16 variances cancel. E C >= C1 C2 = 9e-8,
// so the divisions need no guard.
//
// What bounds it on the H100: bytes. The forward reads x and y and writes s
// (three tensors); the backward reads x, y, g and writes dx, dy (five), a
// few dozen flops per element. The TPU kernel kept one [H,W] channel plane
// in VMEM per grid step and so needed channel-major inputs; here a thread
// owns one element (b, y, x, c) of the NHWC tensor as it lies in memory, its
// nine neighbours are 3 rows x 3 pixels C elements apart and come through
// L1/L2, and neighbouring threads touch neighbouring addresses. The backward
// is a stencil over a stencil (an output needs statistics on a 3x3 ring,
// hence inputs on a 5x5 one), so it runs as two passes inside one C entry:
// pass 1 writes the four cotangent planes (dP1, dP2, vE, 2uB1) as one float4
// per element into an f32 scratch that the caller allocates, pass 2 box-sums
// them. Planes outside the frame do not exist (the pool's padding is zero),
// which pass 2 honours by skipping out-of-frame neighbours: it is not what
// the statistics of zero-padded inputs would give there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };

#define SSIM_C1 1.0e-4f
#define SSIM_C2 9.0e-4f

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Stats {
  float p1, p2, p3, p4, p5;  // box MEANS of x, y, x^2, y^2, xy
};

// Box means at element (b, y, x, c); idx is its flat NHWC index.
template <typename T>
__device__ __forceinline__ Stats box_stats(const T* __restrict__ xs,
                                           const T* __restrict__ ys, long long idx,
                                           int y, int x, int H, int W, int C) {
  float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f, s5 = 0.f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = x + dx;
      if (xx < 0 || xx >= W) continue;
      const long long j = idx + ((long long)dy * W + dx) * C;
      const float a = to_f(xs[j]);
      const float b = to_f(ys[j]);
      s1 += a;
      s2 += b;
      s3 += a * a;
      s4 += b * b;
      s5 += a * b;
    }
  }
  const float ninth = 1.0f / 9.0f;
  Stats st;
  st.p1 = s1 * ninth;
  st.p2 = s2 * ninth;
  st.p3 = s3 * ninth;
  st.p4 = s4 * ninth;
  st.p5 = s5 * ninth;
  return st;
}

struct Terms {
  float a, b1, c, e;
};

__device__ __forceinline__ Terms ssim_terms(const Stats& st) {
  Terms t;
  t.a = 2.0f * (st.p5 - st.p1 * st.p2) + SSIM_C2;
  t.b1 = 2.0f * st.p1 * st.p2 + SSIM_C1;
  t.c = (st.p3 - st.p1 * st.p1) + (st.p4 - st.p2 * st.p2) + SSIM_C2;
  t.e = st.p1 * st.p1 + st.p2 * st.p2 + SSIM_C1;
  return t;
}

template <typename T>
__global__ void ssim_fwd_kernel(const T* __restrict__ xs, const T* __restrict__ ys,
                                T* __restrict__ out, int H, int W, int C, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long pix = idx / C;
  const int x = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  const Terms t = ssim_terms(box_stats(xs, ys, idx, y, x, H, W, C));
  out[idx] = from_f<T>((t.b1 * t.a) / (t.e * t.c));
}

// Pass 1 of the backward: the four cotangent planes of element idx.
template <typename T>
__global__ void ssim_bwd_planes_kernel(const T* __restrict__ xs, const T* __restrict__ ys,
                                       const T* __restrict__ g, float4* __restrict__ planes,
                                       int H, int W, int C, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long pix = idx / C;
  const int x = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  const Stats st = box_stats(xs, ys, idx, y, x, H, W, C);
  const Terms t = ssim_terms(st);
  const float d = t.e * t.c;
  const float u = to_f(g[idx]) / d;
  const float v = -u * (t.b1 * t.a) / d;
  const float gab = u * (t.a - t.b1);
  const float hce = v * (t.c - t.e);
  float4 p;
  p.x = 2.0f * st.p2 * gab + 2.0f * st.p1 * hce;  // dP1
  p.y = 2.0f * st.p1 * gab + 2.0f * st.p2 * hce;  // dP2
  p.z = v * t.e;                                  // dP3 = dP4
  p.w = 2.0f * u * t.b1;                          // dP5
  planes[idx] = p;
}

// Pass 2: box-sum the planes (zero outside the frame) and apply the adjoint.
template <typename T>
__global__ void ssim_bwd_pool_kernel(const T* __restrict__ xs, const T* __restrict__ ys,
                                     const float4* __restrict__ planes, T* __restrict__ dx,
                                     T* __restrict__ dy, int H, int W, int C, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long pix = idx / C;
  const int x = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  float q1 = 0.f, q2 = 0.f, q3 = 0.f, q5 = 0.f;
#pragma unroll
  for (int oy = -1; oy <= 1; ++oy) {
    const int yy = y + oy;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int ox = -1; ox <= 1; ++ox) {
      const int xx = x + ox;
      if (xx < 0 || xx >= W) continue;
      const float4 p = planes[idx + ((long long)oy * W + ox) * C];
      q1 += p.x;
      q2 += p.y;
      q3 += p.z;
      q5 += p.w;
    }
  }
  const float ninth = 1.0f / 9.0f;
  const float a = to_f(xs[idx]);
  const float b = to_f(ys[idx]);
  dx[idx] = from_f<T>((q1 + 2.0f * a * q3 + b * q5) * ninth);
  dy[idx] = from_f<T>((q2 + 2.0f * b * q3 + a * q5) * ninth);
}

static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// x, y [B,H,W,C] (bf16 | f32) -> s [B,H,W,C] in the same type.
// Returns cudaGetLastError().
extern "C" int ssim_fwd(const void* x, const void* y, void* out, int dtype, int B,
                        int H, int W, int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * H * W * C;
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  if (dtype == kBF16)
    ssim_fwd_kernel<__nv_bfloat16><<<blocks_for(n, threads), threads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)y, (__nv_bfloat16*)out, H, W, C, n);
  else if (dtype == kF32)
    ssim_fwd_kernel<float><<<blocks_for(n, threads), threads, 0, s>>>(
        (const float*)x, (const float*)y, (float*)out, H, W, C, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x, y, g [B,H,W,C] (bf16 | f32, one type) -> dx, dy in that type. scratch
// is f32 [B,H,W,C,4] (16-byte aligned), written by pass 1 and read by pass 2
// on the same stream. Returns cudaGetLastError().
extern "C" int ssim_bwd(const void* x, const void* y, const void* g, void* dx, void* dy,
                        void* scratch, int dtype, int B, int H, int W, int C,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * H * W * C;
  if (n == 0) return (int)cudaGetLastError();
  if (((uintptr_t)scratch & 15) != 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = blocks_for(n, threads);
  float4* planes = (float4*)scratch;
  if (dtype == kBF16) {
    typedef __nv_bfloat16 T;
    ssim_bwd_planes_kernel<T><<<blocks, threads, 0, s>>>(
        (const T*)x, (const T*)y, (const T*)g, planes, H, W, C, n);
    ssim_bwd_pool_kernel<T><<<blocks, threads, 0, s>>>(
        (const T*)x, (const T*)y, planes, (T*)dx, (T*)dy, H, W, C, n);
  } else if (dtype == kF32) {
    typedef float T;
    ssim_bwd_planes_kernel<T><<<blocks, threads, 0, s>>>(
        (const T*)x, (const T*)y, (const T*)g, planes, H, W, C, n);
    ssim_bwd_pool_kernel<T><<<blocks, threads, 0, s>>>(
        (const T*)x, (const T*)y, planes, (T*)dx, (T*)dy, H, W, C, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
