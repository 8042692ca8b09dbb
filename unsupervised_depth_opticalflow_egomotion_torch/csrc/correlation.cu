// PWC cost volume (81 shifts at md=4), forward and backward, NHWC.
//
// Replaces: unsupervised_depth_opticalflow_egomotion_tpu/ops/pallas/
//   correlation_fused.py:_fwd_kernel (via _corr_fwd_pallas) and
//   _bwd_df1_kernel / _bwd_df2_kernel (via _corr_bwd_pallas).
//
// What it computes, with D = (2md+1)^2 shifts d = (i, j) in row-major order:
//   out[b,y,x,d] = (1/C) sum_c f1[b,y,x,c] * f2[b, y+i-md, x+j-md, c]
// with zero padding outside f2;
//   df1[b,y,x,c] = (1/C) sum_d g[b,y,x,d] * f2[b, y+i-md, x+j-md, c]
//   df2[b,y,x,c] = (1/C) sum_d g[b, y-i+md, x-j+md, d] * f1[b, y-i+md, x-j+md, c]
// The df2 form is the gather (transpose) of the TPU kernel's scatter into a
// padded accumulator: each thread owns one output element, so no atomics and
// the sums are deterministic. Products and sums are f32; results are stored
// in the input dtype (bf16 or f32). The TPU forward multiplies in bf16 before
// its f32 sum; this one multiplies in f32.
//
// What bounds it on the H100: at the PWC levels (C = 32..196) each output
// element costs C multiply-adds over 2C input values, a few flops per byte
// read, so the kernels sit near the memory side of the roofline; the
// cost volume itself (81 values per pixel) dominates the bytes at the fine
// levels. The TPU kernels kept a whole batch item resident in VMEM in a
// channel-major layout sized to 128-lane tiles. Here the layout stays NHWC,
// so each thread's C loop (forward) reads contiguous channels, and in the
// backward neighbouring threads own neighbouring channels, so the feature
// reads coalesce and the cost-volume value is a broadcast. Reused rows stay
// in L1/L2; shared-memory tiling is left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// one thread per output element (b, y, x, d)
template <typename T>
__global__ void corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                                T* __restrict__ out, int H, int W, int C, int md,
                                long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int nd = 2 * md + 1;
  const int D = nd * nd;
  const int d = (int)(idx % D);
  const long long pix = idx / D;  // (b*H + y)*W + x
  const int x = (int)(pix % W);
  const long long by = pix / W;
  const int y = (int)(by % H);
  const long long b = by / H;
  const int y2 = y + d / nd - md;
  const int x2 = x + d % nd - md;
  float acc = 0.f;
  if (y2 >= 0 && y2 < H && x2 >= 0 && x2 < W) {
    const T* a = f1 + pix * C;
    const T* s = f2 + ((b * H + y2) * W + x2) * C;
    for (int c = 0; c < C; ++c) acc += to_f(a[c]) * to_f(s[c]);
  }
  out[idx] = from_f<T>(acc * (1.0f / (float)C));
}

// one thread per df1 element (b, y, x, c)
template <typename T>
__global__ void corr_bwd_df1_kernel(const T* __restrict__ g, const T* __restrict__ f2,
                                    T* __restrict__ df1, int H, int W, int C, int md,
                                    long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int nd = 2 * md + 1;
  const int D = nd * nd;
  const int c = (int)(idx % C);
  const long long pix = idx / C;
  const int x = (int)(pix % W);
  const long long by = pix / W;
  const int y = (int)(by % H);
  const long long b = by / H;
  const T* gp = g + pix * D;
  float acc = 0.f;
  for (int i = 0; i < nd; ++i) {
    const int y2 = y + i - md;
    if (y2 < 0 || y2 >= H) continue;
    for (int j = 0; j < nd; ++j) {
      const int x2 = x + j - md;
      if (x2 < 0 || x2 >= W) continue;
      acc += to_f(gp[i * nd + j]) * to_f(f2[((b * H + y2) * W + x2) * C + c]);
    }
  }
  df1[idx] = from_f<T>(acc * (1.0f / (float)C));
}

// one thread per df2 element (b, y, x, c): gather over the 81 output pixels
// whose shift lands on (y, x)
template <typename T>
__global__ void corr_bwd_df2_kernel(const T* __restrict__ g, const T* __restrict__ f1,
                                    T* __restrict__ df2, int H, int W, int C, int md,
                                    long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int nd = 2 * md + 1;
  const int D = nd * nd;
  const int c = (int)(idx % C);
  const long long pix = idx / C;
  const int x = (int)(pix % W);
  const long long by = pix / W;
  const int y = (int)(by % H);
  const long long b = by / H;
  float acc = 0.f;
  for (int i = 0; i < nd; ++i) {
    const int y1 = y - i + md;
    if (y1 < 0 || y1 >= H) continue;
    for (int j = 0; j < nd; ++j) {
      const int x1 = x - j + md;
      if (x1 < 0 || x1 >= W) continue;
      const long long q = (b * H + y1) * W + x1;
      acc += to_f(g[q * D + i * nd + j]) * to_f(f1[q * C + c]);
    }
  }
  df2[idx] = from_f<T>(acc * (1.0f / (float)C));
}

static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// f1, f2 [B,H,W,C] -> out [B,H,W,(2md+1)^2], all of dtype (bf16 | f32).
extern "C" int corr_fwd(const void* f1, const void* f2, void* out, int dtype,
                        int B, int H, int W, int C, int md, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * H * W * (2 * md + 1) * (2 * md + 1);
  if (n == 0) return (int)cudaGetLastError();
  const int t = 256;
  if (dtype == kBF16)
    corr_fwd_kernel<__nv_bfloat16><<<blocks_for(n, t), t, 0, s>>>(
        (const __nv_bfloat16*)f1, (const __nv_bfloat16*)f2, (__nv_bfloat16*)out,
        H, W, C, md, n);
  else if (dtype == kF32)
    corr_fwd_kernel<float><<<blocks_for(n, t), t, 0, s>>>(
        (const float*)f1, (const float*)f2, (float*)out, H, W, C, md, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// g [B,H,W,D], f2 [B,H,W,C] -> df1 [B,H,W,C]
extern "C" int corr_bwd_df1(const void* g, const void* f2, void* df1, int dtype,
                            int B, int H, int W, int C, int md, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * H * W * C;
  if (n == 0) return (int)cudaGetLastError();
  const int t = 256;
  if (dtype == kBF16)
    corr_bwd_df1_kernel<__nv_bfloat16><<<blocks_for(n, t), t, 0, s>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)f2, (__nv_bfloat16*)df1,
        H, W, C, md, n);
  else if (dtype == kF32)
    corr_bwd_df1_kernel<float><<<blocks_for(n, t), t, 0, s>>>(
        (const float*)g, (const float*)f2, (float*)df1, H, W, C, md, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// g [B,H,W,D], f1 [B,H,W,C] -> df2 [B,H,W,C]
extern "C" int corr_bwd_df2(const void* g, const void* f1, void* df2, int dtype,
                            int B, int H, int W, int C, int md, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * H * W * C;
  if (n == 0) return (int)cudaGetLastError();
  const int t = 256;
  if (dtype == kBF16)
    corr_bwd_df2_kernel<__nv_bfloat16><<<blocks_for(n, t), t, 0, s>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)f1, (__nv_bfloat16*)df2,
        H, W, C, md, n);
  else if (dtype == kF32)
    corr_bwd_df2_kernel<float><<<blocks_for(n, t), t, 0, s>>>(
        (const float*)g, (const float*)f1, (float*)df2, H, W, C, md, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
