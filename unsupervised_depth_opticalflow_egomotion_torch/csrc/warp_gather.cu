// Bilinear warp gather of a 3-channel image: the forward with the analytic
// coordinate derivatives fused in (warp_gather), the forward without them
// (warp_gather_nograd) and the coordinate backward that re-gathers the taps
// (warp_gather_bwd).
//
// Replaces: unsupervised_depth_opticalflow_egomotion_tpu/ops/pallas/
//   warp_window.py:_fwd_kernel with with_grads=True (reached through
//   _warp_u8_fused_fwd) -> warp_gather; the same body with with_grads=False
//   (reached through _warp_u8_fwd) -> warp_gather_nograd;
//   warp_window.py:_bwd_kernel (reached through _warp_u8_bwd) ->
//   warp_gather_bwd. Public entries there: warp_gather_u8rgb /
//   warp_gather_bf16x3 with fused=True / fused=False.
//
// What it computes, per output pixel p = (b, y, x) with source position
// (ix[p], iy[p]) in pixels: the zeros-padded bilinear sample of src[b] in
// the pre-clipped patch-start form of _pos_weights (warp_window.py:70-93):
// the 2x2 patch starts at clip(floor(i), 0, size-2) along each axis and each
// patch position carries the weight of whichever in-bounds tap lands on it.
// Outputs: rgb (scaled by 1/255 for uint8 sources), weight_sum (the sample
// of an all-ones image), and 6 f32 planes d(rgb)/dix, d(rgb)/diy under the
// same rule (a selected tap's weight moves by -1 or +1 with the coordinate,
// floor contributes 0).
//
// What bounds it on the H100: bytes. Per pixel it reads 8 coordinate bytes
// and 12 source taps (4 x 3 channels) and writes 3+1 outputs plus 24 bytes
// of derivative planes; a handful of flops each. The TPU kernel's VMEM row
// windows, i32 lane packing and displacement clamp existed because the TPU
// has no fast global gather. Here one thread per output pixel gathers its
// taps straight from global memory through L1/L2: neighbouring threads read
// neighbouring source pixels for smooth flows, so the taps mostly hit cache
// lines already fetched, and the kernel is exact at any displacement (no
// window, hence no guard). Coordinate, output and derivative traffic is
// coalesced.
//
// The two routes trade bytes for a second gather. warp_gather writes 24
// bytes of derivative planes per pixel that its elementwise backward reads
// again. warp_gather_nograd writes none; warp_gather_bwd then recomputes the
// tap weights from the coordinates, gathers the same 12 taps again and
// contracts them with the cotangents in registers: it reads the source, the
// coordinates and 3+1 cotangents and writes two f32 planes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };

__device__ __forceinline__ float to_f(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Taps {
  int start;               // patch start, in [0, size-2]
  float w0, w1, dw0, dw1;  // weights of start / start+1 and d/di
};

__device__ __forceinline__ Taps pos_weights(float i, int size) {
  const float i0 = floorf(i);
  const float frac = i - i0;
  const bool inb_lo = (i0 >= 0.f) && (i0 <= (float)(size - 1));
  const bool inb_hi = (i0 >= -1.f) && (i0 <= (float)(size - 2));
  // fmaxf maps a NaN coordinate to 0, so the patch stays in bounds
  const float start = fminf(fmaxf(i0, 0.f), (float)(size - 2));
  const bool lo0 = inb_lo && (start == i0);
  const bool hi0 = inb_hi && (start == i0 + 1.f);
  const bool lo1 = inb_lo && (start + 1.f == i0);
  const bool hi1 = inb_hi && (start + 1.f == i0 + 1.f);
  Taps t;
  t.start = (int)start;
  t.w0 = (lo0 ? 1.f - frac : 0.f) + (hi0 ? frac : 0.f);
  t.w1 = (lo1 ? 1.f - frac : 0.f) + (hi1 ? frac : 0.f);
  t.dw0 = (lo0 ? -1.f : 0.f) + (hi0 ? 1.f : 0.f);
  t.dw1 = (lo1 ? -1.f : 0.f) + (hi1 ? 1.f : 0.f);
  return t;
}

template <typename TS, typename TO, bool WITH_GRADS>
__global__ void warp_gather_kernel(const TS* __restrict__ src,
                                   const float* __restrict__ ix,
                                   const float* __restrict__ iy,
                                   TO* __restrict__ rgb, TO* __restrict__ wsum,
                                   float* __restrict__ dplanes, int H, int W,
                                   long long hw_out, long long n, float scale) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const long long b = p / hw_out;
  const Taps tx = pos_weights(ix[p], W);
  const Taps ty = pos_weights(iy[p], H);
  const TS* r0 = src + ((b * H + ty.start) * (long long)W + tx.start) * 3;
  const TS* r1 = r0 + (long long)W * 3;
  float v[3], dx[3], dy[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a00 = to_f(r0[c]), a01 = to_f(r0[3 + c]);
    const float a10 = to_f(r1[c]), a11 = to_f(r1[3 + c]);
    const float row0 = tx.w0 * a00 + tx.w1 * a01;
    const float row1 = tx.w0 * a10 + tx.w1 * a11;
    v[c] = ty.w0 * row0 + ty.w1 * row1;
    dx[c] = ty.w0 * (tx.dw0 * a00 + tx.dw1 * a01) +
            ty.w1 * (tx.dw0 * a10 + tx.dw1 * a11);
    dy[c] = ty.dw0 * row0 + ty.dw1 * row1;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rgb[p * 3 + c] = from_f<TO>(v[c] * scale);
    if (WITH_GRADS) {
      dplanes[p * 6 + c] = dx[c] * scale;
      dplanes[p * 6 + 3 + c] = dy[c] * scale;
    }
  }
  wsum[p] = from_f<TO>((ty.w0 + ty.w1) * (tx.w0 + tx.w1));
}

// Coordinate backward by re-gathering: d/dix, d/diy of sum(g_rgb * rgb) +
// g_w * wsum. Either cotangent may be absent (a null pointer). The 1/255 of
// a uint8 source scales the rgb part only.
template <typename TS, typename TG>
__global__ void warp_gather_bwd_kernel(const TS* __restrict__ src,
                                       const float* __restrict__ ix,
                                       const float* __restrict__ iy,
                                       const TG* __restrict__ g_rgb,
                                       const TG* __restrict__ g_w,
                                       float* __restrict__ dix, float* __restrict__ diy,
                                       int H, int W, long long hw_out, long long n,
                                       float scale) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const long long b = p / hw_out;
  const Taps tx = pos_weights(ix[p], W);
  const Taps ty = pos_weights(iy[p], H);
  float gx = 0.f, gy = 0.f;
  if (g_rgb != nullptr) {
    const TS* r0 = src + ((b * H + ty.start) * (long long)W + tx.start) * 3;
    const TS* r1 = r0 + (long long)W * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float a00 = to_f(r0[c]), a01 = to_f(r0[3 + c]);
      const float a10 = to_f(r1[c]), a11 = to_f(r1[3 + c]);
      const float g = to_f(g_rgb[p * 3 + c]);
      gx += g * (ty.w0 * (tx.dw0 * a00 + tx.dw1 * a01) +
                 ty.w1 * (tx.dw0 * a10 + tx.dw1 * a11));
      gy += g * (ty.dw0 * (tx.w0 * a00 + tx.w1 * a01) +
                 ty.dw1 * (tx.w0 * a10 + tx.w1 * a11));
    }
    gx *= scale;
    gy *= scale;
  }
  if (g_w != nullptr) {
    const float gw = to_f(g_w[p]);
    gx += gw * (ty.w0 + ty.w1) * (tx.dw0 + tx.dw1);
    gy += gw * (ty.dw0 + ty.dw1) * (tx.w0 + tx.w1);
  }
  dix[p] = gx;
  diy[p] = gy;
}

template <typename TS, typename TO, bool WITH_GRADS>
static void launch(const void* src, const void* ix, const void* iy, void* rgb,
                   void* wsum, void* dplanes, int B, int H, int W, int Ho,
                   int Wo, float scale, cudaStream_t stream) {
  const long long hw_out = (long long)Ho * Wo;
  const long long n = (long long)B * hw_out;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  warp_gather_kernel<TS, TO, WITH_GRADS><<<(unsigned)blocks, threads, 0, stream>>>(
      (const TS*)src, (const float*)ix, (const float*)iy, (TO*)rgb, (TO*)wsum,
      (float*)dplanes, H, W, hw_out, n, scale);
}

template <bool WITH_GRADS>
static int dispatch(const void* src, int src_dtype, const void* ix, const void* iy,
                    void* rgb, void* wsum, void* dplanes, int out_dtype, int B, int H,
                    int W, int Ho, int Wo, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * Ho * Wo == 0) return (int)cudaGetLastError();
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const float scale = src_dtype == kU8 ? 1.0f / 255.0f : 1.0f;
  if (src_dtype == kU8 && out_dtype == kBF16)
    launch<uint8_t, __nv_bfloat16, WITH_GRADS>(src, ix, iy, rgb, wsum, dplanes, B, H, W, Ho, Wo, scale, s);
  else if (src_dtype == kU8 && out_dtype == kF32)
    launch<uint8_t, float, WITH_GRADS>(src, ix, iy, rgb, wsum, dplanes, B, H, W, Ho, Wo, scale, s);
  else if (src_dtype == kBF16 && out_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16, WITH_GRADS>(src, ix, iy, rgb, wsum, dplanes, B, H, W, Ho, Wo, scale, s);
  else if (src_dtype == kBF16 && out_dtype == kF32)
    launch<__nv_bfloat16, float, WITH_GRADS>(src, ix, iy, rgb, wsum, dplanes, B, H, W, Ho, Wo, scale, s);
  else if (src_dtype == kF32 && out_dtype == kF32)
    launch<float, float, WITH_GRADS>(src, ix, iy, rgb, wsum, dplanes, B, H, W, Ho, Wo, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// src [B,H,W,3] (uint8 | bf16 | f32), ix/iy f32 [B,Ho,Wo] -> rgb [B,Ho,Wo,3]
// and wsum [B,Ho,Wo,1] in out_dtype (bf16 | f32), dplanes f32 [B,Ho,Wo,6]
// ordered (d/dix r,g,b, d/diy r,g,b). Returns cudaGetLastError().
extern "C" int warp_gather(const void* src, int src_dtype, const void* ix,
                           const void* iy, void* rgb, void* wsum, void* dplanes,
                           int out_dtype, int B, int H, int W, int Ho, int Wo,
                           void* stream) {
  return dispatch<true>(src, src_dtype, ix, iy, rgb, wsum, dplanes, out_dtype, B, H, W,
                        Ho, Wo, stream);
}

// The same forward without the derivative planes: rgb and wsum only.
extern "C" int warp_gather_nograd(const void* src, int src_dtype, const void* ix,
                                  const void* iy, void* rgb, void* wsum, int out_dtype,
                                  int B, int H, int W, int Ho, int Wo, void* stream) {
  return dispatch<false>(src, src_dtype, ix, iy, rgb, wsum, nullptr, out_dtype, B, H, W,
                         Ho, Wo, stream);
}

template <typename TS, typename TG>
static void launch_bwd(const void* src, const void* ix, const void* iy, const void* g_rgb,
                       const void* g_w, void* dix, void* diy, int B, int H, int W, int Ho,
                       int Wo, float scale, cudaStream_t stream) {
  const long long hw_out = (long long)Ho * Wo;
  const long long n = (long long)B * hw_out;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  warp_gather_bwd_kernel<TS, TG><<<(unsigned)blocks, threads, 0, stream>>>(
      (const TS*)src, (const float*)ix, (const float*)iy, (const TG*)g_rgb,
      (const TG*)g_w, (float*)dix, (float*)diy, H, W, hw_out, n, scale);
}

// src and ix/iy as above; g_rgb [B,Ho,Wo,3] and g_w [B,Ho,Wo,1] in g_dtype
// (bf16 | f32), either may be null -> dix, diy f32 [B,Ho,Wo]. Returns
// cudaGetLastError().
extern "C" int warp_gather_bwd(const void* src, int src_dtype, const void* ix,
                               const void* iy, const void* g_rgb, const void* g_w,
                               int g_dtype, void* dix, void* diy, int B, int H, int W,
                               int Ho, int Wo, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * Ho * Wo == 0) return (int)cudaGetLastError();
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const float scale = src_dtype == kU8 ? 1.0f / 255.0f : 1.0f;
#define BWD(TS, TG) \
  launch_bwd<TS, TG>(src, ix, iy, g_rgb, g_w, dix, diy, B, H, W, Ho, Wo, scale, s)
  if (src_dtype == kU8 && g_dtype == kBF16) BWD(uint8_t, __nv_bfloat16);
  else if (src_dtype == kU8 && g_dtype == kF32) BWD(uint8_t, float);
  else if (src_dtype == kBF16 && g_dtype == kBF16) BWD(__nv_bfloat16, __nv_bfloat16);
  else if (src_dtype == kBF16 && g_dtype == kF32) BWD(__nv_bfloat16, float);
  else if (src_dtype == kF32 && g_dtype == kF32) BWD(float, float);
  else return (int)cudaErrorInvalidValue;
#undef BWD
  return (int)cudaGetLastError();
}
