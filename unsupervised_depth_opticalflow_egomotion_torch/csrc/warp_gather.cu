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
// What bounds it on the H100: bytes. Per pixel warp_gather reads 8
// coordinate bytes and 12 source taps (4 x 3 channels), and writes 3 + 1
// outputs and 24 bytes of derivative planes, against about 100 flops: at
// u8 [16,256,832,3] -> bf16 that is 146 MB, 0.044 ms at 3.35 TB/s, of which
// the planes are 82 MB. The TPU kernel's VMEM row windows, i32 lane packing
// and displacement clamp existed because the TPU has no fast global gather.
// Here the taps are direct gathers through the read-only path: neighbouring
// threads read neighbouring source pixels for smooth flows, so the taps
// mostly hit cache lines already fetched, and the kernel is exact at any
// displacement (no window, hence no guard). A row's two taps (6 values) come
// in the aligned 32-bit words that hold them: 2 or 3 loads for uint8, 3 or
// 4 for bf16, where one load a value took 6 (load_pair).
//
// The stores are what the design is about. One thread per output pixel
// writing its own outputs would store 6 f32 planes 24 bytes apart, 3
// colours 6 or 12 bytes apart and one weight sum: a warp's store
// instruction then touches up to 24 sectors for 128 useful bytes. Instead a
// block of 256 threads owns 256 consecutive output pixels of one image
// (the batch on the grid's y, so index math is 32-bit within an image and
// no thread divides), stages its outputs in shared memory (6 KB of planes,
// 1.5 or 3 KB of colours, 0.5 or 1 KB of weight sums) and writes each of
// the three contiguous runs with 16-byte stores, neighbouring threads on
// neighbouring chunks (store_run; ragged ends and unaligned starts
// element by element). At most 32 registers a thread (eight blocks of 256
// threads a SM, full occupancy), which the gathers' latency needs. ptxas
// (sm_90a, CUDA 12.8): 32 registers and no spill for a uint8 or bf16 source
// with bf16 outputs (the train steps), 8,240 B of shared memory; the f32
// outputs spill 4-8 bytes and stage 10,320 B.
//
// The two routes trade bytes for a second gather. warp_gather writes 24
// bytes of derivative planes per pixel that its elementwise backward reads
// again. warp_gather_nograd writes none (one thread per pixel, its outputs
// stored directly); warp_gather_bwd then recomputes the tap weights from
// the coordinates, gathers the same 12 taps again and contracts them with
// the cotangents in registers: it reads the source, the coordinates and
// 3 + 1 cotangents and writes two f32 planes.

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

// Full-width stores of a run of outputs staged in shared memory. The caller
// stages element i of the run at s[slot + i], slot = vec_slot(dst), into a
// buffer s that is 16-byte aligned and has one chunk of slack: then shared
// and global 16-byte chunks line up, whole chunks move as one uint4 each,
// neighbouring threads on neighbouring chunks, and the ragged ends (a run
// that starts off a 16-byte boundary, a tensor one element off its
// allocation) element by element. Nothing outside dst[0, len) is written.
//
// vec_slot: the position of p within its 16-byte chunk, in elements of T
// (p is T-aligned).
template <typename T>
__device__ __forceinline__ int vec_slot(const T* p) {
  return (int)(((uintptr_t)p & 15) / sizeof(T));
}

// dst[0, len) <- s[slot, slot + len), slot = vec_slot(dst). Threads
// i0, i0 + step, ... share the work.
template <typename T>
__device__ __forceinline__ void store_run(T* __restrict__ dst, const T* __restrict__ s, int len,
                                          int i0, int step) {
  constexpr int V = 16 / (int)sizeof(T);
  const int lo = vec_slot(dst), hi = lo + len;
  T* base = dst - lo;  // 16-byte aligned; only [lo, hi) of it is written
  const int c0 = (lo + V - 1) / V, c1 = hi / V;  // the whole chunks are [c0, c1)
  const int head_end = min(hi, c0 * V);
  for (int i = lo + i0; i < head_end; i += step) base[i] = s[i];
  for (int i = max(c0, c1) * V + i0; i < hi; i += step) base[i] = s[i];
  for (int j = c0 + i0; j < c1; j += step)
    reinterpret_cast<uint4*>(base)[j] = reinterpret_cast<const uint4*>(s)[j];
}

// Two horizontally adjacent 3-channel pixels starting at p, as f32, in as
// few loads as the type allows: the aligned 32-bit words that hold the 6
// values, shifted into place (uint8: 2 or 3 words for 6 bytes; bf16: 3 or 4
// for 12 bytes; f32: six scalar loads). Every word loaded holds at least one
// of the pixels' bytes, so none reaches past the tensor.
__device__ __forceinline__ void load_pair(const uint8_t* p, float a[3], float b[3]) {
  const uintptr_t addr = (uintptr_t)p;
  const unsigned* w = reinterpret_cast<const unsigned*>(addr & ~(uintptr_t)3);
  const unsigned s = (unsigned)(addr & 3) * 8;
  const unsigned w0 = __ldg(w), w1 = __ldg(w + 1);
  const unsigned w2 = s == 24 ? __ldg(w + 2) : 0u;
  const unsigned lo = __funnelshift_r(w0, w1, s);  // bytes 0..3 of the pair
  const unsigned hi = __funnelshift_r(w1, w2, s);  // bytes 4..7 (4 and 5 used)
  a[0] = (float)(lo & 255u);
  a[1] = (float)((lo >> 8) & 255u);
  a[2] = (float)((lo >> 16) & 255u);
  b[0] = (float)(lo >> 24);
  b[1] = (float)(hi & 255u);
  b[2] = (float)((hi >> 8) & 255u);
}

__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float a[3], float b[3]) {
  const uintptr_t addr = (uintptr_t)p;
  const unsigned* w = reinterpret_cast<const unsigned*>(addr & ~(uintptr_t)3);
  const unsigned s = (unsigned)(addr & 3) * 8;  // 0 or 16
  const unsigned w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
  const unsigned w3 = s ? __ldg(w + 3) : 0u;
  const unsigned e0 = __funnelshift_r(w0, w1, s);  // values 0, 1
  const unsigned e1 = __funnelshift_r(w1, w2, s);  // values 2, 3
  const unsigned e2 = __funnelshift_r(w2, w3, s);  // values 4, 5
  // a bf16 is the high half of the f32 of the same value
  a[0] = __uint_as_float(e0 << 16);
  a[1] = __uint_as_float(e0 & 0xffff0000u);
  a[2] = __uint_as_float(e1 << 16);
  b[0] = __uint_as_float(e1 & 0xffff0000u);
  b[1] = __uint_as_float(e2 << 16);
  b[2] = __uint_as_float(e2 & 0xffff0000u);
}

__device__ __forceinline__ void load_pair(const float* p, float a[3], float b[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = __ldg(p + c);
    b[c] = __ldg(p + 3 + c);
  }
}

// The bilinear sample of one 3-channel pixel of image im [H,W,3] at (fx, fy)
// pixels: values, weight sum and, with WITH_GRADS, d/dix and d/diy of the
// values (unscaled). Offsets within one image are 32-bit.
struct Sample {
  float v[3], dx[3], dy[3], w;
};

template <bool WITH_GRADS, typename TS>
__device__ __forceinline__ Sample sample_pixel(const TS* __restrict__ im, float fx, float fy,
                                               int H, int W) {
  const Taps tx = pos_weights(fx, W);
  const Taps ty = pos_weights(fy, H);
  const TS* r0 = im + (ty.start * W + tx.start) * 3;
  float t00[3], t01[3], t10[3], t11[3];
  load_pair(r0, t00, t01);
  load_pair(r0 + W * 3, t10, t11);
  Sample s;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a00 = t00[c], a01 = t01[c], a10 = t10[c], a11 = t11[c];
    const float row0 = tx.w0 * a00 + tx.w1 * a01;
    const float row1 = tx.w0 * a10 + tx.w1 * a11;
    s.v[c] = ty.w0 * row0 + ty.w1 * row1;
    if (WITH_GRADS) {
      s.dx[c] = ty.w0 * (tx.dw0 * a00 + tx.dw1 * a01) + ty.w1 * (tx.dw0 * a10 + tx.dw1 * a11);
      s.dy[c] = ty.dw0 * row0 + ty.dw1 * row1;
    }
  }
  s.w = (ty.w0 + ty.w1) * (tx.w0 + tx.w1);
  return s;
}

// The forward with derivative planes. Block (blockIdx.x, b = blockIdx.y)
// owns the WG_THREADS output pixels [p0, p0 + WG_THREADS) of image b, one a
// thread; each thread stages its 3 + 1 outputs and 6 planes in shared
// memory, and the block writes its three contiguous runs with 16-byte
// stores (store_run).
constexpr int WG_THREADS = 256;

template <typename TS, typename TO>
__global__ void __launch_bounds__(WG_THREADS, 8)
    warp_gather_kernel(const TS* __restrict__ src, const float* __restrict__ ix,
                       const float* __restrict__ iy, TO* __restrict__ rgb,
                       TO* __restrict__ wsum, float* __restrict__ dplanes, int H, int W,
                       int hw_out, float scale) {
  // each staging buffer has one 16-byte chunk of slack for its run's slot
  __shared__ __align__(16) unsigned char pl_raw[(WG_THREADS * 6 + 4) * sizeof(float)];
  __shared__ __align__(16) unsigned char rgb_raw[(WG_THREADS * 3 + 8) * sizeof(TO)];
  __shared__ __align__(16) unsigned char w_raw[(WG_THREADS + 8) * sizeof(TO)];
  float* s_pl = reinterpret_cast<float*>(pl_raw);
  TO* s_rgb = reinterpret_cast<TO*>(rgb_raw);
  TO* s_w = reinterpret_cast<TO*>(w_raw);

  const int t = threadIdx.x;
  const int p0 = blockIdx.x * WG_THREADS;
  const int n = min(WG_THREADS, hw_out - p0);
  const size_t first = (size_t)blockIdx.y * hw_out + p0;  // the block's first output pixel
  float* pl_dst = dplanes + first * 6;
  TO* rgb_dst = rgb + first * 3;
  TO* w_dst = wsum + first;
  const int k_pl = vec_slot(pl_dst), k_rgb = vec_slot(rgb_dst), k_w = vec_slot(w_dst);
  if (t < n) {
    const TS* im = src + (size_t)blockIdx.y * H * W * 3;
    const Sample s = sample_pixel<true>(im, ix[first + t], iy[first + t], H, W);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_rgb[k_rgb + 3 * t + c] = from_f<TO>(s.v[c] * scale);
      s_pl[k_pl + 6 * t + c] = s.dx[c] * scale;
      s_pl[k_pl + 6 * t + 3 + c] = s.dy[c] * scale;
    }
    s_w[k_w + t] = from_f<TO>(s.w);
  }
  __syncthreads();
  store_run(pl_dst, s_pl, 6 * n, t, WG_THREADS);
  store_run(rgb_dst, s_rgb, 3 * n, t, WG_THREADS);
  store_run(w_dst, s_w, n, t, WG_THREADS);
}

// The forward without planes: one thread per output pixel, scalar stores.
template <typename TS, typename TO>
__global__ void warp_gather_nograd_kernel(const TS* __restrict__ src,
                                          const float* __restrict__ ix,
                                          const float* __restrict__ iy, TO* __restrict__ rgb,
                                          TO* __restrict__ wsum, int H, int W,
                                          long long hw_out, long long n, float scale) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const long long b = p / hw_out;
  const Sample s = sample_pixel<false>(src + b * H * W * 3, ix[p], iy[p], H, W);
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[p * 3 + c] = from_f<TO>(s.v[c] * scale);
  wsum[p] = from_f<TO>(s.w);
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
static void launch(const void* src, const void* ix, const void* iy, void* rgb, void* wsum,
                   void* dplanes, int B, int H, int W, int Ho, int Wo, float scale,
                   cudaStream_t stream) {
  const int hw_out = Ho * Wo;
  if constexpr (WITH_GRADS) {
    const dim3 grid((hw_out + WG_THREADS - 1) / WG_THREADS, B);
    warp_gather_kernel<TS, TO><<<grid, WG_THREADS, 0, stream>>>(
        (const TS*)src, (const float*)ix, (const float*)iy, (TO*)rgb, (TO*)wsum,
        (float*)dplanes, H, W, hw_out, scale);
  } else {
    const long long n = (long long)B * hw_out;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    warp_gather_nograd_kernel<TS, TO><<<(unsigned)blocks, threads, 0, stream>>>(
        (const TS*)src, (const float*)ix, (const float*)iy, (TO*)rgb, (TO*)wsum, H, W,
        hw_out, n, scale);
  }
}

template <bool WITH_GRADS>
static int dispatch(const void* src, int src_dtype, const void* ix, const void* iy,
                    void* rgb, void* wsum, void* dplanes, int out_dtype, int B, int H,
                    int W, int Ho, int Wo, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * Ho * Wo == 0) return (int)cudaGetLastError();
  // 32-bit offsets within one image, the batch on the grid's y
  if (H < 2 || W < 2 || B > 65535 || (long long)H * W * 3 >= (1LL << 31) ||
      (long long)Ho * Wo * 6 >= (1LL << 31) - WG_THREADS)
    return (int)cudaErrorInvalidValue;
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
