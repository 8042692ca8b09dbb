// Unit-mass bilinear forward splat of a flow field (the occlusion mass).
//
// Replaces: unsupervised_depth_opticalflow_egomotion_tpu/ops/pallas/
//   splat_window.py:_splat_kernel (reached through splat_mass_window and
//   splat_mass_window_guarded).
//
// What it computes: every source pixel s = (b, y, x) sends one unit of mass
// to its target (tx, ty) = (x + flow_x, y + flow_y), spread over the four
// pixels around the target with bilinear (tent) weights:
//   mass[b, r, c] = sum_s tent(ty_s - r) * tent(tx_s - c),
// where mass that lands outside the frame is dropped, and so is the mass of
// a target that is not finite. There is no gradient (the consumer clamps
// the mass to [0, 1] and stops the gradient).
//
// What bounds it on the H100: bytes, at the roofline. The function reads
// the flow (4 bytes a pixel in bf16) and writes the mass once in the flow's
// type, against a dozen flops a pixel. The TPU has no scatter, so its
// kernel turned the splat into tent-matrix matmuls over a window of target
// rows and needed a guard for flows that leave the window. Here a scatter
// is native, so the kernel is exact at any displacement, with no guard.
//
// Design. One C call (splat_mass) does the whole function on its stream:
// it zero-fills an f32 plane (cudaMemsetAsync), splats into it, and for a
// bf16 flow casts the plane into the bf16 output (an f32 flow's output is
// the plane itself). What bounds a splat into an f32 plane on this card is
// the L2's rate of atomic additions, about 1e11 a second (four scattered
// atomics a source pixel, one thread each, took 0.067 ms at bf16
// [8,256,832,2] on an H100 by kernel_times.py), and coalesced ones were
// measured no faster. So for all but small images:
//   - The window splat. A block of 256 threads owns a tile of 64 x 32
//     source pixels of one image (8 a thread, neighbouring threads on
//     neighbouring pixels). It sums their taps in an f32 window of target
//     pixels in shared memory: the tile moved by the rounded flow of its
//     centre pixel and widened by an 8-pixel margin on every side (81 x 49
//     floats, 15,876 B). A tap that lands outside the window goes straight
//     to the plane with a global atomicAdd; that keeps the result exact at
//     any flow. Then the block adds each non-zero window pixel to the plane
//     with one global atomicAdd, neighbouring threads on neighbouring pixels
//     of a window row: about one atomic a source pixel for a flow that is
//     smooth within 7 px of the centre's, where there were four. (Shared
//     float atomics are compare-and-swap loops on sm_90, ATOMS.CAST.SPIN.)
//   - Below 2^18 source pixels (the two coarsest flow scales of the train
//     steps) the window's per-block latency costs more than the atomics it
//     saves, and a thread per source pixel adds its four taps to the plane
//     with global atomics.
// Alternatives measured slower on the card at bf16 [8,256,832,2]: a
// gather by target tile, whose blocks read their sources with an 8-pixel
// halo and leave only flows of more than 7 px to global atomics (no flush,
// but it visits each source 1.9 times, and its shared atomics loop); and
// flushing the window as 16-byte vector atomics (float4 atomicAdd: the L2
// appears to take one as four additions, and zeros pad the chunks). Sums
// are taken in an order that changes from run to run: the mass agrees with
// a sequential sum to f32 rounding of a few units of mass, not bit for bit.
//
// ptxas (sm_90a, CUDA 12.8), bf16: the window splat 31 registers, the
// direct one 26, the cast 29, no spill; the window's 15,876 B of shared
// memory leave eight blocks of 256 threads a SM, the most threads allow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

constexpr int SP_TW = 64, SP_TH = 32;  // source tile
constexpr int SP_M = 8;                // the window's margin on every side
constexpr int SP_THREADS = 256;
constexpr int SP_WW = SP_TW + 2 * SP_M + 1;  // window columns (+1: a tap's right pixel)
constexpr int SP_WH = SP_TH + 2 * SP_M + 1;  // window rows
constexpr int SP_WIN = SP_WW * SP_WH;
constexpr long long SP_WINDOW_MIN = 1LL << 18;  // source pixels from which the window pays
static_assert(SP_THREADS % SP_TW == 0, "a thread keeps one tile column");

// The four bilinear taps of the mass of source (x, y) with flow (fx, fy):
// tap(column, row, weight) for each one in the frame. A NaN or infinite
// target fails every comparison and drops its mass.
template <typename F>
__device__ __forceinline__ void for_each_tap(int x, int y, float fx, float fy, int H, int W,
                                             F tap) {
  const float tx = (float)x + fx, ty = (float)y + fy;
  const float xf = floorf(tx), yf = floorf(ty);
  const float ax = tx - xf, ay = ty - yf;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xi = xf + (float)(k & 1);
    const float yi = yf + (float)(k >> 1);
    if (!(xi >= 0.f && xi <= (float)(W - 1) && yi >= 0.f && yi <= (float)(H - 1))) continue;
    tap((int)xi, (int)yi, ((k & 1) ? ax : 1.f - ax) * ((k >> 1) ? ay : 1.f - ay));
  }
}

template <typename T>
__global__ void __launch_bounds__(SP_THREADS)
    splat_window_kernel(const T* __restrict__ flow, float* __restrict__ mass, int H, int W) {
  __shared__ float win[SP_WIN];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * SP_TW, y0 = blockIdx.y * SP_TH;
  const size_t img = (size_t)blockIdx.z * H * W;
  const T* fl = flow + img * 2;
  float* plane = mass + img;
  for (int i = tid; i < SP_WIN; i += SP_THREADS) win[i] = 0.f;

  // the window's origin: the tile's, moved by the flow at its centre pixel
  // (a flow larger than the frame, or not finite, moves it by nothing)
  const int pc = min(y0 + SP_TH / 2, H - 1) * W + min(x0 + SP_TW / 2, W - 1);
  const float fcx = to_f(fl[2 * pc]), fcy = to_f(fl[2 * pc + 1]);
  const int wx0 = x0 - SP_M + (fabsf(fcx) <= (float)W ? __float2int_rn(fcx) : 0);
  const int wy0 = y0 - SP_M + (fabsf(fcy) <= (float)H ? __float2int_rn(fcy) : 0);
  __syncthreads();

  const int x = x0 + tid % SP_TW;
  if (x < W) {
#pragma unroll 4
    for (int y = y0 + tid / SP_TW; y < min(y0 + SP_TH, H); y += SP_THREADS / SP_TW) {
      const int p = y * W + x;
      for_each_tap(x, y, to_f(fl[2 * p]), to_f(fl[2 * p + 1]), H, W,
                   [&](int cx, int cy, float wgt) {
                     const unsigned wc = (unsigned)(cx - wx0), wr = (unsigned)(cy - wy0);
                     if (wc < (unsigned)SP_WW && wr < (unsigned)SP_WH)
                       atomicAdd(&win[wr * SP_WW + wc], wgt);
                     else
                       atomicAdd(plane + (size_t)cy * W + cx, wgt);
                   });
    }
  }
  __syncthreads();

  // only in-frame taps reach the window, so a non-zero pixel is in frame
  for (int i = tid; i < SP_WIN; i += SP_THREADS) {
    const float v = win[i];
    if (v != 0.f) {
      const int r = i / SP_WW, c = i - r * SP_WW;
      atomicAdd(plane + (size_t)(wy0 + r) * W + (wx0 + c), v);
    }
  }
}

// One thread a source pixel, its taps added to the plane directly.
template <typename T>
__global__ void splat_direct_kernel(const T* __restrict__ flow, float* __restrict__ mass, int H,
                                    int W, long long n) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float* plane = mass + (p / ((long long)H * W)) * H * W;
  for_each_tap((int)(p % W), (int)((p / W) % H), to_f(flow[2 * p]), to_f(flow[2 * p + 1]), H, W,
               [&](int cx, int cy, float wgt) { atomicAdd(plane + (size_t)cy * W + cx, wgt); });
}

template <typename T>
static void splat(const T* flow, float* plane, int B, int H, int W, long long n, cudaStream_t s) {
  if (n >= SP_WINDOW_MIN) {
    const dim3 grid((W + SP_TW - 1) / SP_TW, (H + SP_TH - 1) / SP_TH, B);
    splat_window_kernel<T><<<grid, SP_THREADS, 0, s>>>(flow, plane, H, W);
  } else {
    splat_direct_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(flow, plane, H, W, n);
  }
}

// out[i] = bf16(in[i]), four elements a thread: one 16-byte load and one
// 8-byte store where both runs are aligned (fresh allocations are), else
// element by element.
__global__ void splat_cast_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                                   long long n, bool aligned) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (aligned && i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(in + i);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(out + i) = u;
    return;
  }
  for (long long j = i; j < min(i + 4, n); ++j) out[j] = __float2bfloat16(in[j]);
}

// flow [B,H,W,2] (bf16 | f32) -> mass [B,H,W] in the flow's type, written
// to `out`, with `plane` f32 [B,H,W] as the sum's scratch (for an f32 flow,
// `out` must be `plane`). Zero-fills the plane, splats, casts; all on
// `stream`. Returns the first CUDA error, or cudaGetLastError().
extern "C" int splat_mass(const void* flow, int dtype, void* plane, void* out, int B, int H,
                          int W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  if (n == 0) return (int)cudaGetLastError();
  if ((dtype != kBF16 && dtype != kF32) || (dtype == kF32 && out != plane) || B > 65535 ||
      n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(plane, 0, (size_t)n * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == kBF16) {
    splat((const __nv_bfloat16*)flow, (float*)plane, B, H, W, n, s);
    const bool aligned = (((uintptr_t)plane | (uintptr_t)out) & 15) == 0;
    splat_cast_kernel<<<(unsigned)((n + 1023) / 1024), 256, 0, s>>>(
        (const float*)plane, (__nv_bfloat16*)out, n, aligned);
  } else {
    splat((const float*)flow, (float*)plane, B, H, W, n, s);
  }
  return (int)cudaGetLastError();
}
