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
// where mass that lands outside the frame is dropped. There is no gradient
// (the consumer clamps the mass to [0, 1] and stops the gradient).
//
// What bounds it on the H100: bytes. A pixel reads its flow (8 bytes in f32)
// and the f32 mass plane is zero-filled once and written once; a dozen
// flops per pixel. The TPU has no scatter, so its kernel turned the splat
// into tent-matrix matmuls over a window of target rows and needed a guard
// for flows that leave the window. Here one thread per source pixel makes
// up to four atomicAdds into the f32 mass plane (L2 atomics; neighbouring
// sources hit neighbouring targets for smooth flows), which is exact at any
// displacement, so there is no window and no guard. Atomic sums are taken
// in an order that changes from run to run: the mass agrees with a
// sequential sum to f32 rounding of a few units of mass, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__global__ void splat_mass_kernel(const T* __restrict__ flow, float* __restrict__ mass,
                                  int H, int W, long long n) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int x = (int)(p % W);
  const int y = (int)((p / W) % H);
  const long long b = p / ((long long)H * W);
  const float tx = (float)x + to_f(flow[p * 2]);
  const float ty = (float)y + to_f(flow[p * 2 + 1]);
  const float x0 = floorf(tx), y0 = floorf(ty);
  const float fx = tx - x0, fy = ty - y0;
  float* plane = mass + b * (long long)H * W;
  const float wmax = (float)(W - 1), hmax = (float)(H - 1);
  // a NaN or infinite target fails every comparison and drops its mass
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xi = x0 + (float)(k & 1);
    const float yi = y0 + (float)(k >> 1);
    if (!(xi >= 0.f && xi <= wmax && yi >= 0.f && yi <= hmax)) continue;
    const float wgt = ((k & 1) ? fx : 1.f - fx) * ((k >> 1) ? fy : 1.f - fy);
    atomicAdd(plane + (long long)yi * W + (long long)xi, wgt);
  }
}

// flow [B,H,W,2] (bf16 | f32) -> mass f32 [B,H,W], which the caller has
// zero-filled; the kernel adds into it. Returns cudaGetLastError().
extern "C" int splat_mass(const void* flow, int dtype, void* mass, int B, int H, int W,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (dtype == kBF16)
    splat_mass_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)flow, (float*)mass, H, W, n);
  else if (dtype == kF32)
    splat_mass_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)flow, (float*)mass, H, W, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
