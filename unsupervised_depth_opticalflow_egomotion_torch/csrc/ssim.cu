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
// What bounds it on the H100. Both kernels are bound by bytes at the
// roofline: the forward reads x and y and writes s (three tensors), the
// backward reads x, y, g and writes dx, dy (five), against a few dozen to
// 150 flops per element. The TPU kernel kept one [H,W] channel plane in
// VMEM per grid step and so needed channel-major inputs; here both work on
// the NHWC tensor as it lies in memory.
//
// Forward: a thread owns one element (b, y, x, c); its nine neighbours are
// 3 rows x 3 pixels C elements apart and come through L1/L2.
//
// Backward: a stencil over a stencil (an output needs planes on a 3x3 ring,
// hence inputs on a 5x5 one). One kernel, one pass, no scratch: a block of
// four warps owns a 30 x 32 pixel tile of one image, every channel.
//   - Staging: x and y over the tile and a 2-pixel halo (36 rows of 34 x C
//     elements), as they lie in memory: each halo row is a contiguous run
//     of an image row, copied as the 16-byte chunks that hold it, one load
//     each and all in flight at once (14 chunks a row at C = 3 in bf16,
//     whatever the alignment); out-of-frame elements are zeroed.
//   - Then each warp streams down its 8 rows, a channel at a time, with
//     everything between the halo and the outputs in registers: a ring
//     row's statistics from three 3-wide horizontal sums (6 shared reads a
//     row), its four planes, their 3-wide sums across lanes (warp
//     shuffles), and three of those down for an output row, stored
//     directly. No barrier follows the staging.
// The planes are zero outside the frame (the pool's padding), which is not
// what the statistics of zero-padded inputs would give there. Shared
// memory: 2 x 36 x 14 x 16 B = 16,128 B (bf16, C = 3), 40,320 B at most
// (f32, C = 4), static. C is a template parameter, 1 to 4 (the paths use 3).
// ptxas (sm_90a, CUDA 12.8): 72 registers and no spill at bf16, C = 3 (64
// to 72 over the instantiations): seven blocks of 128 threads a SM.
//
// What bounds the backward as written: its instructions, not its bytes.
// Counted from the code, a ring pixel costs about 110 instructions a
// channel (the six reads and the horizontal sums, the statistics, two f32
// divisions and the planes, the shuffles) and an output pixel about 25
// more; with 10 ring rows for every 8 output rows and 32 ring columns for
// every 30 that is about 175 an element, some 0.03 ms at bf16
// [8,256,832,3] at the card's full issue rate, against 0.0153 ms for its
// bytes.

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

// The four cotangent planes (dP1, dP2, dP3 = dP4, dP5) of one element from
// its box means and its cotangent gv.
__device__ __forceinline__ float4 cotangent_planes(const Stats& st, float gv) {
  const Terms t = ssim_terms(st);
  const float d = t.e * t.c;
  const float u = gv / d;
  const float v = -u * (t.b1 * t.a) / d;
  const float gab = u * (t.a - t.b1);
  const float hce = v * (t.c - t.e);
  float4 p;
  p.x = 2.0f * st.p2 * gab + 2.0f * st.p1 * hce;  // dP1
  p.y = 2.0f * st.p1 * gab + 2.0f * st.p2 * hce;  // dP2
  p.z = v * t.e;                                  // dP3 = dP4
  p.w = 2.0f * u * t.b1;                          // dP5
  return p;
}

// The fused backward. A block of four warps owns a 30 x 32 pixel tile of
// one image, every channel. It stages x and y over the tile and a 2-pixel
// halo in shared memory as they lie in memory (16-byte chunks of the image
// rows, out-of-frame elements zeroed: the pool's padding). Then each warp,
// on its own, streams down its 8 rows of the tile, a channel at a time,
// lane l on column l of the tile's 1-pixel ring (32 columns):
//   - the 3-wide horizontal sums of x, y, x^2, y^2, xy of the next halo row
//     (6 shared-memory reads), added to those of the two rows above: the
//     box statistics of one ring row;
//   - the four cotangent planes there, zero outside the frame (which is not
//     what the statistics of zero-padded inputs would give);
//   - their 3-wide horizontal sums across lanes (warp shuffles), added to
//     those of the two ring rows above: the box sums of one output row,
//     stored as dx and dy with the centre x and y kept from the halo rows.
// The ring rows at a warp's ends are computed by both warps that need them,
// from the same inputs in the same order, so they agree.
constexpr int BT_W = 30, BWD_WARPS = 4, ROWS_PER_WARP = 8;
constexpr int BT_H = BWD_WARPS * ROWS_PER_WARP;  // 32
constexpr int HALO_W = BT_W + 4, HALO_H = BT_H + 4;
constexpr int BWD_THREADS = 32 * BWD_WARPS;
static_assert(BT_W + 2 == 32, "a warp spans the tile and its ring");

// Chunk u, loaded from address ca, with its elements outside [lo, hi) zeroed.
template <typename T>
__device__ __forceinline__ uint4 mask_chunk(uint4 u, uintptr_t ca, uintptr_t lo, uintptr_t hi) {
  unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uintptr_t a = ca + 4 * k;
    unsigned m;
    if (sizeof(T) == 2)
      m = ((a >= lo && a < hi) ? 0xffffu : 0u) | ((a + 2 >= lo && a + 2 < hi) ? 0xffff0000u : 0u);
    else
      m = (a >= lo && a < hi) ? 0xffffffffu : 0u;
    w[k] &= m;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int C>
__global__ void __launch_bounds__(BWD_THREADS, 6)
    ssim_bwd_kernel(const T* __restrict__ xs, const T* __restrict__ ys,
                    const T* __restrict__ g, T* __restrict__ dx, T* __restrict__ dy, int H,
                    int W) {
  // a halo row: the 16-byte chunks that hold its HALO_W * C elements, the
  // first of which sits `shift` elements into the first chunk
  constexpr int kRow = HALO_W * C;
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int NCH = (kRow + V - 1) / V + 1;
  constexpr int kRaw = NCH * V;  // elements of a staged row
  __shared__ uint4 raw[2][HALO_H * NCH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * BT_W, y0 = blockIdx.y * BT_H;
  const size_t img = (size_t)blockIdx.z * H * W * C;  // 32-bit offsets within the image
  const T* xi = xs + img;
  const T* yi = ys + img;
  const T* gi = g + img;
  const int row_len = W * C;
  const int e_lo = (x0 - 2) * C;  // the halo's first element within an image row
  const int v_lo = max(e_lo, 0), v_hi = min(e_lo + kRow, row_len);  // its in-frame elements

  // 1. every chunk of x and y over the halo: one 16-byte load each, all in
  //    flight at once; chunks outside the frame are zeros
  constexpr int kItems = 2 * HALO_H * NCH;
#pragma unroll
  for (int k = 0; k < (kItems + BWD_THREADS - 1) / BWD_THREADS; ++k) {
    const int it = tid + k * BWD_THREADS;
    if (it < kItems) {
      const int which = it >= HALO_H * NCH;
      const int rem = it - which * HALO_H * NCH;
      const int r = rem / NCH, j = rem - r * NCH;
      const int yy = y0 - 2 + r;
      const uintptr_t row =
          (uintptr_t)(which ? yi : xi) + (intptr_t)yy * row_len * (intptr_t)sizeof(T);
      const uintptr_t ca =
          ((row + (intptr_t)e_lo * (intptr_t)sizeof(T)) & ~(uintptr_t)15) + 16 * j;
      const uintptr_t lo = row + v_lo * sizeof(T), hi = row + v_hi * sizeof(T);
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (yy >= 0 && yy < H && ca + 16 > lo && ca < hi) {
        u = __ldg(reinterpret_cast<const uint4*>(ca));  // holds an in-frame element
        if (ca < lo || ca + 16 > hi) u = mask_chunk<T>(u, ca, lo, hi);
      }
      raw[which][r * NCH + j] = u;
    }
  }
  __syncthreads();
  const T* rx = reinterpret_cast<const T*>(raw[0]);
  const T* ry = reinterpret_cast<const T*>(raw[1]);

  const int r0 = warp * ROWS_PER_WARP;  // the warp's first output row in the tile
  if (y0 + r0 >= H) return;
  const int xr = x0 - 1 + lane;  // the lane's ring column in the image
  const bool ring_col = xr >= 0 && xr < W;
  const bool out_col = lane < BT_W && x0 + lane < W;
  const float ninth = 1.0f / 9.0f;
  const unsigned all = 0xffffffffu;

#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    // horizontal sums of halo row r at the lane's ring column; a2, b2: x and
    // y at the lane's output column
    auto hsum = [&](int r, float h[5], float& a2, float& b2) {
      // byte offset of the row's first halo element, modulo 2^32 (only its
      // low four bits count)
      const unsigned off = (unsigned)((y0 - 2 + r) * row_len + e_lo) * (unsigned)sizeof(T);
      const int shx = (int)((((unsigned)(uintptr_t)xi + off) & 15u) / sizeof(T));
      const int shy = (int)((((unsigned)(uintptr_t)yi + off) & 15u) / sizeof(T));
      const T* px = rx + r * kRaw + shx + lane * C + c;
      const T* py = ry + r * kRaw + shy + lane * C + c;
      const float a0 = to_f(px[0]), a1 = to_f(px[C]);
      const float b0 = to_f(py[0]), b1 = to_f(py[C]);
      a2 = to_f(px[2 * C]);
      b2 = to_f(py[2 * C]);
      h[0] = a0 + a1 + a2;
      h[1] = b0 + b1 + b2;
      h[2] = a0 * a0 + a1 * a1 + a2 * a2;
      h[3] = b0 * b0 + b1 * b1 + b2 * b2;
      h[4] = a0 * b0 + a1 * b1 + a2 * b2;
    };
    // the cotangent of each of the warp's ring rows, loaded ahead
    float gv[ROWS_PER_WARP + 2];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP + 2; ++j) {
      const int yr = y0 + r0 - 1 + j;
      gv[j] = ring_col && yr >= 0 && yr < H ? to_f(gi[(yr * W + xr) * C + c]) : 0.f;
    }
    float h0[5], h1[5], q0[4], q1[4];
    float xa0, ya0, xa1, ya1;  // centre x, y of the two halo rows above
    hsum(r0, h0, xa0, ya0);
    hsum(r0 + 1, h1, xa1, ya1);
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP + 2; ++j) {
      // ring row j of the warp: image row y0 + r0 - 1 + j
      float h2[5], xa2, ya2;
      hsum(r0 + j + 2, h2, xa2, ya2);
      const int yr = y0 + r0 - 1 + j;
      float4 p = make_float4(0.f, 0.f, 0.f, 0.f);  // the planes are zero outside the frame
      if (ring_col && yr >= 0 && yr < H) {
        Stats st;
        st.p1 = (h0[0] + h1[0] + h2[0]) * ninth;
        st.p2 = (h0[1] + h1[1] + h2[1]) * ninth;
        st.p3 = (h0[2] + h1[2] + h2[2]) * ninth;
        st.p4 = (h0[3] + h1[3] + h2[3]) * ninth;
        st.p5 = (h0[4] + h1[4] + h2[4]) * ninth;
        p = cotangent_planes(st, gv[j]);
      }
      // lane l: the planes of ring columns l, l + 1, l + 2 summed
      float q2[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q2[k] += __shfl_down_sync(all, q2[k], 1) + __shfl_down_sync(all, q2[k], 2);
      if (j >= 2) {  // output row r0 + j - 2: ring rows j - 2 .. j; centre halo row r0 + j
        const int yo = y0 + r0 + j - 2;
        if (out_col && yo < H) {
          const float s1 = q0[0] + q1[0] + q2[0];
          const float s2 = q0[1] + q1[1] + q2[1];
          const float s3 = q0[2] + q1[2] + q2[2];
          const float s5 = q0[3] + q1[3] + q2[3];
          const int o = (yo * W + x0 + lane) * C + c;
          dx[img + o] = from_f<T>((s1 + 2.0f * xa0 * s3 + ya0 * s5) * ninth);
          dy[img + o] = from_f<T>((s2 + 2.0f * ya0 * s3 + xa0 * s5) * ninth);
        }
      }
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        h0[k] = h1[k];
        h1[k] = h2[k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        q0[k] = q1[k];
        q1[k] = q2[k];
      }
      xa0 = xa1, ya0 = ya1, xa1 = xa2, ya1 = ya2;
    }
  }
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

template <typename T, int C>
static int launch_bwd(const void* x, const void* y, const void* g, void* dx, void* dy, int B,
                      int H, int W, cudaStream_t s) {
  const dim3 grid((W + BT_W - 1) / BT_W, (H + BT_H - 1) / BT_H, B);
  ssim_bwd_kernel<T, C><<<grid, BWD_THREADS, 0, s>>>((const T*)x, (const T*)y, (const T*)g,
                                                      (T*)dx, (T*)dy, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
static int bwd(const void* x, const void* y, const void* g, void* dx, void* dy, int B, int H,
               int W, int C, cudaStream_t s) {
  switch (C) {
    case 1: return launch_bwd<T, 1>(x, y, g, dx, dy, B, H, W, s);
    case 2: return launch_bwd<T, 2>(x, y, g, dx, dy, B, H, W, s);
    case 3: return launch_bwd<T, 3>(x, y, g, dx, dy, B, H, W, s);
    case 4: return launch_bwd<T, 4>(x, y, g, dx, dy, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, y, g [B,H,W,C] (bf16 | f32, one type; 1 <= C <= 4) -> dx, dy in that
// type. Returns cudaGetLastError().
extern "C" int ssim_bwd(const void* x, const void* y, const void* g, void* dx, void* dy,
                        int dtype, int B, int H, int W, int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * H * W * C == 0) return (int)cudaGetLastError();
  if (C < 1 || C > 4 || B > 65535 || (long long)H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16) return bwd<__nv_bfloat16>(x, y, g, dx, dy, B, H, W, C, s);
  if (dtype == kF32) return bwd<float>(x, y, g, dx, dy, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
