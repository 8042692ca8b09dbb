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
// Both kernels stage their inputs the same way (stage_halo): a block owns
// a tile of one image and copies x and y over the tile and its halo to
// shared memory as they lie in memory. Each halo row is a contiguous run of
// an image row, copied as the 16-byte chunks that hold it, one load each
// and all in flight at once, whatever the alignment; out-of-frame elements
// are zeroed, which is the pool's zero padding. No barrier follows the
// staging: each warp then works on its own. C is a template parameter, 1
// to 4 (the paths use 3; the wrapper lays more out as one-channel images).
//
// Forward: a block of eight warps owns a tile of 128 elements (f32: 64) of
// 32 image rows, and stages it with a 1-pixel halo: C elements on each
// side, a row above and below (34 rows of 18 chunks at bf16, C = 3). The
// horizontal neighbours of an NHWC element in the 3x3 window are C
// elements away in its row, so a lane works on elements, not pixels, and C
// only sets that stride. Warp (wx, wy) streams down 8 rows of a run of 64
// elements (f32: 32), lane l on elements l and l + 32 of it (f32: l): for
// each staged row it reads x and y at the lane's elements and their
// neighbours (six shared reads an element) and forms the row's part of the
// five box sums, keeps those of the two rows above in registers, and
// computes the map of an output row from the three. The map is stored
// directly, 32 lanes on 32 consecutive elements (64 contiguous bytes a
// store in bf16). Staging the map per warp row in shared memory for 16-byte
// stores, as the warp gather does, was measured slower on the card: a
// 64-element run gives each store little to share its setup with.
//   - bf16: the row's part is its 3-wide horizontal sums (products
//     contracted into FMAs), and the map is taken from the sums with 1/9
//     folded into the constants; the result is rounded to bf16.
//   - f32: the sums follow the plain version's order, which the result has
//     to match to 1e-5 where the variance cancels: each window sum row-major
//     from the first value, each product rounded on its own, each mean a
//     division by 9, nothing contracted. Each lane keeps the top row's sum
//     and the middle row's values.
// Shared memory 19,584 B (bf16, C = 3) to 20,672 B (f32, C = 4), static.
// ptxas (sm_90a, CUDA 12.8): 60 registers and no spill at bf16, C = 3 (52
// to 60 over the instantiations): four blocks of 256 threads a SM, by
// registers.
//
// What bounds the forward as written: its instructions. A bf16 element
// costs about 65 (six shared reads and their conversions, the sums, the
// map and its f32 division, the store), a quarter more for the halo rows
// of every 8, and the staging about 12: 0.015 ms at bf16 [8,256,832,3] at
// the card's full issue rate, against 0.0092 ms for its bytes. It runs in
// 0.0275 ms on an H100 (kernel_times.py), at about half that rate; what
// stalls it is not measured.
//
// Backward: a stencil over a stencil (an output needs planes on a 3x3 ring,
// hence inputs on a 5x5 one). One kernel, one pass, no scratch: a block of
// four warps owns a 30 x 32 pixel tile of one image, every channel.
//   - Staging: x and y over the tile and a 2-pixel halo (36 rows of 34 x C
//     elements; 14 chunks a row at C = 3 in bf16).
//   - Then each warp streams down its 8 rows, a channel at a time, with
//     everything between the halo and the outputs in registers: a ring
//     row's statistics from three 3-wide horizontal sums (6 shared reads a
//     row), its four planes, their 3-wide sums across lanes (warp
//     shuffles), and three of those down for an output row, stored
//     directly.
// The planes are zero outside the frame (the pool's padding), which is not
// what the statistics of zero-padded inputs would give there. Shared
// memory: 2 x 36 x 14 x 16 B = 16,128 B (bf16, C = 3), 40,320 B at most
// (f32, C = 4), static.
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

// Stage rows [yr0, yr0 + ROWS) of x and y (image rows; those outside the
// frame are zeros), the elements [e_lo, e_lo + kRow) of each, of which
// [v_lo, v_hi) are in frame and the rest zeros: the NCH 16-byte chunks that
// hold each row, one load each, all in flight at once. Row r of tensor t
// goes to raw[t][r * NCH, (r + 1) * NCH); its element e_lo sits row_shift
// elements into the row's first chunk.
template <typename T, int ROWS, int NCH, int THREADS>
__device__ __forceinline__ void stage_halo(uint4 (*raw)[ROWS * NCH], const T* xi, const T* yi,
                                           int yr0, int H, int row_len, int e_lo, int v_lo,
                                           int v_hi) {
  constexpr int kItems = 2 * ROWS * NCH;
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < (kItems + THREADS - 1) / THREADS; ++k) {
    const int it = tid + k * THREADS;
    if (it < kItems) {
      const int which = it >= ROWS * NCH;
      const int rem = it - which * ROWS * NCH;
      const int r = rem / NCH, j = rem - r * NCH;
      const int yy = yr0 + r;
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
}

// The position of image row yr's element e_lo within its 16-byte chunk, in
// elements (only the low four bits of the byte offset count, so the offset
// is taken modulo 2^32).
template <typename T>
__device__ __forceinline__ int row_shift(const T* img, int yr, int row_len, int e_lo) {
  const unsigned off = (unsigned)(yr * row_len + e_lo) * (unsigned)sizeof(T);
  return (int)((((unsigned)(uintptr_t)img + off) & 15u) / sizeof(T));
}

// The map from the box sums S1..S5 (not means) of x, y, x^2, y^2, xy: A,
// B1, C and E scaled by 81, which leaves their ratio as it was (the bf16
// instantiations; the division stays an f32 one).
__device__ __forceinline__ float map_from_sums(const float s[5]) {
  const float s12 = s[0] * s[1];
  const float sq = s[0] * s[0] + s[1] * s[1];
  const float a = 2.0f * (9.0f * s[4] - s12) + 81.0f * SSIM_C2;
  const float b1 = 2.0f * s12 + 81.0f * SSIM_C1;
  const float c = 9.0f * (s[2] + s[3]) - sq + 81.0f * SSIM_C2;
  const float e = sq + 81.0f * SSIM_C1;
  return (b1 * a) / (e * c);
}

// The map from the box sums in the order in which the plain version rounds
// (the f32 instantiations): each mean a division by 9, each product and sum
// rounded on its own, nothing contracted.
__device__ __forceinline__ float map_plain_order(const float s[5]) {
  const float m1 = __fdiv_rn(s[0], 9.0f), m2 = __fdiv_rn(s[1], 9.0f);
  const float sx = __fsub_rn(__fdiv_rn(s[2], 9.0f), __fmul_rn(m1, m1));
  const float sy = __fsub_rn(__fdiv_rn(s[3], 9.0f), __fmul_rn(m2, m2));
  const float sxy = __fsub_rn(__fdiv_rn(s[4], 9.0f), __fmul_rn(m1, m2));
  const float a = __fadd_rn(__fmul_rn(2.0f, sxy), SSIM_C2);
  const float b1 = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, m1), m2), SSIM_C1);
  const float c = __fadd_rn(__fadd_rn(sx, sy), SSIM_C2);
  const float e = __fadd_rn(__fadd_rn(__fmul_rn(m1, m1), __fmul_rn(m2, m2)), SSIM_C1);
  return __fdiv_rn(__fmul_rn(b1, a), __fmul_rn(e, c));
}

// The forward. Warp (wx, wy) of a block streams down FWD_ROWS image rows,
// lane l on elements l + 32 k (k < EPL) of the warp's run of the tile row.
constexpr int FWD_WX = 2, FWD_WY = 4, FWD_ROWS = 8;
constexpr int FWD_TH = FWD_WY * FWD_ROWS;  // 32
constexpr int FWD_THREADS = 32 * FWD_WX * FWD_WY;

template <typename T>
__host__ __device__ constexpr int fwd_tile_elems() {  // elements of a tile row: 4 bytes a lane
  return FWD_WX * 32 * (4 / (int)sizeof(T));
}

template <typename T, int C>
__global__ void __launch_bounds__(FWD_THREADS, 3)
    ssim_fwd_kernel(const T* __restrict__ xs, const T* __restrict__ ys, T* __restrict__ out,
                    int H, int W) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int EPL = 4 / (int)sizeof(T);  // elements a lane, 32 apart
  constexpr int WE = 32 * EPL;             // elements a warp
  constexpr int TE = fwd_tile_elems<T>();
  constexpr int kRow = TE + 2 * C;  // a staged row: the tile row and C on each side
  constexpr int NCH = (kRow + V - 1) / V + 1;
  constexpr int kRaw = NCH * V;  // elements of a staged row
  constexpr int ROWS = FWD_TH + 2;
  __shared__ uint4 raw[2][ROWS * NCH];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e0 = blockIdx.x * TE, y0 = blockIdx.y * FWD_TH;
  const size_t img = (size_t)blockIdx.z * H * W * C;  // 32-bit offsets within the image
  const T* xi = xs + img;
  const T* yi = ys + img;
  const int row_len = W * C;
  const int e_lo = e0 - C;
  stage_halo<T, ROWS, NCH, FWD_THREADS>(raw, xi, yi, y0 - 1, H, row_len, e_lo, max(e_lo, 0),
                                        min(e_lo + kRow, row_len));
  __syncthreads();
  const T* rx = reinterpret_cast<const T*>(raw[0]);
  const T* ry = reinterpret_cast<const T*>(raw[1]);

  const int ew = (warp % FWD_WX) * WE;        // the warp's first element in the tile row
  const int r0 = (warp / FWD_WX) * FWD_ROWS;  // its first output row in the tile
  if (y0 + r0 >= H || e0 + ew >= row_len) return;
  const int len = min(WE, row_len - e0 - ew);

  // x and y of staged row r at the lane's elements and their two horizontal
  // neighbours (C elements to each side)
  auto taps = [&](int r, float a[EPL][3], float b[EPL][3]) {
    const int yr = y0 - 1 + r;
    const T* px = rx + r * kRaw + row_shift(xi, yr, row_len, e_lo) + C + ew + lane;
    const T* py = ry + r * kRaw + row_shift(yi, yr, row_len, e_lo) + C + ew + lane;
#pragma unroll
    for (int k = 0; k < EPL; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        a[k][d] = to_f(px[32 * k + (d - 1) * C]);
        b[k][d] = to_f(py[32 * k + (d - 1) * C]);
      }
  };
  // a warp's row of the map, stored directly: 32 lanes on consecutive elements
  auto store = [&](int yo, int k, float v) {
    if (lane + 32 * k < len) out[img + (size_t)yo * row_len + e0 + ew + lane + 32 * k] = from_f<T>(v);
  };

  if constexpr (sizeof(T) == 2) {
    // bf16: each staged row's 3-wide horizontal sums, added down three rows
    auto hsum = [&](int r, float h[EPL][5]) {
      float a[EPL][3], b[EPL][3];
      taps(r, a, b);
#pragma unroll
      for (int k = 0; k < EPL; ++k) {
        h[k][0] = a[k][0] + a[k][1] + a[k][2];
        h[k][1] = b[k][0] + b[k][1] + b[k][2];
        h[k][2] = a[k][0] * a[k][0] + a[k][1] * a[k][1] + a[k][2] * a[k][2];
        h[k][3] = b[k][0] * b[k][0] + b[k][1] * b[k][1] + b[k][2] * b[k][2];
        h[k][4] = a[k][0] * b[k][0] + a[k][1] * b[k][1] + a[k][2] * b[k][2];
      }
    };
    float h0[EPL][5], h1[EPL][5];
    hsum(r0, h0);
    hsum(r0 + 1, h1);
#pragma unroll
    for (int t = 0; t < FWD_ROWS; ++t) {
      const int yo = y0 + r0 + t;
      if (yo >= H) break;
      float h2[EPL][5];
      hsum(r0 + t + 2, h2);
#pragma unroll
      for (int k = 0; k < EPL; ++k) {
        float sum[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          sum[j] = h0[k][j] + h1[k][j] + h2[k][j];
          h0[k][j] = h1[k][j];
          h1[k][j] = h2[k][j];
        }
        store(yo, k, map_from_sums(sum));
      }
    }
  } else {
    // f32: the plain version's sums, row-major over the window: the top
    // row's sum, then the middle and bottom rows' values one by one, the
    // products each rounded
    auto values = [&](int r, float v[EPL][5][3]) {
      float a[EPL][3], b[EPL][3];
      taps(r, a, b);
#pragma unroll
      for (int k = 0; k < EPL; ++k)
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          v[k][0][d] = a[k][d];
          v[k][1][d] = b[k][d];
          v[k][2][d] = __fmul_rn(a[k][d], a[k][d]);
          v[k][3][d] = __fmul_rn(b[k][d], b[k][d]);
          v[k][4][d] = __fmul_rn(a[k][d], b[k][d]);
        }
    };
    float top[EPL][5], mid[EPL][5][3];
    values(r0, mid);
#pragma unroll
    for (int k = 0; k < EPL; ++k)
#pragma unroll
      for (int j = 0; j < 5; ++j) top[k][j] = mid[k][j][0] + mid[k][j][1] + mid[k][j][2];
    values(r0 + 1, mid);
#pragma unroll
    for (int t = 0; t < FWD_ROWS; ++t) {
      const int yo = y0 + r0 + t;
      if (yo >= H) break;
      float bot[EPL][5][3];
      values(r0 + t + 2, bot);
#pragma unroll
      for (int k = 0; k < EPL; ++k) {
        float sum[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          sum[j] = top[k][j] + mid[k][j][0] + mid[k][j][1] + mid[k][j][2] + bot[k][j][0] +
                   bot[k][j][1] + bot[k][j][2];
          top[k][j] = mid[k][j][0] + mid[k][j][1] + mid[k][j][2];
#pragma unroll
          for (int d = 0; d < 3; ++d) mid[k][j][d] = bot[k][j][d];
        }
        store(yo, k, map_plain_order(sum));
      }
    }
  }
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

  // 1. x and y over the tile and its 2-pixel halo
  stage_halo<T, HALO_H, NCH, BWD_THREADS>(raw, xi, yi, y0 - 2, H, row_len, e_lo, v_lo, v_hi);
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
      const T* px = rx + r * kRaw + row_shift(xi, y0 - 2 + r, row_len, e_lo) + lane * C + c;
      const T* py = ry + r * kRaw + row_shift(yi, y0 - 2 + r, row_len, e_lo) + lane * C + c;
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

template <typename T, int C>
static int launch_fwd(const void* x, const void* y, void* out, int B, int H, int W,
                      cudaStream_t s) {
  constexpr int TE = fwd_tile_elems<T>();
  const dim3 grid((W * C + TE - 1) / TE, (H + FWD_TH - 1) / FWD_TH, B);
  ssim_fwd_kernel<T, C><<<grid, FWD_THREADS, 0, s>>>((const T*)x, (const T*)y, (T*)out, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
static int fwd(const void* x, const void* y, void* out, int B, int H, int W, int C,
               cudaStream_t s) {
  switch (C) {
    case 1: return launch_fwd<T, 1>(x, y, out, B, H, W, s);
    case 2: return launch_fwd<T, 2>(x, y, out, B, H, W, s);
    case 3: return launch_fwd<T, 3>(x, y, out, B, H, W, s);
    case 4: return launch_fwd<T, 4>(x, y, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, y [B,H,W,C] (bf16 | f32, one type; 1 <= C <= 4) -> s [B,H,W,C] in that
// type. Returns cudaGetLastError().
extern "C" int ssim_fwd(const void* x, const void* y, void* out, int dtype, int B,
                        int H, int W, int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * H * W * C == 0) return (int)cudaGetLastError();
  if (C < 1 || C > 4 || B > 65535 || (long long)H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16) return fwd<__nv_bfloat16>(x, y, out, B, H, W, C, s);
  if (dtype == kF32) return fwd<float>(x, y, out, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
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
