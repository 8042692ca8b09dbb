// PWC cost volume (81 shifts at md=4), forward and backward, NHWC, as
// shared-memory halo tiles on the CUDA cores.
//
// Replaces: unsupervised_depth_opticalflow_egomotion_tpu/ops/pallas/
//   correlation_fused.py:_fwd_kernel (via _corr_fwd_pallas) and
//   _bwd_df1_kernel / _bwd_df2_kernel (via _corr_bwd_pallas); the forward also
//   serves correlation.py:_corr_kernel (pwc_corr="pallas").
//
// What it computes, with D = 81 shifts d = (i, j) in row-major order, md = 4:
//   out[b,y,x,d] = (1/C) sum_c f1[b,y,x,c] * f2[b, y+i-md, x+j-md, c]
// with zero padding outside f2;
//   df1[b,y,x,c] = (1/C) sum_d g[b,y,x,d] * f2[b, y+i-md, x+j-md, c]
//   df2[b,y,x,c] = (1/C) sum_d g[b, y-i+md, x-j+md, d] * f1[b, y-i+md, x-j+md, c]
// df2 is the gather (transpose) of the TPU kernel's scatter into a padded
// accumulator: each thread owns its outputs, so no atomics and the sums are
// deterministic. Products and sums are f32, one rounding to the output dtype
// (bf16 or f32) at the end. The TPU forward multiplies in bf16 before its f32
// sum; this one multiplies in f32.
//
// What bounds it on the H100: bytes. At the PWC levels (C = 32..196) an
// output costs C multiply-adds over values that are each used by 81 shifts;
// read once, the inputs and the 81-wide cost volume take about as long at
// 3.35 TB/s as the multiply-adds take at the CUDA cores' f32 rate.
//
// What the tiles do about it: a block owns a TH x 32 tile of pixels of one
// image and walks the channels in chunks of CK. Per chunk it stages the
// features it needs, with the tile's +-md halo, into shared memory as f32
// (one HBM/L2 read per value and tile; out-of-frame halo pixels are written
// as zeros, which is the zero padding, so the inner loops have no bounds
// checks), and every staged value is then reused from shared memory by its
// 81 shifts. The pixel stride in shared memory is CK + 1 (odd) and a warp's
// lanes are 32 neighbouring pixels of one row, so the inner loops' reads hit
// 32 different banks. Global reads of a staged pixel are 16-, 8- or 4-byte
// vectors where C and the base address allow, else scalars; outputs are
// staged in shared memory and written back in the same contiguous order.
//
// Tiles (TW = 32 pixels wide; shared memory per block, bf16 / f32 inputs):
// - corr_fwd: TH = 2, CK = 32, 576 threads: a thread owns one pixel and one
//   shift row i (9 accumulators over j, carried across the channel chunks).
//   f1 tile 2x32 and f2 halo 10x40 pixels x 33 floats = 61,248 B. The outputs
//   (2 x 32 x 81 floats) reuse that space, so each image row of the tile is
//   written as 32 x 81 contiguous values.
// - corr_bwd_df1 and corr_bwd_df2: one kernel, TH = 4, CK = 32, 512 threads:
//   a thread owns two pixel rows of one column and 4 channels of the chunk
//   (8 accumulators), so each feature value it reads from shared memory
//   serves both rows. The block stages g once, for each tile pixel the 81
//   values it takes (pixel stride 82 in bf16, an odd number of words): df1
//   its own g row; df2 the values g[q - d + md, d] that pixel q gathers, 9
//   contiguous values per source pixel and shift row, not the whole halo.
//   Feature halo 12x40 x 33 floats + g 4x32 x 82 values: 84,352 B (bf16),
//   104,832 B (f32). A chunk's outputs do not depend on other chunks, so
//   where the tiles alone give the card fewer than two blocks per SM (the
//   coarse levels), the chunks are split over blocks as well.
// Above 48 KB a block's dynamic shared memory needs cudaFuncSetAttribute;
// each entry sets it, and returns its error or the launch's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };

constexpr int MD = 4;            // the PWC search range
constexpr int ND = 2 * MD + 1;   // shifts per axis
constexpr int NSH = ND * ND;     // 81 shifts
constexpr int TW = 32;           // tile width: one warp's lanes
constexpr int HW = TW + 2 * MD;  // halo width

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VB bytes of a pixel's channels in one register (VB = 2: one bf16), read
// and written as 32-bit words by bit operations, so that a vector never
// passes through local memory.
template <int VB> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ unsigned word(unsigned short r, int) { return r; }
__device__ __forceinline__ unsigned word(unsigned r, int) { return r; }
__device__ __forceinline__ unsigned word(uint2 r, int n) { return n ? r.y : r.x; }
__device__ __forceinline__ unsigned word(uint4 r, int n) {
  return n == 0 ? r.x : n == 1 ? r.y : n == 2 ? r.z : r.w;
}
__device__ __forceinline__ void set_words(unsigned short& r, const unsigned* w) {
  r = (unsigned short)w[0];
}
__device__ __forceinline__ void set_words(unsigned& r, const unsigned* w) { r = w[0]; }
__device__ __forceinline__ void set_words(uint2& r, const unsigned* w) {
  r = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void set_words(uint4& r, const unsigned* w) {
  r = make_uint4(w[0], w[1], w[2], w[3]);
}

// element h of a 32-bit word (PER_WORD elements) to f32, and back
template <typename T> struct Bits;
template <> struct Bits<float> {
  static constexpr int PER_WORD = 1;
  __device__ static float get(unsigned w, int) { return __uint_as_float(w); }
  __device__ static unsigned put(float v, int) { return __float_as_uint(v); }
};
template <> struct Bits<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;
  __device__ static float get(unsigned w, int h) {
    return __uint_as_float(h ? w & 0xffff0000u : w << 16);
  }
  __device__ static unsigned put(float v, int h) {
    const unsigned b = __bfloat16_as_ushort(__float2bfloat16(v));
    return h ? b << 16 : b;
  }
};

// g's pixel stride in shared memory: an odd number of 32-bit words
template <typename T> __host__ __device__ constexpr int g_stride() {
  return sizeof(T) == 2 ? NSH + 1 : NSH;
}

// Stage channels [c0, c0 + CK) of the ROWS x COLS pixels whose top-left is
// (ya, xa) in image b into s[pixel * (CK + 1) + c] as f32, with the block's
// NT threads; zeros out of frame and for c >= ck. Consecutive threads take
// consecutive vectors of a pixel. The shape is fixed at compile time, so the
// index arithmetic is multiplies and shifts.
template <typename T, int VB, int CK, int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_feat(float* __restrict__ s, const T* __restrict__ f,
                                           int b, int H, int W, int C, int c0, int ck,
                                           int ya, int xa) {
  constexpr int V = VB / (int)sizeof(T);
  constexpr int NV = CK / V;
  using R = typename Raw<VB>::type;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * COLS * NV; e += NT) {
    const int pix = e / NV;
    const int c = (e - pix * NV) * V;
    const int hy = pix / COLS;
    const int y = ya + hy, x = xa + pix - hy * COLS;
    float* d = s + pix * (CK + 1) + c;
    if (c < ck && y >= 0 && y < H && x >= 0 && x < W) {
      const R r = __ldg(reinterpret_cast<const R*>(
          f + ((long long)(b * H + y) * W + x) * C + c0 + c));
      constexpr int PW = Bits<T>::PER_WORD;
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] = Bits<T>::get(word(r, k / PW), k % PW);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] = 0.f;
    }
  }
}

// Write s[pixel * (CK + 1) + c] (already scaled) for channels c < ck of the
// ROWS x TW tile at (ya, xa) to out[..., c0 + c], in the staging order.
template <typename T, int VB, int CK, int ROWS, int NT>
__device__ __forceinline__ void store_feat(T* __restrict__ out, const float* __restrict__ s,
                                           int b, int H, int W, int C, int c0, int ck,
                                           int ya, int xa) {
  constexpr int V = VB / (int)sizeof(T);
  constexpr int NV = CK / V;
  using R = typename Raw<VB>::type;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * TW * NV; e += NT) {
    const int pix = e / NV;
    const int c = (e - pix * NV) * V;
    const int y = ya + pix / TW, x = xa + pix % TW;
    if (c < ck && y < H && x < W) {
      constexpr int PW = Bits<T>::PER_WORD;
      unsigned wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < V; ++k) wv[k / PW] |= Bits<T>::put(s[pix * (CK + 1) + c + k], k % PW);
      R r;
      set_words(r, wv);
      *reinterpret_cast<R*>(out + ((long long)(b * H + y) * W + x) * C + c0 + c) = r;
    }
  }
}

// Stage all 81 values of g for the ROWS x COLS pixels at (ya, xa) into
// s[pixel * GP + d], in the input dtype; zeros out of frame. A row of the
// tile is COLS * 81 contiguous values in g, read in that order.
template <typename T, int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_g(T* __restrict__ s, const T* __restrict__ g, int b,
                                        int H, int W, int ya, int xa) {
  constexpr int GP = g_stride<T>();
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * COLS * NSH; e += NT) {
    const int hy = e / (COLS * NSH);
    const int k = e - hy * (COLS * NSH);
    const int px = k / NSH;
    const int y = ya + hy, x = xa + px;
    s[(hy * COLS + px) * GP + k - px * NSH] =
        (y >= 0 && y < H && x >= 0 && x < W)
            ? g[((long long)(b * H + y) * W + xa) * NSH + k]
            : from_f<T>(0.f);
  }
}

// Stage, for each pixel q of the ROWS x TW tile at (y0, x0), the 81 values
// g[q - d + md, d] (d = (i, j)) that df2 gathers into s[q * GP + d], in the
// input dtype; zeros where q - d + md is out of frame. For a shift row i the
// sources of a tile row lie on one image row, and each source pixel gives 9
// contiguous values (j = 0..8), read in that order; a value of the halo's
// 40 columns that no pixel of the tile takes is skipped.
template <typename T, int ROWS, int NT>
__device__ __forceinline__ void stage_g_shifted(T* __restrict__ s, const T* __restrict__ g,
                                                int b, int H, int W, int y0, int x0) {
  constexpr int GP = g_stride<T>();
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * ND * HW * ND; e += NT) {
    const int t = e / ND, j = e - t * ND;
    const int u = t / HW, hx = t - u * HW;  // source column x0 - md + hx
    const int r = u / ND, i = u - r * ND;
    const int lane = hx + j - 2 * MD;  // the tile column whose shift (i, j) lands here
    if (lane < 0 || lane >= TW) continue;
    const int y = y0 + r + MD - i, x = x0 - MD + hx;
    s[(r * TW + lane) * GP + i * ND + j] =
        (y >= 0 && y < H && x >= 0 && x < W)
            ? g[((long long)(b * H + y) * W + x) * NSH + i * ND + j]
            : from_f<T>(0.f);
  }
}

// ------------------------------------------------------------- forward

constexpr int FWD_TH = 2, FWD_CK = 32, FWD_CKP = FWD_CK + 1;
constexpr int FWD_THREADS = FWD_TH * ND * 32;
constexpr int FWD_SMEM = (FWD_TH * TW + (FWD_TH + 2 * MD) * HW) * FWD_CKP * 4;
static_assert(FWD_TH * TW * NSH * 4 <= FWD_SMEM, "output staging must fit");

// warp w = (tile row r, shift row i), lane = pixel column
template <typename T, int VB>
__global__ void __launch_bounds__(FWD_THREADS, 2)
corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
                int H, int W, int C) {
  extern __shared__ float4 smem_raw[];
  float* f1s = reinterpret_cast<float*>(smem_raw);  // [FWD_TH * TW][CKP]
  float* f2s = f1s + FWD_TH * TW * FWD_CKP;         // [(FWD_TH + 8) * HW][CKP]
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * FWD_TH, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = w / ND, i = w - r * ND;
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += FWD_CK) {
    const int ck = min(FWD_CK, C - c0);
    __syncthreads();  // the previous chunk's reads are done
    stage_feat<T, VB, FWD_CK, FWD_TH, TW, FWD_THREADS>(f1s, f1, b, H, W, C, c0, ck, y0, x0);
    stage_feat<T, VB, FWD_CK, FWD_TH + 2 * MD, HW, FWD_THREADS>(f2s, f2, b, H, W, C, c0, ck,
                                                                y0 - MD, x0 - MD);
    __syncthreads();
    const float* a = f1s + (r * TW + lane) * FWD_CKP;
    const float* s = f2s + ((r + i) * HW + lane) * FWD_CKP;
#pragma unroll 4
    for (int c = 0; c < ck; ++c) {
      const float av = a[c];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j] += av * s[j * FWD_CKP + c];
    }
  }

  __syncthreads();
  float* os = f1s;  // [FWD_TH * TW][81], over the feature tiles
  const float inv_c = 1.0f / (float)C;
#pragma unroll
  for (int j = 0; j < ND; ++j) os[(r * TW + lane) * NSH + i * ND + j] = acc[j] * inv_c;
  __syncthreads();
  // out[b, y, x0 : x0 + tw, :] is tw * 81 contiguous values for each row y
  const int tw = min(TW, W - x0);
  for (int rr = 0; rr < FWD_TH && y0 + rr < H; ++rr) {
    T* dst = out + ((long long)(b * H + y0 + rr) * W + x0) * NSH;
    const float* src = os + rr * TW * NSH;
    for (int e = threadIdx.x; e < tw * NSH; e += FWD_THREADS) dst[e] = from_f<T>(src[e]);
  }
}

// ------------------------------------------------------------- backward

constexpr int BWD_TH = 4, BWD_PR = 2, BWD_CK = 32, BWD_CKP = BWD_CK + 1, BWD_NG = 8;
constexpr int BWD_NC = BWD_CK / BWD_NG;  // channels a thread owns
constexpr int BWD_THREADS = BWD_TH / BWD_PR * BWD_NG * 32;
constexpr int BWD_F = (BWD_TH + 2 * MD) * HW * BWD_CKP * 4;  // feature halo bytes
template <typename T> __host__ __device__ constexpr int bwd_smem() {
  return BWD_F + BWD_TH * TW * g_stride<T>() * (int)sizeof(T);
}
static_assert(BWD_TH * TW * BWD_CKP * 4 <= BWD_F, "output staging must fit");

// df1 (DF2 = false) from g and f2, or df2 (DF2 = true) from g and f1.
// Warp w = (tile rows r0 .. r0 + PR - 1, channel group grp), lane = pixel
// column; the block stages the feature halo f and, per tile pixel q, the 81
// values of g it takes at shift d = (i, j):
// - df1: g[q, d] with f at q + (i - md, j - md): halo row r0 + pr + i,
//   column lane + j;
// - df2: g[q - d + md, d] with f at q - (i - md, j - md): halo row
//   r0 + pr + 2 md - i, column lane + 2 md - j.
// Each f value loaded for halo row r0 + h thus serves the PR pixel rows, at
// shift row i = h - pr (df1) or pr + 2 md - h (df2).
template <typename T, int VB, bool DF2>
__global__ void __launch_bounds__(BWD_THREADS, 2)
corr_bwd_kernel(const T* __restrict__ g, const T* __restrict__ f, T* __restrict__ df,
                int H, int W, int C, int nsplit) {
  constexpr int GP = g_stride<T>();
  extern __shared__ float4 smem_raw[];
  float* fs = reinterpret_cast<float*>(smem_raw);                           // [(TH+8)*HW][CKP]
  T* gs = reinterpret_cast<T*>(reinterpret_cast<char*>(smem_raw) + BWD_F);  // [TH*TW][GP]
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * BWD_TH;
  const int b = blockIdx.z / nsplit, split = blockIdx.z - b * nsplit;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = w % (BWD_TH / BWD_PR) * BWD_PR, grp = w / (BWD_TH / BWD_PR);
  if (DF2)
    stage_g_shifted<T, BWD_TH, BWD_THREADS>(gs, g, b, H, W, y0, x0);
  else
    stage_g<T, BWD_TH, TW, BWD_THREADS>(gs, g, b, H, W, y0, x0);
  const T* gp = gs + (r0 * TW + lane) * GP;
  const float inv_c = 1.0f / (float)C;

  for (int c0 = split * BWD_CK; c0 < C; c0 += nsplit * BWD_CK) {
    const int ck = min(BWD_CK, C - c0);
    __syncthreads();  // the previous chunk's output is written
    stage_feat<T, VB, BWD_CK, BWD_TH + 2 * MD, HW, BWD_THREADS>(fs, f, b, H, W, C, c0, ck,
                                                                y0 - MD, x0 - MD);
    __syncthreads();
    float acc[BWD_PR][BWD_NC] = {};
#pragma unroll
    for (int h = 0; h < BWD_PR + 2 * MD; ++h) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int col = DF2 ? lane + 2 * MD - j : lane + j;
        const float* s = fs + ((r0 + h) * HW + col) * BWD_CKP + grp * BWD_NC;
        float fv[BWD_NC];
#pragma unroll
        for (int k = 0; k < BWD_NC; ++k) fv[k] = s[k];
#pragma unroll
        for (int pr = 0; pr < BWD_PR; ++pr) {
          const int i = DF2 ? pr + 2 * MD - h : h - pr;
          if (i < 0 || i >= ND) continue;
          const float gv = to_f(gp[pr * TW * GP + i * ND + j]);
#pragma unroll
          for (int k = 0; k < BWD_NC; ++k) acc[pr][k] += gv * fv[k];
        }
      }
    }
    __syncthreads();
    float* os = fs;  // [TH * TW][CKP], over the feature halo
#pragma unroll
    for (int pr = 0; pr < BWD_PR; ++pr)
#pragma unroll
      for (int k = 0; k < BWD_NC; ++k)
        os[((r0 + pr) * TW + lane) * BWD_CKP + grp * BWD_NC + k] = acc[pr][k] * inv_c;
    __syncthreads();
    store_feat<T, VB, BWD_CK, BWD_TH, BWD_THREADS>(df, os, b, H, W, C, c0, ck, y0, x0);
  }
}

// ------------------------------------------------------------- entries

// The widest vector (16, 8 or 4 bytes) that every pixel row of the tensors
// at these addresses starts on, else one element.
static int vec_bytes(const void* a, const void* b, int C, int esz) {
  for (int vb = 16; vb > esz; vb /= 2)
    if ((C * esz) % vb == 0 && (uintptr_t)a % vb == 0 && (uintptr_t)b % vb == 0) return vb;
  return esz;
}

// Chunks per block of the backward: where the tiles alone give the card
// fewer than two blocks per SM, block z takes image z / n and every n-th
// channel chunk from z % n.
static int channel_split(long long blocks, int B, int C, int ck) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (2LL * sms + blocks - 1) / blocks;
  long long n = (C + ck - 1) / ck;
  if (want < n) n = want;
  if (n * B > 65535) n = 65535 / B;
  return n < 1 ? 1 : (int)n;
}

template <typename K>
static cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// One launch at the widest vector that the feature pointers a and b and the
// channel count allow (vec_bytes).
template <typename T, int VB>
static int launch_fwd(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                      cudaStream_t s) {
  auto k = corr_fwd_kernel<T, VB>;
  cudaError_t e = allow_smem(k, FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + FWD_TH - 1) / FWD_TH, B);
  k<<<grid, FWD_THREADS, FWD_SMEM, s>>>((const T*)f1, (const T*)f2, (T*)out, H, W, C);
  return (int)cudaGetLastError();
}

template <typename T>
static int fwd(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
               cudaStream_t s) {
  switch (vec_bytes(f1, f2, C, (int)sizeof(T))) {
    case 16: return launch_fwd<T, 16>(f1, f2, out, B, H, W, C, s);
    case 8: return launch_fwd<T, 8>(f1, f2, out, B, H, W, C, s);
    case 4: return launch_fwd<T, 4>(f1, f2, out, B, H, W, C, s);
    default: return launch_fwd<T, (int)sizeof(T)>(f1, f2, out, B, H, W, C, s);
  }
}

template <typename T, int VB, bool DF2>
static int launch_bwd(const void* g, const void* f, void* df, int B, int H, int W, int C,
                      cudaStream_t s) {
  auto k = corr_bwd_kernel<T, VB, DF2>;
  cudaError_t e = allow_smem(k, bwd_smem<T>());
  if (e != cudaSuccess) return (int)e;
  const int tx = (W + TW - 1) / TW, ty = (H + BWD_TH - 1) / BWD_TH;
  const int n = channel_split((long long)tx * ty * B, B, C, BWD_CK);
  k<<<dim3(tx, ty, B * n), BWD_THREADS, bwd_smem<T>(), s>>>((const T*)g, (const T*)f, (T*)df,
                                                             H, W, C, n);
  return (int)cudaGetLastError();
}

template <typename T, bool DF2>
static int bwd(const void* g, const void* f, void* df, int B, int H, int W, int C,
               cudaStream_t s) {
  switch (vec_bytes(f, df, C, (int)sizeof(T))) {
    case 16: return launch_bwd<T, 16, DF2>(g, f, df, B, H, W, C, s);
    case 8: return launch_bwd<T, 8, DF2>(g, f, df, B, H, W, C, s);
    case 4: return launch_bwd<T, 4, DF2>(g, f, df, B, H, W, C, s);
    default: return launch_bwd<T, (int)sizeof(T), DF2>(g, f, df, B, H, W, C, s);
  }
}

// Arguments the tiles do not take: another md, C < 1, a grid too tall.
static bool bad_args(int dtype, int B, int H, int C, int md, int th) {
  return md != MD || C < 1 || (dtype != kBF16 && dtype != kF32) || B > 65535 ||
         (H + th - 1) / th > 65535;
}

// f1, f2 [B,H,W,C] -> out [B,H,W,81], all of dtype (bf16 | f32); md must be 4.
extern "C" int corr_fwd(const void* f1, const void* f2, void* out, int dtype,
                        int B, int H, int W, int C, int md, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * H * W == 0) return (int)cudaGetLastError();
  if (bad_args(dtype, B, H, C, md, FWD_TH)) return (int)cudaErrorInvalidValue;
  return dtype == kBF16 ? fwd<__nv_bfloat16>(f1, f2, out, B, H, W, C, s)
                        : fwd<float>(f1, f2, out, B, H, W, C, s);
}

// g [B,H,W,81], f2 [B,H,W,C] -> df1 [B,H,W,C]
extern "C" int corr_bwd_df1(const void* g, const void* f2, void* df1, int dtype,
                            int B, int H, int W, int C, int md, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * H * W * C == 0) return (int)cudaGetLastError();
  if (bad_args(dtype, B, H, C, md, BWD_TH)) return (int)cudaErrorInvalidValue;
  return dtype == kBF16 ? bwd<__nv_bfloat16, false>(g, f2, df1, B, H, W, C, s)
                        : bwd<float, false>(g, f2, df1, B, H, W, C, s);
}

// g [B,H,W,81], f1 [B,H,W,C] -> df2 [B,H,W,C]
extern "C" int corr_bwd_df2(const void* g, const void* f1, void* df2, int dtype,
                            int B, int H, int W, int C, int md, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)B * H * W * C == 0) return (int)cudaGetLastError();
  if (bad_args(dtype, B, H, C, md, BWD_TH)) return (int)cudaErrorInvalidValue;
  return dtype == kBF16 ? bwd<__nv_bfloat16, true>(g, f1, df2, B, H, W, C, s)
                        : bwd<float, true>(g, f1, df2, B, H, W, C, s);
}
