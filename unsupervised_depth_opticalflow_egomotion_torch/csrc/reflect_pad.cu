// Reflection pad of one pixel on each side of an NHWC tensor, and its
// gradient: the input of every 3x3 convolution of the depth decoder.
//
// Replaces: no Pallas kernel. The JAX package's decoder builds the
// reflection halo from slices in its own layout (models/layers.py,
// ReflectConv3x3), which XLA fuses. ATen's reflection pad works in NCHW
// only: on the decoder's NHWC activations it first made a permuting copy,
// padded in NCHW and handed cuDNN an NCHW tensor, which cuDNN converted to
// NHWC again (nchwToNhwcKernel) in the forward and in both gradients, and
// its backward was an atomic scatter into a zero-filled gradient, in the
// gradient's own type. This pair works on NHWC as it lies in memory, so the
// padded tensor goes to cuDNN channels-last and no layout is converted.
//
// What it computes. out[b, i, j, c] = x[b, r(i - 1, H), r(j - 1, W), c] for
// i in [0, H + 2), j in [0, W + 2), with r(-1, n) = 1, r(n, n) = n - 2 and
// r(k, n) = k otherwise (H, W >= 2). The gradient of a source pixel (y, x)
// is the sum of the cotangents of the padded pixels that read it: the
// interior one (y + 1, x + 1), and on source row 1 also padded row 0, on
// row H - 2 also padded row H + 1, and the same for columns, corners by
// both: at most four terms (nine on a 3x3 image).
//
// What bounds it on the H100: bytes, at the roofline. Both kernels read
// one tensor and write one, with no arithmetic but the backward's few
// additions. At the decoder's 13 calls a train step (24 frames at
// 256x832) each direction moves about 2.0 GB, about 0.61 ms at 3.35 TB/s.
//
// Design. A thread owns one 16-byte chunk along C (8 bf16 or 4 f32
// values), neighbouring threads on neighbouring chunks, so every load and
// store is a full, coalesced 16-byte access; the decoder's widths (16 to
// 512 channels) all take this path. A row of C that is not a multiple of
// 16 bytes, or a pointer that is not 16-byte aligned, takes the same
// kernels with one element a thread.
//   - Forward: a vectorised copy. The thread of a padded chunk reads the
//     chunk of its reflected source pixel.
//   - Backward: the gather form. The thread of a source chunk reads the
//     interior cotangent and, on the rows and columns next to the border,
//     the reflected ones, adds them in f32 in a fixed order, and writes the
//     sum once in the gradient's type. No atomics and no zero fill: the
//     result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };

constexpr int RP_THREADS = 256;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// N values of T moved as one access: 16 bytes on the vector path, one
// element on the scalar path.
template <typename T, int N>
struct alignas(sizeof(T) * N) Chunk {
  T v[N];
};

// One access of a chunk: a 128-bit load or store on the vector path.
template <typename T, int N>
__device__ __forceinline__ Chunk<T, N> load(const Chunk<T, N>* p) {
  if constexpr (sizeof(Chunk<T, N>) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    Chunk<T, N> c;
    memcpy(&c, &u, 16);
    return c;
  } else {
    return *p;
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(Chunk<T, N>* p, const Chunk<T, N>& c) {
  if constexpr (sizeof(Chunk<T, N>) == 16) {
    uint4 u;
    memcpy(&u, &c, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = c;
  }
}

// The source index that padded index i (in [0, n + 2)) reads.
__device__ __forceinline__ unsigned reflect(unsigned i, unsigned n) {
  return i == 0 ? 1u : (i == n + 1 ? n - 2 : i - 1);
}

// `chunks` = chunks of C a pixel; `total` = chunks of the padded output.
template <typename T, int N>
__global__ void __launch_bounds__(RP_THREADS)
    reflect_pad_fwd_kernel(const Chunk<T, N>* __restrict__ in, Chunk<T, N>* __restrict__ out,
                           unsigned H, unsigned W, unsigned chunks, unsigned total) {
  const unsigned i = blockIdx.x * RP_THREADS + threadIdx.x;
  if (i >= total) return;
  const unsigned p = i / chunks, v = i - p * chunks;
  const unsigned row = p / (W + 2), j = p - row * (W + 2);
  const unsigned b = row / (H + 2), r = row - b * (H + 2);
  store(out + i, load(in + ((b * H + reflect(r, H)) * W + reflect(j, W)) * chunks + v));
}

// `total` = chunks of the source (the gradient written).
template <typename T, int N>
__global__ void __launch_bounds__(RP_THREADS)
    reflect_pad_bwd_kernel(const Chunk<T, N>* __restrict__ g, Chunk<T, N>* __restrict__ dx,
                           unsigned H, unsigned W, unsigned chunks, unsigned total) {
  const unsigned i = blockIdx.x * RP_THREADS + threadIdx.x;
  if (i >= total) return;
  const unsigned p = i / chunks, v = i - p * chunks;
  const unsigned row = p / W, x = p - row * W;
  const unsigned b = row / H, y = row - b * H;
  // the padded rows and columns that read (y, x): the interior one first
  const unsigned rows[3] = {y + 1, 0u, H + 1};
  const bool row_on[3] = {true, y == 1, y == H - 2};
  const unsigned cols[3] = {x + 1, 0u, W + 1};
  const bool col_on[3] = {true, x == 1, x == W - 2};
  const Chunk<T, N>* gb = g + (size_t)b * (H + 2) * (W + 2) * chunks + v;
  float acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (!row_on[a]) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (!col_on[c]) continue;
      const Chunk<T, N> t = load(gb + (rows[a] * (W + 2) + cols[c]) * chunks);
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] += to_f(t.v[k]);
    }
  }
  Chunk<T, N> o;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = from_f<T>(acc[k]);
  store(dx + i, o);
}

template <typename T>
static int launch(bool fwd, const void* src, void* dst, int B, int H, int W, int C,
                  cudaStream_t s) {
  constexpr int VN = 16 / sizeof(T);
  const unsigned hw = fwd ? (unsigned)(H + 2) * (W + 2) : (unsigned)H * W;
  const bool vec = C % VN == 0 && (((uintptr_t)src | (uintptr_t)dst) & 15) == 0;
  const unsigned chunks = vec ? C / VN : C;
  const unsigned total = (unsigned)B * hw * chunks;
  const unsigned blocks = (total + RP_THREADS - 1) / RP_THREADS;
  if (vec) {
    using V = Chunk<T, VN>;
    if (fwd)
      reflect_pad_fwd_kernel<T, VN><<<blocks, RP_THREADS, 0, s>>>((const V*)src, (V*)dst, H, W,
                                                                   chunks, total);
    else
      reflect_pad_bwd_kernel<T, VN><<<blocks, RP_THREADS, 0, s>>>((const V*)src, (V*)dst, H, W,
                                                                   chunks, total);
  } else {
    using E = Chunk<T, 1>;
    if (fwd)
      reflect_pad_fwd_kernel<T, 1><<<blocks, RP_THREADS, 0, s>>>((const E*)src, (E*)dst, H, W,
                                                                  chunks, total);
    else
      reflect_pad_bwd_kernel<T, 1><<<blocks, RP_THREADS, 0, s>>>((const E*)src, (E*)dst, H, W,
                                                                  chunks, total);
  }
  return (int)cudaGetLastError();
}

static int run(bool fwd, const void* src, void* dst, int dtype, int B, int H, int W, int C,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 0 || C < 0 || H < 2 || W < 2 ||
      (long long)B * (H + 2) * (W + 2) * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * C == 0) return (int)cudaGetLastError();
  if (dtype == kBF16) return launch<__nv_bfloat16>(fwd, src, dst, B, H, W, C, s);
  if (dtype == kF32) return launch<float>(fwd, src, dst, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// x [B,H,W,C] -> out [B,H+2,W+2,C], both contiguous, bf16 | f32.
extern "C" int reflect_pad_fwd(const void* x, void* out, int dtype, int B, int H, int W, int C,
                               void* stream) {
  return run(true, x, out, dtype, B, H, W, C, stream);
}

// g [B,H+2,W+2,C] (the padded output's cotangent) -> dx [B,H,W,C], both
// contiguous, bf16 | f32; the sums in f32.
extern "C" int reflect_pad_bwd(const void* g, void* dx, int dtype, int B, int H, int W, int C,
                               void* stream) {
  return run(false, g, dx, dtype, B, H, W, C, stream);
}
