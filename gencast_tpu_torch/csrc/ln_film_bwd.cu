// Backward of LayerNorm (no learned scale/bias) followed by FiLM:
//   y = x_hat * scale + offset,   x_hat = (x - mean) * rstd
//   dx      = rstd * (g - mean_C(g) - x_hat * mean_C(g * x_hat)), g = dy * scale
//   dscale  = sum over rows of dy * x_hat   (per batch element, float32)
//   doffset = sum over rows of dy           (per batch element, float32)
//
// Replaces the TPU kernel gencast_tpu/ops/ln_film.py:_bwd_kernel (pallas_call
// in _bwd_pallas). The statistics are recomputed here with the port's
// forward formula (nn/mlp.py: one-pass E[x^2] - E[x]^2 clamped at 0, then
// rsqrt(var + eps)), which the reference's kernel uses without the clamp;
// the two differ only where the one-pass variance rounds below zero.
//
// What bounds it on an H100: bytes. Each row of x and dy is read once and
// each row of dx written once (at 1 degree up to 195,480 x 512 bf16 rows per
// call, 0.6 GB moved), against ~10 flops per element.
//
// Design:
// * One warp per row, lane l holding columns l + 32 j in registers (C a
//   multiple of 32 up to 1024), so the four row reductions (sum x, sum x^2,
//   sum g, sum g * x_hat) are warp shuffles and x and dy are read once.
// * The TPU kernel accumulated dscale/doffset across its sequential row
//   grid. Here each lane keeps its columns' partial sums over the rows its
//   warp visits; a block folds its 8 warps in shared memory in a fixed
//   order and writes one partial row per block; a second kernel sums the
//   block partials per batch element, again in a fixed order. No atomics:
//   the result is the same bits from run to run.
// * Both layouts, rows-leading [R, B, C] (GNN) and batch-leading [B, R, C]
//   (transformer), through a row stride and a batch stride, without a
//   transpose copy. Ragged rows past R are skipped.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxC = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Grid (num_blocks, batch). Block `blk` of batch element b covers rows
// [blk * rows_per_block, +rows_per_block); warp w takes rows_per_warp
// consecutive rows of it. NJ >= c / 32 is the register array length.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) ln_film_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const T* __restrict__ scale, T* __restrict__ dx,
    float* __restrict__ dscale_part, float* __restrict__ doffset_part,
    int rows, int c, long long row_stride, long long batch_stride,
    int rows_per_warp, float eps) {
  __shared__ float red[kWarps * kMaxC];
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nj = c / 32;
  const float inv_c = 1.f / static_cast<float>(c);

  float sc[NJ], dsc[NJ], doff[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    sc[j] = j < nj ? gt::to_float(scale[static_cast<size_t>(b) * c + lane + 32 * j])
                   : 0.f;
    dsc[j] = 0.f;
    doff[j] = 0.f;
  }

  const long long row0 =
      (static_cast<long long>(blk) * kWarps + warp) * rows_per_warp;
  for (int i = 0; i < rows_per_warp; ++i) {
    const long long r = row0 + i;
    if (r >= rows) break;  // the same for every lane of the warp
    const size_t base = static_cast<size_t>(b * batch_stride + r * row_stride);
    float xv[NJ], gv[NJ];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        xv[j] = gt::to_float(x[base + lane + 32 * j]);
        gv[j] = gt::to_float(dy[base + lane + 32 * j]);
        s1 += xv[j];
        s2 += xv[j] * xv[j];
      }
    }
    const float mu = warp_sum(s1) * inv_c;
    const float var = fmaxf(warp_sum(s2) * inv_c - mu * mu, 0.f);
    const float rstd = rsqrtf(var + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        const float xh = (xv[j] - mu) * rstd;
        xv[j] = xh;
        dsc[j] += gv[j] * xh;
        doff[j] += gv[j];
        gv[j] *= sc[j];
        m1 += gv[j];
        m2 += gv[j] * xh;
      }
    }
    m1 = warp_sum(m1) * inv_c;
    m2 = warp_sum(m2) * inv_c;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        dx[base + lane + 32 * j] =
            gt::from_float<T>(rstd * (gv[j] - m1 - xv[j] * m2));
      }
    }
  }

  // Fold the 8 warps' partial sums in a fixed order: dscale, then doffset.
  // (One call site per array keeps both arrays in registers.)
  const size_t part = (static_cast<size_t>(b) * gridDim.x + blk) * c;
  auto fold = [&](const float (&mine)[NJ], float* out) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) red[warp * c + lane + 32 * j] = mine[j];
    }
    __syncthreads();
    for (int col = threadIdx.x; col < c; col += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += red[w * c + col];
      out[part + col] = acc;
    }
    __syncthreads();
  };
  fold(dsc, dscale_part);
  fold(doff, doffset_part);
}

// Grid (ceil(c / 32), batch, 2): sums the num_blocks partial rows of one
// batch element for 32 columns; z = 0 reduces dscale, z = 1 doffset. The 8
// warps take every 8th partial row, then fold in a fixed order.
__global__ void __launch_bounds__(kThreads) ln_film_reduce_kernel(
    const float* __restrict__ dscale_part,
    const float* __restrict__ doffset_part, float* __restrict__ dscale,
    float* __restrict__ doffset, int num_blocks, int c) {
  __shared__ float red[kWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  const int b = blockIdx.y;
  const float* part = blockIdx.z == 0 ? dscale_part : doffset_part;
  float acc = 0.f;
  if (col < c) {
    for (int k = warp; k < num_blocks; k += kWarps) {
      acc += part[(static_cast<size_t>(b) * num_blocks + k) * c + col];
    }
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < c) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w][lane];
    (blockIdx.z == 0 ? dscale : doffset)[static_cast<size_t>(b) * c + col] =
        total;
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* x, const void* dy, const void* scale, void* dx,
                   float* dscale_part, float* doffset_part, int batch,
                   int rows, int c, long long row_stride,
                   long long batch_stride, int rows_per_warp, int num_blocks,
                   float eps, cudaStream_t stream) {
  ln_film_bwd_kernel<T, NJ><<<dim3(num_blocks, batch), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(scale), static_cast<T*>(dx), dscale_part,
      doffset_part, rows, c, row_stride, batch_stride, rows_per_warp, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(const void* x, const void* dy, const void* scale,
                       void* dx, float* dscale_part, float* doffset_part,
                       int batch, int rows, int c, long long row_stride,
                       long long batch_stride, int rows_per_warp,
                       int num_blocks, float eps, cudaStream_t stream) {
  const int nj = c / 32;
#define GT_LN_FILM_LAUNCH(NJ)                                                \
  return launch<T, NJ>(x, dy, scale, dx, dscale_part, doffset_part, batch,  \
                       rows, c, row_stride, batch_stride, rows_per_warp,    \
                       num_blocks, eps, stream)
  if (nj <= 2) GT_LN_FILM_LAUNCH(2);    // C <= 64 (TINY)
  if (nj <= 4) GT_LN_FILM_LAUNCH(4);    // C <= 128
  if (nj <= 8) GT_LN_FILM_LAUNCH(8);    // C <= 256
  if (nj <= 16) GT_LN_FILM_LAUNCH(16);  // C <= 512 (ONE_DEG)
  GT_LN_FILM_LAUNCH(32);                // C <= 1024
#undef GT_LN_FILM_LAUNCH
}

}  // namespace

// x, dy, dx: [batch, rows, c] or [rows, batch, c] contiguous (element (b, r,
// col) at b * batch_stride + r * row_stride + col), float32 or bfloat16;
// scale: [batch, c] of the same dtype; dscale_part / doffset_part:
// [batch, num_blocks, c] float32 scratch; dscale / doffset: [batch, c]
// float32. c a multiple of 32 in [32, 1024]; num_blocks * 8 * rows_per_warp
// >= rows. Returns a cudaError_t code.
extern "C" int gt_ln_film_bwd(int dtype, const void* x, const void* dy,
                              const void* scale, void* dx, void* dscale_part,
                              void* doffset_part, void* dscale, void* doffset,
                              int batch, int rows, int c,
                              long long row_stride, long long batch_stride,
                              int rows_per_warp, int num_blocks, float eps,
                              void* stream) {
  if (c % 32 != 0 || c < 32 || c > kMaxC || rows_per_warp < 1 ||
      static_cast<long long>(num_blocks) * kWarps * rows_per_warp < rows) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* dsp = static_cast<float*>(dscale_part);
  auto* dop = static_cast<float*>(doffset_part);
  cudaError_t err;
  switch (dtype) {
    case gt::kFloat32:
      err = dispatch_c<float>(x, dy, scale, dx, dsp, dop, batch, rows, c,
                              row_stride, batch_stride, rows_per_warp,
                              num_blocks, eps, s);
      break;
    case gt::kBFloat16:
      err = dispatch_c<__nv_bfloat16>(x, dy, scale, dx, dsp, dop, batch, rows,
                                      c, row_stride, batch_stride,
                                      rows_per_warp, num_blocks, eps, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  ln_film_reduce_kernel<<<dim3((c + 31) / 32, batch, 2), kThreads, 0, s>>>(
      dsp, dop, static_cast<float*>(dscale), static_cast<float*>(doffset),
      num_blocks, c);
  return cudaGetLastError();
}
