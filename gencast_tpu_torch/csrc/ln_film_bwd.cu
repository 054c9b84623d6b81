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
// call, 0.6 GB moved, and 33 calls per training step of 10,304 x 512, 32 MB
// each), against ~16 flops per element.
//
// Design: one launch per call, a persistent cooperative grid.
// * Rows: one warp per row, each lane holding 16-byte vectors (8 bf16 or 4
//   float32 consecutive columns; vector v = lane + 32 j), so the four row
//   reductions (sum x, sum x^2, sum g, sum g * x_hat) are warp shuffles and
//   x and dy are read once. The grid (a whole number of blocks per SM, at
//   most the blocks that fit on one, shared among the batch elements: the
//   wrapper's launch_blocks) strides over the rows; a warp issues the loads
//   of its next row before it reduces the current one, so two rows per warp
//   are in flight.
// * dscale / doffset: the TPU kernel accumulated them across its sequential
//   row grid. Here each lane keeps its columns' sums over the rows its warp
//   visits; a block folds its warps in shared memory in a fixed order and
//   writes one partial row; then, after a grid-wide barrier (the launch is
//   cooperative, so every block is resident), every block folds 32 columns
//   at a time over all the partial rows of a batch element, each column in
//   a fixed order. No float atomics: the same bits from run to run on a
//   card. The barrier is one self-resetting integer counter (no reset from
//   the host between calls, so a CUDA graph can replay the launch).
// * Both layouts, rows-leading [R, B, C] (GNN) and batch-leading [B, R, C]
//   (transformer), through a row stride and a batch stride, without a
//   transpose copy. Shared memory: scale and the warps' fold, sized to C.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxC = 1024;

// The grid barrier's counter. Block 0 adds 2^31 - (blocks - 1) and every
// other block 1, so the top bit flips once all have arrived and the low bits
// come back to 0: the counter needs no reset between barriers or calls.
// Launches on one device must not overlap (the port runs on one stream).
__device__ unsigned int g_barrier = 0;

__device__ __forceinline__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();  // this block's partial row, before its arrival
    const unsigned int old = atomicAdd(&g_barrier, add);
    volatile unsigned int* counter = &g_barrier;
    while (((old ^ *counter) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Shared memory: scale [c] (float), then the warps' sums [kWarps][c].
size_t smem_bytes(int c) { return sizeof(float) * (kWarps + 1) * c; }

// Grid: batch * blocks_per_batch blocks; block k serves batch element
// k / blocks_per_batch. Its warp w takes rows blk * kWarps + w + i * stride,
// stride = blocks_per_batch * kWarps (ln_film.warp_rows mirrors this).
// parts: [batch * blocks_per_batch, 2, c] float32 scratch. NV >= the
// 16-byte vectors per lane, c / (32 * vec).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) ln_film_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const T* __restrict__ scale, T* __restrict__ dx,
    float* __restrict__ parts, float* __restrict__ dscale,
    float* __restrict__ doffset, int batch, int rows, int c,
    long long row_stride, long long batch_stride, int blocks_per_batch,
    float eps) {
  constexpr int V = gt::kVec16<T>;
  constexpr int N = NV * V;  // columns per lane
  extern __shared__ float smem[];
  float* sc = smem;          // [c]
  float* red = smem + c;     // [kWarps][c]
  const int b = blockIdx.x / blocks_per_batch;
  const int blk = blockIdx.x % blocks_per_batch;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvec = c / V;
  const float inv_c = 1.f / static_cast<float>(c);

  for (int i = threadIdx.x; i < c; i += kThreads) {
    sc[i] = gt::to_float(scale[static_cast<size_t>(b) * c + i]);
  }
  __syncthreads();

  bool valid[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) valid[j] = lane + 32 * j < nvec;
  float dsc[N], doff[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    dsc[i] = 0.f;
    doff[i] = 0.f;
  }

  const size_t base_b = static_cast<size_t>(b) * batch_stride;
  auto load = [&](long long r, uint4 (&xr)[NV], uint4 (&dr)[NV]) {
    const size_t at = base_b + static_cast<size_t>(r) * row_stride;
    const uint4* xp = reinterpret_cast<const uint4*>(x + at);
    const uint4* dp = reinterpret_cast<const uint4*>(dy + at);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (valid[j]) {
        xr[j] = __ldg(xp + lane + 32 * j);
        dr[j] = __ldg(dp + lane + 32 * j);
      } else {
        xr[j] = make_uint4(0, 0, 0, 0);  // zeros add nothing to the sums
        dr[j] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  const long long stride = static_cast<long long>(blocks_per_batch) * kWarps;
  long long r = static_cast<long long>(blk) * kWarps + warp;
  uint4 xa[NV], da[NV];
  if (r < rows) load(r, xa, da);
  for (; r < rows; r += stride) {  // the same rows for every lane of a warp
    uint4 xn[NV], dn[NV];
    if (r + stride < rows) load(r + stride, xn, dn);
    float xv[N], gv[N];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      gt::unpack16(xa[j], xv + j * V, T());
      gt::unpack16(da[j], gv + j * V, T());
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s1 += xv[i];
      s2 += xv[i] * xv[i];
    }
    const float mu = warp_sum(s1) * inv_c;
    const float var = fmaxf(warp_sum(s2) * inv_c - mu * mu, 0.f);
    const float rstd = rsqrtf(var + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!valid[j]) continue;
      const float* s = sc + (lane + 32 * j) * V;
#pragma unroll
      for (int i = j * V; i < (j + 1) * V; ++i) {
        const float xh = (xv[i] - mu) * rstd;
        xv[i] = xh;
        dsc[i] += gv[i] * xh;
        doff[i] += gv[i];
        gv[i] *= s[i - j * V];
        m1 += gv[i];
        m2 += gv[i] * xh;
      }
    }
    m1 = warp_sum(m1) * inv_c;
    m2 = warp_sum(m2) * inv_c;
    uint4* out = reinterpret_cast<uint4*>(
        dx + base_b + static_cast<size_t>(r) * row_stride);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!valid[j]) continue;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        o[i] = rstd * (gv[j * V + i] - m1 - xv[j * V + i] * m2);
      }
      out[lane + 32 * j] = gt::pack16(o, T());
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      xa[j] = xn[j];
      da[j] = dn[j];
    }
  }

  // The block's partial row: its warps folded in a fixed order, dscale then
  // doffset (one call site per array keeps both arrays in registers).
  float* part = parts + static_cast<size_t>(blockIdx.x) * 2 * c;
  auto fold = [&](const float (&mine)[N], float* out) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!valid[j]) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[warp * c + (lane + 32 * j) * V + i] = mine[j * V + i];
      }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < c; col += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += red[w * c + col];
      out[col] = acc;
    }
    __syncthreads();
  };
  fold(dsc, part);
  fold(doff, part + c);

  grid_barrier();

  // Fold the partial rows: unit u = (batch element, 32 of the 2c columns
  // [dscale | doffset]); warp w sums partial rows w, w + kWarps, ... in
  // order, then warp 0 adds the warps' sums in order. __ldcg reads from L2,
  // where the other blocks' rows are.
  const int units_per_b = 2 * c / 32;
  for (int u = blockIdx.x; u < batch * units_per_b; u += gridDim.x) {
    const int ub = u / units_per_b;
    const int col = (u % units_per_b) * 32 + lane;
    const float* p = parts + static_cast<size_t>(ub) * blocks_per_batch * 2 * c
                     + col;
    constexpr int kInFlight = 8;  // partial rows loaded before their adds
    float acc = 0.f;
    int i = warp;
    for (; i + (kInFlight - 1) * kWarps < blocks_per_batch;
         i += kInFlight * kWarps) {
      float a[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        a[k] = __ldcg(p + static_cast<size_t>(i + k * kWarps) * 2 * c);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) acc += a[k];
    }
    for (; i < blocks_per_batch; i += kWarps) {
      acc += __ldcg(p + static_cast<size_t>(i) * 2 * c);
    }
    red[warp * 32 + lane] = acc;
    __syncthreads();
    if (warp == 0) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += red[w * 32 + lane];
      if (col < c) {
        dscale[static_cast<size_t>(ub) * c + col] = total;
      } else {
        doffset[static_cast<size_t>(ub) * c + col - c] = total;
      }
    }
    __syncthreads();
  }
}

// What the entry points run for one (T, NV) instantiation.
struct Launch {
  const void *x, *dy, *scale;
  void* dx;
  float *parts, *dscale, *doffset;
  int batch, rows, c;
  long long row_stride, batch_stride;
  int blocks_per_batch;
  float eps;
  cudaStream_t stream;

  template <typename T, int NV>
  int run() const {
    const T* xt = static_cast<const T*>(x);
    const T* dyt = static_cast<const T*>(dy);
    const T* st = static_cast<const T*>(scale);
    T* dxt = static_cast<T*>(dx);
    float *p = parts, *ds = dscale, *dof = doffset;
    int b = batch, r = rows, cc = c, bpb = blocks_per_batch;
    long long rs = row_stride, bs = batch_stride;
    float e = eps;
    void* args[] = {&xt, &dyt, &st, &dxt, &p, &ds, &dof, &b,
                    &r,  &cc,  &rs, &bs,  &bpb, &e};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(ln_film_bwd_kernel<T, NV>),
        dim3(batch * blocks_per_batch), dim3(kThreads), args, smem_bytes(c),
        stream));
  }
};

struct BlocksPerSm {
  int c;

  template <typename T, int NV>
  int run() const {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, ln_film_bwd_kernel<T, NV>, kThreads, smem_bytes(c)) !=
        cudaSuccess) {
      return 0;
    }
    return blocks;
  }
};

// fn.run<T, NV>() with NV the 16-byte vectors per lane that c needs,
// c / (32 * vector), rounded up to 1, 2, 4 (or 8, float32 above c 512);
// `invalid` for an unknown dtype.
template <typename Fn>
int dispatch(int dtype, int c, const Fn& fn, int invalid) {
  if (dtype == gt::kFloat32) {
    const int nv = (c / 4 + 31) / 32;
    if (nv <= 1) return fn.template run<float, 1>();
    if (nv <= 2) return fn.template run<float, 2>();
    if (nv <= 4) return fn.template run<float, 4>();
    return fn.template run<float, 8>();
  }
  if (dtype == gt::kBFloat16) {
    const int nv = (c / 8 + 31) / 32;
    if (nv <= 1) return fn.template run<__nv_bfloat16, 1>();
    if (nv <= 2) return fn.template run<__nv_bfloat16, 2>();
    return fn.template run<__nv_bfloat16, 4>();
  }
  return invalid;
}

}  // namespace

// Blocks of the kernel that fit on one SM for this dtype and c (the wrapper
// sizes the cooperative grid from it and the SM count); 0 on a bad dtype or
// c, or when the query fails.
extern "C" int gt_ln_film_bwd_blocks_per_sm(int dtype, int c) {
  if (c % 32 != 0 || c < 32 || c > kMaxC) return 0;
  return dispatch(dtype, c, BlocksPerSm{c}, 0);
}

// x, dy, dx: [batch, rows, c] or [rows, batch, c] contiguous (element (b, r,
// col) at b * batch_stride + r * row_stride + col), float32 or bfloat16,
// starting on 16 bytes; scale: [batch, c] of the same dtype; parts:
// [batch * blocks_per_batch, 2, c] float32 scratch; dscale / doffset:
// [batch, c] float32. c a multiple of 32 in [32, 1024]; batch *
// blocks_per_batch blocks must fit on the card at once (a cooperative
// launch refuses more). Returns a cudaError_t code.
extern "C" int gt_ln_film_bwd(int dtype, const void* x, const void* dy,
                              const void* scale, void* dx, void* parts,
                              void* dscale, void* doffset, int batch,
                              int rows, int c, long long row_stride,
                              long long batch_stride, int blocks_per_batch,
                              float eps, void* stream) {
  if (c % 32 != 0 || c < 32 || c > kMaxC || batch < 1 || rows < 0 ||
      blocks_per_batch < 1) {
    return cudaErrorInvalidValue;
  }
  const Launch launch{x, dy, scale, dx, static_cast<float*>(parts),
                      static_cast<float*>(dscale),
                      static_cast<float*>(doffset), batch, rows, c,
                      row_stride, batch_stride, blocks_per_batch, eps,
                      static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, c, launch, static_cast<int>(cudaErrorInvalidValue));
}
