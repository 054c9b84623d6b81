// Forward of LayerNorm (no learned scale/bias) followed by FiLM:
//   y = round(round(x_hat) * scale) + offset,   x_hat = (x - mean) * rstd
// with mean = sum(x) / C, var = max(sum(x^2) / C - mean^2, 0) and
// rstd = rsqrt(var + eps), all in float32, in the op order of the plain
// version (ops/ln_film.py: ln_film_forward): x_hat rounded to x's dtype,
// then the FiLM multiply and the add each rounded to that dtype, as
// PyTorch's elementwise multiply and add round them (no FMA across them).
// Only the float32 summation order of the two means differs.
//
// Replaces no TPU kernel: the JAX package leaves this forward to XLA
// (gencast_tpu/ops/ln_film.py: ln_film_reference), which fuses it. Without
// a fusion the plain version runs ~14 launches and moves ~52 bytes per bf16
// element through device memory; this kernel reads x once and writes y
// once (4 bytes per bf16 element).
//
// What bounds it on an H100: bytes (~10 flops per element). Every
// CondMLP output and every transformer norm of the denoiser goes through
// it: at 0.25 degrees ~14 M rows x 512 a call.
//
// Design: one warp per row, each lane holding 16-byte vectors (8 bf16 or 4
// float32 consecutive columns; vector v = lane + 32 j), so a row's two sums
// are warp shuffles and x is read once. A block serves one batch element:
// its warps load that element's scale and offset once into registers, then
// stride over the rows (the grid is a few waves of the blocks that fit on
// the card at once: the wrapper's launch_blocks_fwd), each warp loading its
// next row before it normalizes the current one. A row's bits depend on the
// row alone: its sums are taken in a fixed order by one warp whatever the
// grid or batch. Both layouts, rows-leading [R, B, C] (GNN) and batch-leading
// [B, R, C] (transformer), through a row stride and a batch stride.
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

// Grid (blocks_per_batch, batch); block (k, b) serves batch element b. Its
// warp w takes rows k * kWarps + w + i * stride, stride = blocks_per_batch *
// kWarps (ln_film.warp_rows mirrors this). NV >= the 16-byte vectors per
// lane, c / (32 * vec).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) ln_film_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ scale,
    const T* __restrict__ offset, T* __restrict__ y, int rows, int c,
    long long row_stride, long long batch_stride, float eps) {
  constexpr int V = gt::kVec16<T>;
  constexpr int N = NV * V;  // columns per lane
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvec = c / V;
  const float inv_c = 1.f / static_cast<float>(c);

  bool valid[NV];
  uint4 sv[NV], ov[NV];
  const uint4* sp = reinterpret_cast<const uint4*>(scale) +
                    static_cast<size_t>(b) * nvec;
  const uint4* op = reinterpret_cast<const uint4*>(offset) +
                    static_cast<size_t>(b) * nvec;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    valid[j] = lane + 32 * j < nvec;
    sv[j] = valid[j] ? __ldg(sp + lane + 32 * j) : make_uint4(0, 0, 0, 0);
    ov[j] = valid[j] ? __ldg(op + lane + 32 * j) : make_uint4(0, 0, 0, 0);
  }

  const size_t base_b = static_cast<size_t>(b) * batch_stride;
  auto load = [&](long long r, uint4 (&xr)[NV]) {
    const uint4* xp = reinterpret_cast<const uint4*>(
        x + base_b + static_cast<size_t>(r) * row_stride);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      // Zeros add nothing to the sums.
      xr[j] = valid[j] ? __ldg(xp + lane + 32 * j) : make_uint4(0, 0, 0, 0);
    }
  };

  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  uint4 xa[NV];
  if (r < rows) load(r, xa);
  for (; r < rows; r += stride) {  // the same rows for every lane of a warp
    uint4 xn[NV];
    if (r + stride < rows) load(r + stride, xn);
    float xv[N];
#pragma unroll
    for (int j = 0; j < NV; ++j) gt::unpack16(xa[j], xv + j * V, T());
    // Each square rounded before its add, as the plain version's x * x.
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s1 = __fadd_rn(s1, xv[i]);
      s2 = __fadd_rn(s2, __fmul_rn(xv[i], xv[i]));
    }
    const float mu = __fmul_rn(warp_sum(s1), inv_c);
    float var = __fsub_rn(__fmul_rn(warp_sum(s2), inv_c), __fmul_rn(mu, mu));
    var = var < 0.f ? 0.f : var;  // clamp_min(0): a NaN stays NaN
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    uint4* out = reinterpret_cast<uint4*>(
        y + base_b + static_cast<size_t>(r) * row_stride);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!valid[j]) continue;
      float s[V], o[V], v[V];
      gt::unpack16(sv[j], s, T());
      gt::unpack16(ov[j], o, T());
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh =
            gt::round_to<T>(__fmul_rn(__fsub_rn(xv[j * V + i], mu), rstd));
        v[i] = __fadd_rn(gt::round_to<T>(__fmul_rn(xh, s[i])), o[i]);
      }
      out[lane + 32 * j] = gt::pack16(v, T());
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) xa[j] = xn[j];
  }
}

// What the entry points run for one (T, NV) instantiation.
struct Launch {
  const void *x, *scale, *offset;
  void* y;
  int batch, rows, c;
  long long row_stride, batch_stride;
  int blocks_per_batch;
  float eps;
  cudaStream_t stream;

  template <typename T, int NV>
  int run() const {
    ln_film_fwd_kernel<T, NV>
        <<<dim3(blocks_per_batch, batch), kThreads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(scale),
            static_cast<const T*>(offset), static_cast<T*>(y), rows, c,
            row_stride, batch_stride, eps);
    return static_cast<int>(cudaGetLastError());
  }
};

struct BlocksPerSm {
  template <typename T, int NV>
  int run() const {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, ln_film_fwd_kernel<T, NV>, kThreads, 0) != cudaSuccess) {
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
// sizes the grid from it and the SM count); 0 on a bad dtype or c, or when
// the query fails.
extern "C" int gt_ln_film_fwd_blocks_per_sm(int dtype, int c) {
  if (c % 32 != 0 || c < 32 || c > kMaxC) return 0;
  return dispatch(dtype, c, BlocksPerSm{}, 0);
}

// x, y: [batch, rows, c] or [rows, batch, c] contiguous (element (b, r, col)
// at b * batch_stride + r * row_stride + col), float32 or bfloat16,
// starting on 16 bytes; scale, offset: [batch, c] contiguous, of the same
// dtype, starting on 16 bytes. c a multiple of 32 in [32, 1024]. Launches
// blocks_per_batch x batch blocks on `stream`. Returns a cudaError_t code.
extern "C" int gt_ln_film_fwd(int dtype, const void* x, const void* scale,
                              const void* offset, void* y, int batch,
                              int rows, int c, long long row_stride,
                              long long batch_stride, int blocks_per_batch,
                              float eps, void* stream) {
  if (c % 32 != 0 || c < 32 || c > kMaxC || batch < 1 || batch > 65535 ||
      rows < 0 || blocks_per_batch < 1) {
    return cudaErrorInvalidValue;
  }
  const Launch launch{x, scale, offset, y, batch, rows, c, row_stride,
                      batch_stride, blocks_per_batch, eps,
                      static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, c, launch, static_cast<int>(cudaErrorInvalidValue));
}
