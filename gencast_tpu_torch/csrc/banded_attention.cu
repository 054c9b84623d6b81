// Tri-block (banded) flash-attention forward over the RCM-banded mesh.
//
// Replaces the TPU kernel gencast_tpu/ops/banded_attention.py:_fwd_kernel
// (pallas_call in _banded_attention_fwd_impl). Same contract: the N nodes
// form nb blocks of bs rows; each query block j attends jointly to key /
// value blocks j-1, j and j+1 under the uint8 mask blocks
// mask[2][j] (lower), mask[0][j] (diagonal) and mask[1][j] (upper), with one
// softmax over the three. Outputs o in the input dtype and the row
// log-sum-exp in float32. Rows that see no allowed key (the padding nodes,
// any row the mask leaves empty) give o = 0 and lse = +1e30, the reference's
// convention, so its backward's exp(logits - lse) is 0 there.
//
// What bounds it on an H100: arithmetic. Per computed 64 x 64 sub-tile pair
// and head it does 2 * 64 * 64 * d multiply-adds against 2 * 64 * d loaded
// elements. This first version runs both products as float32 FMAs from
// shared memory (no tensor cores), with kernel A's thread layout: a 16 x 16
// grid of threads, each keeping 4 x 4 logits and 4 x (d / 16) output
// columns in registers.
//
// What the design does about the differences from the TPU kernel:
// * The TPU grid is (batch * heads, nb): 16 programs at nano, batch 1. Here
//   each block of bs rows is cut into 64-row query sub-tiles (the last one
//   ragged: 656 = 10 * 64 + 16 at nano, 88 = 64 + 24 at TINY), one CUDA
//   block each, 176 blocks at nano. A block walks the up to three
//   neighbouring key blocks in 64-column sub-tiles with an online softmax;
//   its running max and sum in float32 give the reference's joint
//   three-block softmax. Rows and columns are bounded by the block edge.
// * The reference pads K and V with a zero block on each side and
//   transposes them to [batch * heads, N, d]. Here the kernel reads
//   [batch, N, heads, d] by strides and skips the neighbours that do not
//   exist (block 0's lower, block nb - 1's upper; their mask blocks are all
//   False).
// * A sub-tile pair whose mask sub-tile has no allowed entry is skipped (one
//   __syncthreads_or over the staged mask): at nano only 12.6% of the
//   entries of the three mask blocks are allowed.
// * Matmul operands keep the input dtype's values: bf16 inputs are widened
//   exactly, and the probabilities are rounded to the input dtype before the
//   P.V product, as the reference's e.astype(v.dtype); sums are float32.
#include "common.cuh"

namespace {

constexpr int kSub = 64;        // rows of a query / key sub-tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kRows = kSub / 16;  // query rows per thread
constexpr int kCols = kSub / 16;  // logit columns per thread
constexpr float kNegInf = -1e30f;
constexpr int kPStride = kSub + 1;

template <int D>
struct Layout {
  static constexpr int kStride = D + 1;  // +1: conflict-free column reads
  static constexpr size_t kFloats = 2 * kSub * kStride + kSub * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float) + kSub * kSub;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) banded_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, T* __restrict__ o,
    float* __restrict__ lse, int n, int h, int nb, int bs, float scale) {
  constexpr int kStride = Layout<D>::kStride;
  constexpr int kOutCols = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* kvs = qs + kSub * kStride;
  float* ps = kvs + kSub * kStride;
  uint8_t* ms = reinterpret_cast<uint8_t*>(ps + kSub * kPStride);

  const int subs = (bs + kSub - 1) / kSub;  // sub-tiles per block
  const int qb = blockIdx.x / subs;         // query block
  const int qsub = blockIdx.x % subs;
  const int q0 = qb * bs + qsub * kSub;     // first query node
  const int q_count = min(kSub, bs - qsub * kSub);
  const int bh = blockIdx.y;  // batch * h + head
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t node_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(bh / h) * n * h + bh % h) * D;

  // `count` rows from node `row0` of q, k or v into shared memory as float;
  // the rows of the sub-tile past the block edge read as zeros.
  auto load_rows = [&](const T* src, int row0, int count, float* dst) {
    for (int idx = tid; idx < kSub * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      dst[r * kStride + c] =
          r < count
              ? gt::to_float(src[base + static_cast<size_t>(row0 + r) *
                                            node_stride + c])
              : 0.f;
    }
  };

  load_rows(q, q0, q_count, qs);

  float row_max[kRows], row_sum[kRows], acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    row_max[i] = kNegInf;
    row_sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;
  }

  // Key blocks in order: lower (j - 1, mask part 2), diagonal (j, part 0),
  // upper (j + 1, part 1).
#pragma unroll 1
  for (int shift = -1; shift <= 1; ++shift) {
    const int kb = qb + shift;
    if (kb < 0 || kb >= nb) continue;  // the same for every thread
    const int part = shift < 0 ? 2 : shift;
    const uint8_t* mblock =
        mask + (static_cast<size_t>(part) * nb + qb) * bs * bs;
#pragma unroll 1
    for (int ksub = 0; ksub < subs; ++ksub) {
      const int k0 = kb * bs + ksub * kSub;
      const int k_count = min(kSub, bs - ksub * kSub);
      // Stage the mask sub-tile [query row, key column]; outside the block
      // it is 0. Every thread is past the previous pair's softmax, the last
      // reader of ms.
      int any = 0;
      for (int idx = tid; idx < kSub * kSub; idx += kThreads) {
        const int r = idx / kSub, c = idx % kSub;
        const uint8_t m =
            (r < q_count && c < k_count)
                ? mblock[static_cast<size_t>(qsub * kSub + r) * bs +
                         ksub * kSub + c]
                : 0;
        ms[idx] = m;
        any |= m;
      }
      // Also the barrier after the previous pair's P.V (kvs is free).
      if (!__syncthreads_or(any)) continue;
      load_rows(k, k0, k_count, kvs);
      __syncthreads();

      // Logits for rows ty*kRows + i and columns tx + 16*j.
      float s[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float qv[kRows], kv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * kStride + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) kv[j] = kvs[(tx + 16 * j) * kStride + c];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }

      // Online softmax; the 16 threads of one row group share a half-warp.
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty * kRows + i;
        bool on[kCols];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          on[j] = ms[r * kSub + tx + 16 * j] != 0;
          s[i][j] = on[j] ? s[i][j] * scale : kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float m_new = fmaxf(row_max[i], mx);
        const float alpha = expf(row_max[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          // Explicit select: masked entries add 0 even while the running
          // max is still kNegInf.
          const float pr = on[j] ? expf(s[i][j] - m_new) : 0.f;
          rs += pr;
          ps[r * kPStride + tx + 16 * j] = gt::round_to<T>(pr);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        }
        row_max[i] = m_new;
        row_sum[i] = row_sum[i] * alpha + rs;
#pragma unroll
        for (int j = 0; j < kOutCols; ++j) acc[i][j] *= alpha;
      }

      __syncthreads();  // ps is complete and nobody reads K any more
      load_rows(v, k0, k_count, kvs);
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < kSub; ++kk) {
        float pv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * kPStride + kk];
#pragma unroll
        for (int j = 0; j < kOutCols; ++j) {
          const float vv = kvs[kk * kStride + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= q_count) continue;
    const size_t node = q0 + r;
    // A row that saw an allowed key has a finite running max.
    const bool valid = row_max[i] > 0.5f * kNegInf;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      o[base + node * node_stride + tx + 16 * j] =
          gt::from_float<T>(valid ? acc[i][j] / row_sum[i] : 0.f);
    }
    if (tx == 0) {
      lse[static_cast<size_t>(bh) * n + node] =
          valid ? row_max[i] + logf(row_sum[i]) : -kNegInf;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, float* lse, int batch, int n,
                   int h, int nb, int bs, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      banded_attention_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nb * ((bs + kSub - 1) / kSub), batch * h);
  banded_attention_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, n, h, nb, bs,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int head_dim, const void* q, const void* k,
                       const void* v, const uint8_t* mask, void* o,
                       float* lse, int batch, int n, int h, int nb, int bs,
                       float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:  // TINY
      return launch<T, 32>(q, k, v, mask, o, lse, batch, n, h, nb, bs, scale,
                           stream);
    case 64:  // NANO
      return launch<T, 64>(q, k, v, mask, o, lse, batch, n, h, nb, bs, scale,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [batch, n, h, head_dim] contiguous, float32 or bfloat16,
// head_dim 32 or 64, n = nb * bs; mask: [3, nb, bs, bs] uint8 (diagonal,
// upper, lower); lse: [batch * h, n] float32. Returns a cudaError_t code
// (0 on success).
extern "C" int gt_banded_attention_fwd(int dtype, int head_dim,
                                       const void* q, const void* k,
                                       const void* v, const void* mask,
                                       void* o, void* lse, int batch, int n,
                                       int h, int nb, int bs, float scale,
                                       void* stream) {
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* l = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gt::kFloat32:
      return dispatch_d<float>(head_dim, q, k, v, m, o, l, batch, n, h, nb,
                               bs, scale, s);
    case gt::kBFloat16:
      return dispatch_d<__nv_bfloat16>(head_dim, q, k, v, m, o, l, batch, n,
                                       h, nb, bs, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
