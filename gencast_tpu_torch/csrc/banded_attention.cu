// Tri-block (banded) flash-attention forward over the RCM-banded mesh
// (kernel C).
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
// What bounds it on an H100: at nano's size, the serial walk of a block.
// Each block of bs rows is cut into 64-row query sub-tiles (the last one
// ragged: 656 = 10 * 64 + 16 at nano, 88 = 64 + 24 at TINY), one CUDA block
// each: 176 blocks at nano, batch 1, on 132 SMs, each walking the up to
// 3 * 11 key sub-tiles of its three neighbouring blocks. Per computed
// 64 x 64 sub-tile pair and head a block does 2 * 64 * 64 * d multiply-adds
// against 2 * 64 * d loaded elements; only 12.6% of the entries of nano's
// mask blocks are allowed, and a pair whose mask sub-tile has no allowed
// entry is skipped.
//
// bf16 (serving and training): both products are mma.sync m16n8k16 on the
// tensor cores with float32 sums (mma_tile.cuh says why not wgmma), four
// warps a block, a warp 16 query rows, the per-pair step mma::fwd_pair shared
// with the block-sparse kernel A: the softmax on the accumulator fragments,
// p kept in registers as the next product's A operand.
// * The warps first flag the candidate pairs whose mask sub-tile holds an
//   allowed entry (read 8 bytes at a time); only those are copied and
//   computed, K, V and the mask sub-tile of the following pair arriving by
//   cp.async while a pair is computed, one barrier per pair.
// * Rows and columns are bounded by the block edge: the ragged sub-tiles are
//   zero-filled on load and their mask is 0. The mask's rows are bs bytes
//   apart, so bs must be a multiple of 8 (the wrapper checks).
//
// float32 (tests, TINY) keeps the first design: both products as float32
// FMAs from shared memory (TF32 would not hold float32's tolerance), a
// 16 x 16 grid of threads, each keeping 4 x 4 logits and 4 x (d / 16) output
// columns in registers; every candidate mask sub-tile is staged and a pair
// without an allowed entry skipped by one __syncthreads_or.
//
// What both do about the differences from the TPU kernel:
// * The TPU grid is (batch * heads, nb): 16 programs at nano. Here a block's
//   running max and sum in float32 over the sub-tiles it walks (lower,
//   diagonal, upper) give the reference's joint three-block softmax.
// * The reference pads K and V with a zero block on each side and
//   transposes them to [batch * heads, N, d]. Here the kernels read
//   [batch, N, heads, d] by strides and skip the neighbours that do not
//   exist (block 0's lower, block nb - 1's upper; their mask blocks are all
//   False).
// * Matmul operands keep the input dtype: the probabilities are rounded to
//   it before the P.V product, as the reference's e.astype(v.dtype), the row
//   sum takes them unrounded, and sums are float32.
#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

namespace mma = gt::mma;
using mma::bf16;
using mma::kNegInf;

constexpr int kSub = 64;        // rows of a query / key sub-tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kRows = kSub / 16;  // query rows per thread
constexpr int kCols = kSub / 16;  // logit columns per thread
constexpr int kPStride = kSub + 1;

template <int D>
struct Layout {
  static constexpr int kStride = D + 1;  // +1: conflict-free column reads
  static constexpr size_t kFloats = 2 * kSub * kStride + kSub * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float) + kSub * kSub;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2) banded_attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ mask,
    float* __restrict__ o, float* __restrict__ lse, int n, int h, int nb,
    int bs, float scale) {
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

  // `count` rows from node `row0` of q, k or v into shared memory; the rows
  // of the sub-tile past the block edge read as zeros.
  auto load_rows = [&](const float* src, int row0, int count, float* dst) {
    for (int idx = tid; idx < kSub * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      dst[r * kStride + c] =
          r < count
              ? src[base + static_cast<size_t>(row0 + r) * node_stride + c]
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
          ps[r * kPStride + tx + 16 * j] = pr;
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
          valid ? acc[i][j] / row_sum[i] : 0.f;
    }
    if (tx == 0) {
      lse[static_cast<size_t>(bh) * n + node] =
          valid ? row_max[i] + logf(row_sum[i]) : -kNegInf;
    }
  }
}

// ---- bf16 kernel C on the tensor cores ----

template <int D>
__global__ void __launch_bounds__(mma::kThreads, 2)
banded_attention_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
    bf16* __restrict__ o, float* __restrict__ lse, int n, int h, int nb,
    int bs, float scale) {
  constexpr int kElems = mma::Tile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kElems;       // two stages
  bf16* vs = ks + 2 * kElems;   // two stages
  uint8_t* ms = reinterpret_cast<uint8_t*>(vs + 2 * kElems);  // two stages
  uint8_t* flags = ms + 2 * mma::kMaskBytes;  // [3 * subs]

  const int subs = (bs + kSub - 1) / kSub;
  const int qb = blockIdx.x / subs;
  const int qsub = blockIdx.x % subs;
  const int q0 = qb * bs + qsub * kSub;
  const int q_count = min(kSub, bs - qsub * kSub);
  const int bh = blockIdx.y;  // batch * h + head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(bh / h) * n * h + bh % h) * D;

  const size_t q_at = base + static_cast<size_t>(q0) * row_stride;
  mma::load_tile_async<D>(q + q_at, row_stride, q_count, qs);

  // Candidate pair c is key sub-tile c % subs of key block qb + c / subs - 1:
  // lower (mask part 2), diagonal (0), upper (1). The mask sub-tile of a
  // pair, rows of query block qb by columns of that key block:
  auto mask_sub = [&](int c) {
    const int shift = c / subs - 1;
    const int part = shift < 0 ? 2 : shift;
    return mask + ((static_cast<size_t>(part) * nb + qb) * bs + qsub * kSub) *
                      bs + (c % subs) * kSub;
  };
  auto k_count_of = [&](int c) { return min(kSub, bs - (c % subs) * kSub); };
  const int pairs = 3 * subs;
  for (int c = warp; c < pairs; c += mma::kWarps) {
    const int kb = qb + c / subs - 1;
    const bool any = kb >= 0 && kb < nb &&
                     mma::mask_sub_any(mask_sub(c), bs, q_count, k_count_of(c),
                                       lane);
    if (lane == 0) flags[c] = any;
  }
  __syncthreads();  // the flags are in shared memory

  auto start_pair = [&](int c, int stage) {
    const int k0 = (qb + c / subs - 1) * bs + (c % subs) * kSub;
    const int k_count = k_count_of(c);
    const size_t at = base + static_cast<size_t>(k0) * row_stride;
    mma::load_tile_async<D>(k + at, row_stride, k_count, ks + stage * kElems);
    mma::load_tile_async<D>(v + at, row_stride, k_count, vs + stage * kElems);
    mma::load_mask_sub_async(mask_sub(c), bs, q_count, k_count,
                             ms + stage * mma::kMaskBytes);
  };

  float acc[D / 8][4] = {};
  float row_max[2] = {kNegInf, kNegInf}, row_sum[2] = {0.f, 0.f};
  mma::walk_pairs(
      pairs, [&](int c) { return mma::next_flagged(flags, c, pairs); },
      start_pair, [&](int stage) {
        mma::fwd_pair<D>(acc, row_max, row_sum, qs, ks + stage * kElems,
                         vs + stage * kElems, ms + stage * mma::kMaskBytes,
                         scale, warp, lane);
      });

  // A row that saw an allowed key has a finite running max; the others give
  // o = 0 and lse = +1e30 exactly.
  const bool valid0 = row_max[0] > 0.5f * kNegInf;
  const bool valid1 = row_max[1] > 0.5f * kNegInf;
  mma::store_strip<D>(acc, o + q_at, row_stride, q_count,
                      valid0 ? 1.f / row_sum[0] : 0.f,
                      valid1 ? 1.f / row_sum[1] : 0.f, warp, lane);
  mma::store_rows(valid0 ? row_max[0] + logf(row_sum[0]) : -kNegInf,
                  valid1 ? row_max[1] + logf(row_sum[1]) : -kNegInf,
                  lse + static_cast<size_t>(bh) * n + q0, q_count, warp, lane);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, float* lse, int batch, int n,
                   int h, int nb, int bs, float scale, cudaStream_t stream) {
  const int subs = (bs + kSub - 1) / kSub;
  const dim3 grid(nb * subs, batch * h);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // bf16: blocks of four warps, the pairs' flags behind the stages.
    const size_t smem = mma::Staged<D>::kFwdBytes + (3 * subs + 15) / 16 * 16;
    cudaError_t err = cudaFuncSetAttribute(
        banded_attention_fwd_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    banded_attention_fwd_mma_kernel<D><<<grid, mma::kThreads, smem, stream>>>(
        qt, kt, vt, mask, static_cast<T*>(o), lse, n, h, nb, bs, scale);
  } else {
    const size_t smem = Layout<D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        banded_attention_fwd_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    banded_attention_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, mask, static_cast<T*>(o), lse, n, h, nb, bs, scale);
  }
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
