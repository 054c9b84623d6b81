// Block-sparse flash-attention forward over a static tile plan (kernel A).
//
// Replaces the TPU kernel gencast_tpu/ops/sparse_attention.py:_fwd_kernel
// (pallas_call in _fwd_impl). Same contract: for every query tile, an
// online softmax over the tile's list of active key/value tiles
// (fwd_kv_ids / fwd_pair_ids), each under its exact uint8 mask tile;
// outputs o in the input dtype and the row log-sum-exp in float32. Rows
// that see no allowed key (padding) give o = 0 and lse ~ -1e30: the
// denominator is clamped at 1e-30 as in the reference.
//
// What bounds it on an H100: the two tile products. Per active (q tile, kv
// tile) pair and head it does 2 * 64 * 64 * d multiply-adds against
// 2 * 64 * d loaded elements, on every entry of a tile that has an allowed
// one, and the plan keeps only such tiles, so the mask costs no bytes for
// skipped tiles. K and V tiles are read again for every pair, but from L2
// and behind the products.
//
// bf16 (serving and training): both products are mma.sync m16n8k16 on the
// tensor cores with float32 sums (mma_tile.cuh says why not wgmma). A block
// of four warps owns one query tile, a warp 16 of its rows, and walks the
// tile's list with o, the running row maximum and the denominator in
// registers (mma::fwd_pair, shared with the tri-block kernel C):
// * Q is copied to shared memory once; K, V and the mask tile of pair a + 1
//   arrive by 16-byte cp.async, two stages deep, while pair a is computed,
//   with one barrier per pair: 93 KB at d = 128, two blocks per SM.
// * The softmax runs on the accumulator fragments of q . k^T: row maximum
//   and row sum across the four lanes of a quad by shuffles, the mask by a
//   select on its bit. p never touches shared memory: rounded to bf16 it is
//   the A operand of o += p . v, with V read along its rows by
//   ldmatrix.trans.
// * The tile's list (ids and pair ids) is copied to shared memory once; pad
//   slots are skipped outright, where the TPU had to stream them.
//
// float32 (tests, TINY) keeps the first design: the products as float32 FMAs
// from shared memory, a 16 x 16 grid of threads with 4 x 4 logits and
// 4 x (d/16) output columns each (TF32 would not hold float32's tolerance);
// K and V share one shared-memory buffer, and the probabilities pass through
// a shared tile between the products.
//
// In both, one block per (batch * head, q tile) and a loop over the active
// list inside the block replace the sequential grid axis the TPU carried
// its accumulators across. Matmul operands keep the input dtype: the
// probabilities are rounded to it before the P.V product, as the
// reference's p.astype(v.dtype), the row sum takes them unrounded, and sums
// are float32.
#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

namespace mma = gt::mma;
using mma::bf16;
using mma::kNegInf;

constexpr int kTile = 64;       // rows per query / key tile (the plan tile)
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kRows = kTile / 16;  // query rows per thread
constexpr int kCols = kTile / 16;  // logit columns per thread
constexpr int kPStride = kTile + 1;

template <int D>
struct Layout {
  static constexpr int kStride = D + 1;  // +1: conflict-free column reads
  static constexpr size_t kFloats = 2 * kTile * kStride + kTile * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float) + kTile * kTile;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2) sparse_attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ mask_tiles,
    const int* __restrict__ kv_ids, const int* __restrict__ pair_ids,
    float* __restrict__ o, float* __restrict__ lse, int n, int h,
    int num_active, int pad_tile, float scale) {
  constexpr int kStride = Layout<D>::kStride;
  constexpr int kOutCols = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* kvs = qs + kTile * kStride;
  float* ps = kvs + kTile * kStride;
  uint8_t* ms = reinterpret_cast<uint8_t*>(ps + kTile * kPStride);

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;  // batch * h + head
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t node_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(bh / h) * n * h + bh % h) * D;

  // [kTile, D] rows of one tile of q, k or v into shared memory; rows past n
  // (the ragged last tile) read as zeros.
  auto load_tile = [&](const float* src, int tile, float* dst) {
    const int row0 = tile * kTile;
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int node = row0 + r;
      dst[r * kStride + c] =
          node < n ? src[base + node * node_stride + c] : 0.f;
    }
  };

  load_tile(q, qt, qs);

  float row_max[kRows], row_sum[kRows], acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    row_max[i] = kNegInf;
    row_sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;
  }

  const int* ids = kv_ids + static_cast<size_t>(qt) * num_active;
  const int* pids = pair_ids + static_cast<size_t>(qt) * num_active;
  for (int a = 0; a < num_active; ++a) {
    const int pid = pids[a];
    if (pid == pad_tile) continue;  // the same for every thread of the block
    const int kt = ids[a];

    __syncthreads();  // the previous pair is done with kvs and ps
    load_tile(k, kt, kvs);
    const uint32_t* msrc = reinterpret_cast<const uint32_t*>(
        mask_tiles + static_cast<size_t>(pid) * kTile * kTile);
    uint32_t* mdst = reinterpret_cast<uint32_t*>(ms);
    for (int idx = tid; idx < kTile * kTile / 4; idx += kThreads) {
      mdst[idx] = msrc[idx];
    }
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
        on[j] = ms[r * kTile + tx + 16 * j] != 0;
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
        // Explicit select: fully masked tiles add 0 even while the running
        // max is still kNegInf.
        const float p = on[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        ps[r * kPStride + tx + 16 * j] = p;
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
    load_tile(v, kt, kvs);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
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

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int node = qt * kTile + ty * kRows + i;
    if (node >= n) continue;
    const float denom = fmaxf(row_sum[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      o[base + node * node_stride + tx + 16 * j] = acc[i][j] / denom;
    }
    if (tx == 0) lse[static_cast<size_t>(bh) * n + node] = row_max[i] + logf(denom);
  }
}

// ---- bf16 kernel A on the tensor cores ----

template <int D>
__global__ void __launch_bounds__(mma::kThreads, 2)
sparse_attention_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint8_t* __restrict__ mask_tiles,
    const int* __restrict__ kv_ids, const int* __restrict__ pair_ids,
    bf16* __restrict__ o, float* __restrict__ lse, int n, int h,
    int num_active, int pad_tile, float scale) {
  constexpr int kElems = mma::Tile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kElems;       // two stages
  bf16* vs = ks + 2 * kElems;   // two stages
  uint8_t* ms = reinterpret_cast<uint8_t*>(vs + 2 * kElems);  // two stages
  int* ids = reinterpret_cast<int*>(ms + 2 * mma::kMaskBytes);
  int* pids = ids + num_active;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;  // batch * h + head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(bh / h) * n * h + bh % h) * D;
  const int q_rows = mma::tile_rows(qt, n);
  if (q_rows == 0) return;  // the whole block: a plan tile past n

  for (int i = threadIdx.x; i < num_active; i += mma::kThreads) {
    ids[i] = kv_ids[static_cast<size_t>(qt) * num_active + i];
    pids[i] = pair_ids[static_cast<size_t>(qt) * num_active + i];
  }
  const size_t q_at = base + static_cast<size_t>(qt) * kTile * row_stride;
  mma::load_tile_async<D>(q + q_at, row_stride, q_rows, qs);
  __syncthreads();  // the list is in shared memory

  auto start_pair = [&](int a, int stage) {
    const int kt = ids[a];
    const int k_rows = mma::tile_rows(kt, n);
    const int k0 = k_rows > 0 ? kt * kTile : 0;  // a valid address anyway
    const size_t at = base + static_cast<size_t>(k0) * row_stride;
    mma::load_tile_async<D>(k + at, row_stride, k_rows, ks + stage * kElems);
    mma::load_tile_async<D>(v + at, row_stride, k_rows, vs + stage * kElems);
    mma::load_mask_tile_async(
        mask_tiles + static_cast<size_t>(pids[a]) * mma::kMaskBytes,
        ms + stage * mma::kMaskBytes);
  };

  float acc[D / 8][4] = {};
  float row_max[2] = {kNegInf, kNegInf}, row_sum[2] = {0.f, 0.f};
  mma::walk_pairs(
      num_active,
      [&](int a) { return mma::next_real(pids, a, num_active, pad_tile); },
      start_pair, [&](int stage) {
        mma::fwd_pair<D>(acc, row_max, row_sum, qs, ks + stage * kElems,
                         vs + stage * kElems, ms + stage * mma::kMaskBytes,
                         scale, warp, lane);
      });

  // A row without a key has sum 0 and maximum kNegInf: o = 0, lse ~ -1e30.
  const float denom0 = fmaxf(row_sum[0], 1e-30f);
  const float denom1 = fmaxf(row_sum[1], 1e-30f);
  mma::store_strip<D>(acc, o + q_at, row_stride, q_rows, 1.f / denom0,
                      1.f / denom1, warp, lane);
  mma::store_rows(row_max[0] + logf(denom0), row_max[1] + logf(denom1),
                  lse + static_cast<size_t>(bh) * n + qt * kTile, q_rows, warp,
                  lane);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask_tiles, const int* kv_ids,
                   const int* pair_ids, void* o, float* lse, int batch, int n,
                   int h, int num_q_tiles, int num_active, int pad_tile,
                   float scale, cudaStream_t stream) {
  const dim3 grid(num_q_tiles, batch * h);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // bf16: blocks of four warps, the tile's list behind the stages.
    const size_t smem = mma::Staged<D>::kFwdBytes +
                        2 * static_cast<size_t>(num_active) * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        sparse_attention_fwd_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    sparse_attention_fwd_mma_kernel<D><<<grid, mma::kThreads, smem, stream>>>(
        qt, kt, vt, mask_tiles, kv_ids, pair_ids, static_cast<T*>(o), lse, n,
        h, num_active, pad_tile, scale);
  } else {
    const size_t smem = Layout<D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        sparse_attention_fwd_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    sparse_attention_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, mask_tiles, kv_ids, pair_ids, static_cast<T*>(o), lse, n,
        h, num_active, pad_tile, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int head_dim, const void* q, const void* k,
                       const void* v, const uint8_t* mask_tiles,
                       const int* kv_ids, const int* pair_ids, void* o,
                       float* lse, int batch, int n, int h, int num_q_tiles,
                       int num_active, int pad_tile, float scale,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 32:  // TINY
      return launch<T, 32>(q, k, v, mask_tiles, kv_ids, pair_ids, o, lse,
                           batch, n, h, num_q_tiles, num_active, pad_tile,
                           scale, stream);
    case 128:  // ONE_DEG
      return launch<T, 128>(q, k, v, mask_tiles, kv_ids, pair_ids, o, lse,
                            batch, n, h, num_q_tiles, num_active, pad_tile,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [batch, n, h, head_dim] contiguous, float32 or bfloat16,
// head_dim 32 or 128;
// mask_tiles: [pad_tile + 1, 64, 64] uint8; kv_ids, pair_ids:
// [num_q_tiles, num_active] int32; lse: [batch * h, n] float32.
// Returns a cudaError_t code (0 on success).
extern "C" int gt_sparse_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* mask_tiles, const void* kv_ids, const void* pair_ids,
    void* o, void* lse, int batch, int n, int h, int num_q_tiles,
    int num_active, int pad_tile, float scale, void* stream) {
  const auto* m = static_cast<const uint8_t*>(mask_tiles);
  const auto* ids = static_cast<const int*>(kv_ids);
  const auto* pids = static_cast<const int*>(pair_ids);
  auto* l = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gt::kFloat32:
      return dispatch_d<float>(head_dim, q, k, v, m, ids, pids, o, l, batch,
                               n, h, num_q_tiles, num_active, pad_tile,
                               scale, s);
    case gt::kBFloat16:
      return dispatch_d<__nv_bfloat16>(head_dim, q, k, v, m, ids, pids, o, l,
                                       batch, n, h, num_q_tiles, num_active,
                                       pad_tile, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int gt_sparse_attention_tile() { return kTile; }
