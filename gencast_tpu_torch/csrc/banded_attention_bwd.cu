// Tri-block (banded) flash-attention backward: two kernels, dq per query
// sub-tile over its three key blocks, and dk/dv per key sub-tile over its
// three query blocks.
//
// Replaces the TPU kernels gencast_tpu/ops/banded_attention.py:_dq_kernel
// and :_dkv_kernel (pallas_calls in _banded_attention_bwd). Same contract:
// from the forward's saved row log-sum-exp (lse) and
// delta = rowsum(dO * O) (float32, computed outside, as in the reference),
// recompute each allowed entry's probability w = exp(s * scale - lse), then
//   dp = dO . V^T,   ds = w * (dp - delta),
//   dq = scale * ds . K,   dk = scale * ds^T . Q,   dv = w^T . dO.
// Masked entries, the rows and columns of a ragged sub-tile past the block
// edge, and rows that see no key (their lse is +1e30) are zeroed by an
// explicit select on the mask. Sums are float32; w and ds are rounded to the
// input dtype before their products, as the reference's ds.astype(k.dtype)
// and w.astype(do.dtype).
//
// Mask roles. For query block j the key blocks are j - 1 (mask[2][j]), j
// (mask[0][j]) and j + 1 (mask[1][j]). For key block j the query blocks are
// j (mask[0][j]), j + 1 (which sees key block j as its lower neighbour:
// mask[2][j + 1]) and j - 1 (its upper neighbour: mask[1][j - 1]), as the
// reference's _dkv_kernel docstring and index maps say. Read that way the
// mask is [query row, key column].
//
// What bounds it on an H100: not the products (3 of 64 x 64 x d per
// computed sub-tile pair and head in dq, 4 in dk/dv) and not the bytes, but
// the walk of one block: the grid has one block per (batch * head, 64-row
// sub-tile), 176 at nano for 264 block slots, and each walks up to 33
// sub-tile pairs one after another, so a call takes as long as one pair
// times the longest walk.
//
// bf16 D (nano's training path) therefore makes the pair short: every
// product is an mma.sync m16n8k16 on the tensor cores with float32 sums, in
// kernel F's design (mma_tile.cuh, shared with it, says why not wgmma). A
// block of four warps owns one sub-tile, a warp 16 of its rows:
// * Before the walk the block's warps read, 8 bytes at a time, the mask
//   sub-tiles of all its candidate pairs and note which have an allowed
//   entry; only those are loaded and computed, missing neighbours never.
// * Sub-tiles arrive by 16-byte cp.async (the mask by 8 bytes: a block size
//   is a multiple of 8, not of 16), rows and columns past the block edge
//   zero-filled, two stages deep: the next pair's K, V (dq) or Q, dO, lse,
//   delta (dk/dv) and mask are in flight during this pair's products, with
//   one barrier per pair.
// * w and ds stay in registers between the products, and dk/dv selects on
//   mask[query, key] by (column, row) of its transposed logits, with no
//   transposed copy.
//
// float32 D (tests, TINY) keeps the first design: float32 FMAs from shared
// memory with a 16 x 16 grid of threads, 4 x 4 entries and 4 x (d / 16)
// output columns each (TF32 would not hold float32's tolerance), the mask
// sub-tile read first and the pair skipped if it is empty, the dk/dv mask
// staged transposed.
//
// What both designs do about the differences from the TPU kernels:
// * One CUDA block per (batch * head, 64-row sub-tile of a block) in place
//   of the TPU's (batch * head, block) grid, which has 16 programs at nano;
//   the block walks the up to three neighbouring blocks in 64-row sub-tiles,
//   keeping dq, or dk and dv, in registers. No atomics: every output row
//   belongs to one CUDA block.
// * Neighbours that do not exist are skipped, and the kernels read
//   [batch, N, heads, d] by strides: no zero-padded or transposed copies, as
//   the reference's _pad_blocks and [batch * heads, N, d] reshapes made.
// * Sub-tile pairs whose mask sub-tile has no allowed entry are skipped.
// * Tiles are stored in shared memory in the input dtype.
#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kSub = 64;        // rows of a query / key sub-tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kRows = kSub / 16;  // sub-tile rows per thread
constexpr int kCols = kSub / 16;  // sub-tile columns per thread
constexpr int kMaskStride = kSub + 1;

// Row padding of a shared tile of T: one float or two bf16 keep the
// column reads of 16 neighbouring rows on 16 different banks.
template <typename T>
constexpr int pad() { return sizeof(T) == 4 ? 1 : 2; }

template <typename T, int D>
struct Bwd {
  static constexpr int kStride = D + pad<T>();      // [kSub, D] tiles
  static constexpr int kPStride = kSub + pad<T>();  // [kSub, kSub] tiles
  static constexpr size_t kTileBytes = kSub * kStride * sizeof(T);
  static constexpr size_t kPBytes = kSub * kPStride * sizeof(T);
  static constexpr size_t kVecBytes = 2 * kSub * sizeof(float);  // lse, delta
  static constexpr size_t kMaskBytes = kSub * kMaskStride;
  static constexpr size_t kDqBytes =
      4 * kTileBytes + kPBytes + kVecBytes + kMaskBytes;
  static constexpr size_t kDkvBytes =
      4 * kTileBytes + 2 * kPBytes + kVecBytes + kMaskBytes;
};

// `count` rows from node `row0` of q, k, v or dO into shared memory (as T);
// the rows of the sub-tile past the block edge read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          size_t base, size_t node_stride,
                                          int row0, int count, T* dst) {
  constexpr int kStride = Bwd<T, D>::kStride;
  for (int idx = threadIdx.x; idx < kSub * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * kStride + c] =
        r < count ? src[base + static_cast<size_t>(row0 + r) * node_stride + c]
                  : gt::from_float<T>(0.f);
  }
}

// lse and delta ([batch * h, n] float32) of `count` rows from node `row0`;
// 0 past the block edge.
__device__ __forceinline__ void load_vecs(const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int bh, int n, int row0, int count,
                                          float* lse_s, float* delta_s) {
  for (int r = threadIdx.x; r < kSub; r += kThreads) {
    const size_t at = static_cast<size_t>(bh) * n + row0 + r;
    lse_s[r] = r < count ? lse[at] : 0.f;
    delta_s[r] = r < count ? delta[at] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) banded_attention_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ mask,
    T* __restrict__ dq, int n, int h, int nb, int bs, float scale) {
  using L = Bwd<T, D>;
  constexpr int kStride = L::kStride;
  constexpr int kPStride = L::kPStride;
  constexpr int kOutCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + L::kTileBytes);
  T* ks = reinterpret_cast<T*>(smem + 2 * L::kTileBytes);
  T* vs = reinterpret_cast<T*>(smem + 3 * L::kTileBytes);
  T* dss = reinterpret_cast<T*>(smem + 4 * L::kTileBytes);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * L::kTileBytes + L::kPBytes);
  float* delta_s = lse_s + kSub;
  uint8_t* ms = reinterpret_cast<uint8_t*>(delta_s + kSub);

  const int subs = (bs + kSub - 1) / kSub;
  const int qb = blockIdx.x / subs;
  const int qsub = blockIdx.x % subs;
  const int q0 = qb * bs + qsub * kSub;
  const int q_count = min(kSub, bs - qsub * kSub);
  const int bh = blockIdx.y;  // batch * h + head
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t node_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(bh / h) * n * h + bh % h) * D;

  load_rows<T, D>(q, base, node_stride, q0, q_count, qs);
  load_rows<T, D>(dout, base, node_stride, q0, q_count, dos);
  load_vecs(lse, delta, bh, n, q0, q_count, lse_s, delta_s);

  float acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;

  // Key blocks: lower (j - 1, mask part 2), diagonal (j, 0), upper (j + 1, 1).
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
      // Every thread is past the previous pair's w/ds pass, the last reader
      // of ms.
      int any = 0;
      for (int idx = tid; idx < kSub * kSub; idx += kThreads) {
        const int r = idx / kSub, c = idx % kSub;
        const uint8_t m =
            (r < q_count && c < k_count)
                ? mblock[static_cast<size_t>(qsub * kSub + r) * bs +
                         ksub * kSub + c]
                : 0;
        ms[r * kMaskStride + c] = m;
        any |= m;
      }
      // Also the barrier after the previous pair's dq products (ks, vs and
      // dss are free).
      if (!__syncthreads_or(any)) continue;
      load_rows<T, D>(k, base, node_stride, k0, k_count, ks);
      load_rows<T, D>(v, base, node_stride, k0, k_count, vs);
      __syncthreads();

      // Logits s and dp = dO . V^T for rows ty*kRows + i, columns tx + 16*j.
      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = 0.f;
          dp[i][j] = 0.f;
        }
#pragma unroll 2
      for (int c = 0; c < D; ++c) {
        float qv[kRows], dov[kRows], kv[kCols], vv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          qv[i] = gt::to_float(qs[(ty * kRows + i) * kStride + c]);
          dov[i] = gt::to_float(dos[(ty * kRows + i) * kStride + c]);
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          kv[j] = gt::to_float(ks[(tx + 16 * j) * kStride + c]);
          vv[j] = gt::to_float(vs[(tx + 16 * j) * kStride + c]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty * kRows + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = tx + 16 * j;
          const float w = ms[r * kMaskStride + col] != 0
                              ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          dss[r * kPStride + col] =
              gt::from_float<T>(w * (dp[i][j] - delta_s[r]));
        }
      }
      __syncthreads();  // dss is complete

#pragma unroll 4
      for (int kk = 0; kk < kSub; ++kk) {
        float dsv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          dsv[i] = gt::to_float(dss[(ty * kRows + i) * kPStride + kk]);
        }
#pragma unroll
        for (int j = 0; j < kOutCols; ++j) {
          const float kvv = gt::to_float(ks[kk * kStride + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(dsv[i], kvv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= q_count) continue;
    const size_t node = q0 + r;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      dq[base + node * node_stride + tx + 16 * j] =
          gt::from_float<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) banded_attention_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ mask,
    T* __restrict__ dk, T* __restrict__ dv, int n, int h, int nb, int bs,
    float scale) {
  using L = Bwd<T, D>;
  constexpr int kStride = L::kStride;
  constexpr int kPStride = L::kPStride;
  constexpr int kOutCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + L::kTileBytes);
  T* qs = reinterpret_cast<T*>(smem + 2 * L::kTileBytes);
  T* dos = reinterpret_cast<T*>(smem + 3 * L::kTileBytes);
  T* ws = reinterpret_cast<T*>(smem + 4 * L::kTileBytes);
  T* dss = reinterpret_cast<T*>(smem + 4 * L::kTileBytes + L::kPBytes);
  float* lse_s =
      reinterpret_cast<float*>(smem + 4 * L::kTileBytes + 2 * L::kPBytes);
  float* delta_s = lse_s + kSub;
  uint8_t* ms = reinterpret_cast<uint8_t*>(delta_s + kSub);

  const int subs = (bs + kSub - 1) / kSub;
  const int kb = blockIdx.x / subs;  // key block
  const int ksub = blockIdx.x % subs;
  const int k0 = kb * bs + ksub * kSub;
  const int k_count = min(kSub, bs - ksub * kSub);
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t node_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(bh / h) * n * h + bh % h) * D;

  load_rows<T, D>(k, base, node_stride, k0, k_count, ks);
  load_rows<T, D>(v, base, node_stride, k0, k_count, vs);

  float dk_acc[kRows][kOutCols], dv_acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  // Query blocks: j - 1 (mask[1][j - 1]), j (mask[0][j]), j + 1
  // (mask[2][j + 1]).
#pragma unroll 1
  for (int shift = -1; shift <= 1; ++shift) {
    const int qb = kb + shift;
    if (qb < 0 || qb >= nb) continue;  // the same for every thread
    const int part = shift < 0 ? 1 : (shift > 0 ? 2 : 0);
    const uint8_t* mblock =
        mask + (static_cast<size_t>(part) * nb + qb) * bs * bs;
#pragma unroll 1
    for (int qsub = 0; qsub < subs; ++qsub) {
      const int q0 = qb * bs + qsub * kSub;
      const int q_count = min(kSub, bs - qsub * kSub);
      // The mask block is [query row, key column]; keep the sub-tile as
      // [key row, query column]. Every thread is past the previous pair's
      // w/ds pass, the last reader of ms.
      int any = 0;
      for (int idx = tid; idx < kSub * kSub; idx += kThreads) {
        const int qr = idx / kSub, kr = idx % kSub;
        const uint8_t m =
            (qr < q_count && kr < k_count)
                ? mblock[static_cast<size_t>(qsub * kSub + qr) * bs +
                         ksub * kSub + kr]
                : 0;
        ms[kr * kMaskStride + qr] = m;
        any |= m;
      }
      // Also the barrier after the previous pair's dk/dv products (qs, dos,
      // ws, dss and the row vectors are free).
      if (!__syncthreads_or(any)) continue;
      load_rows<T, D>(q, base, node_stride, q0, q_count, qs);
      load_rows<T, D>(dout, base, node_stride, q0, q_count, dos);
      load_vecs(lse, delta, bh, n, q0, q_count, lse_s, delta_s);
      __syncthreads();

      // Transposed logits for key rows ty*kRows + i and query columns
      // tx + 16*j, turned into w in place; then dp^T, turned into ds.
      float w[kRows][kCols], ds[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          w[i][j] = 0.f;
          ds[i][j] = 0.f;
        }
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float kv[kRows], qv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kv[i] = gt::to_float(ks[(ty * kRows + i) * kStride + c]);
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qv[j] = gt::to_float(qs[(tx + 16 * j) * kStride + c]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) w[i][j] = fmaf(kv[i], qv[j], w[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = tx + 16 * j;
          w[i][j] = ms[(ty * kRows + i) * kMaskStride + col] != 0
                        ? expf(w[i][j] * scale - lse_s[col]) : 0.f;
        }
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float vv[kRows], dov[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          vv[i] = gt::to_float(vs[(ty * kRows + i) * kStride + c]);
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          dov[j] = gt::to_float(dos[(tx + 16 * j) * kStride + c]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) ds[i][j] = fmaf(vv[i], dov[j], ds[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty * kRows + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = tx + 16 * j;
          ws[r * kPStride + col] = gt::from_float<T>(w[i][j]);
          dss[r * kPStride + col] =
              gt::from_float<T>(w[i][j] * (ds[i][j] - delta_s[col]));
        }
      }
      __syncthreads();  // ws and dss are complete

#pragma unroll 4
      for (int qq = 0; qq < kSub; ++qq) {
        float wv[kRows], dsv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          wv[i] = gt::to_float(ws[(ty * kRows + i) * kPStride + qq]);
          dsv[i] = gt::to_float(dss[(ty * kRows + i) * kPStride + qq]);
        }
#pragma unroll
        for (int j = 0; j < kOutCols; ++j) {
          const float dov = gt::to_float(dos[qq * kStride + tx + 16 * j]);
          const float qv = gt::to_float(qs[qq * kStride + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            dv_acc[i][j] = fmaf(wv[i], dov, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= k_count) continue;
    const size_t node = k0 + r;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      const size_t at = base + node * node_stride + tx + 16 * j;
      dk[at] = gt::from_float<T>(dk_acc[i][j] * scale);
      dv[at] = gt::from_float<T>(dv_acc[i][j]);
    }
  }
}

// ---- bf16 kernel D on the tensor cores ----

namespace mma = gt::mma;
using mma::bf16;

// The first candidate pair from `c` on whose mask sub-tile has an allowed
// entry; `count` if none.
__device__ __forceinline__ int next_allowed(const uint8_t* flags, int c,
                                            int count) {
  while (c < count && !flags[c]) ++c;
  return c;
}

template <int D>
__global__ void __launch_bounds__(mma::kThreads, 2)
banded_attention_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ mask, bf16* __restrict__ dq, int n, int h,
    int nb, int bs, float scale) {
  constexpr int kElems = mma::Tile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kElems;
  bf16* ks = dos + kElems;      // two stages
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
  mma::load_tile_async<D>(dout + q_at, row_stride, q_count, dos);

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
  // lse and delta of this lane's two rows; 0 past the block edge.
  const int row = 16 * warp + lane / 4;
  const float* lse_t = lse + static_cast<size_t>(bh) * n + q0;
  const float* delta_t = delta + static_cast<size_t>(bh) * n + q0;
  const float lse0 = row < q_count ? lse_t[row] : 0.f;
  const float lse1 = row + 8 < q_count ? lse_t[row + 8] : 0.f;
  const float delta0 = row < q_count ? delta_t[row] : 0.f;
  const float delta1 = row + 8 < q_count ? delta_t[row + 8] : 0.f;
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
  mma::walk_pairs(
      pairs, [&](int c) { return next_allowed(flags, c, pairs); }, start_pair,
      [&](int stage) {
        mma::dq_pair<D>(acc, qs, dos, ks + stage * kElems, vs + stage * kElems,
                        ms + stage * mma::kMaskBytes, lse0, lse1, delta0,
                        delta1, scale, warp, lane);
      });
  mma::store_strip<D>(acc, dq + q_at, row_stride, q_count, scale, warp, lane);
}

template <int D>
__global__ void __launch_bounds__(mma::kThreads, 2)
banded_attention_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ mask, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int n, int h, int nb, int bs, float scale) {
  constexpr int kElems = mma::Tile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kElems;
  bf16* qs = vs + kElems;       // two stages
  bf16* dos = qs + 2 * kElems;  // two stages
  uint8_t* ms = reinterpret_cast<uint8_t*>(dos + 2 * kElems);  // two stages
  float* vecs = reinterpret_cast<float*>(ms + 2 * mma::kMaskBytes);  // two
  uint8_t* flags = reinterpret_cast<uint8_t*>(vecs + 4 * kSub);  // [3 * subs]

  const int subs = (bs + kSub - 1) / kSub;
  const int kb = blockIdx.x / subs;  // key block
  const int ksub = blockIdx.x % subs;
  const int k0 = kb * bs + ksub * kSub;
  const int k_count = min(kSub, bs - ksub * kSub);
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(bh / h) * n * h + bh % h) * D;

  const size_t k_at = base + static_cast<size_t>(k0) * row_stride;
  mma::load_tile_async<D>(k + k_at, row_stride, k_count, ks);
  mma::load_tile_async<D>(v + k_at, row_stride, k_count, vs);

  // Candidate pair c is query sub-tile c % subs of query block
  // kb + c / subs - 1: j - 1 (which sees key block j above it: mask[1][j - 1]),
  // j (mask[0][j]), j + 1 (mask[2][j + 1]). The mask sub-tile of a pair,
  // rows of that query block by columns of key block kb:
  auto mask_sub = [&](int c) {
    const int shift = c / subs - 1;
    const int part = shift < 0 ? 1 : (shift > 0 ? 2 : 0);
    return mask + ((static_cast<size_t>(part) * nb + kb + shift) * bs +
                   (c % subs) * kSub) * bs + ksub * kSub;
  };
  auto q_count_of = [&](int c) { return min(kSub, bs - (c % subs) * kSub); };
  const int pairs = 3 * subs;
  for (int c = warp; c < pairs; c += mma::kWarps) {
    const int qb = kb + c / subs - 1;
    const bool any = qb >= 0 && qb < nb &&
                     mma::mask_sub_any(mask_sub(c), bs, q_count_of(c), k_count,
                                       lane);
    if (lane == 0) flags[c] = any;
  }
  __syncthreads();  // the flags are in shared memory

  auto start_pair = [&](int c, int stage) {
    const int q0 = (kb + c / subs - 1) * bs + (c % subs) * kSub;
    const int q_count = q_count_of(c);
    const size_t at = base + static_cast<size_t>(q0) * row_stride;
    mma::load_tile_async<D>(q + at, row_stride, q_count, qs + stage * kElems);
    mma::load_tile_async<D>(dout + at, row_stride, q_count,
                            dos + stage * kElems);
    mma::load_vecs_async(lse + static_cast<size_t>(bh) * n + q0,
                         delta + static_cast<size_t>(bh) * n + q0, q_count,
                         vecs + stage * 2 * kSub);
    mma::load_mask_sub_async(mask_sub(c), bs, q_count, k_count,
                             ms + stage * mma::kMaskBytes);
  };

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  mma::walk_pairs(
      pairs, [&](int c) { return next_allowed(flags, c, pairs); }, start_pair,
      [&](int stage) {
        mma::dkv_pair<D, kSub>(dk_acc, dv_acc, ks, vs, qs + stage * kElems,
                               dos + stage * kElems,
                               ms + stage * mma::kMaskBytes,
                               vecs + stage * 2 * kSub, scale, warp, lane);
      });
  mma::store_strip<D>(dk_acc, dk + k_at, row_stride, k_count, scale, warp,
                      lane);
  mma::store_strip<D>(dv_acc, dv + k_at, row_stride, k_count, 1.f, warp, lane);
}

template <typename T, int D>
cudaError_t launch(bool dkv, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const uint8_t* mask, void* out0, void* out1, int batch,
                   int n, int h, int nb, int bs, float scale,
                   cudaStream_t stream) {
  const dim3 grid(nb * ((bs + kSub - 1) / kSub), batch * h);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // bf16 D: blocks of four warps, the pairs' flags behind the stages.
    const size_t flags = (3 * ((bs + kSub - 1) / kSub) + 15) / 16 * 16;
    if (dkv) {
      const size_t smem = mma::Staged<D>::kDkvBytes + flags;
      cudaError_t err = cudaFuncSetAttribute(
          banded_attention_dkv_mma_kernel<D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      banded_attention_dkv_mma_kernel<D>
          <<<grid, mma::kThreads, smem, stream>>>(
              qt, kt, vt, dot, lse, delta, mask, static_cast<T*>(out0),
              static_cast<T*>(out1), n, h, nb, bs, scale);
    } else {
      const size_t smem = mma::Staged<D>::kDqBytes + flags;
      cudaError_t err = cudaFuncSetAttribute(
          banded_attention_dq_mma_kernel<D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      banded_attention_dq_mma_kernel<D><<<grid, mma::kThreads, smem, stream>>>(
          qt, kt, vt, dot, lse, delta, mask, static_cast<T*>(out0), n, h, nb,
          bs, scale);
    }
  } else if (dkv) {
    const size_t smem = Bwd<T, D>::kDkvBytes;
    cudaError_t err = cudaFuncSetAttribute(
        banded_attention_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    banded_attention_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, mask, static_cast<T*>(out0),
        static_cast<T*>(out1), n, h, nb, bs, scale);
  } else {
    const size_t smem = Bwd<T, D>::kDqBytes;
    cudaError_t err = cudaFuncSetAttribute(
        banded_attention_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    banded_attention_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, mask, static_cast<T*>(out0), n, h, nb,
        bs, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int head_dim, bool dkv, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* delta, const uint8_t* mask, void* out0,
                       void* out1, int batch, int n, int h, int nb, int bs,
                       float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:  // TINY
      return launch<T, 32>(dkv, q, k, v, dout, lse, delta, mask, out0, out1,
                           batch, n, h, nb, bs, scale, stream);
    case 64:  // NANO
      return launch<T, 64>(dkv, q, k, v, dout, lse, delta, mask, out0, out1,
                           batch, n, h, nb, bs, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(bool dkv, int dtype, int head_dim, const void* q, const void* k,
        const void* v, const void* dout, const void* lse, const void* delta,
        const void* mask, void* out0, void* out1, int batch, int n, int h,
        int nb, int bs, float scale, void* stream) {
  const auto* l = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gt::kFloat32:
      return dispatch_d<float>(head_dim, dkv, q, k, v, dout, l, dl, m, out0,
                               out1, batch, n, h, nb, bs, scale, s);
    case gt::kBFloat16:
      return dispatch_d<__nv_bfloat16>(head_dim, dkv, q, k, v, dout, l, dl, m,
                                       out0, out1, batch, n, h, nb, bs, scale,
                                       s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout, dq: [batch, n, h, head_dim] contiguous, float32 or bfloat16,
// head_dim 32 or 64, n = nb * bs; lse, delta: [batch * h, n] float32; mask:
// [3, nb, bs, bs] uint8 (diagonal, upper, lower). Returns a cudaError_t code.
extern "C" int gt_banded_attention_bwd_dq(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, const void* mask,
    void* dq, int batch, int n, int h, int nb, int bs, float scale,
    void* stream) {
  return run(false, dtype, head_dim, q, k, v, dout, lse, delta, mask, dq,
             nullptr, batch, n, h, nb, bs, scale, stream);
}

// As gt_banded_attention_bwd_dq; dk, dv: [batch, n, h, head_dim] of the
// input dtype.
extern "C" int gt_banded_attention_bwd_dkv(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, const void* mask,
    void* dk, void* dv, int batch, int n, int h, int nb, int bs, float scale,
    void* stream) {
  return run(true, dtype, head_dim, q, k, v, dout, lse, delta, mask, dk, dv,
             batch, n, h, nb, bs, scale, stream);
}
