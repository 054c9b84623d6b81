// Block-sparse flash-attention backward over the static tile plan: three
// kernels, dq over the forward plan, dk/dv over the reverse plan (kernel F),
// and the fused sweep that gives dk/dv and every pair's dq partial in one
// pass over the reverse plan (kernel G).
//
// Replaces the TPU kernels gencast_tpu/ops/sparse_attention.py:_dq_kernel
// and :_dkv_kernel (pallas_calls in _sba_bwd), and :_dkvq_kernel (the
// pallas_call in _sba_bwd_fused, the reference's opt-in fused backward).
// Same contract: from the forward's saved row log-sum-exp (lse) and
// delta = rowsum(dO * O) (float32, computed outside, as in the reference),
// recompute each allowed pair's probability w = exp(s * scale - lse) under
// the exact uint8 mask tile, then
//   dp = dO . V^T,   ds = w * (dp - delta),
//   dq = scale * ds . K,   dk = scale * ds^T . Q,   dv = w^T . dO.
// Masked entries, the padded rows of the ragged last tile and rows that
// see no key (their lse is ~-1e30) are zeroed by an explicit select on the
// mask, never by exp underflowing. Sums are float32; w and ds are rounded
// to the input dtype before their products, as the reference's
// ds.astype(k.dtype) and w.astype(do.dtype).
//
// Kernel G writes, for each (kv tile kt, slot a) pair of the reverse plan,
// the unscaled product ds . K of that pair alone, rounded to the input
// dtype (the reference's per-pair dqp tile), into slot kt * num_active + a
// of a [batch, num_kv_tiles * num_active, h, 64, head_dim] buffer; the
// caller sums each q tile's partials in float32 and scales them
// (ops/sparse_attention.py, sparse_attention_dq_reduce). Pad slots are not
// written: the caller's gather never reads them.
//
// What bounds it on an H100: the tile products. Per active (q tile, kv
// tile) pair and head, dq does 3 products of 64 x 64 x d, dk/dv 4 and G 5
// (against F's 7 in all), on every entry of a tile that has an allowed one;
// the other side's tiles are read again for every pair, but from L2 and
// behind the products. G also stores one 64 x d partial tile per pair and
// head.
//
// bf16 F (the training path): every product is an mma.sync m16n8k16 on the
// tensor cores with float32 sums (mma_tile.cuh says why not wgmma). A block
// of four warps owns one tile (q rows in dq, kv rows in dk/dv), a warp 16 of
// its rows, and walks the tile's list with dq, or dk and dv, in registers:
// * Tiles arrive by 16-byte cp.async into rows that ldmatrix reads without
//   bank conflicts, two stages deep: while pair a is computed, the K, V (dq)
//   or Q, dO, lse, delta (dk/dv) and the mask tile of pair a + 1 are in
//   flight, with one barrier per pair.
// * w and ds never touch shared memory: the accumulator fragments of s and
//   dp are turned into w and ds in place, rounded to bf16 and fed as the A
//   operand of dq += ds . K, dv += w^T . dO and dk += ds^T . Q; K, dO and Q
//   are read along their rows by ldmatrix.trans.
// * dk/dv computes the transposed logits K . Q^T, so each lane selects on
//   mask[q, kv] by (column, row) of its fragment: no transposed mask copy.
// * At d = 128 dk/dv holds 128 float32 sums per thread; it takes the q
//   columns of a pair 32 at a time to stay clear of spills.
// * The tile's list (ids and pair ids) is copied to shared memory once; pad
//   slots are skipped.
//
// float32 F (tests, TINY) and G in both dtypes keep the first design: the
// products as float32 FMAs from shared memory, a 16 x 16 grid of threads
// with 4 x 4 logits and 4 x (d/16) output columns each (TF32 would not hold
// float32's tolerance).
//
// What that first design does about the differences from the TPU kernels:
// * One block per (batch * head, tile) walks that tile's list inside the
//   block, in place of the TPU's sequential grid axis; dq, or dk and dv,
//   stay in registers across the list. Pad slots are skipped.
// * Shared memory: tiles are stored in the input dtype (bf16 values are
//   exact there and widened on read), so G's bf16 block (which reuses the
//   ds and K tiles it already holds) takes K, V, Q, dO, the w and ds tiles
//   and the transposed mask in 88 KB: two blocks per SM. The float32
//   variants take twice that and one block per SM.
// * The dk/dv sweep reads the mask tile, indexed [q row, kv col],
//   transposed: it is copied into shared memory as [kv row, q col].
// * G's partial tile is summed four output columns at a time, so its
//   accumulators do not add to the dk/dv ones held across the list.
#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kTile = 64;       // rows per query / key tile (the plan tile)
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kRows = kTile / 16;  // tile rows per thread
constexpr int kCols = kTile / 16;  // tile columns per thread
constexpr int kMaskStride = kTile + 1;

// Row padding of a shared tile of T: one float or two bf16 keep the
// column reads of 16 neighbouring rows on 16 different banks.
template <typename T>
constexpr int pad() { return sizeof(T) == 4 ? 1 : 2; }

template <typename T, int D>
struct Bwd {
  static constexpr int kStride = D + pad<T>();       // [kTile, D] tiles
  static constexpr int kPStride = kTile + pad<T>();  // [kTile, kTile] tiles
  static constexpr size_t kTileBytes = kTile * kStride * sizeof(T);
  static constexpr size_t kPBytes = kTile * kPStride * sizeof(T);
  static constexpr size_t kVecBytes = 2 * kTile * sizeof(float);  // lse, delta
  static constexpr size_t kMaskBytes = kTile * kMaskStride;
  static constexpr size_t kDqBytes =
      4 * kTileBytes + kPBytes + kVecBytes + kMaskBytes;
  static constexpr size_t kDkvBytes =
      4 * kTileBytes + 2 * kPBytes + kVecBytes + kMaskBytes;
};

// [kTile, D] rows of one tile of q, k, v or dO into shared memory (as T);
// rows past n (the ragged last tile) read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          size_t base, size_t node_stride,
                                          int tile, int n, T* dst) {
  constexpr int kStride = Bwd<T, D>::kStride;
  const int row0 = tile * kTile;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int node = row0 + r;
    dst[r * kStride + c] =
        node < n ? src[base + node * node_stride + c] : gt::from_float<T>(0.f);
  }
}

// lse and delta ([batch * h, n] float32) of one tile's rows; 0 past n.
__device__ __forceinline__ void load_rows(const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int bh, int tile, int n,
                                          float* lse_s, float* delta_s) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int node = tile * kTile + r;
    const size_t at = static_cast<size_t>(bh) * n + node;
    lse_s[r] = node < n ? lse[at] : 0.f;
    delta_s[r] = node < n ? delta[at] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) sparse_attention_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ mask_tiles,
    const int* __restrict__ kv_ids, const int* __restrict__ pair_ids,
    T* __restrict__ dq, int n, int h, int num_active, int pad_tile,
    float scale) {
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
  float* delta_s = lse_s + kTile;
  uint8_t* ms = reinterpret_cast<uint8_t*>(delta_s + kTile);

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;  // batch * h + head
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t node_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(bh / h) * n * h + bh % h) * D;

  load_tile<T, D>(q, base, node_stride, qt, n, qs);
  load_tile<T, D>(dout, base, node_stride, qt, n, dos);
  load_rows(lse, delta, bh, qt, n, lse_s, delta_s);

  float acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;

  const int* ids = kv_ids + static_cast<size_t>(qt) * num_active;
  const int* pids = pair_ids + static_cast<size_t>(qt) * num_active;
  for (int a = 0; a < num_active; ++a) {
    const int pid = pids[a];
    if (pid == pad_tile) continue;  // the same for every thread of the block
    const int kt = ids[a];

    __syncthreads();  // the previous pair is done with ks, vs, dss and ms
    load_tile<T, D>(k, base, node_stride, kt, n, ks);
    load_tile<T, D>(v, base, node_stride, kt, n, vs);
    const uint8_t* msrc = mask_tiles + static_cast<size_t>(pid) * kTile * kTile;
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      ms[(idx / kTile) * kMaskStride + idx % kTile] = msrc[idx];
    }
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
        dss[r * kPStride + col] = gt::from_float<T>(w * (dp[i][j] - delta_s[r]));
      }
    }
    __syncthreads();  // dss is complete

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
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

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int node = qt * kTile + ty * kRows + i;
    if (node >= n) continue;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      dq[base + node * node_stride + tx + 16 * j] =
          gt::from_float<T>(acc[i][j] * scale);
    }
  }
}

// The reverse-plan sweep of one block (batch * head, kv tile): dk and dv
// over the tile's q list (kernel F's dk/dv); with kPartial (kernel G) also
// each pair's dq partial into `partial`.
template <typename T, int D, bool kPartial>
__device__ __forceinline__ void reverse_sweep(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ mask_tiles,
    const int* __restrict__ q_ids, const int* __restrict__ pair_ids,
    T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ partial, int n,
    int h, int num_active, int pad_tile, float scale) {
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
  float* delta_s = lse_s + kTile;
  uint8_t* ms = reinterpret_cast<uint8_t*>(delta_s + kTile);

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t node_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(bh / h) * n * h + bh % h) * D;

  load_tile<T, D>(k, base, node_stride, kt, n, ks);
  load_tile<T, D>(v, base, node_stride, kt, n, vs);

  float dk_acc[kRows][kOutCols], dv_acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  const int* ids = q_ids + static_cast<size_t>(kt) * num_active;
  const int* pids = pair_ids + static_cast<size_t>(kt) * num_active;
  for (int a = 0; a < num_active; ++a) {
    const int pid = pids[a];
    if (pid == pad_tile) continue;
    const int qt = ids[a];

    __syncthreads();  // the previous pair is done with qs, dos, ws, dss, ms
    load_tile<T, D>(q, base, node_stride, qt, n, qs);
    load_tile<T, D>(dout, base, node_stride, qt, n, dos);
    load_rows(lse, delta, bh, qt, n, lse_s, delta_s);
    // The mask tile is [q row, kv col]; keep it as [kv row, q col].
    const uint8_t* msrc = mask_tiles + static_cast<size_t>(pid) * kTile * kTile;
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      ms[(idx % kTile) * kMaskStride + idx / kTile] = msrc[idx];
    }
    __syncthreads();

    // Transposed logits for kv rows ty*kRows + i and q columns tx + 16*j,
    // turned into w in place; then dp^T, turned into ds.
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
    for (int qq = 0; qq < kTile; ++qq) {
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

    if constexpr (kPartial) {
      // The pair's dq partial ds . K for q rows ty*kRows + i and columns
      // tx + 16*j: dss holds ds^T, [kv row, q col].
      constexpr int kGroup = kOutCols < 4 ? kOutCols : 4;
      const size_t slot = static_cast<size_t>(kt) * num_active + a;
      T* dst = partial + ((static_cast<size_t>(bh / h) * gridDim.x *
                           num_active + slot) * h + bh % h) * kTile * D;
#pragma unroll
      for (int j0 = 0; j0 < kOutCols; j0 += kGroup) {
        float p[kRows][kGroup];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kGroup; ++j) p[i][j] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < kTile; ++kk) {
          float dsv[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            dsv[i] = gt::to_float(dss[kk * kPStride + ty * kRows + i]);
          }
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const float kvv =
                gt::to_float(ks[kk * kStride + tx + 16 * (j0 + j)]);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              p[i][j] = fmaf(dsv[i], kvv, p[i][j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            dst[(ty * kRows + i) * D + tx + 16 * (j0 + j)] =
                gt::from_float<T>(p[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int node = kt * kTile + ty * kRows + i;
    if (node >= n) continue;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      const size_t at = base + node * node_stride + tx + 16 * j;
      dk[at] = gt::from_float<T>(dk_acc[i][j] * scale);
      dv[at] = gt::from_float<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) sparse_attention_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ mask_tiles,
    const int* __restrict__ q_ids, const int* __restrict__ pair_ids,
    T* __restrict__ dk, T* __restrict__ dv, int n, int h, int num_active,
    int pad_tile, float scale) {
  reverse_sweep<T, D, false>(q, k, v, dout, lse, delta, mask_tiles, q_ids,
                             pair_ids, dk, dv, nullptr, n, h, num_active,
                             pad_tile, scale);
}

// Kernel G.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) sparse_attention_dkvq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ mask_tiles,
    const int* __restrict__ q_ids, const int* __restrict__ pair_ids,
    T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ partial, int n,
    int h, int num_active, int pad_tile, float scale) {
  reverse_sweep<T, D, true>(q, k, v, dout, lse, delta, mask_tiles, q_ids,
                            pair_ids, dk, dv, partial, n, h, num_active,
                            pad_tile, scale);
}

// ---- bf16 kernel F on the tensor cores ----

namespace mma = gt::mma;
using mma::bf16;

// The first slot from `a` on that is not a pad slot; num_active if none.
__device__ __forceinline__ int next_real(const int* pids, int a,
                                         int num_active, int pad_tile) {
  while (a < num_active && pids[a] == pad_tile) ++a;
  return a;
}

// Rows of tile `tile` that lie below n (64, fewer in the ragged last tile).
__device__ __forceinline__ int tile_rows(int tile, int n) {
  return max(0, min(kTile, n - tile * kTile));
}

template <int D>
__global__ void __launch_bounds__(mma::kThreads, 2)
sparse_attention_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ mask_tiles, const int* __restrict__ kv_ids,
    const int* __restrict__ pair_ids, bf16* __restrict__ dq, int n, int h,
    int num_active, int pad_tile, float scale) {
  constexpr int kElems = mma::Tile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kElems;
  bf16* ks = dos + kElems;      // two stages
  bf16* vs = ks + 2 * kElems;   // two stages
  uint8_t* ms = reinterpret_cast<uint8_t*>(vs + 2 * kElems);  // two stages
  int* ids = reinterpret_cast<int*>(ms + 2 * mma::kMaskBytes);
  int* pids = ids + num_active;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;  // batch * h + head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(bh / h) * n * h + bh % h) * D;
  const int q_rows = tile_rows(qt, n);
  if (q_rows == 0) return;  // the whole block: a plan tile past n

  for (int i = threadIdx.x; i < num_active; i += mma::kThreads) {
    ids[i] = kv_ids[static_cast<size_t>(qt) * num_active + i];
    pids[i] = pair_ids[static_cast<size_t>(qt) * num_active + i];
  }
  const size_t q_at = base + static_cast<size_t>(qt) * kTile * row_stride;
  mma::load_tile_async<D>(q + q_at, row_stride, q_rows, qs);
  mma::load_tile_async<D>(dout + q_at, row_stride, q_rows, dos);
  // lse and delta of this lane's two rows; 0 past n.
  const int row = 16 * warp + lane / 4;
  const float* lse_t = lse + static_cast<size_t>(bh) * n + qt * kTile;
  const float* delta_t = delta + static_cast<size_t>(bh) * n + qt * kTile;
  const float lse0 = row < q_rows ? lse_t[row] : 0.f;
  const float lse1 = row + 8 < q_rows ? lse_t[row + 8] : 0.f;
  const float delta0 = row < q_rows ? delta_t[row] : 0.f;
  const float delta1 = row + 8 < q_rows ? delta_t[row + 8] : 0.f;
  __syncthreads();  // the list is in shared memory

  auto start_pair = [&](int a, int stage) {
    const int kt = ids[a];
    const int k_rows = tile_rows(kt, n);
    const int k0 = k_rows > 0 ? kt * kTile : 0;  // a valid address anyway
    const size_t at = base + static_cast<size_t>(k0) * row_stride;
    mma::load_tile_async<D>(k + at, row_stride, k_rows, ks + stage * kElems);
    mma::load_tile_async<D>(v + at, row_stride, k_rows, vs + stage * kElems);
    mma::load_mask_tile_async(
        mask_tiles + static_cast<size_t>(pids[a]) * mma::kMaskBytes,
        ms + stage * mma::kMaskBytes);
  };

  float acc[D / 8][4] = {};
  mma::walk_pairs(
      num_active,
      [&](int a) { return next_real(pids, a, num_active, pad_tile); },
      start_pair, [&](int stage) {
        mma::dq_pair<D>(acc, qs, dos, ks + stage * kElems, vs + stage * kElems,
                        ms + stage * mma::kMaskBytes, lse0, lse1, delta0,
                        delta1, scale, warp, lane);
      });
  mma::store_strip<D>(acc, dq + q_at, row_stride, q_rows, scale, warp, lane);
}

template <int D>
__global__ void __launch_bounds__(mma::kThreads, 2)
sparse_attention_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ mask_tiles, const int* __restrict__ q_ids,
    const int* __restrict__ pair_ids, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int n, int h, int num_active, int pad_tile,
    float scale) {
  constexpr int kElems = mma::Tile<D>::kElems;
  constexpr int kCols = D > 64 ? 32 : kTile;  // q columns in registers at once
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kElems;
  bf16* qs = vs + kElems;       // two stages
  bf16* dos = qs + 2 * kElems;  // two stages
  uint8_t* ms = reinterpret_cast<uint8_t*>(dos + 2 * kElems);  // two stages
  float* vecs = reinterpret_cast<float*>(ms + 2 * mma::kMaskBytes);  // two
  int* ids = reinterpret_cast<int*>(vecs + 4 * kTile);
  int* pids = ids + num_active;

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;  // batch * h + head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(h) * D;
  const size_t base = (static_cast<size_t>(bh / h) * n * h + bh % h) * D;
  const int k_rows = tile_rows(kt, n);
  if (k_rows == 0) return;  // the whole block: a plan tile past n

  for (int i = threadIdx.x; i < num_active; i += mma::kThreads) {
    ids[i] = q_ids[static_cast<size_t>(kt) * num_active + i];
    pids[i] = pair_ids[static_cast<size_t>(kt) * num_active + i];
  }
  const size_t k_at = base + static_cast<size_t>(kt) * kTile * row_stride;
  mma::load_tile_async<D>(k + k_at, row_stride, k_rows, ks);
  mma::load_tile_async<D>(v + k_at, row_stride, k_rows, vs);
  __syncthreads();  // the list is in shared memory

  auto start_pair = [&](int a, int stage) {
    const int qt = ids[a];
    const int q_rows = tile_rows(qt, n);
    const int q0 = q_rows > 0 ? qt * kTile : 0;  // a valid address anyway
    const size_t at = base + static_cast<size_t>(q0) * row_stride;
    mma::load_tile_async<D>(q + at, row_stride, q_rows, qs + stage * kElems);
    mma::load_tile_async<D>(dout + at, row_stride, q_rows,
                            dos + stage * kElems);
    mma::load_vecs_async(lse + static_cast<size_t>(bh) * n + q0,
                         delta + static_cast<size_t>(bh) * n + q0, q_rows,
                         vecs + stage * 2 * kTile);
    mma::load_mask_tile_async(
        mask_tiles + static_cast<size_t>(pids[a]) * mma::kMaskBytes,
        ms + stage * mma::kMaskBytes);
  };

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  mma::walk_pairs(
      num_active,
      [&](int a) { return next_real(pids, a, num_active, pad_tile); },
      start_pair, [&](int stage) {
        mma::dkv_pair<D, kCols>(dk_acc, dv_acc, ks, vs, qs + stage * kElems,
                                dos + stage * kElems,
                                ms + stage * mma::kMaskBytes,
                                vecs + stage * 2 * kTile, scale, warp, lane);
      });
  mma::store_strip<D>(dk_acc, dk + k_at, row_stride, k_rows, scale, warp,
                      lane);
  mma::store_strip<D>(dv_acc, dv + k_at, row_stride, k_rows, 1.f, warp, lane);
}

enum Kind : int { kDq = 0, kDkv = 1, kDkvq = 2 };

template <typename Kernel>
cudaError_t with_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
cudaError_t launch(Kind kind, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const uint8_t* mask_tiles, const int* ids, const int* pids,
                   void* out0, void* out1, void* out2, int batch, int n,
                   int h, int num_tiles, int num_active, int pad_tile,
                   float scale, cudaStream_t stream) {
  const dim3 grid(num_tiles, batch * h);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  T* o0 = static_cast<T*>(out0);
  T* o1 = static_cast<T*>(out1);
  constexpr bool kTensorCores = std::is_same_v<T, __nv_bfloat16>;
  cudaError_t err;
  if (kind == kDkvq) {
    const size_t smem = Bwd<T, D>::kDkvBytes;
    if ((err = with_smem(sparse_attention_dkvq_kernel<T, D>, smem))) {
      return err;
    }
    sparse_attention_dkvq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, mask_tiles, ids, pids, o0, o1,
        static_cast<T*>(out2), n, h, num_active, pad_tile, scale);
  } else if constexpr (kTensorCores) {
    // bf16 F: blocks of four warps, the tile's list behind the stages.
    const size_t lists = 2 * static_cast<size_t>(num_active) * sizeof(int);
    if (kind == kDq) {
      const size_t smem = mma::Staged<D>::kDqBytes + lists;
      if ((err = with_smem(sparse_attention_dq_mma_kernel<D>, smem))) {
        return err;
      }
      sparse_attention_dq_mma_kernel<D><<<grid, mma::kThreads, smem, stream>>>(
          qt, kt, vt, dot, lse, delta, mask_tiles, ids, pids, o0, n, h,
          num_active, pad_tile, scale);
    } else {
      const size_t smem = mma::Staged<D>::kDkvBytes + lists;
      if ((err = with_smem(sparse_attention_dkv_mma_kernel<D>, smem))) {
        return err;
      }
      sparse_attention_dkv_mma_kernel<D>
          <<<grid, mma::kThreads, smem, stream>>>(
              qt, kt, vt, dot, lse, delta, mask_tiles, ids, pids, o0, o1, n,
              h, num_active, pad_tile, scale);
    }
  } else if (kind == kDq) {
    const size_t smem = Bwd<T, D>::kDqBytes;
    if ((err = with_smem(sparse_attention_dq_kernel<T, D>, smem))) return err;
    sparse_attention_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, mask_tiles, ids, pids, o0, n, h,
        num_active, pad_tile, scale);
  } else {
    const size_t smem = Bwd<T, D>::kDkvBytes;
    if ((err = with_smem(sparse_attention_dkv_kernel<T, D>, smem))) return err;
    sparse_attention_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, mask_tiles, ids, pids, o0, o1, n, h,
        num_active, pad_tile, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int head_dim, Kind kind, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* delta, const uint8_t* mask_tiles,
                       const int* ids, const int* pids, void* out0,
                       void* out1, void* out2, int batch, int n, int h,
                       int num_tiles, int num_active, int pad_tile,
                       float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:  // TINY
      return launch<T, 32>(kind, q, k, v, dout, lse, delta, mask_tiles, ids,
                           pids, out0, out1, out2, batch, n, h, num_tiles,
                           num_active, pad_tile, scale, stream);
    case 128:  // ONE_DEG
      return launch<T, 128>(kind, q, k, v, dout, lse, delta, mask_tiles, ids,
                            pids, out0, out1, out2, batch, n, h, num_tiles,
                            num_active, pad_tile, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(Kind kind, int dtype, int head_dim, const void* q, const void* k,
        const void* v, const void* dout, const void* lse, const void* delta,
        const void* mask_tiles, const void* ids, const void* pids,
        void* out0, void* out1, void* out2, int batch, int n, int h,
        int num_tiles, int num_active, int pad_tile, float scale,
        void* stream) {
  const auto* l = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* m = static_cast<const uint8_t*>(mask_tiles);
  const auto* i = static_cast<const int*>(ids);
  const auto* p = static_cast<const int*>(pids);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gt::kFloat32:
      return dispatch_d<float>(head_dim, kind, q, k, v, dout, l, dl, m, i, p,
                               out0, out1, out2, batch, n, h, num_tiles,
                               num_active, pad_tile, scale, s);
    case gt::kBFloat16:
      return dispatch_d<__nv_bfloat16>(head_dim, kind, q, k, v, dout, l, dl,
                                       m, i, p, out0, out1, out2, batch, n, h,
                                       num_tiles, num_active, pad_tile, scale,
                                       s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout, dq: [batch, n, h, head_dim] contiguous, float32 or bfloat16,
// head_dim 32 or 128; lse, delta: [batch * h, n] float32; mask_tiles:
// [pad_tile + 1, 64, 64] uint8; kv_ids, pair_ids: the forward plan
// [num_q_tiles, num_active] int32. Returns a cudaError_t code.
extern "C" int gt_sparse_attention_bwd_dq(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta,
    const void* mask_tiles, const void* kv_ids, const void* pair_ids,
    void* dq, int batch, int n, int h, int num_q_tiles, int num_active,
    int pad_tile, float scale, void* stream) {
  return run(kDq, dtype, head_dim, q, k, v, dout, lse, delta, mask_tiles,
             kv_ids, pair_ids, dq, nullptr, nullptr, batch, n, h,
             num_q_tiles, num_active, pad_tile, scale, stream);
}

// As gt_sparse_attention_bwd_dq, with the reverse plan: q_ids, pair_ids
// [num_kv_tiles, num_active] int32 list, per kv tile, the q tiles that
// touch it. dk, dv: [batch, n, h, head_dim] of the input dtype.
extern "C" int gt_sparse_attention_bwd_dkv(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta,
    const void* mask_tiles, const void* q_ids, const void* pair_ids,
    void* dk, void* dv, int batch, int n, int h, int num_kv_tiles,
    int num_active, int pad_tile, float scale, void* stream) {
  return run(kDkv, dtype, head_dim, q, k, v, dout, lse, delta, mask_tiles,
             q_ids, pair_ids, dk, dv, nullptr, batch, n, h, num_kv_tiles,
             num_active, pad_tile, scale, stream);
}

// Kernel G: as gt_sparse_attention_bwd_dkv, and also partial: [batch,
// num_kv_tiles * num_active, h, 64, head_dim] of the input dtype, slot
// kt * num_active + a holding the dq partial ds . K (unscaled) of reverse
// pair (kt, a); pad slots are left as they were.
extern "C" int gt_sparse_attention_bwd_dkvq(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta,
    const void* mask_tiles, const void* q_ids, const void* pair_ids,
    void* dk, void* dv, void* partial, int batch, int n, int h,
    int num_kv_tiles, int num_active, int pad_tile, float scale,
    void* stream) {
  return run(kDkvq, dtype, head_dim, q, k, v, dout, lse, delta, mask_tiles,
             q_ids, pair_ids, dk, dv, partial, batch, n, h, num_kv_tiles,
             num_active, pad_tile, scale, stream);
}
