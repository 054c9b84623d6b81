// Tensor-core building blocks of the bf16 attention kernels: the forwards
// (the block-sparse kernel A, sparse_attention.cu, and the tri-block kernel
// C, banded_attention.cu) and the backwards (the tri-block kernel D,
// banded_attention_bwd.cu, and the block-sparse kernels F and G,
// sparse_attention_bwd.cu). Here are the asynchronous 16-byte tile copies
// into shared memory, the ldmatrix fragment loads, the m16n8k16 bf16 product
// with float32 sums, the two-stage walk over a block's pair list
// (walk_pairs), and the per-pair routines the kernels run on a 64 x 64 tile
// pair: fwd_pair (A and C), dq_pair and dkv_pair (D, F and G) and
// dq_partial (G's fifth product).
//
// Numerics: sums are float32; p, w and ds are rounded to bf16 where the plain
// version casts them. The exponentials (the backward's
// w = exp(s * scale - lse), the forward's p = exp(s * scale - row max) and
// its rescaling factor) use the fast intrinsic __expf (ex2.approx after a
// multiply), whose error CUDA bounds by 2 + floor(|1.4427 x|) float32 ulp.
// Allowed entries have x <= 0 up to rounding, and for x >= -20 (a value
// >= 2e-9) that is at most 30 ulp, 1.8e-6 relative: a thousandth of the bf16
// rounding that follows (2^-9 relative). The float32 kernels (FMA products)
// keep expf.
//
// Route: mma.sync with cp.async, not wgmma with TMA. The tiles are 64 x 64,
// the pair lists are irregular (a plan's list, or the sub-tiles of three
// neighbouring blocks with empty ones skipped), the products of a probability
// tile with V, K, dO or Q read that operand along its other axis
// (ldmatrix.trans gives that from the row-major tile, where wgmma needs a
// descriptor per major-ness), and p, w and ds must stay in registers between
// products (only G's partial reads ds back, transposed, from shared memory):
// the float32 accumulator fragment of m16n8 has the layout of the A
// operand of m16n8k16, so a warp feeds its 16-row strip of p, w or ds,
// rounded to bf16, straight into the next product.
//
// A block has four warps; warp i owns rows 16 i .. 16 i + 15 of the block's
// resident tile (query rows in the forward and dq, key rows in dk/dv). Within
// a warp, lane
// l holds of every 16 x 8 accumulator tile the entries (row l / 4, columns
// 2 (l % 4) and + 1) and the same of row l / 4 + 8.
#pragma once

#include "common.cuh"

namespace gt {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;     // rows of a tile, and columns of a tile pair
constexpr int kWarps = 4;     // one 16-row strip each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaskBytes = kTile * kTile;  // a staged uint8 mask tile
constexpr int kVecBytes = 2 * kTile * sizeof(float);  // staged lse and delta
// The running row maximum before a row has seen an allowed key: finite, so
// that differences of two of them are 0 and never NaN.
constexpr float kNegInf = -1e30f;
static_assert(kThreads == 2 * kTile, "load_vecs_async copies one entry each");

// A [kTile, D] bf16 tile in shared memory: rows D + 8 elements apart, so
// every row starts on a 16-byte boundary and the eight rows of one ldmatrix
// 8 x 8 block fall into eight different 16-byte bank groups.
template <int D>
struct Tile {
  static constexpr int kStride = D + 8;
  static constexpr int kElems = kTile * kStride;
  static constexpr size_t kBytes = kElems * sizeof(bf16);
};

// Shared memory of a block, two stages deep. Forward: q resident, then per
// stage k, v and the mask tile. dq: q and dO resident, then the same stages.
// dk/dv: k and v resident, then per stage q, dO, the mask tile, lse and
// delta; G as dk/dv. At D = 128 that is 93.0, 110.0 and 111.0 KB: two blocks
// fit into an SM's 227 KB.
// Kernel G's transposed ds tile of a pair, [kTile key rows, kTile query
// columns] bf16, which dkv_pair writes for dq_partial: two blocks of
// kDsCols query columns, rows kDsStride elements (80 bytes) apart, so that
// the eight rows of an ldmatrix 8 x 8 block fall into eight different
// 16-byte bank groups. Where a block fits into the 32 query rows of the
// staged q tile that the pass writing it has finished with (D = 128), block
// h lies over rows 32 h .. of that tile and costs no shared memory;
// otherwise (D = 32) both blocks lie in a buffer of their own.
constexpr int kDsCols = 32;
constexpr int kDsStride = kDsCols + 8;
template <int D>
struct DsT {
  static constexpr int kOwnBlock = kTile * kDsStride;
  static constexpr bool kInQ = kDsCols * Tile<D>::kStride >= kOwnBlock;
  static constexpr int kBlockElems = kInQ ? kDsCols * Tile<D>::kStride
                                          : kOwnBlock;
  static constexpr size_t kOwnBytes =
      kInQ ? 0 : 2 * kOwnBlock * sizeof(bf16);
};

template <int D>
struct Staged {
  static constexpr size_t kFwdBytes = 5 * Tile<D>::kBytes + 2 * kMaskBytes;
  static constexpr size_t kDqBytes = 6 * Tile<D>::kBytes + 2 * kMaskBytes;
  static constexpr size_t kDkvBytes = kDqBytes + 2 * kVecBytes;
  // G: dk/dv's stages and, at D = 32, the ds tile's own buffer.
  static constexpr size_t kDkvqBytes = kDkvBytes + DsT<D>::kOwnBytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies global -> shared of 16, 8 or 4 bytes; `bytes` of them
// are read (all or none here) and the rest of the destination is zeroed.
// The source address must be valid even when nothing is read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most kPending of this thread's committed groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Walks a block's list of `count` tile pairs two stages deep, one barrier
// per pair. next(i) is the first pair from i on that has work (count if
// none), start(i, stage) starts the copies of pair i's tiles into `stage`,
// and compute(stage) runs the products on the tiles of `stage`. Copies the
// block started before the walk (its resident tiles) arrive with the first
// pair's; none is in flight when the walk returns.
template <typename Next, typename Start, typename Compute>
__device__ __forceinline__ void walk_pairs(int count, Next next, Start start,
                                           Compute compute) {
  int i = next(0);
  if (i < count) start(i, 0);
  cp_async_commit();
  for (int stage = 0; i < count; stage ^= 1) {
    // This pair's tiles have arrived, and every warp is done with the other
    // stage, which the following pair's copies now fill during the products.
    cp_async_wait<0>();
    __syncthreads();
    const int following = next(i + 1);
    if (following < count) start(following, stage ^ 1);
    cp_async_commit();
    compute(stage);
    i = following;
  }
  cp_async_wait<0>();
}

// The first slot from `a` on of a plan list that is not a pad slot;
// num_active if none.
__device__ __forceinline__ int next_real(const int* pids, int a,
                                         int num_active, int pad_tile) {
  while (a < num_active && pids[a] == pad_tile) ++a;
  return a;
}

// The first candidate pair from `c` on whose flag is set; `count` if none.
__device__ __forceinline__ int next_flagged(const uint8_t* flags, int c,
                                            int count) {
  while (c < count && !flags[c]) ++c;
  return c;
}

// Rows of tile `tile` that lie below n (64, fewer in the ragged last tile,
// 0 for a plan tile past n).
__device__ __forceinline__ int tile_rows(int tile, int n) {
  return max(0, min(kTile, n - tile * kTile));
}

// Starts the copy of rows 0 .. rows - 1 of a [kTile, D] tile (`src` is its
// first row, rows `row_stride` elements apart: [batch, n, h, D] read by
// strides) into `dst`; rows from `rows` on (the ragged edge) are zeroed.
template <int D>
__device__ __forceinline__ void load_tile_async(const bf16* __restrict__ src,
                                                size_t row_stride, int rows,
                                                bf16* dst) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r < rows;
    cp_async_16(dst + r * Tile<D>::kStride + c * 8,
                src + (ok ? r : 0) * row_stride + c * 8, ok ? 16 : 0);
  }
}

// Starts the copy of `rows` float32 entries of lse and of delta (from
// `lse`, `delta`, each the first entry) into vec[0 .. 63] and
// vec[64 .. 127]; entries from `rows` on are zeroed. Four bytes at a time:
// a row of [batch * h, n] starts on a 16-byte boundary only when n % 4 == 0.
__device__ __forceinline__ void load_vecs_async(const float* __restrict__ lse,
                                                const float* __restrict__ delta,
                                                int rows, float* vec) {
  const int r = threadIdx.x % kTile;
  const float* src = threadIdx.x < kTile ? lse : delta;
  const bool ok = r < rows;
  cp_async_4(vec + threadIdx.x, src + (ok ? r : 0), ok ? 4 : 0);
}

// Byte offset of mask entry [row, col] in a staged 64 x 64 mask tile. The
// four 16-byte chunks of a row are permuted by the row, so that the eight
// rows a warp reads at once (dq) and the four rows it reads at once (dk/dv,
// which indexes the [query row, key column] tile by (column, row) of its
// transposed logits) fall into different banks.
__device__ __forceinline__ int mask_offset(int row, int col) {
  return row * kTile + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

// Starts the copy of a contiguous [64, 64] uint8 mask tile, 16 bytes at a
// time.
__device__ __forceinline__ void load_mask_tile_async(
    const uint8_t* __restrict__ src, uint8_t* dst) {
  for (int idx = threadIdx.x; idx < kTile * 4; idx += kThreads) {
    const int r = idx / 4, c = idx % 4;
    cp_async_16(dst + mask_offset(r, 16 * c), src + r * kTile + 16 * c, 16);
  }
}

// Starts the copy of the `rows` x `cols` corner of a 64 x 64 sub-tile of a
// mask block whose rows are `pitch` bytes apart, 8 bytes at a time (pitch
// and cols are multiples of 8, not always of 16); the rest is zeroed.
__device__ __forceinline__ void load_mask_sub_async(
    const uint8_t* __restrict__ src, int pitch, int rows, int cols,
    uint8_t* dst) {
  for (int idx = threadIdx.x; idx < kTile * 8; idx += kThreads) {
    const int r = idx / 8, c = idx % 8;
    const bool ok = r < rows && 8 * c < cols;
    cp_async_8(dst + mask_offset(r, 8 * c),
               ok ? src + static_cast<size_t>(r) * pitch + 8 * c : src,
               ok ? 8 : 0);
  }
}

// Whether the `rows` x `cols` corner of such a sub-tile has a nonzero
// entry; one warp reads it 8 bytes at a time. The same for every lane.
__device__ __forceinline__ bool mask_sub_any(const uint8_t* __restrict__ src,
                                             int pitch, int rows, int cols,
                                             int lane) {
  unsigned long long seen = 0;
  for (int idx = lane; idx < kTile * 8; idx += 32) {
    const int r = idx / 8, c = idx % 8;
    if (r < rows && 8 * c < cols) {
      seen |= *reinterpret_cast<const unsigned long long*>(
          src + static_cast<size_t>(r) * pitch + 8 * c);
    }
  }
  return __any_sync(0xffffffffu, seen != 0);
}

// Four 8 x 8 bf16 blocks of shared memory into one register each; lane l
// gives the address of row l % 8 of block l / 8 and receives from block i,
// in r[i], the entries (row l / 4, columns 2 (l % 4) and + 1) — with
// `_trans`, those of the block's transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8] on the tensor cores, bf16 operands,
// float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[16 x kCols] += A[a_row0 .. + 15, :] . B[b_row0 .. + kCols - 1, :]^T for
// two row-major [kTile, D] tiles in shared memory: the logits-like products
// (q . k^T, dO . v^T and their transposes). acc[j] is the 16 x 8 tile of
// columns 8 j .. 8 j + 7.
template <int D, int kCols>
__device__ __forceinline__ void mma_abt(float (&acc)[kCols / 8][4],
                                        const bf16* a, int a_row0,
                                        const bf16* b, int b_row0, int lane) {
  constexpr int kStride = Tile<D>::kStride;
  const bf16* a_ptr = a + (a_row0 + (lane & 15)) * kStride + (lane >> 4) * 8;
  const bf16* b_ptr = b + (b_row0 + (lane & 7) + (lane >> 4) * 8) * kStride +
                      ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int c = 0; c < D; c += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, a_ptr + c);
#pragma unroll
    for (int j = 0; j < kCols / 8; j += 2) {
      uint32_t bfrag[4];
      ldmatrix_x4(bfrag, b_ptr + j * 8 * kStride + c);
      mma_bf16(acc[j], af, bfrag[0], bfrag[1]);
      mma_bf16(acc[j + 1], af, bfrag[2], bfrag[3]);
    }
  }
}

// out[16 x kOut] += P[16 x kCols] . X[x_row0 .. + kCols - 1, col0 .. +
// kOut - 1] with P in registers as A fragments (p[i] covers columns 16 i ..
// 16 i + 15) and X a row-major [kTile, D] tile in shared memory, read along
// its rows by ldmatrix.trans: the products ds . k, w^T . dO and ds^T . q
// (all D columns), and G's dq partial (kOut columns at a time).
template <int D, int kCols, int kOut = D>
__device__ __forceinline__ void mma_pb(float (&out)[kOut / 8][4],
                                       const uint32_t (&p)[kCols / 16][4],
                                       const bf16* x, int x_row0, int lane,
                                       int col0 = 0) {
  constexpr int kStride = Tile<D>::kStride;
  const bf16* x_ptr =
      x + (x_row0 + (lane & 15)) * kStride + (lane >> 4) * 8 + col0;
#pragma unroll
  for (int i = 0; i < kCols / 16; ++i) {
#pragma unroll
    for (int j = 0; j < kOut / 8; j += 2) {
      uint32_t bfrag[4];
      ldmatrix_x4_trans(bfrag, x_ptr + i * 16 * kStride + j * 8);
      mma_bf16(out[j], p[i], bfrag[0], bfrag[1]);
      mma_bf16(out[j + 1], p[i], bfrag[2], bfrag[3]);
    }
  }
}

// 16 x 8 accumulator tiles 2 i and 2 i + 1 rounded to bf16 as the A
// fragment of columns 16 i .. 16 i + 15.
template <int kTiles>
__device__ __forceinline__ void pack_fragments(
    uint32_t (&frag)[kTiles / 2][4], const float (&acc)[kTiles][4]) {
#pragma unroll
  for (int i = 0; i < kTiles / 2; ++i) {
    frag[i][0] = pack_bf16(acc[2 * i][0], acc[2 * i][1]);
    frag[i][1] = pack_bf16(acc[2 * i][2], acc[2 * i][3]);
    frag[i][2] = pack_bf16(acc[2 * i + 1][0], acc[2 * i + 1][1]);
    frag[i][3] = pack_bf16(acc[2 * i + 1][2], acc[2 * i + 1][3]);
  }
}

// One (query tile, key tile) pair of the forward for this warp's 16 query
// rows, a step of the online softmax:
//   s = mask ? (q . k^T) * scale : kNegInf,   m' = max(m, rowmax(s)),
//   p = mask ? exp(s - m') : 0,   sum = sum * exp(m - m') + rowsum(p),
//   o = o * exp(m - m') + bf16(p) . v.
// qs, ks, vs: [kTile, D] tiles; ms: the staged mask tile [query row, key
// column]. row_max, row_sum: the running maximum and denominator of rows
// 16 warp + lane / 4 ([0]) and the row eight below ([1]), the same in the
// four lanes of a quad. p is selected on the mask bit, so a row whose
// maximum is still kNegInf adds 0; the row sum takes the unrounded p.
template <int D>
__device__ __forceinline__ void fwd_pair(float (&o)[D / 8][4],
                                         float (&row_max)[2],
                                         float (&row_sum)[2], const bf16* qs,
                                         const bf16* ks, const bf16* vs,
                                         const uint8_t* ms, float scale,
                                         int warp, int lane) {
  const int row = 16 * warp + (lane >> 2);
  float s[kTile / 8][4] = {};
  mma_abt<D, kTile>(s, qs, 16 * warp, ks, 0, lane);
  uint32_t on = 0;  // bit 4 j + e: entry e of accumulator tile j is allowed
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const uchar2 m0 =
        *reinterpret_cast<const uchar2*>(ms + mask_offset(row, col));
    const uchar2 m1 =
        *reinterpret_cast<const uchar2*>(ms + mask_offset(row + 8, col));
    const bool allowed[4] = {m0.x != 0, m0.y != 0, m1.x != 0, m1.y != 0};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      on |= static_cast<uint32_t>(allowed[e]) << (4 * j + e);
      s[j][e] = allowed[e] ? s[j][e] * scale : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(mx[r], row_max[r]);
    // 1 while the row has no key (its sum is 0), 0 at its first key.
    alpha[r] = __expf(row_max[r] - mx[r]);
    row_max[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = (on >> (4 * j + e)) & 1u ? __expf(s[j][e] - mx[e >> 1]) : 0.f;
      sum[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    row_sum[r] = row_sum[r] * alpha[r] + sum[r];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
  uint32_t p[kTile / 16][4];
  pack_fragments<kTile / 8>(p, s);
  mma_pb<D, kTile>(o, p, vs, 0, lane);
}

// One (query tile, key tile) pair of dq for this warp's 16 query rows:
//   s = q . k^T, dp = dO . v^T, w = mask ? exp(s * scale - lse) : 0,
//   ds = w * (dp - delta) rounded to bf16, dq += ds . k   (unscaled).
// qs, dos, ks, vs: [kTile, D] tiles; ms: the staged mask tile [query row,
// key column]; lse0, delta0 belong to row 16 warp + lane / 4 and lse1,
// delta1 to the row eight below.
template <int D>
__device__ __forceinline__ void dq_pair(float (&dq)[D / 8][4], const bf16* qs,
                                        const bf16* dos, const bf16* ks,
                                        const bf16* vs, const uint8_t* ms,
                                        float lse0, float lse1, float delta0,
                                        float delta1, float scale, int warp,
                                        int lane) {
  const int row = 16 * warp + (lane >> 2);
  float s[kTile / 8][4] = {}, dp[kTile / 8][4] = {};
  mma_abt<D, kTile>(s, qs, 16 * warp, ks, 0, lane);
  mma_abt<D, kTile>(dp, dos, 16 * warp, vs, 0, lane);
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const uchar2 m0 =
        *reinterpret_cast<const uchar2*>(ms + mask_offset(row, col));
    const uchar2 m1 =
        *reinterpret_cast<const uchar2*>(ms + mask_offset(row + 8, col));
    s[j][0] = m0.x ? __expf(s[j][0] * scale - lse0) * (dp[j][0] - delta0)
                   : 0.f;
    s[j][1] = m0.y ? __expf(s[j][1] * scale - lse0) * (dp[j][1] - delta0)
                   : 0.f;
    s[j][2] = m1.x ? __expf(s[j][2] * scale - lse1) * (dp[j][2] - delta1)
                   : 0.f;
    s[j][3] = m1.y ? __expf(s[j][3] * scale - lse1) * (dp[j][3] - delta1)
                   : 0.f;
  }
  uint32_t ds[kTile / 16][4];
  pack_fragments<kTile / 8>(ds, s);
  mma_pb<D, kTile>(dq, ds, ks, 0, lane);
}

// One (key tile, query tile) pair of dk and dv for this warp's 16 key rows,
// on the transposed logits:
//   s^T = k . q^T, dp^T = v . dO^T, w^T = mask ? exp(s^T * scale - lse) : 0,
//   ds^T = w^T * (dp^T - delta), both rounded to bf16,
//   dv += w^T . dO, dk += ds^T . q   (unscaled).
// ms is the staged mask tile [query row, key column], read by (column, row);
// vec holds the query tile's lse in [0, 64) and delta in [64, 128). kCols
// query columns are in registers at a time (64, or 32 where D = 128 leaves
// no room for more). With kDsOut (kernel G) each pass also writes its bf16
// ds^T fragments, the very operand of dk's product, into the DsT<D> tile at
// ds_t; where that tile lies over the q tile, a barrier first waits until
// every warp is done with the pass's q rows. The caller waits for the whole
// tile with a barrier of its own.
template <int D, int kCols, bool kDsOut = false>
__device__ __forceinline__ void dkv_pair(float (&dk)[D / 8][4],
                                         float (&dv)[D / 8][4], const bf16* ks,
                                         const bf16* vs, const bf16* qs,
                                         const bf16* dos, const uint8_t* ms,
                                         const float* vec, float scale,
                                         int warp, int lane,
                                         bf16* ds_t = nullptr) {
  static_assert(!(kDsOut && DsT<D>::kInQ) || kCols == kDsCols,
                "a pass must free exactly the q rows its ds^T block covers");
  const int row = 16 * warp + (lane >> 2);  // key row; the other is row + 8
  // Not unrolled: the passes would share their registers' lifetimes, and at
  // D = 128 (128 sums held across the list) that spills.
#pragma unroll 1
  for (int c0 = 0; c0 < kTile; c0 += kCols) {
    float w[kCols / 8][4] = {}, dp[kCols / 8][4] = {};
    mma_abt<D, kCols>(w, ks, 16 * warp, qs, c0, lane);
    mma_abt<D, kCols>(dp, vs, 16 * warp, dos, c0, lane);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int col = c0 + 8 * j + 2 * (lane & 3);  // query rows col, col + 1
      const float2 lse = *reinterpret_cast<const float2*>(vec + col);
      const float2 delta = *reinterpret_cast<const float2*>(vec + kTile + col);
      w[j][0] = ms[mask_offset(col, row)]
                    ? __expf(w[j][0] * scale - lse.x) : 0.f;
      w[j][1] = ms[mask_offset(col + 1, row)]
                    ? __expf(w[j][1] * scale - lse.y) : 0.f;
      w[j][2] = ms[mask_offset(col, row + 8)]
                    ? __expf(w[j][2] * scale - lse.x) : 0.f;
      w[j][3] = ms[mask_offset(col + 1, row + 8)]
                    ? __expf(w[j][3] * scale - lse.y) : 0.f;
      dp[j][0] = w[j][0] * (dp[j][0] - delta.x);
      dp[j][1] = w[j][1] * (dp[j][1] - delta.y);
      dp[j][2] = w[j][2] * (dp[j][2] - delta.x);
      dp[j][3] = w[j][3] * (dp[j][3] - delta.y);
    }
    uint32_t wf[kCols / 16][4], dsf[kCols / 16][4];
    pack_fragments<kCols / 8>(wf, w);
    pack_fragments<kCols / 8>(dsf, dp);
    mma_pb<D, kCols>(dv, wf, dos, c0, lane);
    mma_pb<D, kCols>(dk, dsf, qs, c0, lane);
    if constexpr (kDsOut) {
      if constexpr (DsT<D>::kInQ) __syncthreads();
#pragma unroll
      for (int i = 0; i < kCols / 16; ++i) {
        const int col = c0 + 16 * i;  // the fragment's first query column
        uint32_t* at = reinterpret_cast<uint32_t*>(
            ds_t + (col / kDsCols) * DsT<D>::kBlockElems + row * kDsStride +
            col % kDsCols + 2 * (lane & 3));
        constexpr int kRow8 = 8 * kDsStride / 2;  // eight rows, in words
        at[0] = dsf[i][0];
        at[kRow8] = dsf[i][1];
        at[4] = dsf[i][2];
        at[kRow8 + 4] = dsf[i][3];
      }
    }
  }
}

// Kernel G's fifth product for one pair, this warp's 16 query rows:
// partial = ds . K rounded to bf16 once, from the DsT<D> tile ds_t (ds^T,
// read by ldmatrix.trans as the A operand) and the resident key tile ks,
// kChunk output columns at a time. The strip is staged, rounded, in rows
// 16 warp .. of `stage` (a [kTile, D] tile no warp reads any more) and then
// stored 16 bytes a lane into rows 16 warp .. of the pair's contiguous
// [kTile, D] partial tile `dst`.
template <int D>
__device__ __forceinline__ void dq_partial(const bf16* ds_t, const bf16* ks,
                                           bf16* stage, bf16* __restrict__ dst,
                                           int warp, int lane) {
  constexpr int kStride = Tile<D>::kStride;
  constexpr int kChunk = D < 32 ? D : 32;
  // Rows 16 warp .. 16 warp + 15 of ds are columns of ds^T block warp / 2.
  const bf16* a_ptr = ds_t + (warp >> 1) * DsT<D>::kBlockElems +
                      ((lane & 7) + ((lane >> 4) & 1) * 8) * kDsStride +
                      16 * (warp & 1) + ((lane >> 3) & 1) * 8;
  uint32_t a[kTile / 16][4];
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
    ldmatrix_x4_trans(a[kc], a_ptr + 16 * kc * kDsStride);
  }
  const int row = 16 * warp + (lane >> 2);
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    float acc[kChunk / 8][4] = {};
    mma_pb<D, kTile, kChunk>(acc, a, ks, 0, lane, c0);
    uint32_t* at = reinterpret_cast<uint32_t*>(stage + row * kStride + c0 +
                                               2 * (lane & 3));
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      at[4 * j] = pack_bf16(acc[j][0], acc[j][1]);
      at[4 * j + 8 * kStride / 2] = pack_bf16(acc[j][2], acc[j][3]);
    }
  }
  __syncwarp();
  constexpr int kRowChunks = D / 8;  // 16-byte pieces of a row
#pragma unroll
  for (int idx = lane; idx < 16 * kRowChunks; idx += 32) {
    const int r = 16 * warp + idx / kRowChunks, c = 8 * (idx % kRowChunks);
    *reinterpret_cast<uint4*>(dst + r * D + c) =
        *reinterpret_cast<const uint4*>(stage + r * kStride + c);
  }
}

// This warp's 16 x D strip of sums, rounded to bf16 into rows 16 warp .. of a
// tile of [batch, n, h, D] (`dst` its first row), row 16 warp + lane / 4
// times `scale_lo` and the row eight below times `scale_hi`; rows from `rows`
// on are not written.
template <int D>
__device__ __forceinline__ void store_strip(const float (&acc)[D / 8][4],
                                            bf16* __restrict__ dst,
                                            size_t row_stride, int rows,
                                            float scale_lo, float scale_hi,
                                            int warp, int lane) {
  const int row = 16 * warp + (lane >> 2);
  bf16* at = dst + row * row_stride + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row < rows) {
      *reinterpret_cast<__nv_bfloat162*>(at + 8 * j) =
          __floats2bfloat162_rn(acc[j][0] * scale_lo, acc[j][1] * scale_lo);
    }
    if (row + 8 < rows) {
      *reinterpret_cast<__nv_bfloat162*>(at + 8 * row_stride + 8 * j) =
          __floats2bfloat162_rn(acc[j][2] * scale_hi, acc[j][3] * scale_hi);
    }
  }
}

// The same with one scale for the whole strip.
template <int D>
__device__ __forceinline__ void store_strip(const float (&acc)[D / 8][4],
                                            bf16* __restrict__ dst,
                                            size_t row_stride, int rows,
                                            float scale, int warp, int lane) {
  store_strip<D>(acc, dst, row_stride, rows, scale, scale, warp, lane);
}

// The forward's two row values of this lane (lse, one per query row) into
// `dst` (the tile's first entry of a [batch * h, n] row): the first lane of
// each quad writes row 16 warp + lane / 4 and the row eight below, where
// they lie below `rows`.
__device__ __forceinline__ void store_rows(float lo, float hi,
                                           float* __restrict__ dst, int rows,
                                           int warp, int lane) {
  const int row = 16 * warp + (lane >> 2);
  if ((lane & 3) == 0) {
    if (row < rows) dst[row] = lo;
    if (row + 8 < rows) dst[row + 8] = hi;
  }
}

}  // namespace mma
}  // namespace gt
