// dq of the fused block-sparse attention backward: for each (batch * head,
// q tile qi),
//   dq[qi] = scale * sum of partial[slot_ids[qi, a]] over a with
//            valid[qi, a] != 0,
// summed in float32 in slot order a = 0, 1, ..., rounded to the partials'
// dtype and written straight into dq [batch, n, h, head_dim], the ragged
// last tile cut at n. The partials are kernel G's per-pair dq tiles ds . K
// ([batch, num_slots, h, 64, head_dim], sparse_attention_bwd.cu).
//
// Replaces the reference's gather-multiply-reduce after its fused backward
// (gencast_tpu/ops/sparse_attention.py:634-638, XLA ops outside the
// pallas_call in _sba_bwd_fused), which the port first ran as PyTorch ops
// (index_select, where, sum, scale, cast, strided copy per chunk of q tiles).
//
// What bounds it on an H100: bytes. Each valid partial tile is read once
// (at 1 degree ~0.65 GB in bf16) and dq written once; one add per element
// read.
//
// Design: one block per (q tile, batch * head). Its first warp compacts the
// tile's valid slots, in order, into shared memory with a ballot; entries
// with valid 0 are never read, so their slot (slot 0, or a pad slot G leaves
// unwritten, NaN included) cannot reach the sum. Each thread owns a few
// 16-byte pieces of the [64, head_dim] tile, keeps their sums in float32
// registers and reads kInFlight slots' pieces before adding them in slot
// order: no atomics, the same bits from run to run.
#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ void add_piece(float* acc, const uint4& v,
                                          float) {
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += f[i];
}
__device__ __forceinline__ void add_piece(float* acc, const uint4& v,
                                          __nv_bfloat16) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

__device__ __forceinline__ uint4 pack_piece(const float* acc, float scale,
                                            float) {
  uint4 v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = acc[i] * scale;
  return v;
}
__device__ __forceinline__ uint4 pack_piece(const float* acc, float scale,
                                            __nv_bfloat16) {
  uint4 v;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[i] = __floats2bfloat162_rn(acc[2 * i] * scale, acc[2 * i + 1] * scale);
  }
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) sparse_attention_dq_reduce_kernel(
    const T* __restrict__ partial, const int* __restrict__ slot_ids,
    const float* __restrict__ valid, T* __restrict__ dq, int n, int h,
    int num_slots, int num_active, float scale) {
  constexpr int kVec = 16 / sizeof(T);        // elements of a 16-byte piece
  constexpr int kRowPieces = D / kVec;
  constexpr int kPer = kTile * kRowPieces / kThreads;  // pieces per thread
  static_assert(kPer >= 1 && kTile * kRowPieces % kThreads == 0,
                "the threads split the tile evenly");
  // Slots read before their adds: ~16 pieces in flight per thread.
  constexpr int kInFlight = kPer >= 8 ? 2 : 4;
  extern __shared__ int slots[];  // the tile's valid slots, in order
  __shared__ int count;

  const int qi = blockIdx.x;
  const int bh = blockIdx.y;  // batch * h + head
  const int rows = min(kTile, n - qi * kTile);
  if (rows <= 0) return;  // the whole block: a plan tile past n

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const size_t list = static_cast<size_t>(qi) * num_active;
    int total = 0;
    for (int a0 = 0; a0 < num_active; a0 += 32) {
      const int a = a0 + lane;
      const bool keep = a < num_active && valid[list + a] != 0.f;
      const unsigned kept = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        slots[total + __popc(kept & ((1u << lane) - 1u))] = slot_ids[list + a];
      }
      total += __popc(kept);
    }
    if (lane == 0) count = total;
  }
  __syncthreads();

  const size_t tile_elems = static_cast<size_t>(kTile) * D;
  const size_t slot_stride = static_cast<size_t>(h) * tile_elems;
  const T* src = partial +
                 (static_cast<size_t>(bh / h) * num_slots * h + bh % h) *
                     tile_elems;
  float acc[kPer][kVec] = {};
  const int total = count;
  int i = 0;
  for (; i + kInFlight <= total; i += kInFlight) {
    uint4 v[kInFlight][kPer];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const uint4* at =
          reinterpret_cast<const uint4*>(src + slots[i + u] * slot_stride);
#pragma unroll
      for (int p = 0; p < kPer; ++p) v[u][p] = at[threadIdx.x + p * kThreads];
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
#pragma unroll
      for (int p = 0; p < kPer; ++p) add_piece(acc[p], v[u][p], T());
  }
  for (; i < total; ++i) {
    const uint4* at =
        reinterpret_cast<const uint4*>(src + slots[i] * slot_stride);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      add_piece(acc[p], at[threadIdx.x + p * kThreads], T());
    }
  }

  const size_t row_stride = static_cast<size_t>(h) * D;
  T* out = dq + (static_cast<size_t>(bh / h) * n * h + bh % h) * D +
           static_cast<size_t>(qi) * kTile * row_stride;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int piece = threadIdx.x + p * kThreads;
    const int r = piece / kRowPieces, c = (piece % kRowPieces) * kVec;
    if (r < rows) {
      *reinterpret_cast<uint4*>(out + r * row_stride + c) =
          pack_piece(acc[p], scale, T());
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* partial, const int* slot_ids,
                   const float* valid, void* dq, int batch, int n, int h,
                   int num_q_tiles, int num_slots, int num_active,
                   float scale, cudaStream_t stream) {
  const dim3 grid(num_q_tiles, batch * h);
  const size_t smem = static_cast<size_t>(num_active) * sizeof(int);
  sparse_attention_dq_reduce_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(partial), slot_ids, valid, static_cast<T*>(dq),
      n, h, num_slots, num_active, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int head_dim, const void* partial, const int* slot_ids,
                       const float* valid, void* dq, int batch, int n, int h,
                       int num_q_tiles, int num_slots, int num_active,
                       float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:  // TINY
      return launch<T, 32>(partial, slot_ids, valid, dq, batch, n, h,
                           num_q_tiles, num_slots, num_active, scale, stream);
    case 128:  // ONE_DEG
      return launch<T, 128>(partial, slot_ids, valid, dq, batch, n, h,
                            num_q_tiles, num_slots, num_active, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// partial: [batch, num_slots, h, 64, head_dim] contiguous, float32 or
// bfloat16, head_dim 32 or 128; slot_ids: [num_q_tiles, num_active] int32
// (each valid entry < num_slots); valid: [num_q_tiles, num_active] float32;
// dq: [batch, n, h, head_dim] contiguous, the partials' dtype. Returns a
// cudaError_t code.
extern "C" int gt_sparse_attention_dq_reduce(
    int dtype, int head_dim, const void* partial, const void* slot_ids,
    const void* valid, void* dq, int batch, int n, int h, int num_q_tiles,
    int num_slots, int num_active, float scale, void* stream) {
  if (batch == 0 || n == 0 || h == 0) return cudaSuccess;
  const auto* s = static_cast<const int*>(slot_ids);
  const auto* w = static_cast<const float*>(valid);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gt::kFloat32:
      return dispatch_d<float>(head_dim, partial, s, w, dq, batch, n, h,
                               num_q_tiles, num_slots, num_active, scale, st);
    case gt::kBFloat16:
      return dispatch_d<__nv_bfloat16>(head_dim, partial, s, w, dq, batch, n,
                                       h, num_q_tiles, num_slots, num_active,
                                       scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
