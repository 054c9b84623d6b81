// Planned sorted segment sum: out[n] = sum of data[e] over the edges e of
// receiver n, accumulated in float32, from float32 or bfloat16 edge rows.
//
// Replaces the TPU kernel gencast_tpu/ops/segment.py:_segment_kernel
// (pallas_call in _segment_sum_mxu_impl), which built a [tile, width]
// one-hot of receiver ids in VMEM and reduced it on the matrix unit at
// HIGHEST precision, because TPU scatter-adds ran far below memory
// bandwidth. It read the edge rows in their own dtype and widened them to
// float32 in the kernel (`data_ref[...].astype(jnp.float32)`); so does this
// one, so a bf16 caller writes no float32 copy of its edges first.
//
// What bounds it on an H100: bytes. Each edge row is read once and each
// output row written once (at 1 degree, grid2mesh: 101,892 x 512 bf16 read,
// 10,242 x 512 float32 written), against one add per element read.
//
// Design: a CSR row reduction over the plan's row_ptr (receivers sorted; an
// optional perm gathers unsorted edges into that order).
// * Each warp sums one row at a time, taking rows from a shared integer
//   counter, so the warps stay busy until the rows run out. A lane holds
//   16-byte vectors of the row (8 bf16 or 4 float32 columns; vector v =
//   lane + 32 j) and their float32 sums in registers. 16 / NV edges are
//   loaded before they are added, so many rows' loads are in flight while
//   each row is still summed in stored order; a warp reads perm for 32 edges
//   at once, one index per lane, and passes them by shuffle.
// * Rows longer than `split_degree` edges (64 from the wrapper; mesh2grid's
//   senders at 1 degree reach 845) would leave one warp walking them long
//   after the rest of the card is done. They are summed first, each by all 8 warps of the block
//   that owns it (rows b + i * blocks; long rows cluster in index ranges, so
//   they spread over the blocks): a warp takes one contiguous eighth of the
//   row, and the eighths are added in warp order in shared memory.
// * No float atomics (the work queue's counters are integers): the result
//   is the same bits from run to run. A row of at most split_degree edges
//   is summed in stored order, so its bits are the plain float32 loop's;
//   bf16 input gives the same bits as its exact float32 upcast.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerTake = 2;  // short rows a warp takes at a time

// The short rows' work queue: warps take the next kRowsPerTake rows from
// g_next_row; the last block to finish puts both counters back to 0, so no
// reset from the host is needed between calls (a CUDA graph can replay the
// launch). Launches on one device must not overlap (the port runs on one
// stream).
__device__ unsigned int g_next_row = 0;
__device__ unsigned int g_blocks_done = 0;

// Sums, into acc (NV vectors of V floats per lane), the edges [begin, end)
// of the plan's order, vectors base + lane + 32 j of each edge row.
template <typename T, int NV>
__device__ __forceinline__ void sum_edges(const T* __restrict__ data,
                                          const int* __restrict__ perm,
                                          int begin, int end, long long f,
                                          int base, int nvec, int lane,
                                          float* acc) {
  constexpr int V = gt::kVec16<T>;
  constexpr int kInFlight = 16 / NV;  // edges loaded before their adds
  bool valid[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) valid[j] = base + lane + 32 * j < nvec;
  for (int e0 = begin; e0 < end; e0 += 32) {
    const int count = min(32, end - e0);
    // Lane i holds the source row of edge e0 + i.
    const int mine = perm == nullptr ? e0 + lane
                     : lane < count  ? __ldg(perm + e0 + lane)
                                     : 0;
    for (int k = 0; k < count; k += kInFlight) {
      uint4 raw[kInFlight][NV];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int src = __shfl_sync(0xffffffffu, mine, k + u);
        const uint4* row = reinterpret_cast<const uint4*>(
            data + static_cast<long long>(src) * f) + base + lane;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          raw[u][j] = k + u < count && valid[j] ? __ldg(row + 32 * j)
                                                : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (k + u >= count) break;  // the same for every lane
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float v[V];
          gt::unpack16(raw[u][j], v, T());
#pragma unroll
          for (int i = 0; i < V; ++i) acc[j * V + i] += v[i];
        }
      }
    }
  }
}

// Writes a lane's sums (vectors base + lane + 32 j) into the output row.
template <int V, int NV>
__device__ __forceinline__ void store_row(float* __restrict__ out,
                                          const float* acc, int base,
                                          int nvec, int lane) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = base + lane + 32 * j;
    if (v >= nvec) continue;
    float4* at = reinterpret_cast<float4*>(out + static_cast<long long>(v) * V);
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      at[i / 4] = make_float4(acc[j * V + i], acc[j * V + i + 1],
                              acc[j * V + i + 2], acc[j * V + i + 3]);
    }
  }
}

// Sums row r (begin, end = its edges) with all 8 warps: warp w takes the
// w-th contiguous eighth of the edges, and the eighths are added in warp
// order. Called by every thread of the block.
template <typename T, int NV>
__device__ __forceinline__ void sum_split_row(
    const T* __restrict__ data, const int* __restrict__ perm,
    float* __restrict__ out, int r, int begin, int end, int f, int warp,
    int lane, float (*red)[32 * NV * gt::kVec16<T>]) {
  constexpr int V = gt::kVec16<T>;
  constexpr int N = NV * V;
  const int nvec = f / V;
  const int share = (end - begin + kWarps - 1) / kWarps;
  const int mine = min(end, begin + warp * share);
  const int last = min(end, mine + share);
  float* dst = out + static_cast<long long>(r) * f;
  for (int base = 0; base < nvec; base += 32 * NV) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    sum_edges<T, NV>(data, perm, mine, last, f, base, nvec, lane, acc);
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp][lane * N + i] = acc[i];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float total = red[0][lane * N + i];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) total += red[w][lane * N + i];
        acc[i] = total;
      }
      store_row<V, NV>(dst, acc, base, nvec, lane);
    }
    __syncthreads();
  }
}

// A persistent grid of G blocks. Block b first sums the rows it owns, rows
// b + i * G, that have more than split_degree edges, each with all its
// warps (sum_split_row): long rows cluster in index ranges, so they spread
// over the blocks and all start at once. Then each warp takes the other
// rows kRowsPerTake at a time from a shared counter and sums them in stored
// order on its own: no warp waits for a slower row of its block, and no warp
// is left with more rows than the rest. f a multiple of V; NV the
// vectors per lane of one pass over the columns (f / V / 32 rounded up, at
// most 16 / V).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const T* __restrict__ data, const int* __restrict__ row_ptr,
    const int* __restrict__ perm, float* __restrict__ out, int num_segments,
    int f, int split_degree) {
  constexpr int V = gt::kVec16<T>;
  constexpr int N = NV * V;       // floats per lane in one pass
  constexpr int kPass = 32 * NV;  // vectors per warp in one pass
  __shared__ int long_rows[kThreads];
  __shared__ int num_long;
  __shared__ float red[kWarps][32 * N];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvec = f / V;
  const long long blocks = gridDim.x;  // long rows: b + i * blocks

  // The long rows this block owns, kThreads candidates at a time (their
  // order in long_rows does not matter: each row is summed on its own).
  for (long long first = blockIdx.x; first < num_segments;
       first += kThreads * blocks) {
    if (threadIdx.x == 0) num_long = 0;
    __syncthreads();
    const long long r = first + threadIdx.x * blocks;
    if (r < num_segments &&
        __ldg(row_ptr + r + 1) - __ldg(row_ptr + r) > split_degree) {
      long_rows[atomicAdd(&num_long, 1)] = static_cast<int>(r);
    }
    __syncthreads();
    for (int k = 0; k < num_long; ++k) {  // the same for every thread
      const int row = long_rows[k];
      sum_split_row<T, NV>(data, perm, out, row, __ldg(row_ptr + row),
                           __ldg(row_ptr + row + 1), f, warp, lane, red);
    }
  }

  // The other rows: one warp each, stored order.
  for (;;) {
    unsigned int take = 0;
    if (lane == 0) take = atomicAdd(&g_next_row, 1u);
    const long long first =
        static_cast<long long>(__shfl_sync(0xffffffffu, take, 0)) *
        kRowsPerTake;
    if (first >= num_segments) break;  // the same for every lane
    const long long stop = min(first + kRowsPerTake,
                               static_cast<long long>(num_segments));
    for (long long r = first; r < stop; ++r) {
      const int begin = __ldg(row_ptr + r), end = __ldg(row_ptr + r + 1);
      if (end - begin > split_degree) continue;  // the same for every lane
      float* dst = out + r * f;
      for (int base = 0; base < nvec; base += kPass) {
        float acc[N];
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = 0.f;
        sum_edges<T, NV>(data, perm, begin, end, f, base, nvec, lane, acc);
        store_row<V, NV>(dst, acc, base, nvec, lane);
      }
    }
  }

  // The last block to finish resets the queue for the next launch.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&g_blocks_done, 1u) == gridDim.x - 1) {
      atomicExch(&g_next_row, 0u);
      atomicExch(&g_blocks_done, 0u);
    }
  }
}

template <typename T, int NV>
cudaError_t launch(const void* data, const void* row_ptr, const void* perm,
                   void* out, int num_segments, int f, int split_degree,
                   int num_sms, cudaStream_t stream) {
  // Blocks of this instantiation that fit on one SM, queried once.
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_sum_kernel<T, NV>, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const int rows_of_warps = (num_segments + kWarps - 1) / kWarps;
  const int blocks = std::max(1, std::min(num_sms * per_sm, rows_of_warps));
  segment_sum_kernel<T, NV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(data), static_cast<const int*>(row_ptr),
      static_cast<const int*>(perm), static_cast<float*>(out), num_segments,
      f, split_degree);
  return cudaGetLastError();
}

}  // namespace

// data: [num_edges, f] contiguous, float32 (dtype 0) or bfloat16 (1),
// starting on 16 bytes, f a multiple of 16 bytes' elements (4 or 8);
// row_ptr: [num_segments + 1] int32; perm: [num_edges] int32 or null; out:
// [num_segments, f] float32, starting on 16 bytes. Rows of more than
// split_degree edges are split over a block's warps; the grid is num_sms
// times the blocks that fit on one SM. Returns a cudaError_t code.
extern "C" int gt_segment_sum(int dtype, const void* data,
                              const void* row_ptr, const void* perm,
                              void* out, int num_segments, int f,
                              int split_degree, int num_sms, void* stream) {
  if (num_segments == 0 || f == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == gt::kFloat32 && f % 4 == 0) {
    const int nv = f / 4 > 64 ? 4 : f / 4 > 32 ? 2 : 1;
    if (nv == 4) {
      return launch<float, 4>(data, row_ptr, perm, out, num_segments, f,
                              split_degree, num_sms, s);
    }
    if (nv == 2) {
      return launch<float, 2>(data, row_ptr, perm, out, num_segments, f,
                              split_degree, num_sms, s);
    }
    return launch<float, 1>(data, row_ptr, perm, out, num_segments, f,
                            split_degree, num_sms, s);
  }
  if (dtype == gt::kBFloat16 && f % 8 == 0) {
    if (f / 8 > 32) {
      return launch<__nv_bfloat16, 2>(data, row_ptr, perm, out, num_segments,
                                      f, split_degree, num_sms, s);
    }
    return launch<__nv_bfloat16, 1>(data, row_ptr, perm, out, num_segments,
                                    f, split_degree, num_sms, s);
  }
  return cudaErrorInvalidValue;
}
