// Planned sorted segment sum: out[n] = sum of data[e] over the edges e of
// receiver n, accumulated in float32.
//
// Replaces the TPU kernel gencast_tpu/ops/segment.py:_segment_kernel
// (pallas_call in _segment_sum_mxu_impl), which built a [tile, width]
// one-hot of receiver ids in VMEM and reduced it on the matrix unit at
// HIGHEST precision, because TPU scatter-adds ran far below memory
// bandwidth.
//
// What bounds it on an H100: bytes. Each edge row is read once and each
// output row written once (at 1 degree, grid2mesh: 101,892 x 512 float32
// read, 10,242 x 512 written), against one add per element read.
//
// Design: a CSR row reduction over the plan's row_ptr (receivers sorted;
// an optional perm gathers unsorted edges into that order). One block per
// receiver row, threads across the feature axis, so a warp reads 32
// neighbouring elements of one edge row per step. Each thread sums its
// row's edges in stored order in a float32 register: no atomics and no
// one-hot, so the result is the same bits from run to run.
//
// Float32 only: its one caller, the grid2mesh receiver aggregation, always
// accumulates in float32 (f32_aggregation), as in the reference.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads) segment_sum_kernel(
    const float* __restrict__ data, const int* __restrict__ row_ptr,
    const int* __restrict__ perm, float* __restrict__ out, int f) {
  const int row = blockIdx.x;
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  for (int col = threadIdx.x; col < f; col += blockDim.x) {
    float acc = 0.f;
    for (int e = start; e < end; ++e) {
      const int src = perm != nullptr ? perm[e] : e;
      acc += data[static_cast<size_t>(src) * f + col];
    }
    out[static_cast<size_t>(row) * f + col] = acc;
  }
}

}  // namespace

// data: [num_edges, f] contiguous float32; row_ptr: [num_segments + 1]
// int32; perm: [num_edges] int32 or null; out: [num_segments, f] float32.
// Returns a cudaError_t code.
extern "C" int gt_segment_sum(const void* data, const void* row_ptr,
                              const void* perm, void* out, int num_segments,
                              int f, void* stream) {
  if (num_segments == 0 || f == 0) return cudaSuccess;
  const int threads = f >= kMaxThreads ? kMaxThreads : ((f + 31) / 32) * 32;
  segment_sum_kernel<<<num_segments, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(row_ptr),
      static_cast<const int*>(perm), static_cast<float*>(out), f);
  return cudaGetLastError();
}
