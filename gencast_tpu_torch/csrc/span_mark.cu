// Span marks: one empty kernel per edge of each device span of the program's
// span table (gencast_tpu_torch/utils.py, SPANS and MARKS, in this order).
//
// Replaces no TPU kernel. A host annotation made while a CUDA graph is
// captured does not run again when the graph is replayed, and a forecast's
// denoiser call or a training step is one replay of about a thousand or
// several thousand kernels. A mark is a kernel on the stream of the work it
// bounds, so the graphs captured at set-up hold it, every replay runs it,
// and it carries the device trace's own clock. Its name alone says which
// span and which edge: gt_span_<span>_<begin|end|grad>.
//
// What bounds it on an H100: launch latency (one block of one thread, no
// memory); about a microsecond of device time a mark.
#include <cuda_runtime.h>

#define GT_SPAN_MARKS(X)                                                    \
  X(denoiser_begin) X(denoiser_end) X(denoiser_grad)                        \
  X(grid2mesh_begin) X(grid2mesh_end) X(grid2mesh_grad)                     \
  X(processor_begin) X(processor_end) X(processor_grad)                     \
  X(mesh2grid_begin) X(mesh2grid_end) X(mesh2grid_grad)                     \
  X(noise_begin) X(noise_end)                                               \
  X(remat_begin) X(remat_end)                                               \
  X(backward_begin) X(backward_end)                                         \
  X(optimizer_begin) X(optimizer_end)

// Unmangled names, so the profiler shows gt_span_<span>_<edge> as it is.
#define GT_SPAN_KERNEL(name) extern "C" __global__ void gt_span_##name() {}
GT_SPAN_MARKS(GT_SPAN_KERNEL)
#undef GT_SPAN_KERNEL

namespace {

#define GT_SPAN_ENTRY(name) gt_span_##name,
void (*const kMarks[])() = {GT_SPAN_MARKS(GT_SPAN_ENTRY)};
#undef GT_SPAN_ENTRY

constexpr int kNumMarks = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

// Launches mark `id` (its index in the list above) on `stream`. Returns a
// cudaError_t code.
extern "C" int gt_span_mark(int id, void* stream) {
  if (id < 0 || id >= kNumMarks) return cudaErrorInvalidValue;
  return cudaLaunchKernel(reinterpret_cast<const void*>(kMarks[id]), dim3(1),
                          dim3(1), nullptr, 0,
                          static_cast<cudaStream_t>(stream));
}
