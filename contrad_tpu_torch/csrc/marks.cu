// Phase marks of the train step on Hopper (sm_90a): empty one-thread kernels,
// one per phase and edge, named for both (contrad_mark_<phase>_begin,
// contrad_mark_<phase>_end).
//
// Replaces no TPU kernel. The port runs a train step as one CUDA graph replay
// (training/graph.py), and a host span cannot split a replay: it exists while
// the graph is captured, not while it runs. So the phases of the step (the D
// and G updates, R1, the augment, the optimiser updates) are marked on the
// device. contrad_tpu_torch/utils/trace.py::phase launches the phase's begin
// mark on the caller's stream where the phase opens and its end mark where it
// closes. Inside a capture the marks become nodes of the graph, so every
// replay runs them in order between the phase's kernels, and a device trace
// (CUPTI) records them by name on the kernels' timeline.
//
// What bounds it: launch latency alone. A mark reads and writes no memory,
// allocates nothing and has one thread; inside a graph it costs a kernel
// node's latency, about a microsecond. The step has at most 24 marks.
//
// C interface for ctypes: contrad_mark_count() is the number of marks,
// contrad_mark_name(i) the kernel name of mark i (2 * phase + edge, the
// phases in CONTRAD_PHASES' order, which utils/trace.py::PHASES repeats), and
// contrad_mark(i, device, stream) launches mark i on the stream of the given
// device and returns the launch's CUDA error (0 on success); it never
// synchronises.

#include <cuda_runtime.h>

#define CONTRAD_PHASES(X) X(step) X(d) X(r1) X(g) X(aug) X(update)

#define CONTRAD_DEFINE(p)                                \
  extern "C" __global__ void contrad_mark_##p##_begin() {} \
  extern "C" __global__ void contrad_mark_##p##_end() {}
CONTRAD_PHASES(CONTRAD_DEFINE)

#define CONTRAD_KERNEL(p) \
  (const void*)contrad_mark_##p##_begin, (const void*)contrad_mark_##p##_end,
#define CONTRAD_NAME(p) \
  "contrad_mark_" #p "_begin", "contrad_mark_" #p "_end",

namespace {
const void* const kMarks[] = {CONTRAD_PHASES(CONTRAD_KERNEL)};
const char* const kNames[] = {CONTRAD_PHASES(CONTRAD_NAME)};
constexpr int kCount = sizeof(kMarks) / sizeof(kMarks[0]);
}  // namespace

extern "C" int contrad_mark_count() { return kCount; }

extern "C" const char* contrad_mark_name(int index) {
  return index >= 0 && index < kCount ? kNames[index] : nullptr;
}

extern "C" int contrad_mark(int index, int device, void* stream) {
  if (index < 0 || index >= kCount) return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  void* none[1] = {nullptr};
  const int err = (int)cudaLaunchKernel(kMarks[index], dim3(1), dim3(1), none,
                                        0, static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return err;
}
