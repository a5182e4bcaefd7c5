// An empty kernel.  The time from its launch to its completion is the floor
// of any single launch on the card, which is what the latency-bound kernels
// of this package are measured against (their byte and FLOP rooflines are
// fractions of a microsecond).  Used by chip_smoke.py only.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Launches the empty kernel on `stream`; returns the CUDA error (0 = success).
int vors_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
