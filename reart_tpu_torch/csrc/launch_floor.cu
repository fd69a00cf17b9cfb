// An empty kernel: the floor that a launch-bound kernel's device time is
// measured against (chip_smoke.py phase 3, bench_nn.py). No path runs it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One launch of a kernel that does nothing, on one warp.
extern "C" int reart_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
