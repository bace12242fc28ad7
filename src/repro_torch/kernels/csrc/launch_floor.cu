// launch_floor: an empty kernel, one warp in one block.  It ports no TPU
// kernel and no path of the port launches it: chip_smoke.py times it with the
// same CUDA-graph harness as every kernel, so that each kernel's time can be
// read against the measured cost of a launch that does no work.
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_launch_floor(cudaStream_t stream) {
  launch_floor_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
