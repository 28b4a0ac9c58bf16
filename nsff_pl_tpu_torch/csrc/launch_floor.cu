// An empty kernel, for the stopwatch's launch floor: its time on a grid
// is the least any kernel of that grid can take (the measurement scripts
// and chip_smoke.py time it on the packed compositor's grid). No training
// or serving path loads this library.
//
// Plain C interface (loaded with ctypes); launches on the given stream and
// returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int nsff_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}
