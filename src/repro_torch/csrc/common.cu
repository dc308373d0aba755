// Shared entry points of the port's kernel library (libkernels.so).
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// An empty kernel, one block of 32 threads.  It replaces no TPU kernel: it
// exists to time the device's fixed cost of a launch replayed from a CUDA
// graph (kernels/timing.py::launch_floor_ms), the floor under which no
// standalone launch of a kernel's can fall.
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int launch_floor(void* stream) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
