// Shared entry points of the port's kernel library (libkernels.so).
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
