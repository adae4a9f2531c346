// Shared C entry points of the kernel library.
//
// The library is built with nvcc into one shared object and loaded with
// ctypes (nemar_tpu_torch/ops/_build.py); every launcher returns the
// cudaError_t of its launches as an int, and the Python wrapper turns a
// non-zero code into an exception with the text below.
#include <cuda_runtime.h>

extern "C" const char* nemar_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
