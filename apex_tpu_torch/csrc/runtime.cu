// The kernel library's error reporting: every launcher returns a
// cudaError_t as an int, and the Python side turns it into text here.
#include <cuda_runtime.h>

extern "C" const char* apex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
