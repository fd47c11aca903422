// Names a CUDA error code returned by the kernel entry points.

#include <cuda_runtime.h>

extern "C" const char* vdb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
