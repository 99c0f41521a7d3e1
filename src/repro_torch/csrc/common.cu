// Shared C entry of the port's kernel library: CUDA error text for the
// Python wrappers, which raise with it when a launcher returns nonzero.
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
