// C entry points shared by every kernel of the library.
#include "common.cuh"

extern "C" const char* ppt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
