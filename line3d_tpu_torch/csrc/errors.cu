// Error text for the codes the launch functions return.
#include "l3d_common.cuh"

L3D_EXPORT const char* l3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
