// Shared definitions of the port's CUDA kernels (built for sm_90a with
// -fmad=false; see line3d_tpu_torch/native/cuda.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define L3D_EXPORT extern "C" __attribute__((visibility("default")))

namespace l3d {

// L3D_EPS_G (cudawrapper.h:43), rounded to f32 as the reference kernels do
constexpr float kEps = 1e-12f;

__host__ __device__ inline int div_up(int a, int b) { return (a + b - 1) / b; }

// M @ (x, y, 1) for a row-major 3x3 M
__device__ __forceinline__ void mat3_xy1(const float* M, float x, float y,
                                         float& a, float& b, float& c) {
  a = M[0] * x + M[1] * y + M[2];
  b = M[3] * x + M[4] * y + M[5];
  c = M[6] * x + M[7] * y + M[8];
}

// M^T @ (x, y, 1) for a row-major 3x3 M
__device__ __forceinline__ void mat3t_xy1(const float* M, float x, float y,
                                          float& a, float& b, float& c) {
  a = M[0] * x + M[3] * y + M[6];
  b = M[1] * x + M[4] * y + M[7];
  c = M[2] * x + M[5] * y + M[8];
}

}  // namespace l3d
