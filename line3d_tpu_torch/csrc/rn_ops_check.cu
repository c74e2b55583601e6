// The check of pair_math.cuh's FastRnOps, which kernel K5 (pair_dense.cu)
// uses in place of the IEEE reciprocal and 1 / sqrt: over every float of
// FastRnOps' ranges, its results against IeeeOps' bit for bit.  Not a
// port of a TPU kernel; chip_smoke.py phase validate and a cuda test run
// it.
#include "pair_math.cuh"

namespace {

using namespace l3d;

// Every float x of FastRnOps' ranges, its fast paths against IeeeOps bit
// for bit.  counts: [floats with 2^-126 <= |x| < 2^126, rcp differing or
// marked slow, floats with 2^-100 <= x < 2^126, inv_sqrt differing or
// marked slow].
__global__ void __launch_bounds__(256)
rn_ops_check_kernel(unsigned long long* __restrict__ counts) {
  unsigned long long c[4] = {0, 0, 0, 0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t b = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       b < (1ull << 32); b += stride) {
    const float x = __uint_as_float(static_cast<uint32_t>(b));
    IeeeOps ieee;
    const float a = fabsf(x);
    if (a >= 0x1p-126f && a < 0x1p126f) {
      FastRnOps fast;
      const float r = fast.rcp(x);
      ++c[0];
      c[1] += fast.slow || __float_as_uint(r) != __float_as_uint(ieee.rcp(x));
    }
    if (x >= 0x1p-100f && x < 0x1p126f) {
      FastRnOps fast;
      const float q = fast.inv_sqrt(x);
      ++c[2];
      c[3] += fast.slow ||
              __float_as_uint(q) != __float_as_uint(ieee.inv_sqrt(x));
    }
  }
  for (int k = 0; k < 4; ++k) {
    for (int off = 16; off > 0; off >>= 1)
      c[k] += __shfl_down_sync(0xffffffffu, c[k], off);
    if ((threadIdx.x & 31) == 0) atomicAdd(&counts[k], c[k]);
  }
}

}  // namespace

// counts [4] u64, zeroed by the caller: FastRnOps against IeeeOps over
// every float (rn_ops_check_kernel)
L3D_EXPORT int l3d_rn_ops_check(void* counts, void* stream) {
  rn_ops_check_kernel<<<132 * 8, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
