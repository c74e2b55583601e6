// Kernel K6: the card's float32 FMA rate, outside the tensor cores.
//
// Replaces the Pallas probe in bench.py:_measure_vpu_peak (:353, kernel
// :376-391, pallas_call :398), which ran two chained FMA streams over a
// VMEM-resident [256, 512] f32 block to measure the TPU's vector unit.
// Same chain, v = v * a + b, redesigned for Hopper:
//
//   * every thread runs kChains independent chains, kUnroll steps per
//     loop trip, so each warp has kChains FMAs in flight and the 4-cycle
//     FMA latency hides behind the other chains and the other warps
//     (the wrapper launches a full SM's worth of threads on every SM);
//   * each step is an explicit fmaf: the library is built with
//     -fmad=false, which would otherwise split v * a + b into a multiply
//     and an add (two instructions, two roundings);
//   * a and b arrive at run time and each thread writes the sum of its
//     chains, so the compiler can neither fold nor drop the chain.
//
// What bounds it: FMA issue (128 float32 lanes per SM per cycle), nothing
// else.  The inputs are read once and one float per thread is written.
#include "l3d_common.cuh"

namespace {

constexpr int kChains = 8;
constexpr int kUnroll = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fma_peak_kernel(const float* __restrict__ x, float a, float b, int trips,
                int n, float* __restrict__ out) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n) return;
  float v[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
    v[c] = x[static_cast<size_t>(tid) * kChains + c];
  for (int r = 0; r < trips; ++r) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) v[c] = fmaf(v[c], a, b);
    }
  }
  float acc = v[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) acc = acc + v[c];
  out[tid] = acc;
}

}  // namespace

// x [n, 8] f32 chain starts -> out [n] f32; each of the n threads runs 8
// chains of 16 * trips steps
L3D_EXPORT int l3d_fma_peak(const void* x, float a, float b, int trips, int n,
                            void* out, void* stream) {
  if (n == 0) return 0;
  fma_peak_kernel<<<l3d::div_up(n, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), a, b, trips, n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
