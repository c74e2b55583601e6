// Kernel K4: the collinearity keep plane of one view.
//
// Replaces line3d_tpu/match/collinearity_pallas.py:_kernel (:35, called from
// collinearity_keep_pallas :89), the candidate gate of the reference's
// K_collinearity (cudawrapper.cu:476-535): segments i and j are kept when
// the mutual maximum endpoint-to-line distance passes
//     max(n1^2, n2^2) <= thr^2 * den   (both ways),
// thr^2 = 2 sigma^2 ln(1/T) (1 + 1e-4), i.e. exp(-d^2 / 2 sigma^2) > T on
// squared distances with a tiny relative widening, when the segments do not
// overlap along their common direction (four endpoint dot products
// > -eps), both are valid, and i != j.  The plane is a SUPERSET of
// `collinearity_matrix > 0`; the affinity is recomputed and regated at the
// compacted pairs (match/collinearity.py:_pair_aff).  Built with
// -fmad=false so that the products round as in the reference.
//
// What bounds it on the H100: arithmetic, ~60 f32 operations per pair
// against one byte written.  Same structure as K1: a block covers 64
// partner segments x 4 row segments, each segment's line and squared
// normalizer are computed once into shared memory, and every thread
// evaluates one pair.  No sqrt, divide or exp in the pair loop.
#include "l3d_common.cuh"

namespace {

using l3d::kEps;

constexpr int kBT = 64;   // partner segments per block (threadIdx.x)
constexpr int kBS = 4;    // row segments per block (threadIdx.y)

enum { kX1, kY1, kX2, kY2, kLA, kLB, kLC, kDen, kMask, kNQ };

__device__ __forceinline__ void stage(const float* seg, bool in, uint8_t mask,
                                      float* q, int stride) {
  float v[kNQ];
  const float x1 = in ? seg[0] : 0.0f, y1 = in ? seg[1] : 0.0f;
  const float x2 = in ? seg[2] : 0.0f, y2 = in ? seg[3] : 0.0f;
  v[kX1] = x1; v[kY1] = y1; v[kX2] = x2; v[kY2] = y2;
  v[kLA] = y1 - y2;
  v[kLB] = x2 - x1;
  v[kLC] = x1 * y2 - y1 * x2;
  v[kDen] = v[kLA] * v[kLA] + v[kLB] * v[kLB];
  v[kMask] = (in && mask) ? 1.0f : 0.0f;
  for (int k = 0; k < kNQ; ++k) q[k * stride] = v[k];
}

__device__ __forceinline__ float dot2(float ux, float uy, float vx, float vy) {
  return ux * vx + uy * vy;
}

__global__ void __launch_bounds__(kBT * kBS)
collin_keep_kernel(const float* __restrict__ segs,
                   const uint8_t* __restrict__ mask, float thr_sq, int S,
                   uint8_t* __restrict__ out) {
  __shared__ float jq[kNQ][kBT];
  __shared__ float iq[kNQ][kBS];
  const int j0 = blockIdx.x * kBT;
  const int i0 = blockIdx.y * kBS;
  const int tid = threadIdx.y * kBT + threadIdx.x;
  if (tid < kBT) {
    const int j = j0 + tid;
    const bool in = j < S;
    stage(segs + static_cast<size_t>(in ? j : 0) * 4, in, in ? mask[j] : 0,
          &jq[0][tid], kBT);
  } else if (tid < kBT + kBS) {
    const int r = tid - kBT;
    const int i = i0 + r;
    const bool in = i < S;
    stage(segs + static_cast<size_t>(in ? i : 0) * 4, in, in ? mask[i] : 0,
          &iq[0][r], kBS);
  }
  __syncthreads();

  const int c = threadIdx.x, r = threadIdx.y;
  const int i = i0 + r, j = j0 + c;
  if (i >= S || j >= S) return;

  const float p1x = iq[kX1][r], p1y = iq[kY1][r];
  const float p2x = iq[kX2][r], p2y = iq[kY2][r];
  const float q1x = jq[kX1][c], q1y = jq[kY1][c];
  const float q2x = jq[kX2][c], q2y = jq[kY2][c];
  const float lia = iq[kLA][r], lib = iq[kLB][r], lic = iq[kLC][r];
  const float lja = jq[kLA][c], ljb = jq[kLB][c], ljc = jq[kLC][c];
  const float den_i = iq[kDen][r], den_j = jq[kDen][c];

  // mutual max endpoint-to-line distances (cudawrapper.cu:509-511) on
  // squared numerators
  const float n1 = lja * p1x + ljb * p1y + ljc;   // i's endpoints on j's line
  const float n2 = lja * p2x + ljb * p2y + ljc;
  const float m1 = lia * q1x + lib * q1y + lic;   // j's endpoints on i's line
  const float m2 = lia * q2x + lib * q2y + lic;
  const bool close = (fmaxf(n1 * n1, n2 * n2) <= thr_sq * den_j) &&
                     (fmaxf(m1 * m1, m2 * m2) <= thr_sq * den_i) &&
                     (den_i > kEps) && (den_j > kEps);

  // no-overlap check (cudawrapper.cu:518-528)
  const float pos1 = dot2(q1x - p1x, q1y - p1y, q2x - p1x, q2y - p1y);
  const float pos2 = dot2(q1x - p2x, q1y - p2y, q2x - p2x, q2y - p2y);
  const float pos3 = dot2(p1x - q1x, p1y - q1y, p2x - q1x, p2y - q1y);
  const float pos4 = dot2(p1x - q2x, p1y - q2y, p2x - q2x, p2y - q2y);
  const bool no_overlap = (pos1 > -kEps) && (pos2 > -kEps) &&
                          (pos3 > -kEps) && (pos4 > -kEps);

  const bool keep = close && no_overlap && (iq[kMask][r] > 0.5f) &&
                    (jq[kMask][c] > 0.5f) && (i != j);
  out[static_cast<size_t>(i) * S + j] = keep ? 1 : 0;
}

}  // namespace

// segs [S,4] f32, mask [S] u8, thr_sq -> out [S,S] u8 (0/1)
L3D_EXPORT int l3d_collin_keep(const void* segs, const void* mask,
                               float thr_sq, int S, void* out, void* stream) {
  if (S == 0) return 0;
  const dim3 block(kBT, kBS);
  const dim3 grid(l3d::div_up(S, kBT), l3d::div_up(S, kBS));
  collin_keep_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(segs), static_cast<const uint8_t*>(mask),
      thr_sq, S, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
