// Kernels K2 + K3: multi-view support scoring of one view's match table.
//
// Replaces line3d_tpu/match/scoring_pallas.py:_kernel_tiled (:239, K2, the
// M > 256 form, called at :520) and _kernel (:212, K3, the untiled M <= 256
// form, called at :453), whose shared body is _conf_plane (:71-209).  One
// kernel serves both: the card has no VMEM limit that would force two
// forms.  Same semantics as the reference's K_verify_matches
// (cudawrapper.cu:614-714): for source segment s and scored match m,
//   conf(m2, m) = exp(-max(dist^2 / 2 sigma_p^2, ang^2 / 2 sigma_a^2))
// over the other matches m2 of s, where the hypothesis of m (its depths on
// s's two endpoint rays) is projected into m2's camera -- affine in the
// depth through the per-camera tables atab / btab -- and compared with m2's
// target segment both ways (max point-to-line distance), and ang is the 3D
// angle between the two hypotheses.  A support counts when the depth-delta
// spatial gate holds, both slots are valid, m2 != m and conf > support_t;
// the result is the sum over cameras != cam[m] of the per-camera maximum.
//
// The angle is acosf in degrees, folded to [0, 90], as the plain twin
// (match/scoring.py) and the XLA twin of line3d_tpu compute it with arccos;
// the Pallas kernel uses the Abramowitz & Stegun 4.4.46 polynomial instead.
// The affine-in-depth projection rounds differently from the twin's
// projection of 3D points: a point-to-line distance of a few pixels is a
// difference of coordinates near a thousand pixels, so the two confidences
// differ by some 1e-5, and a support whose confidence sits that close to
// support_t counts on one side only.
//
// need[s] = 1 + the last valid slot of row s.  The merge packs valid slots
// first, so slots >= need are empty; the kernel relies only on every valid
// slot lying below need, so rows with gaps are scored correctly too.
//
// What bounds it on the H100: arithmetic -- ~80 f32 operations, one exp,
// one acos and one sqrt per (m2, m) pair, sum_s need_s^2 pairs per view --
// against a [S, 16, M] input that is read once per m-tile.  Design: one block of 128
// threads per (s, 128-wide m tile); each thread owns one scored match and
// keeps its row quantities in registers.  The block walks the m2 axis in
// 128-wide tiles up to need[s]: the threads first stage the tile's 16
// per-match planes and derive the per-m2 camera coefficients (the affine
// projection terms and the point-to-line numerators) into shared memory,
// then every thread loops over the tile.  The per-camera maxima live in
// shared memory, one column per thread (no bank conflicts, no atomics).
// m tiles at or past need[s] do no work.
#include "l3d_common.cuh"

namespace {

using l3d::kEps;

constexpr int kT = 128;         // m tile = m2 tile = threads per block
constexpr int kMaxCams = 32;    // compiled-in neighbor-camera limit

// pm plane slots (scoring_pallas.py:60-64)
enum { kD1 = 0, kD2, kCam, kValid, kTLX, kTLY, kTLZ, kITDen,
       kQ1X, kQ1Y, kQ2X, kQ2Y, kDirX, kDirY, kDirZ, kPM = 16 };

// per-m2 quantities staged in shared memory
enum { cD1, cD2, cQ1X, cQ1Y, cQ2X, cQ2Y, cDX, cDY, cDZ,
       cAX, cAY, cAZ, cBX1, cBY1, cBZ1, cBX2, cBY2, cBZ2, cU0, cU1, cU2,
       kNC };

// 180/pi in f32, the factor torch.rad2deg applies
constexpr float kRad2Deg = static_cast<float>(57.29577951308232);

__global__ void __launch_bounds__(kT)
score_kernel(const float* __restrict__ pm, const float* __restrict__ btab,
             const float* __restrict__ atab,
             const float* __restrict__ params,
             const int* __restrict__ need, int N, int M,
             float* __restrict__ out) {
  __shared__ float col[kNC][kT];
  __shared__ int ccam[kT];
  __shared__ float acc[kMaxCams][kT];
  __shared__ float sa[3 * kMaxCams];
  __shared__ float sb[6 * kMaxCams];

  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int m = blockIdx.x * kT + tid;
  const float* P = pm + static_cast<size_t>(s) * kPM * M;
  const int nd = need[s];

  const float inv_sig_p2 = params[0];
  const float inv_sig_a2 = params[1];
  const float spatial_k = params[2];
  const float support_t = params[3];

  for (int n = 0; n < N; ++n) acc[n][tid] = 0.0f;
  for (int k = tid; k < 3 * N; k += kT) sa[k] = atab[k];
  for (int k = tid; k < 6 * N; k += kT)
    sb[k] = btab[static_cast<size_t>(s) * 6 * N + k];

  const bool in_row = m < M;
  const float d1r = in_row ? P[kD1 * M + m] : 0.0f;
  const float d2r = in_row ? P[kD2 * M + m] : 0.0f;
  const float camr = in_row ? P[kCam * M + m] : -1.0f;
  const bool valid_r = in_row && (P[kValid * M + m] > 0.5f);
  const float dxr = in_row ? P[kDirX * M + m] : 0.0f;
  const float dyr = in_row ? P[kDirY * M + m] : 0.0f;
  const float dzr = in_row ? P[kDirZ * M + m] : 0.0f;
  __syncthreads();

  if (blockIdx.x * kT < nd) {           // uniform over the block
    for (int t0 = 0; t0 < nd; t0 += kT) {
      // stage the m2 tile: its planes and per-camera coefficients
      const int m2 = t0 + tid;
      int c2 = -1;
      float v[kNC];
      for (int k = 0; k < kNC; ++k) v[k] = 0.0f;
      if (m2 < nd) {
        const float camf = P[kCam * M + m2];
        const bool val = P[kValid * M + m2] > 0.5f;
        const int ci = static_cast<int>(camf);
        const bool in_cam = camf >= 0.0f && ci < N &&
                            static_cast<float>(ci) == camf;
        v[cD1] = P[kD1 * M + m2];
        v[cD2] = P[kD2 * M + m2];
        v[cQ1X] = P[kQ1X * M + m2];
        v[cQ1Y] = P[kQ1Y * M + m2];
        v[cQ2X] = P[kQ2X * M + m2];
        v[cQ2Y] = P[kQ2Y * M + m2];
        v[cDX] = P[kDirX * M + m2];
        v[cDY] = P[kDirY * M + m2];
        v[cDZ] = P[kDirZ * M + m2];
        if (in_cam) {
          for (int k = 0; k < 3; ++k) v[cAX + k] = sa[ci * 3 + k];
          for (int k = 0; k < 6; ++k) v[cBX1 + k] = sb[ci * 6 + k];
        }
        const float tlx = P[kTLX * M + m2], tly = P[kTLY * M + m2];
        const float tlz = P[kTLZ * M + m2], itd = P[kITDen * M + m2];
        v[cU0] = (tlx * v[cAX] + tly * v[cAY] + tlz * v[cAZ]) * itd;
        v[cU1] = (tlx * v[cBX1] + tly * v[cBY1] + tlz * v[cBZ1]) * itd;
        v[cU2] = (tlx * v[cBX2] + tly * v[cBY2] + tlz * v[cBZ2]) * itd;
        if (val && in_cam) c2 = ci;
      }
      for (int k = 0; k < kNC; ++k) col[k][tid] = v[k];
      ccam[tid] = c2;
      __syncthreads();

      const int cnt = min(kT, nd - t0);
      if (valid_r) {
        for (int j = 0; j < cnt; ++j) {
          const int cj = ccam[j];
          if (cj < 0 || t0 + j == m) continue;
          // spatial gate: hypotheses share the src rays => depth-delta test
          // (cudawrapper.cu:387-401)
          if (!(fabsf(d1r - col[cD1][j]) <= spatial_k * d1r &&
                fabsf(d2r - col[cD2][j]) <= spatial_k * d2r))
            continue;
          const float az = col[cAZ][j];
          const float Z1 = az + d1r * col[cBZ1][j];
          const float Z2 = az + d2r * col[cBZ2][j];
          if (!(fabsf(Z1) > kEps && fabsf(Z2) > kEps)) continue;
          // point-to-target-line distances, numerator affine in depth
          const float U0 = col[cU0][j];
          const float da1 = fabsf((U0 + d1r * col[cU1][j]) / Z1);
          const float da2 = fabsf((U0 + d2r * col[cU2][j]) / Z2);
          // target points to the projected line (undivided homogeneous
          // cross product: the qz factors cancel)
          const float ax = col[cAX][j], ay = col[cAY][j];
          const float q1x = ax + d1r * col[cBX1][j];
          const float q1y = ay + d1r * col[cBY1][j];
          const float q2x = ax + d2r * col[cBX2][j];
          const float q2y = ay + d2r * col[cBY2][j];
          const float PLx = q1y * Z2 - q2y * Z1;
          const float PLy = q2x * Z1 - q1x * Z2;
          const float PLz = q1x * q2y - q1y * q2x;
          const float rden =
              1.0f / sqrtf(fmaxf(PLx * PLx + PLy * PLy, kEps * kEps));
          const float db1 =
              fabsf(PLx * col[cQ1X][j] + PLy * col[cQ1Y][j] + PLz) * rden;
          const float db2 =
              fabsf(PLx * col[cQ2X][j] + PLy * col[cQ2Y][j] + PLz) * rden;
          const float dist = fmaxf(fmaxf(da1, da2), fmaxf(db1, db2));
          const float y_pos = dist * dist * inv_sig_p2;
          // 3D angle term (cudawrapper.cu:405-415)
          const float dots =
              col[cDX][j] * dxr + col[cDY][j] * dyr + col[cDZ][j] * dzr;
          float ang = acosf(fminf(fmaxf(dots, -1.0f), 1.0f)) * kRad2Deg;
          if (ang > 90.0f) ang = 180.0f - ang;
          const float y_ang = ang * ang * inv_sig_a2;
          const float conf = expf(-fmaxf(y_pos, y_ang));
          if (conf > support_t) acc[cj][tid] = fmaxf(acc[cj][tid], conf);
        }
      }
      __syncthreads();
    }
  }

  if (in_row) {
    // per-camera maxima summed over cameras != cam[m]
    float total = 0.0f;
    for (int n = 0; n < N; ++n)
      total = total + ((camr == static_cast<float>(n)) ? 0.0f : acc[n][tid]);
    out[static_cast<size_t>(s) * M + m] = valid_r ? total : 0.0f;
  }
}

}  // namespace

// pm [S,16,M] f32, btab [S,6N] f32, atab [3N] f32,
// params [4] f32 (1/2sp^2, 1/2sa^2, spatial_k, support_t), need [S] i32
// -> out [S,M] f32.  Returns cudaErrorInvalidValue for N > kMaxCams.
L3D_EXPORT int l3d_score(const void* pm, const void* btab, const void* atab,
                         const void* params, const void* need, int N, int S,
                         int M, void* out, void* stream) {
  if (N > kMaxCams || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || M == 0) return 0;
  const dim3 grid(l3d::div_up(M, kT), S);
  score_kernel<<<grid, kT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pm), static_cast<const float*>(btab),
      static_cast<const float*>(atab), static_cast<const float*>(params),
      static_cast<const int*>(need), N, M, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
