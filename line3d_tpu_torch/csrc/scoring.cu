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
// The kernel reads the match table as the engine holds it (cam [S, M],
// depths [S, M, 4], valid [S, M], the target coordinates [S, M, 4]) and
// derives everything else itself: the source rays, the per-camera tables
// atab / btab, and per slot the target line, its inverse norm and the unit
// hypothesis direction -- the arithmetic of match/scoring.py's slot_terms
// and kernel_inputs term for term (-fmad=false, IEEE divides, sqrtf
// correctly rounded as core.geometry.sqrt).  There is no host-side prep.
//
// What bounds it on the H100: the gate work.  A dense walk tests
// sum_s need_s^2 (m, m2) pairs (1.2e8 at facade view 0) of which 0.4% pass
// the spatial gate |d1 - d1'| <= k d1.  Design: one block per row s.  The
// block stages the row's valid slots, sorts their d1 keys with a bitonic
// sort, and writes each slot's columns in sorted order; each thread then
// takes slots m and binary-searches the run of sorted keys that can pass
// the d1 gate (the passing set of that exact expression is one contiguous
// run, since rounding is monotone), and tests only that run with the full
// gate.  Work falls to sum need log need plus the survivors.  The
// per-camera maximum is order-free and the sum over cameras keeps its
// fixed order, so the result is the bits of the dense walk.  A row's sort
// keys and columns live in shared memory (60 bytes a slot); when M is too
// wide for that, in a global scratch buffer the wrapper allocates, walked
// by a grid of kGlobalBlocks blocks.
#include "l3d_common.cuh"

namespace {

using l3d::kEps;

constexpr int kThreads = 256;      // threads per block (one row per block)
constexpr int kMaxCams = 32;       // neighbor-camera limit of the wrapper
constexpr int kGlobalBlocks = 256; // blocks of the global-scratch form

// per-slot columns, stored in sorted d1 order
enum { cD1, cD2, cCam, cQ1X, cQ1Y, cQ2X, cQ2Y, cDX, cDY, cDZ, cU0, cU1, cU2,
       kNC };
// a staged slot: its 64-bit sort key and its columns
constexpr int kSlotBytes = 8 + 4 * kNC;

// 180/pi in f32, the factor torch.rad2deg applies
constexpr float kRad2Deg = static_cast<float>(57.29577951308232);

// torch's clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// a float's place in the total order of non-NaN floats, as an unsigned int
__device__ __forceinline__ uint32_t order_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__host__ __device__ inline int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// bytes of dynamic shared memory besides the staged slots: atab [3N],
// btab row [6N], per-thread camera maxima [N][kThreads], the two source
// rays, the slot counter
__host__ __device__ inline size_t fixed_bytes(int N) {
  const size_t b = 4 * (static_cast<size_t>(9 + kThreads) * N + 8);
  return (b + 15) / 16 * 16;
}

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
score_kernel(const int* __restrict__ cam, const float* __restrict__ depths,
             const uint8_t* __restrict__ valid,
             const float* __restrict__ tcoords,
             const float* __restrict__ segs_src,
             const float* __restrict__ RtKinv, const float* __restrict__ C,
             const float* __restrict__ P_nb, float inv_sig_p2,
             float inv_sig_a2, float spatial_k, float support_t, int S, int M,
             int N, int cap, char* __restrict__ scratch,
             float* __restrict__ out) {
  extern __shared__ __align__(16) char dsmem[];
  float* sa = reinterpret_cast<float*>(dsmem);
  float* sb = sa + 3 * N;
  float* acc = sb + 6 * N;                 // acc[n * kThreads + tid]
  float* ray = acc + N * kThreads;         // ray1 (0..2), ray2 (3..5)
  int* cnt = reinterpret_cast<int*>(ray + 6);
  uint64_t* keys;
  float* col;
  if (kGlobal) {
    keys = reinterpret_cast<uint64_t*>(scratch) +
           static_cast<size_t>(blockIdx.x) * cap;
    col = reinterpret_cast<float*>(scratch + static_cast<size_t>(gridDim.x) *
                                                 cap * 8) +
          static_cast<size_t>(blockIdx.x) * kNC * cap;
  } else {
    keys = reinterpret_cast<uint64_t*>(dsmem + fixed_bytes(N));
    col = reinterpret_cast<float*>(dsmem + fixed_bytes(N) +
                                   static_cast<size_t>(cap) * 8);
  }
  const int tid = threadIdx.x;
  float* my_acc = acc + tid;

  // atab: projection of C into camera n (scoring.py:kernel_inputs)
  for (int k = tid; k < 3 * N; k += kThreads) {
    const float* p = P_nb + (k / 3) * 12 + (k % 3) * 4;
    sa[k] = p[0] * C[0] + p[1] * C[1] + p[2] * C[2] + p[3];
  }

  for (int s = blockIdx.x; s < S; s += gridDim.x) {
    // the source rays (core.geometry.ray_dir) and the row's btab
    if (tid < 2) {
      float rx, ry, rz;
      l3d::mat3_xy1(RtKinv, segs_src[s * 4 + 2 * tid],
                    segs_src[s * 4 + 2 * tid + 1], rx, ry, rz);
      const float nrm = clamp_min(sqrtf(rx * rx + ry * ry + rz * rz), kEps);
      ray[3 * tid] = rx / nrm;
      ray[3 * tid + 1] = ry / nrm;
      ray[3 * tid + 2] = rz / nrm;
    }
    if (tid == 0) *cnt = 0;
    __syncthreads();
    for (int k = tid; k < 6 * N; k += kThreads) {
      const int e = k % 6;
      const float* p = P_nb + (k / 6) * 12 + (e % 3) * 4;
      const float* r = ray + 3 * (e / 3);
      sb[k] = p[0] * r[0] + p[1] * r[1] + p[2] * r[2];
    }

    // stage the valid slots' sort keys: d1's order bits, then the slot.
    // A NaN d1 never passes the gate and is left out; every slot that is
    // not staged scores 0.
    const size_t row = static_cast<size_t>(s) * M;
    for (int m = tid; m < M; m += kThreads) {
      bool staged = false;
      if (valid[row + m]) {
        const float d1 = depths[(row + m) * 4];
        if (!isnan(d1)) {
          const int pos = atomicAdd(cnt, 1);
          keys[pos] = (static_cast<uint64_t>(order_bits(d1)) << 32) |
                      static_cast<uint32_t>(m);
          staged = true;
        }
      }
      if (!staged) out[row + m] = 0.0f;
    }
    __syncthreads();
    const int nv = *cnt;
    const int P = pow2_ceil(nv);
    for (int k = nv + tid; k < P; k += kThreads) keys[k] = ~0ull;
    __syncthreads();

    // bitonic sort of keys[0, P), ascending
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = tid; t < P / 2; t += kThreads) {
          const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          const uint64_t a = keys[i], b = keys[i + j];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[i + j] = a;
          }
        }
        __syncthreads();
      }
    }

    // columns in sorted order (scoring.py:slot_terms, _unit_dirs)
    for (int p = tid; p < nv; p += kThreads) {
      const size_t o = row + static_cast<uint32_t>(keys[p]);
      const float d1 = depths[o * 4], d2 = depths[o * 4 + 1];
      const int c = cam[o];
      const bool in_cam = c >= 0 && c < N;
      const float q1x = tcoords[o * 4], q1y = tcoords[o * 4 + 1];
      const float q2x = tcoords[o * 4 + 2], q2y = tcoords[o * 4 + 3];
      const float dx = d2 * ray[3] - d1 * ray[0];
      const float dy = d2 * ray[4] - d1 * ray[1];
      const float dz = d2 * ray[5] - d1 * ray[2];
      const float dn = clamp_min(sqrtf(dx * dx + dy * dy + dz * dz), kEps);
      const float tlx = q1y - q2y;
      const float tly = q2x - q1x;
      const float tlz = q1x * q2y - q1y * q2x;
      const float itd =
          1.0f / clamp_min(sqrtf(tlx * tlx + tly * tly), kEps);
      float a[3] = {0.0f, 0.0f, 0.0f}, b[6] = {0.0f, 0.0f, 0.0f,
                                                0.0f, 0.0f, 0.0f};
      if (in_cam) {
        for (int k = 0; k < 3; ++k) a[k] = sa[c * 3 + k];
        for (int k = 0; k < 6; ++k) b[k] = sb[c * 6 + k];
      }
      col[cD1 * cap + p] = d1;
      col[cD2 * cap + p] = d2;
      col[cCam * cap + p] = __int_as_float(in_cam ? c : -1);
      col[cQ1X * cap + p] = q1x;
      col[cQ1Y * cap + p] = q1y;
      col[cQ2X * cap + p] = q2x;
      col[cQ2Y * cap + p] = q2y;
      col[cDX * cap + p] = dx / dn;
      col[cDY * cap + p] = dy / dn;
      col[cDZ * cap + p] = dz / dn;
      col[cU0 * cap + p] = (tlx * a[0] + tly * a[1] + tlz * a[2]) * itd;
      col[cU1 * cap + p] = (tlx * b[0] + tly * b[1] + tlz * b[2]) * itd;
      col[cU2 * cap + p] = (tlx * b[3] + tly * b[4] + tlz * b[5]) * itd;
    }
    __syncthreads();

    const float* D1 = col + cD1 * cap;
    const float* D2 = col + cD2 * cap;
    for (int p = tid; p < nv; p += kThreads) {
      const float d1r = D1[p], d2r = D2[p];
      const int camr = __float_as_int(col[cCam * cap + p]);
      const float dxr = col[cDX * cap + p], dyr = col[cDY * cap + p];
      const float dzr = col[cDZ * cap + p];
      const float t1 = spatial_k * d1r;
      // the run of sorted keys that can pass fabsf(d1r - d1') <= t1: its
      // first key is the first with d1' >= d1r or passing, its end the
      // first with d1' > d1r and failing (both predicates are monotone
      // over the sorted keys)
      int lo = 0, hi = nv;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const float x = D1[mid];
        if (x >= d1r || fabsf(d1r - x) <= t1) hi = mid; else lo = mid + 1;
      }
      int end = nv;
      for (int a = lo; a < end;) {
        const int mid = (a + end) >> 1;
        const float x = D1[mid];
        if (x > d1r && !(fabsf(d1r - x) <= t1)) end = mid; else a = mid + 1;
      }

      for (int n = 0; n < N; ++n) my_acc[n * kThreads] = 0.0f;
      for (int q = lo; q < end; ++q) {
        const int cj = __float_as_int(col[cCam * cap + q]);
        if (cj < 0 || q == p) continue;
        // spatial gate: hypotheses share the src rays => depth-delta test
        // (cudawrapper.cu:387-401)
        if (!(fabsf(d1r - D1[q]) <= spatial_k * d1r &&
              fabsf(d2r - D2[q]) <= spatial_k * d2r))
          continue;
        const float ax = sa[cj * 3], ay = sa[cj * 3 + 1];
        const float az = sa[cj * 3 + 2];
        const float* bq = sb + cj * 6;
        const float Z1 = az + d1r * bq[2];
        const float Z2 = az + d2r * bq[5];
        if (!(fabsf(Z1) > kEps && fabsf(Z2) > kEps)) continue;
        // point-to-target-line distances, numerator affine in depth
        const float U0 = col[cU0 * cap + q];
        const float da1 = fabsf((U0 + d1r * col[cU1 * cap + q]) / Z1);
        const float da2 = fabsf((U0 + d2r * col[cU2 * cap + q]) / Z2);
        // target points to the projected line (undivided homogeneous
        // cross product: the qz factors cancel)
        const float q1x = ax + d1r * bq[0];
        const float q1y = ay + d1r * bq[1];
        const float q2x = ax + d2r * bq[3];
        const float q2y = ay + d2r * bq[4];
        const float PLx = q1y * Z2 - q2y * Z1;
        const float PLy = q2x * Z1 - q1x * Z2;
        const float PLz = q1x * q2y - q1y * q2x;
        const float rden =
            1.0f / sqrtf(fmaxf(PLx * PLx + PLy * PLy, kEps * kEps));
        const float db1 = fabsf(PLx * col[cQ1X * cap + q] +
                                PLy * col[cQ1Y * cap + q] + PLz) * rden;
        const float db2 = fabsf(PLx * col[cQ2X * cap + q] +
                                PLy * col[cQ2Y * cap + q] + PLz) * rden;
        const float dist = fmaxf(fmaxf(da1, da2), fmaxf(db1, db2));
        const float y_pos = dist * dist * inv_sig_p2;
        // 3D angle term (cudawrapper.cu:405-415)
        const float dots = col[cDX * cap + q] * dxr +
                           col[cDY * cap + q] * dyr + col[cDZ * cap + q] * dzr;
        float ang = acosf(fminf(fmaxf(dots, -1.0f), 1.0f)) * kRad2Deg;
        if (ang > 90.0f) ang = 180.0f - ang;
        const float y_ang = ang * ang * inv_sig_a2;
        const float conf = expf(-fmaxf(y_pos, y_ang));
        if (conf > support_t)
          my_acc[cj * kThreads] = fmaxf(my_acc[cj * kThreads], conf);
      }
      // per-camera maxima summed over cameras != cam[m]
      float total = 0.0f;
      for (int n = 0; n < N; ++n)
        total = total + ((camr == n) ? 0.0f : my_acc[n * kThreads]);
      out[row + static_cast<uint32_t>(keys[p])] = total;
    }
    __syncthreads();   // the next row reuses the tables and the slots
  }
}

// The launch shape for (M, N) on device `dev`: 0 bytes of scratch when a
// row's slots fit the block's shared memory, else the scratch bytes of
// the global form.  Returns a CUDA error code.
int layout(int M, int N, int S, int dev, size_t* smem, size_t* scratch,
           int* grid) {
  int max_smem = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cap = pow2_ceil(M);
  const size_t fixed = fixed_bytes(N);
  const size_t rows = static_cast<size_t>(cap) * kSlotBytes;
  if (fixed + rows <= static_cast<size_t>(max_smem)) {
    *smem = fixed + rows;
    *scratch = 0;
    *grid = S;
  } else {
    *smem = fixed;
    *grid = S < kGlobalBlocks ? S : kGlobalBlocks;
    *scratch = rows * static_cast<size_t>(*grid);
  }
  return 0;
}

template <bool kGlobal>
int launch(const void* cam, const void* depths, const void* valid,
           const void* tcoords, const void* segs_src, const void* RtKinv,
           const void* C, const void* P_nb, float isp2, float isa2, float k,
           float t, int N, int S, int M, size_t smem, int grid, void* scratch,
           void* out, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      score_kernel<kGlobal>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  score_kernel<kGlobal><<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cam), static_cast<const float*>(depths),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(tcoords),
      static_cast<const float*>(segs_src), static_cast<const float*>(RtKinv),
      static_cast<const float*>(C), static_cast<const float*>(P_nb), isp2,
      isa2, k, t, S, M, N, pow2_ceil(M), static_cast<char*>(scratch),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch bytes l3d_score needs for (M, N, S) on device `dev` (0 when a
// row fits shared memory), or -(CUDA error code).
L3D_EXPORT long long l3d_score_scratch_bytes(int M, int N, int S, int dev) {
  size_t smem, scratch;
  int grid;
  if (M <= 0 || S <= 0) return 0;
  const int rc = layout(M, N, S, dev, &smem, &scratch, &grid);
  return rc ? -static_cast<long long>(rc) : static_cast<long long>(scratch);
}

// cam [S,M] i32, depths [S,M,4] f32, valid [S,M] u8, tcoords [S,M,4] f32,
// segs_src [S,4] f32, RtKinv [3,3] f32, C [3] f32, P_nb [N,3,4] f32,
// scalars 1/2sp^2, 1/2sa^2, spatial_k, support_t, scratch of
// l3d_score_scratch_bytes -> out [S,M] f32.  Returns
// cudaErrorInvalidValue for N > kMaxCams or missing scratch.
L3D_EXPORT int l3d_score(const void* cam, const void* depths,
                         const void* valid, const void* tcoords,
                         const void* segs_src, const void* RtKinv,
                         const void* C, const void* P_nb, float isp2,
                         float isa2, float k, float t, int N, int S, int M,
                         void* scratch, void* out, int dev, void* stream) {
  if (N > kMaxCams || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || M == 0) return 0;
  size_t smem, need;
  int grid;
  const int rc = layout(M, N, S, dev, &smem, &need, &grid);
  if (rc) return rc;
  if (need == 0)
    return launch<false>(cam, depths, valid, tcoords, segs_src, RtKinv, C,
                         P_nb, isp2, isa2, k, t, N, S, M, smem, grid, nullptr,
                         out, stream);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(cam, depths, valid, tcoords, segs_src, RtKinv, C, P_nb,
                      isp2, isa2, k, t, N, S, M, smem, grid, scratch, out,
                      stream);
}
