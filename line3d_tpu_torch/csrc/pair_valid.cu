// Kernel K1: the pairwise match valid plane, for N neighbor views at once.
//
// Replaces line3d_tpu/match/pairwise_pallas.py:_kernel_valid (:216, body
// _compute :44-200 with signs_only=True, called from
// match_pair_valid_pallas :290).  Same semantics as the reference's
// K_pairwise_matches (cudawrapper.cu:538-611): for every (source segment s,
// target segment t) of one (view, neighbor) pair, the epipolar transfer of
// both segments' endpoints through F, the four line intersections, the
// mutual 2D overlap gate (min > lo, max > hi) and the signs of the four
// two-ray triangulation depths, plus the segment masks.
//
// Arithmetic follows the Pallas body term for term: the overlap ratios are
// kept as (numerator, denominator) pairs of SQUARED distances and compared
// cross-multiplied, and a depth's sign is taken as sign(num * denom) with
// no divide.  Built with -fmad=false so that every a*b + c rounds twice,
// as in the reference.
//
// What bounds it on the H100: arithmetic.  Each pair costs ~400 f32
// operations (four intersections, eight divide-free ray normalizations,
// four triangulations) and writes one byte, so the plane is far above the
// card's bytes-per-operation line.  The design keeps the per-segment work
// out of the pair loop: a block covers 64 targets x 4 sources, the first
// threads compute each target's and source's line, epipolar lines and
// endpoint rays once into shared memory, and every thread then evaluates
// one pair from those.  Rows of one neighbor are independent, and the N
// neighbors of a view ride the grid's z axis in one launch.
#include "l3d_common.cuh"

namespace {

using l3d::kEps;

constexpr int kBT = 64;   // targets per block (threadIdx.x)
constexpr int kBS = 4;    // sources per block (threadIdx.y)
constexpr int kNP = 35;   // F, RtKinv_src, RtKinv_tgt, C_src, C_tgt, lo, hi

// per-segment quantities staged in shared memory
enum {
  kX1, kY1, kX2, kY2,           // endpoints
  kLA, kLB, kLC,                // supporting line
  kE1A, kE1B, kE1C,             // epipolar line of endpoint 1 in the other view
  kE2A, kE2B, kE2C,             // epipolar line of endpoint 2
  kR1X, kR1Y, kR1Z,             // normalized ray through endpoint 1
  kR2X, kR2Y, kR2Z,             // normalized ray through endpoint 2
  kMask,
  kNQ
};

__device__ __forceinline__ void ray_n(const float* M, float x, float y,
                                      float& rx, float& ry, float& rz) {
  l3d::mat3_xy1(M, x, y, rx, ry, rz);
  const float inv = 1.0f / sqrtf(fmaxf(rx * rx + ry * ry + rz * rz, kEps));
  rx = rx * inv;
  ry = ry * inv;
  rz = rz * inv;
}

// cross(line l, line m), normalized to z = 1 (zero when |z| <= eps)
__device__ __forceinline__ bool intersect(float la, float lb, float lc,
                                          float ma, float mb, float mc,
                                          float& x, float& y) {
  const float ix = lb * mc - lc * mb;
  const float iy = lc * ma - la * mc;
  const float iz = la * mb - lb * ma;
  const bool ok = fabsf(iz) > kEps;
  const float inv = 1.0f / (ok ? iz : 1.0f);
  x = ok ? ix * inv : 0.0f;
  y = ok ? iy * inv : 0.0f;
  return ok;
}

__device__ __forceinline__ float d2(float ux, float uy, float vx, float vy) {
  return (ux - vx) * (ux - vx) + (uy - vy) * (uy - vy);
}

__device__ __forceinline__ bool on_seg(float px, float py, float qx, float qy,
                                       float rx, float ry) {
  return (px - rx) * (qx - rx) + (py - ry) * (qy - ry) < kEps;
}

// Overlap of segment (c, d) with segment (a, b) as a (num, den) ratio of
// squared distances (pairwise_pallas.py:106-141).
__device__ __forceinline__ void overlap_sq_nd(float ax, float ay, float bx,
                                              float by, float cx, float cy,
                                              float dx, float dy, float& num,
                                              float& den) {
  const float kEps2 = kEps * kEps;
  const float len2_ab = d2(ax, ay, bx, by);
  const float len2_cd = d2(cx, cy, dx, dy);
  const bool c_in = on_seg(ax, ay, bx, by, cx, cy);
  const bool d_in = on_seg(ax, ay, bx, by, dx, dy);
  const bool a_in = on_seg(cx, cy, dx, dy, ax, ay);
  const bool b_in = on_seg(cx, cy, dx, dy, bx, by);
  const float l31 = d2(bx, by, dx, dy);
  const float l32 = d2(ax, ay, dx, dy);
  const bool b3 = a_in && (l31 > kEps2);
  const float n3 = b3 ? d2(cx, cy, ax, ay)
                      : (l32 > kEps2 ? d2(cx, cy, bx, by) : 0.0f);
  const float e3 = b3 ? fmaxf(l31, kEps) : (l32 > kEps2 ? fmaxf(l32, kEps) : 1.0f);
  const float l41 = d2(ax, ay, cx, cy);
  const float l42 = d2(bx, by, cx, cy);
  const bool b4 = b_in && (l41 > kEps2);
  const float n4 = b4 ? d2(dx, dy, bx, by)
                      : (l42 > kEps2 ? d2(dx, dy, ax, ay) : 0.0f);
  const float e4 = b4 ? fmaxf(l41, kEps) : (l42 > kEps2 ? fmaxf(l42, kEps) : 1.0f);
  if (c_in && d_in) {
    num = len2_cd;
    den = fmaxf(len2_ab, kEps);
  } else if (a_in && b_in) {
    num = len2_ab;
    den = fmaxf(len2_cd, kEps);
  } else if (c_in) {
    num = n3;
    den = e3;
  } else if (d_in) {
    num = n4;
    den = e4;
  } else {
    num = 0.0f;
    den = 1.0f;
  }
  if ((len2_ab < 1.0f) || (len2_cd < 1.0f)) num = 0.0f;
}

// sign carrier of a two-ray depth: num * denom (no divide); ok = |denom| > eps
__device__ __forceinline__ float tri_sign(const float* r1, const float* r2,
                                          const float* w0, bool want_first,
                                          bool& ok) {
  const float a = r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2];
  const float b = r1[0] * r2[0] + r1[1] * r2[1] + r1[2] * r2[2];
  const float c = r2[0] * r2[0] + r2[1] * r2[1] + r2[2] * r2[2];
  const float d = r1[0] * w0[0] + r1[1] * w0[1] + r1[2] * w0[2];
  const float e = r2[0] * w0[0] + r2[1] * w0[1] + r2[2] * w0[2];
  const float denom = a * c - b * b;
  ok = fabsf(denom) > kEps;
  const float num = want_first ? (b * e - c * d) : (a * e - b * d);
  return num * denom;
}

// Stage one segment's quantities: its line, the epipolar lines of its
// endpoints (through F for a source segment, F^T for a target) and its
// normalized endpoint rays (through its own view's RtKinv).
__device__ __forceinline__ void stage(const float* seg, bool valid_slot,
                                      uint8_t mask, const float* F,
                                      bool transpose, const float* Mray,
                                      float* q, int stride) {
  float v[kNQ];
  const float x1 = valid_slot ? seg[0] : 0.0f, y1 = valid_slot ? seg[1] : 0.0f;
  const float x2 = valid_slot ? seg[2] : 0.0f, y2 = valid_slot ? seg[3] : 0.0f;
  v[kX1] = x1; v[kY1] = y1; v[kX2] = x2; v[kY2] = y2;
  v[kLA] = y1 - y2;
  v[kLB] = x2 - x1;
  v[kLC] = x1 * y2 - y1 * x2;
  if (transpose) {
    l3d::mat3t_xy1(F, x1, y1, v[kE1A], v[kE1B], v[kE1C]);
    l3d::mat3t_xy1(F, x2, y2, v[kE2A], v[kE2B], v[kE2C]);
  } else {
    l3d::mat3_xy1(F, x1, y1, v[kE1A], v[kE1B], v[kE1C]);
    l3d::mat3_xy1(F, x2, y2, v[kE2A], v[kE2B], v[kE2C]);
  }
  ray_n(Mray, x1, y1, v[kR1X], v[kR1Y], v[kR1Z]);
  ray_n(Mray, x2, y2, v[kR2X], v[kR2Y], v[kR2Z]);
  v[kMask] = (valid_slot && mask) ? 1.0f : 0.0f;
  for (int k = 0; k < kNQ; ++k) q[k * stride] = v[k];
}

__global__ void __launch_bounds__(kBT * kBS)
pair_valid_kernel(const float* __restrict__ segs_src,
                  const uint8_t* __restrict__ mask_src,
                  const float* __restrict__ segs_nb,
                  const uint8_t* __restrict__ mask_nb,
                  const float* __restrict__ params, int Ss, int St,
                  uint8_t* __restrict__ out) {
  __shared__ float tq[kNQ][kBT];
  __shared__ float sq[kNQ][kBS];
  __shared__ float prm[kNP];

  const int n = blockIdx.z;
  const int t0 = blockIdx.x * kBT;
  const int s0 = blockIdx.y * kBS;
  const int tid = threadIdx.y * kBT + threadIdx.x;

  if (tid < kNP) prm[tid] = params[n * kNP + tid];
  __syncthreads();
  const float* F = prm;
  const float* Ms = prm + 9;
  const float* Mt = prm + 18;

  if (tid < kBT) {
    const int t = t0 + tid;
    const bool in = t < St;
    const size_t row = static_cast<size_t>(n) * St + (in ? t : 0);
    stage(segs_nb + row * 4, in, in ? mask_nb[row] : 0, F, true, Mt,
          &tq[0][tid], kBT);
  } else if (tid < kBT + kBS) {
    const int i = tid - kBT;
    const int s = s0 + i;
    const bool in = s < Ss;
    stage(segs_src + static_cast<size_t>(in ? s : 0) * 4, in,
          in ? mask_src[s] : 0, F, false, Ms,
          &sq[0][i], kBS);
  }
  __syncthreads();

  const int j = threadIdx.x, i = threadIdx.y;
  const int s = s0 + i, t = t0 + j;
  if (s >= Ss || t >= St) return;

  const float p1x = sq[kX1][i], p1y = sq[kY1][i];
  const float p2x = sq[kX2][i], p2y = sq[kY2][i];
  const float q1x = tq[kX1][j], q1y = tq[kY1][j];
  const float q2x = tq[kX2][j], q2y = tq[kY2][j];

  // epipolar transfer points (cudawrapper.cu:570-573)
  float a1x, a1y, a2x, a2y, b1x, b1y, b2x, b2y;
  const bool ok1 = intersect(tq[kLA][j], tq[kLB][j], tq[kLC][j],
                             sq[kE1A][i], sq[kE1B][i], sq[kE1C][i], a1x, a1y);
  const bool ok2 = intersect(tq[kLA][j], tq[kLB][j], tq[kLC][j],
                             sq[kE2A][i], sq[kE2B][i], sq[kE2C][i], a2x, a2y);
  const bool ok3 = intersect(sq[kLA][i], sq[kLB][i], sq[kLC][i],
                             tq[kE1A][j], tq[kE1B][j], tq[kE1C][j], b1x, b1y);
  const bool ok4 = intersect(sq[kLA][i], sq[kLB][i], sq[kLC][i],
                             tq[kE2A][j], tq[kE2B][j], tq[kE2C][j], b2x, b2y);

  // overlap gate (cudawrapper.cu:584-588), cross-multiplied on squares
  float n1, e1, n2, e2;
  overlap_sq_nd(p1x, p1y, p2x, p2y, b1x, b1y, b2x, b2y, n1, e1);
  overlap_sq_nd(q1x, q1y, q2x, q2y, a1x, a1y, a2x, a2y, n2, e2);
  const float lo2 = prm[33] * prm[33];
  const float hi2 = prm[34] * prm[34];
  const bool ov_ok = (n1 > lo2 * e1) && (n2 > lo2 * e2) &&
                     ((n1 > hi2 * e1) || (n2 > hi2 * e2));

  // triangulation signs (cudawrapper.cu:594-601)
  const float w0[3] = {prm[27] - prm[30], prm[28] - prm[31],
                       prm[29] - prm[32]};
  const float rp1[3] = {sq[kR1X][i], sq[kR1Y][i], sq[kR1Z][i]};
  const float rp2[3] = {sq[kR2X][i], sq[kR2Y][i], sq[kR2Z][i]};
  const float rq1[3] = {tq[kR1X][j], tq[kR1Y][j], tq[kR1Z][j]};
  const float rq2[3] = {tq[kR2X][j], tq[kR2Y][j], tq[kR2Z][j]};
  float ra1[3], ra2[3], rb1[3], rb2[3];
  ray_n(Mt, a1x, a1y, ra1[0], ra1[1], ra1[2]);
  ray_n(Mt, a2x, a2y, ra2[0], ra2[1], ra2[2]);
  ray_n(Ms, b1x, b1y, rb1[0], rb1[1], rb1[2]);
  ray_n(Ms, b2x, b2y, rb2[0], rb2[1], rb2[2]);
  bool t1, t2, t3, t4;
  const float d_p1 = tri_sign(rp1, ra1, w0, true, t1);
  const float d_p2 = tri_sign(rp2, ra2, w0, true, t2);
  const float d_q1 = tri_sign(rb1, rq1, w0, false, t3);
  const float d_q2 = tri_sign(rb2, rq2, w0, false, t4);

  const bool pos = (d_p1 > 0.0f) && (d_p2 > 0.0f) && (d_q1 > 0.0f) &&
                   (d_q2 > 0.0f);
  const bool valid = ok1 && ok2 && ok3 && ok4 && ov_ok && pos && t1 && t2 &&
                     t3 && t4 && (sq[kMask][i] > 0.5f) && (tq[kMask][j] > 0.5f);
  out[(static_cast<size_t>(n) * Ss + s) * St + t] = valid ? 1 : 0;
}

}  // namespace

// segs_src [Ss,4] f32, mask_src [Ss] u8, segs_nb [N,St,4] f32,
// mask_nb [N,St] u8, params [N,35] f32 -> out [N,Ss,St] u8 (0/1)
L3D_EXPORT int l3d_pair_valid(const void* segs_src, const void* mask_src,
                              const void* segs_nb, const void* mask_nb,
                              const void* params, int N, int Ss, int St,
                              void* out, void* stream) {
  if (N == 0 || Ss == 0 || St == 0) return 0;
  const dim3 block(kBT, kBS);
  const dim3 grid(l3d::div_up(St, kBT), l3d::div_up(Ss, kBS), N);
  pair_valid_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(segs_src),
      static_cast<const uint8_t*>(mask_src),
      static_cast<const float*>(segs_nb),
      static_cast<const uint8_t*>(mask_nb),
      static_cast<const float*>(params), Ss, St,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
