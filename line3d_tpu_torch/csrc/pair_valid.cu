// Kernels K1 and K5: the pairwise match valid plane (K1) and the dense
// depth planes beside it (K5), for N neighbor views at once.
//
// K1 replaces line3d_tpu/match/pairwise_pallas.py:_kernel_valid (:216, body
// _compute :44-200 with signs_only=True, called from
// match_pair_valid_pallas :290); K5 replaces _kernel (:203, the same body
// with signs_only=False, called from match_pair_dense_pallas :230).  One
// template body serves both: kDepths selects K5.  Same semantics as the
// reference's
// K_pairwise_matches (cudawrapper.cu:538-611): for every (source segment s,
// target segment t) of one (view, neighbor) pair, the epipolar transfer of
// both segments' endpoints through F, the four line intersections, the
// mutual 2D overlap gate (min > lo, max > hi) and the signs of the four
// two-ray triangulation depths, plus the segment masks.
//
// Arithmetic follows the Pallas body term for term: the overlap ratios are
// kept as (numerator, denominator) pairs of SQUARED distances and compared
// cross-multiplied.  K1 takes a depth's sign as sign(num * denom) with no
// divide; K5 computes the depth itself as the Pallas body does,
// num * (1 / denom) (not num / denom), -1 where |denom| <= eps, and takes
// the signs from those depths.  Built with -fmad=false so that every
// a*b + c rounds twice, as in the reference.
//
// What bounds it on the H100: arithmetic.  A pair's cheap gates (four
// intersections, two overlap ratios, the masks) cost ~250 f32 operations;
// the triangulation (four ray normalizations with a correctly rounded
// sqrt and an IEEE divide each, four two-ray depths) ~200 more, but on the
// facade only ~2% of the pairs pass the cheap gates.  K1 writes one byte a
// pair (K5: 17 bytes), far above the card's bytes-per-operation line.
// Design: a block covers a 64-target x 16-source tile; the first threads
// compute each target's and source's line, epipolar lines and endpoint
// rays once into shared memory, and the block's 256 threads then walk the
// tile's 1,024 pairs.  K1 runs the triangulation only for the survivors of
// the cheap gates, queued in shared memory and then taken up densely by
// the whole block, so the warps that hold no survivor do no triangulation
// (a walk that triangulated every pair took 0.511 ms at facade view 0 x 10
// on an NVIDIA H100 80GB HBM3 at 700 W).  Rows of one neighbor are
// independent, and the N neighbors of a view ride the grid's z axis in one
// launch.
#include "l3d_common.cuh"

namespace {

using l3d::kEps;

constexpr int kTT = 64;         // targets per tile
constexpr int kTS = 16;         // sources per tile
constexpr int kThreads = 256;   // threads per block
constexpr int kNP = 35;   // F, RtKinv_src, RtKinv_tgt, C_src, C_tgt, lo, hi

static_assert(kTT % 32 == 0 && (kTT * kTS) % kThreads == 0 &&
              kTT + kTS <= kThreads && kTT <= 0xffff,
              "a warp takes 32 targets of one source; rounds are whole");
static_assert(4 * (20 * (kTT + kTS) + 9 * kTT * kTS + kNP) <= 48 * 1024,
              "the staged segments and a tile's queue fit static shared "
              "memory");

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

// A two-ray depth (pairwise_pallas.py:166-181); ok = |denom| > eps.  With
// kDepths the depth num * (1 / denom), -1 when not ok; without, only its
// sign carrier num * denom (no divide).
template <bool kDepths>
__device__ __forceinline__ float tri(const float* r1, const float* r2,
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
  if (kDepths) {
    const float inv = 1.0f / (ok ? denom : 1.0f);
    return ok ? num * inv : -1.0f;
  }
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

// The four epipolar transfer points of pair (i, j) (cudawrapper.cu:570-573)
// and the pair's cheap gates: the four intersections, the mutual overlap
// gate (cudawrapper.cu:584-588, cross-multiplied on squares) and both
// masks.  pt = (a1, a2, b1, b2), zero where an intersection fails.
__device__ __forceinline__ bool cheap_gates(const float (*sq)[kTS],
                                            const float (*tq)[kTT],
                                            const float* prm, int i, int j,
                                            float* pt) {
  const bool ok1 = intersect(tq[kLA][j], tq[kLB][j], tq[kLC][j],
                             sq[kE1A][i], sq[kE1B][i], sq[kE1C][i], pt[0],
                             pt[1]);
  const bool ok2 = intersect(tq[kLA][j], tq[kLB][j], tq[kLC][j],
                             sq[kE2A][i], sq[kE2B][i], sq[kE2C][i], pt[2],
                             pt[3]);
  const bool ok3 = intersect(sq[kLA][i], sq[kLB][i], sq[kLC][i],
                             tq[kE1A][j], tq[kE1B][j], tq[kE1C][j], pt[4],
                             pt[5]);
  const bool ok4 = intersect(sq[kLA][i], sq[kLB][i], sq[kLC][i],
                             tq[kE2A][j], tq[kE2B][j], tq[kE2C][j], pt[6],
                             pt[7]);
  float n1, e1, n2, e2;
  overlap_sq_nd(sq[kX1][i], sq[kY1][i], sq[kX2][i], sq[kY2][i], pt[4], pt[5],
                pt[6], pt[7], n1, e1);
  overlap_sq_nd(tq[kX1][j], tq[kY1][j], tq[kX2][j], tq[kY2][j], pt[0], pt[1],
                pt[2], pt[3], n2, e2);
  const float lo2 = prm[33] * prm[33];
  const float hi2 = prm[34] * prm[34];
  const bool ov_ok = (n1 > lo2 * e1) && (n2 > lo2 * e2) &&
                     ((n1 > hi2 * e1) || (n2 > hi2 * e2));
  return ok1 && ok2 && ok3 && ok4 && ov_ok && (sq[kMask][i] > 0.5f) &&
         (tq[kMask][j] > 0.5f);
}

// The triangulation gates of pair (i, j) from its transfer points
// (cudawrapper.cu:594-601): all four depths positive and well posed.  With
// kDepths the depths go to d[4].
template <bool kDepths>
__device__ __forceinline__ bool tri_gates(const float (*sq)[kTS],
                                          const float (*tq)[kTT],
                                          const float* prm, int i, int j,
                                          const float* pt, float* d) {
  const float* Ms = prm + 9;
  const float* Mt = prm + 18;
  const float w0[3] = {prm[27] - prm[30], prm[28] - prm[31],
                       prm[29] - prm[32]};
  const float rp1[3] = {sq[kR1X][i], sq[kR1Y][i], sq[kR1Z][i]};
  const float rp2[3] = {sq[kR2X][i], sq[kR2Y][i], sq[kR2Z][i]};
  const float rq1[3] = {tq[kR1X][j], tq[kR1Y][j], tq[kR1Z][j]};
  const float rq2[3] = {tq[kR2X][j], tq[kR2Y][j], tq[kR2Z][j]};
  float ra1[3], ra2[3], rb1[3], rb2[3];
  ray_n(Mt, pt[0], pt[1], ra1[0], ra1[1], ra1[2]);
  ray_n(Mt, pt[2], pt[3], ra2[0], ra2[1], ra2[2]);
  ray_n(Ms, pt[4], pt[5], rb1[0], rb1[1], rb1[2]);
  ray_n(Ms, pt[6], pt[7], rb2[0], rb2[1], rb2[2]);
  bool t1, t2, t3, t4;
  d[0] = tri<kDepths>(rp1, ra1, w0, true, t1);
  d[1] = tri<kDepths>(rp2, ra2, w0, true, t2);
  d[2] = tri<kDepths>(rb1, rq1, w0, false, t3);
  d[3] = tri<kDepths>(rb2, rq2, w0, false, t4);
  return (d[0] > 0.0f) && (d[1] > 0.0f) && (d[2] > 0.0f) && (d[3] > 0.0f) &&
         t1 && t2 && t3 && t4;
}

// One block: a kTT x kTS tile of (target, source) pairs of neighbor
// blockIdx.z, kThreads threads walking it in rounds (a warp takes 32
// consecutive targets of one source).  K5 (kDepths) evaluates every pair
// in full and writes its depths.  K1 evaluates the cheap gates of every
// pair, queues the survivors (warp ballot, one shared counter) with their
// transfer points, and then triangulates the queue with the whole block;
// each pair writes its own byte, so the queue's order is immaterial.  K1
// skips a tile whose staged sources or targets are all masked.
// depths: [4, N, Ss, St] (d_p1, d_p2, d_q1, d_q2), written only with
// kDepths; stats (K1, may be null): cheap-gate survivors and warps of 32
// pairs holding any, added up over the launch.
template <bool kDepths>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const float* __restrict__ segs_src,
            const uint8_t* __restrict__ mask_src,
            const float* __restrict__ segs_nb,
            const uint8_t* __restrict__ mask_nb,
            const float* __restrict__ params, int Ss, int St,
            uint8_t* __restrict__ out, float* __restrict__ depths,
            unsigned long long* __restrict__ stats) {
  constexpr int kQ = kDepths ? 1 : kTT * kTS;   // queue capacity
  __shared__ float tq[kNQ][kTT];
  __shared__ float sq[kNQ][kTS];
  __shared__ float prm[kNP];
  __shared__ uint32_t q_ij[kQ];
  __shared__ float q_pt[8][kQ];
  __shared__ int q_n, n_warps;

  const int n = blockIdx.z;
  const int t0 = blockIdx.x * kTT;
  const int s0 = blockIdx.y * kTS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid < kNP) prm[tid] = params[n * kNP + tid];
  if (tid == 0) q_n = n_warps = 0;
  __syncthreads();
  const float* F = prm;

  if (tid < kTT) {
    const int t = t0 + tid;
    const bool in = t < St;
    const size_t row = static_cast<size_t>(n) * St + (in ? t : 0);
    stage(segs_nb + row * 4, in, in ? mask_nb[row] : 0, F, true, prm + 18,
          &tq[0][tid], kTT);
  } else if (tid < kTT + kTS) {
    const int i = tid - kTT;
    const int s = s0 + i;
    const bool in = s < Ss;
    stage(segs_src + static_cast<size_t>(in ? s : 0) * 4, in,
          in ? mask_src[s] : 0, F, false, prm + 9, &sq[0][i], kTS);
  }
  const bool live_t = __syncthreads_or(tid < kTT && tq[kMask][tid] > 0.5f);
  const bool live_s = __syncthreads_or(tid < kTS && sq[kMask][tid] > 0.5f);

  for (int p = tid; p < kTT * kTS; p += kThreads) {
    const int j = p % kTT, i = p / kTT;
    const int s = s0 + i, t = t0 + j;
    const bool in = s < Ss && t < St;
    const size_t o = (static_cast<size_t>(n) * Ss + s) * St + t;
    float pt[8];
    if (kDepths) {
      if (!in) continue;
      const bool cheap = cheap_gates(sq, tq, prm, i, j, pt);
      float d[4];
      const bool tri_ok = tri_gates<true>(sq, tq, prm, i, j, pt, d);
      out[o] = (cheap && tri_ok) ? 1 : 0;
      const size_t plane = static_cast<size_t>(gridDim.z) * Ss * St;
      for (int k = 0; k < 4; ++k) depths[k * plane + o] = d[k];
    } else {
      const bool surv =
          in && live_t && live_s && cheap_gates(sq, tq, prm, i, j, pt);
      if (in && !surv) out[o] = 0;
      const unsigned bal = __ballot_sync(0xffffffffu, surv);
      if (bal == 0) continue;
      int base = 0;
      if (lane == 0) {
        base = atomicAdd(&q_n, __popc(bal));
        if (stats != nullptr) atomicAdd(&n_warps, 1);
      }
      base = __shfl_sync(0xffffffffu, base, 0);
      if (surv) {
        const int slot = base + __popc(bal & ((1u << lane) - 1u));
        q_ij[slot] = (static_cast<uint32_t>(i) << 16) | j;
        for (int k = 0; k < 8; ++k) q_pt[k][slot] = pt[k];
      }
    }
  }
  if (kDepths) return;
  __syncthreads();

  // triangulate the queued survivors densely
  const int qn = q_n;
  for (int q = tid; q < qn; q += kThreads) {
    const int i = q_ij[q] >> 16, j = q_ij[q] & 0xffff;
    float pt[8], d[4];
    for (int k = 0; k < 8; ++k) pt[k] = q_pt[k][q];
    const bool ok = tri_gates<false>(sq, tq, prm, i, j, pt, d);
    out[(static_cast<size_t>(n) * Ss + s0 + i) * St + t0 + j] = ok ? 1 : 0;
  }
  if (stats != nullptr && tid == 0 && qn > 0) {
    atomicAdd(&stats[0], static_cast<unsigned long long>(qn));
    atomicAdd(&stats[1], static_cast<unsigned long long>(n_warps));
  }
}

template <bool kDepths>
int launch(const void* segs_src, const void* mask_src, const void* segs_nb,
           const void* mask_nb, const void* params, int N, int Ss, int St,
           void* out, void* depths, void* stats, void* stream) {
  if (N == 0 || Ss == 0 || St == 0) return 0;
  const dim3 grid(l3d::div_up(St, kTT), l3d::div_up(Ss, kTS), N);
  pair_kernel<kDepths><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(segs_src),
      static_cast<const uint8_t*>(mask_src),
      static_cast<const float*>(segs_nb),
      static_cast<const uint8_t*>(mask_nb),
      static_cast<const float*>(params), Ss, St, static_cast<uint8_t*>(out),
      static_cast<float*>(depths),
      static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// segs_src [Ss,4] f32, mask_src [Ss] u8, segs_nb [N,St,4] f32,
// mask_nb [N,St] u8, params [N,35] f32 -> out [N,Ss,St] u8 (0/1);
// stats [2] u64 (may be null): cheap-gate survivors, warps holding any
L3D_EXPORT int l3d_pair_valid(const void* segs_src, const void* mask_src,
                              const void* segs_nb, const void* mask_nb,
                              const void* params, int N, int Ss, int St,
                              void* out, void* stats, void* stream) {
  return launch<false>(segs_src, mask_src, segs_nb, mask_nb, params, N, Ss,
                       St, out, nullptr, stats, stream);
}

// K5: as l3d_pair_valid, plus depths [4,N,Ss,St] f32
L3D_EXPORT int l3d_pair_dense(const void* segs_src, const void* mask_src,
                              const void* segs_nb, const void* mask_nb,
                              const void* params, int N, int Ss, int St,
                              void* out, void* depths, void* stream) {
  return launch<true>(segs_src, mask_src, segs_nb, mask_nb, params, N, Ss,
                      St, out, depths, nullptr, stream);
}
