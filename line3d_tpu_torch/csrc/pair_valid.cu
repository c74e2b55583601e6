// Kernel K1: the pairwise match valid plane of one view against N
// neighbor views at once.
//
// Replaces line3d_tpu/match/pairwise_pallas.py:_kernel_valid (:216, body
// _compute :44-200 with signs_only=True, called from
// match_pair_valid_pallas :290).  Same semantics as the reference's
// K_pairwise_matches (cudawrapper.cu:538-611): for every (source segment s,
// target segment t) of one (view, neighbor) pair, the epipolar transfer of
// both segments' endpoints through F, the four line intersections, the
// mutual 2D overlap gate (min > lo, max > hi) and the signs of the four
// two-ray triangulation depths, plus the segment masks.  The dense depth
// planes beside this plane are kernel K5, pair_dense.cu; the two share
// their per-pair arithmetic through pair_math.cuh.
//
// Arithmetic follows the Pallas body term for term: the overlap ratios are
// kept as (numerator, denominator) pairs of SQUARED distances and compared
// cross-multiplied.  K1 takes a depth's sign as sign(num * denom) with no
// divide (K5 computes the depth, num * (1 / denom), and takes the sign
// from it; the two planes agree pair for pair).  Built with -fmad=false so
// that every a*b + c rounds twice, as in the reference.
//
// What bounds it on the H100: arithmetic.  A pair's cheap gates (four
// intersections, two overlap ratios, the masks) cost ~250 f32 operations;
// the triangulation (four ray normalizations with a correctly rounded
// sqrt and an IEEE divide each, four two-ray depths) ~200 more, but on the
// facade only ~2% of the pairs pass the cheap gates.  K1 writes one byte a
// pair, far above the card's bytes-per-operation line.
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
#include "pair_math.cuh"

namespace {

using namespace l3d;

constexpr int kTT = 64;         // targets per tile
constexpr int kTS = 16;         // sources per tile
constexpr int kThreads = 256;   // threads per block
constexpr int kQ = kTT * kTS;   // queue capacity

static_assert(kTT % 32 == 0 && (kTT * kTS) % kThreads == 0 &&
              kTT + kTS <= kThreads && kTT <= 0xffff,
              "a warp takes 32 targets of one source; rounds are whole");
static_assert(4 * (kNQ * (kTT + kTS) + 9 * kQ + kNP) <= 48 * 1024,
              "the staged segments and a tile's queue fit static shared "
              "memory");

// The triangulation gates of pair (i, j) from its transfer points: all
// four depths positive (signs from num * denom) and well posed.
__device__ __forceinline__ bool tri_gates(const Col<kTS>& s,
                                          const Col<kTT>& t,
                                          const float* prm,
                                          const float* pt) {
  float num[4], den[4];
  bool ok[4];
  IeeeOps ieee;
  two_ray_terms(s, t, prm, pt, num, den, ok, ieee);
  float d[4];
  for (int k = 0; k < 4; ++k) d[k] = num[k] * den[k];
  return (d[0] > 0.0f) && (d[1] > 0.0f) && (d[2] > 0.0f) && (d[3] > 0.0f) &&
         ok[0] && ok[1] && ok[2] && ok[3];
}

// One block: a kTT x kTS tile of (target, source) pairs of neighbor
// blockIdx.z, kThreads threads walking it in rounds (a warp takes 32
// consecutive targets of one source).  The block evaluates the cheap gates
// of every pair, queues the survivors (warp ballot, one shared counter)
// with their transfer points, and then triangulates the queue with the
// whole block; each pair writes its own byte, so the queue's order is
// immaterial.  A tile whose staged sources or targets are all masked is
// skipped.  stats (may be null): cheap-gate survivors and warps of 32
// pairs holding any, added up over the launch.
__global__ void __launch_bounds__(kThreads)
pair_kernel(const float* __restrict__ segs_src,
            const uint8_t* __restrict__ mask_src,
            const float* __restrict__ segs_nb,
            const uint8_t* __restrict__ mask_nb,
            const float* __restrict__ params, int Ss, int St,
            uint8_t* __restrict__ out,
            unsigned long long* __restrict__ stats) {
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
    IeeeOps ieee;
    const bool surv = in && live_t && live_s &&
                      cheap_gates(Col<kTS>{&sq[0][i]}, Col<kTT>{&tq[0][j]},
                                  prm, pt, ieee);
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
  __syncthreads();

  // triangulate the queued survivors densely
  const int qn = q_n;
  for (int q = tid; q < qn; q += kThreads) {
    const int i = q_ij[q] >> 16, j = q_ij[q] & 0xffff;
    float pt[8];
    for (int k = 0; k < 8; ++k) pt[k] = q_pt[k][q];
    const bool ok =
        tri_gates(Col<kTS>{&sq[0][i]}, Col<kTT>{&tq[0][j]}, prm, pt);
    out[(static_cast<size_t>(n) * Ss + s0 + i) * St + t0 + j] = ok ? 1 : 0;
  }
  if (stats != nullptr && tid == 0 && qn > 0) {
    atomicAdd(&stats[0], static_cast<unsigned long long>(qn));
    atomicAdd(&stats[1], static_cast<unsigned long long>(n_warps));
  }
}

}  // namespace

// segs_src [Ss,4] f32, mask_src [Ss] u8, segs_nb [N,St,4] f32,
// mask_nb [N,St] u8, params [N,35] f32 -> out [N,Ss,St] u8 (0/1);
// stats [2] u64 (may be null): cheap-gate survivors, warps holding any
L3D_EXPORT int l3d_pair_valid(const void* segs_src, const void* mask_src,
                              const void* segs_nb, const void* mask_nb,
                              const void* params, int N, int Ss, int St,
                              void* out, void* stats, void* stream) {
  if (N == 0 || Ss == 0 || St == 0) return 0;
  const dim3 grid(l3d::div_up(St, kTT), l3d::div_up(Ss, kTS), N);
  pair_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(segs_src),
      static_cast<const uint8_t*>(mask_src),
      static_cast<const float*>(segs_nb),
      static_cast<const uint8_t*>(mask_nb),
      static_cast<const float*>(params), Ss, St, static_cast<uint8_t*>(out),
      static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}
