// Kernel K5: the pairwise valid plane and the four dense two-ray depth
// planes of one view against N neighbor views at once.
//
// Replaces line3d_tpu/match/pairwise_pallas.py:_kernel (:203, body
// _compute :44-200 with signs_only=False, called from
// match_pair_dense_pallas :230, pallas_call :261).  For every (source
// segment s, target segment t) of one (view, neighbor) pair: K1's gates
// (pair_valid.cu) and the four depths d_p1, d_p2, d_q1, d_q2, each
// num * (1 / denom) as the Pallas body computes it (not num / denom), -1
// where |denom| <= eps; the pair is valid when the cheap gates pass and
// all four depths are positive and well posed.  The per-pair arithmetic is
// pair_math.cuh's, the expressions K1 evaluates, in the same order and
// under the same -fmad=false.
//
// What bounds it on the H100: instruction issue.  Every pair is evaluated
// in full: 354 f32 operations a pair as the function needs them
// (chip_smoke.py pair_ops), among them 12 IEEE reciprocals and 4
// correctly rounded square roots.  Written as 1.0f / x and sqrtf, each
// of those compiles to a range check, a branch to a slow-path call and
// the MUFU estimate with its Newton steps, ten instructions or more.  Every
// pair writes 17 bytes: 278.5 MB at facade view 0 x 10, 0.083 ms at
// 3.35 TB/s, below the time its instructions take.
// Design, for a dense output:
//   * one thread per target, 128 consecutive targets a block: each thread
//     stages its target's quantities (line, epipolar lines, endpoint rays)
//     once into registers, where they stay for the block's kTS sources,
//     and whatever of a pair depends on the target alone is loop-invariant;
//   * the block's sources are staged once into shared memory, one 80-byte
//     row each, and every thread reads the same row at the same time (five
//     16-byte broadcasts a pair);
//   * the reciprocals and roots run as their fast paths alone (FastRnOps:
//     the same bits for every operand below 2^126, checked on every float
//     by rn_ops_check.cu); a pair that meets a larger operand or a NaN is
//     evaluated again with the IEEE operations, out of line, so that the
//     loop keeps the registers of one evaluation;
//   * a warp's 32 threads write 32 consecutive bytes of the valid plane and
//     128 consecutive bytes of each depth plane per source, with streaming
//     stores (st.global.cs), since nothing in the call reads them back.
// The N neighbors of a view ride the grid's z axis in one launch.
#include "pair_math.cuh"

namespace {

using namespace l3d;

constexpr int kThreads = 128;   // targets per block, one a thread
constexpr int kTS = 32;         // sources per block
constexpr int kMinBlocks = 4;   // blocks per SM: at most 128 registers

static_assert(kTS <= kThreads && kNP <= kThreads,
              "the first threads stage the sources and the parameters");
static_assert(kNQ % 4 == 0, "a staged source is read as whole float4s");

// A segment's staged quantities in registers.
struct Regs {
  float v[kNQ];
  __device__ __forceinline__ float operator[](int k) const { return v[k]; }
};

// Pair (s, t) in full: its four depths into d, its valid bit returned.
template <class Ops>
__device__ __forceinline__ bool eval_pair(const Regs& s, const Regs& t,
                                          const float* prm, Ops& ops,
                                          float* d) {
  float pt[8];
  const bool cheap = cheap_gates(s, t, prm, pt, ops);
  float num[4], den[4];
  bool ok[4];
  two_ray_terms(s, t, prm, pt, num, den, ok, ops);
  for (int k = 0; k < 4; ++k) {
    const float inv = ops.rcp(ok[k] ? den[k] : 1.0f);
    d[k] = ok[k] ? num[k] * inv : -1.0f;
  }
  return cheap && (d[0] > 0.0f) && (d[1] > 0.0f) && (d[2] > 0.0f) &&
         (d[3] > 0.0f) && ok[0] && ok[1] && ok[2] && ok[3];
}

// A pair's outputs: its four depths and its valid bit.
struct PairOut {
  float d[4];
  bool valid;
};

// eval_pair with IeeeOps, out of line: the rare pair with an operand
// outside FastRnOps' domain calls it, and the loop that inlines the fast
// path keeps the registers of one evaluation only.
__device__ __noinline__ PairOut eval_pair_ieee(const Regs s, const Regs t,
                                               const float* prm) {
  PairOut r;
  IeeeOps ieee;
  r.valid = eval_pair(s, t, prm, ieee, r.d);
  return r;
}

// One block: targets blockIdx.x * kThreads + threadIdx.x against sources
// blockIdx.y * kTS .. + kTS of neighbor blockIdx.z.
// out [N, Ss, St] u8, depths [4, N, Ss, St] f32 (d_p1, d_p2, d_q1, d_q2).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pair_dense_kernel(const float* __restrict__ segs_src,
                  const uint8_t* __restrict__ mask_src,
                  const float* __restrict__ segs_nb,
                  const uint8_t* __restrict__ mask_nb,
                  const float* __restrict__ params, int Ss, int St,
                  uint8_t* __restrict__ out, float* __restrict__ depths) {
  __shared__ __align__(16) float sq[kTS][kNQ];
  __shared__ float prm[kNP];

  const int n = blockIdx.z;
  const int s0 = blockIdx.y * kTS;
  const int tid = threadIdx.x;
  const int t = blockIdx.x * kThreads + tid;

  if (tid < kNP) prm[tid] = params[n * kNP + tid];
  __syncthreads();
  if (tid < kTS) {
    const int s = s0 + tid;
    const bool in = s < Ss;
    stage(segs_src + static_cast<size_t>(in ? s : 0) * 4, in,
          in ? mask_src[s] : 0, prm, false, prm + 9, &sq[tid][0], 1);
  }
  const bool in_t = t < St;
  Regs tr;
  const size_t row = static_cast<size_t>(n) * St + (in_t ? t : 0);
  stage(segs_nb + row * 4, in_t, in_t ? mask_nb[row] : 0, prm, true,
        prm + 18, tr.v, 1);
  __syncthreads();
  if (!in_t) return;

  const int ns = min(kTS, Ss - s0);
  const size_t plane = static_cast<size_t>(gridDim.z) * Ss * St;
  const size_t o = (static_cast<size_t>(n) * Ss + s0) * St + t;
  uint8_t* out_p = out + o;
  float* d_p = depths + o;
#pragma unroll 1
  for (int i = 0; i < ns; ++i, out_p += St, d_p += St) {
    Regs sr;
    const float4* q4 = reinterpret_cast<const float4*>(&sq[i][0]);
    for (int k = 0; k < kNQ / 4; ++k) {
      const float4 q = q4[k];
      sr.v[4 * k] = q.x;
      sr.v[4 * k + 1] = q.y;
      sr.v[4 * k + 2] = q.z;
      sr.v[4 * k + 3] = q.w;
    }
    PairOut r;
    FastRnOps fast;
    r.valid = eval_pair(sr, tr, prm, fast, r.d);
    if (fast.slow) r = eval_pair_ieee(sr, tr, prm);
    __stcs(out_p, static_cast<uint8_t>(r.valid ? 1 : 0));
    for (int k = 0; k < 4; ++k) __stcs(d_p + k * plane, r.d[k]);
  }
}

}  // namespace

// segs_src [Ss,4] f32, mask_src [Ss] u8, segs_nb [N,St,4] f32,
// mask_nb [N,St] u8, params [N,35] f32 -> out [N,Ss,St] u8 (0/1),
// depths [4,N,Ss,St] f32
L3D_EXPORT int l3d_pair_dense(const void* segs_src, const void* mask_src,
                              const void* segs_nb, const void* mask_nb,
                              const void* params, int N, int Ss, int St,
                              void* out, void* depths, void* stream) {
  if (N == 0 || Ss == 0 || St == 0) return 0;
  const dim3 grid(l3d::div_up(St, kThreads), l3d::div_up(Ss, kTS), N);
  pair_dense_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(segs_src),
      static_cast<const uint8_t*>(mask_src),
      static_cast<const float*>(segs_nb),
      static_cast<const uint8_t*>(mask_nb),
      static_cast<const float*>(params), Ss, St, static_cast<uint8_t*>(out),
      static_cast<float*>(depths));
  return static_cast<int>(cudaGetLastError());
}
