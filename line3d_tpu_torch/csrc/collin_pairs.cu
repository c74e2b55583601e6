// Kernel K4: every view's collinear segment pairs, as flat sorted lists.
//
// Replaces line3d_tpu/match/collinearity_pallas.py:_kernel (:35, called from
// collinearity_keep_pallas :89) together with the device work around it in
// line3d_tpu/match/collinearity.py:collinearity_compact_all (:126-195): the
// keep plane, the per-block quota of compact_rows_blockq, the affinity
// regate of _pair_aff, the (i, j) merge sort and the per-view cap.
//
// Per view v and row segment i, partner j is a CANDIDATE when K4's superset
// gate passes (the reference's K_collinearity, cudawrapper.cu:476-535, on
// squared distances):
//     max(n1^2, n2^2) <= thr^2 * den_j  and  max(m1^2, m2^2) <= thr^2 * den_i,
// thr^2 = 2 sigma^2 ln(1/T) (1 + 1e-4), both normalisers > eps, the four
// endpoint dot products > -eps (no overlap), both segments valid, i != j.
// `count[v]` is the number of candidates.  Within each block of `blk`
// partners (128, halved until it divides S) the first `quota` candidates in
// ascending j are regated with _pair_aff's arithmetic, operation for
// operation: d = max over the four endpoint distances |a x + b y + c| /
// sqrtf(max(a^2 + b^2, eps)), w = expf(-d * d / (2 sigma^2)), kept when
// w > T.  The survivors of a view are written in (i, j) order as keys
// i * S + j with their weights; the first C of them fill pairs[v] / w[v],
// the rest of the C slots hold -1 / 0.
//
// Two launches of one kernel.  Pass 1 counts each row's candidates and
// survivors and notes the span of partners from the block of its first
// survivor to its last; pass 2 re-evaluates that span of the rows holding
// survivors and writes them at the offset that the survivor counts of the
// rows above give (each writing warp sums them itself); the warp of the
// view's last row writes count[v] and the pad slots.  No [S, S] plane and
// no per-row partner table reaches device memory (four ints per row do),
// and the host does not wait between the passes.
//
// What bounds it on the H100: arithmetic, ~63 f32 operations per (i, j)
// pair against 17 bytes per segment.  One warp walks one row: a block stages
// the view's partners in shared memory, kTile at a time (the segment, its
// line, its squared normaliser and its mask, 9 floats: 36 KB), and each
// lane evaluates one partner of a 32-partner chunk.  One ballot gives every
// candidate its rank inside its block (no atomics, ascending j by
// construction), so the square root, the divides and the exp run only for
// the quota's candidates.  Built with -fmad=false so that every product
// rounds as PyTorch's separate operations round it.
#include "l3d_common.cuh"

namespace {

using l3d::kEps;

constexpr int kWarps = 8;                 // rows per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;               // partners staged at a time
constexpr unsigned kAll = 0xffffffffu;

enum { kX1, kY1, kX2, kY2, kLA, kLB, kLC, kDen, kMask, kNQ };

// one segment with its supporting line (a, b, c) and a^2 + b^2
struct Seg {
  float x1, y1, x2, y2, la, lb, lc, den;
};

__device__ __forceinline__ Seg make_seg(float x1, float y1, float x2,
                                        float y2) {
  Seg s;
  s.x1 = x1; s.y1 = y1; s.x2 = x2; s.y2 = y2;
  s.la = y1 - y2;
  s.lb = x2 - x1;
  s.lc = x1 * y2 - y1 * x2;
  s.den = s.la * s.la + s.lb * s.lb;
  return s;
}

__device__ __forceinline__ float dot2(float ux, float uy, float vx,
                                      float vy) {
  return ux * vx + uy * vy;
}

// torch.maximum and clamp_min: a NaN operand gives NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// K4's superset gate for row segment p and partner q (both valid, i != j
// tested by the caller); n1, n2 (p's endpoints on q's line) and m1, m2
// (q's endpoints on p's line) are kept for the regate.  max(x, y) <= t is
// written x <= t && y <= t, which is the same test, NaN included.
__device__ __forceinline__ bool gate(const Seg& p, const Seg& q, float thr_sq,
                                     float& n1, float& n2, float& m1,
                                     float& m2) {
  n1 = q.la * p.x1 + q.lb * p.y1 + q.lc;
  n2 = q.la * p.x2 + q.lb * p.y2 + q.lc;
  m1 = p.la * q.x1 + p.lb * q.y1 + p.lc;
  m2 = p.la * q.x2 + p.lb * q.y2 + p.lc;
  const float tj = thr_sq * q.den, ti = thr_sq * p.den;
  const bool close = (n1 * n1 <= tj) && (n2 * n2 <= tj) && (m1 * m1 <= ti) &&
                     (m2 * m2 <= ti) && (p.den > kEps) && (q.den > kEps);
  // no-overlap check (cudawrapper.cu:518-528)
  const float pos1 = dot2(q.x1 - p.x1, q.y1 - p.y1, q.x2 - p.x1, q.y2 - p.y1);
  const float pos2 = dot2(q.x1 - p.x2, q.y1 - p.y2, q.x2 - p.x2, q.y2 - p.y2);
  const float pos3 = dot2(p.x1 - q.x1, p.y1 - q.y1, p.x2 - q.x1, p.y2 - q.y1);
  const float pos4 = dot2(p.x1 - q.x2, p.y1 - q.y2, p.x2 - q.x2, p.y2 - q.y2);
  return close && (pos1 > -kEps) && (pos2 > -kEps) && (pos3 > -kEps) &&
         (pos4 > -kEps);
}

// _pair_aff's weight of a candidate (match/collinearity.py); its
// no-overlap, mask and i != j terms are the gate's, already true here
__device__ __forceinline__ float weight(const Seg& p, const Seg& q, float n1,
                                        float n2, float m1, float m2,
                                        float two_sig2) {
  const float dj = sqrtf(clamp_min(q.den, kEps));
  const float di = sqrtf(clamp_min(p.den, kEps));
  const float d = tmax(tmax(fabsf(n1) / dj, fabsf(n2) / dj),
                       tmax(fabsf(m1) / di, fabsf(m2) / di));
  return expf(-d * d / two_sig2);
}

struct Args {
  const float* segs;       // [V, S, 4]
  const uint8_t* mask;     // [V, S]
  int S, blk, quota, C;    // blk: a power of two dividing S
  float thr_sq, two_sig2, aff_t;
  int* row_keep;           // [V, S] candidates per row (pass 1 writes)
  int* row_surv;           // [V, S] survivors per row (pass 1 writes)
  int* row_lo;             // [V, S] first partner pass 2 walks (pass 1)
  int* row_hi;             // [V, S] last survivor + 1 (pass 1)
  int* pairs;              // [V, C] keys i * S + j, -1 pads (pass 2)
  float* w;                // [V, C] weights, 0 pads (pass 2)
  long long* count;        // [V] candidates per view (pass 2)
};

template <bool kWrite>
__global__ void __launch_bounds__(kThreads) collin_pairs_kernel(Args a) {
  __shared__ float jq[kNQ][kTile];
  const int S = a.S;
  const int v = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const float* segs = a.segs + static_cast<size_t>(v) * S * 4;
  const uint8_t* mask = a.mask + static_cast<size_t>(v) * S;
  int* row_keep = a.row_keep + static_cast<size_t>(v) * S;
  int* row_surv = a.row_surv + static_cast<size_t>(v) * S;
  int* row_lo = a.row_lo + static_cast<size_t>(v) * S;
  int* row_hi = a.row_hi + static_cast<size_t>(v) * S;
  int* pairs = a.pairs + static_cast<size_t>(v) * a.C;
  float* w = a.w + static_cast<size_t>(v) * a.C;

  bool active = i < S && mask[i] != 0;
  int base = 0;                 // pass 2: the row's first slot in pairs[v]
  int lo = 0, hi = S;           // the partners walked: all, in pass 1
  if (kWrite) {
    int below = 0, all = 0;
    long long cand = 0;
    const bool last = i == S - 1;
    if (active || last) {
      for (int r = lane; r < S; r += 32) {
        const int n = row_surv[r];
        below += r < i ? n : 0;
        all += n;
        if (last) cand += row_keep[r];
      }
      below = warp_sum(below);
    }
    if (last) {
      all = warp_sum(all);
      cand = warp_sum(cand);
      for (int s = min(all, a.C) + lane; s < a.C; s += 32) {
        pairs[s] = -1;
        w[s] = 0.0f;
      }
      if (lane == 0) a.count[v] = cand;
    }
    active = active && row_surv[i] > 0 && below < a.C;
    base = below;
    if (active) {
      lo = row_lo[i];
      hi = row_hi[i];
    }
  }

  int n_keep = 0, n_surv = 0, j_first = S, j_last = -1;
  if (__syncthreads_or(active)) {
    Seg p{};
    if (active) {
      const float* s = segs + static_cast<size_t>(i) * 4;
      p = make_seg(s[0], s[1], s[2], s[3]);
    }
    const int q = a.quota, bm = a.blk - 1;
    const unsigned lt = (1u << lane) - 1u;
    int carry = 0;              // candidates of the current block before
                                // this chunk (blocks of 32 or more)
    for (int t0 = 0; t0 < S; t0 += kTile) {
      const int tn = min(kTile, S - t0);
      // a tile none of the block's rows walks is skipped; the barrier
      // also tells that the previous tile is consumed
      const bool walk = active && lo < t0 + tn && hi > t0;
      if (!__syncthreads_or(walk)) continue;
      for (int k = threadIdx.x; k < tn; k += kThreads) {
        const float* s = segs + static_cast<size_t>(t0 + k) * 4;
        const Seg g = make_seg(s[0], s[1], s[2], s[3]);
        jq[kX1][k] = g.x1; jq[kY1][k] = g.y1;
        jq[kX2][k] = g.x2; jq[kY2][k] = g.y2;
        jq[kLA][k] = g.la; jq[kLB][k] = g.lb; jq[kLC][k] = g.lc;
        jq[kDen][k] = g.den;
        jq[kMask][k] = mask[t0 + k] ? 1.0f : 0.0f;
      }
      __syncthreads();
      if (!walk) continue;
      const int c_end = min(tn, hi - t0);
      for (int c0 = max(lo - t0, 0); c0 < c_end; c0 += 32) {
        const int j0 = t0 + c0, c = c0 + lane, j = j0 + lane;
        if ((j0 & bm) == 0) carry = 0;
        bool cand = false;
        Seg g{};
        float n1 = 0.0f, n2 = 0.0f, m1 = 0.0f, m2 = 0.0f;
        if (c < tn && j != i && jq[kMask][c] > 0.5f) {
          g.x1 = jq[kX1][c]; g.y1 = jq[kY1][c];
          g.x2 = jq[kX2][c]; g.y2 = jq[kY2][c];
          g.la = jq[kLA][c]; g.lb = jq[kLB][c]; g.lc = jq[kLC][c];
          g.den = jq[kDen][c];
          cand = gate(p, g, a.thr_sq, n1, n2, m1, m2);
        }
        const unsigned bal = __ballot_sync(kAll, cand);
        // this lane's rank among its block's candidates: those of earlier
        // chunks of the block, then the lower lanes of the block in this one
        const int first = max((j & ~bm) - j0, 0);
        const int rank = carry + __popc(bal & lt & ~((1u << first) - 1u));
        carry += __popc(bal);
        n_keep += __popc(bal);
        float wt = 0.0f;
        bool surv = false;
        if (cand && rank < q) {
          wt = weight(p, g, n1, n2, m1, m2, a.two_sig2);
          surv = wt > a.aff_t && wt > 0.0f;
        }
        const unsigned sb = __ballot_sync(kAll, surv);
        if (!kWrite && sb) {
          j_first = min(j_first, j0 + __ffs(sb) - 1);
          j_last = j0 + 31 - __clz(sb);
        }
        if (kWrite && surv) {
          const int slot = base + n_surv + __popc(sb & lt);
          if (slot < a.C) {
            pairs[slot] = i * S + j;
            w[slot] = wt;
          }
        }
        n_surv += __popc(sb);
      }
    }
  }
  if (!kWrite && i < S && lane == 0) {
    row_keep[i] = n_keep;
    row_surv[i] = n_surv;
    // pass 2 starts at the chunk holding the first survivor's block start
    // (a block start for blocks of 32 or more, whose rank count resets
    // there)
    row_lo[i] = j_first & ~(a.blk - 1) & ~31;
    row_hi[i] = j_last + 1;
  }
}

}  // namespace

// segs [V,S,4] f32, mask [V,S] u8; blk a power of two dividing S,
// 0 <= quota <= blk; scratch [4,V,S] i32 -> pairs [V,C] i32, w [V,C] f32,
// count [V] i64.
// Launches pass 1 and pass 2 on `stream`.
L3D_EXPORT int l3d_collin_pairs(const void* segs, const void* mask, int V,
                                int S, int blk, int quota, float thr_sq,
                                float two_sig2, float aff_t, int C,
                                void* scratch, void* pairs, void* w,
                                void* count, void* stream) {
  if (V == 0 || S == 0) return 0;
  Args a;
  a.segs = static_cast<const float*>(segs);
  a.mask = static_cast<const uint8_t*>(mask);
  a.S = S; a.blk = blk; a.quota = quota; a.C = C;
  a.thr_sq = thr_sq; a.two_sig2 = two_sig2; a.aff_t = aff_t;
  a.row_keep = static_cast<int*>(scratch);
  a.row_surv = a.row_keep + static_cast<size_t>(V) * S;
  a.row_lo = a.row_surv + static_cast<size_t>(V) * S;
  a.row_hi = a.row_lo + static_cast<size_t>(V) * S;
  a.pairs = static_cast<int*>(pairs);
  a.w = static_cast<float*>(w);
  a.count = static_cast<long long*>(count);
  const dim3 grid(l3d::div_up(S, kWarps), V);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  collin_pairs_kernel<false><<<grid, kThreads, 0, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  collin_pairs_kernel<true><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
