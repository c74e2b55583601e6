// The affinity stage's conservative weight filter, on the card.
//
// Replaces no TPU kernel: line3d_tpu weighs every candidate of the affinity
// stage's stream on the host (the native OpenMP sweep `weights_range`,
// native/affinity_enum.cpp, which stays the CPU path and weighs what this
// filter keeps).  About nine in ten candidates fail their kind's threshold
// and give no node and no edge.  The filter drops on the card the
// candidates it can prove failing, so that the host weighs and emits only
// the rest; the host's sweep then decides, with its own bits, every
// candidate that could pass, and the graph is the whole stream's.
//
// The card's float64 exp and acos differ from the host's by an ulp, the
// host library may contract to FMAs where these kernels (-fmad=false) do
// not, and |X - P1|^2 - t^2 cancels for near-line endpoints.  So a weight
// computed here is not the host's bit for bit, and the filter decides only
// with a margin: a candidate is dropped when its weight is finite and lies
// below its kind's threshold by more than `margin` of it (the caller passes
// the cuts).  Every other candidate, NaN and inf included, is kept.  The
// weight is similarity_one's arithmetic (native/affinity_enum.cpp:152-207)
// in its form and order, without its `sim <= 0.01 -> 0` cut, which only
// lowers a weight.
//
// Launches: the filter, one thread a candidate, writing keep flags; the
// caller's inclusive prefix sum over them; the compaction, one thread a
// candidate, copying each kept one to its place in the walk's order.
//
// What bounds it on the H100: bytes.  Each candidate reads its 25 stream
// bytes once, and its two rows (~88 bytes each) from the row arrays, which
// at ~75,000 rows (~6.6 MB) stay in the 50 MB L2; ~120 float64 operations
// a candidate, exp and acos counted once, against 34 TFLOP/s.
#include <math.h>

#include "l3d_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr double kRad2Deg = 180.0 / 3.14159265358979323846;

// a stream of n candidates, laid out as the enumeration writes it
struct Stream {
  const int64_t* src;
  const int64_t* tgt;
  const double* cw;
  const int8_t* kind;
  int64_t n;
};

// the best-match rows and the cameras' uncertainty model
struct Rows {
  const double* P1;           // [B, 3]
  const double* P2;           // [B, 3]
  const double* dir;          // [B, 3], unit
  const float* d1;            // [B] depth of P1
  const float* d2;            // [B]
  const int32_t* view;        // [B]
  const float* score;         // [B]
  const double* k_lower;      // [V]
  const double* k_upper;      // [V]
  const double* median_depth; // [V]
};

__host__ __device__ Stream make_stream(const void* buf, int64_t n) {
  Stream s;
  s.src = static_cast<const int64_t*>(buf);
  s.tgt = s.src + n;
  s.cw = reinterpret_cast<const double*>(s.tgt + n);
  s.kind = reinterpret_cast<const int8_t*>(s.cw + n);
  s.n = n;
  return s;
}

// distance of X to the line through p1o along dov
__device__ __forceinline__ double p2l(const double* X, const double* p1o,
                                      const double* dov) {
  const double dx = X[0] - p1o[0];
  const double dy = X[1] - p1o[1];
  const double dz = X[2] - p1o[2];
  const double t = dx * dov[0] + dy * dov[1] + dz * dov[2];
  const double q = dx * dx + dy * dy + dz * dz - t * t;
  return sqrt(q > 0.0 ? q : 0.0);
}

// row e's endpoints against row o's line, under e's uncertainties
__device__ double side(const Rows& r, int64_t e, int64_t o,
                       double log001x2) {
  const double* p1o = r.P1 + 3 * o;
  const double* dov = r.dir + 3 * o;
  const double da = p2l(r.P1 + 3 * e, p1o, dov);
  const double db = p2l(r.P2 + 3 * e, p1o, dov);
  const int32_t v = r.view[e];
  const double med = r.median_depth[v];
  const double de1 = static_cast<double>(r.d1[e]);
  const double de2 = static_cast<double>(r.d2[e]);
  const double m1 = r.k_lower[v] * (de1 < med ? de1 : med);
  const double m2 = r.k_lower[v] * (de2 < med ? de2 : med);
  const double u1 = r.k_upper[v] * (de1 < med ? de1 : med);
  const double u2 = r.k_upper[v] * (de2 < med ? de2 : med);
  const double s1sq = -(u1 - m1) * (u1 - m1) / log001x2;
  const double s2sq = -(u2 - m2) * (u2 - m2) / log001x2;
  const double e1 =
      da < m1 ? 1.0 : exp(-(da - m1) * (da - m1) / (2.0 * s1sq));
  const double e2 =
      db < m2 ? 1.0 : exp(-(db - m2) * (db - m2) / (2.0 * s2sq));
  return e1 < e2 ? e1 : e2;
}

__global__ void __launch_bounds__(kThreads)
    filter_kernel(Stream s, Rows r, double log001x2, double sa2,
                  double cut_a, double cut_c, uint8_t* keep) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= s.n) return;
  const int64_t a = s.src[i], b = s.tgt[i];
  const double w12 = side(r, a, b, log001x2);
  const double w34 = side(r, b, a, log001x2);
  const double wd = w12 < w34 ? w12 : w34;
  const double* da = r.dir + 3 * a;
  const double* db = r.dir + 3 * b;
  double dot = da[0] * db[0] + da[1] * db[1] + da[2] * db[2];
  if (dot > 1.0) dot = 1.0;
  if (dot < -1.0) dot = -1.0;
  double ang = acos(dot) * kRad2Deg;
  if (ang > 90.0) ang = 180.0 - ang;
  const double wa = exp(-ang * ang / sa2);
  const double sim = wd < wa ? wd : wa;
  const double base = 0.5 * (static_cast<double>(r.score[a]) +
                             static_cast<double>(r.score[b]));
  const int8_t k = s.kind[i];
  const double w = (k == 2 ? s.cw[i] : 1.0) * base * sim;
  keep[i] = !(isfinite(w) && w < (k == 0 ? cut_a : cut_c));
}

// pos: the inclusive prefix sum of the keep flags, so candidate i is kept
// when pos[i] passes pos[i - 1], and goes to pos[i] - 1
__global__ void __launch_bounds__(kThreads)
    compact_kernel(Stream s, const int32_t* pos, int64_t m, uint8_t* out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= s.n) return;
  const int32_t p = pos[i];
  if (p == (i > 0 ? pos[i - 1] : 0)) return;
  const int64_t j = p - 1;
  int64_t* o_src = reinterpret_cast<int64_t*>(out);
  int64_t* o_tgt = o_src + m;
  double* o_cw = reinterpret_cast<double*>(o_tgt + m);
  int8_t* o_kind = reinterpret_cast<int8_t*>(o_cw + m);
  o_src[j] = s.src[i];
  o_tgt[j] = s.tgt[i];
  o_cw[j] = s.cw[i];
  o_kind[j] = s.kind[i];
}

unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// The filter on `stream`: the enumeration's buffer of n candidates (src
// rows i64 [n], tgt rows i64 [n], collinear weights f64 [n], kinds i8
// [n]); the rows P1, P2, dir (f64 [B, 3]), d1, d2 (f32 [B]), view (i32
// [B]), score (f32 [B]) and the cameras' k_lower, k_upper, median_depth
// (f64 [V]); log001x2 = 2 log(0.01), sa2 = 2 sigma_a^2, and the cuts of
// kind 0 and of kinds 1-2; out keep [n] u8, 1 where the candidate is kept.
L3D_EXPORT int l3d_affinity_filter(
    const void* buf, long long n, const void* P1, const void* P2,
    const void* dir, const void* d1, const void* d2, const void* view,
    const void* score, const void* k_lower, const void* k_upper,
    const void* median_depth, double log001x2, double sa2, double cut_a,
    double cut_c, void* keep, void* stream) {
  if (n == 0) return 0;
  Rows r;
  r.P1 = static_cast<const double*>(P1);
  r.P2 = static_cast<const double*>(P2);
  r.dir = static_cast<const double*>(dir);
  r.d1 = static_cast<const float*>(d1);
  r.d2 = static_cast<const float*>(d2);
  r.view = static_cast<const int32_t*>(view);
  r.score = static_cast<const float*>(score);
  r.k_lower = static_cast<const double*>(k_lower);
  r.k_upper = static_cast<const double*>(k_upper);
  r.median_depth = static_cast<const double*>(median_depth);
  filter_kernel<<<blocks(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      make_stream(buf, n), r, log001x2, sa2, cut_a, cut_c,
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

// The compaction on `stream`: the same buffer of n candidates, pos [n] i32
// the inclusive prefix sum of the keep flags, m its last value; out a byte
// buffer of 25 m in the buffer's layout, the kept candidates in order.
L3D_EXPORT int l3d_affinity_compact(const void* buf, long long n,
                                    const void* pos, long long m, void* out,
                                    void* stream) {
  if (n == 0 || m == 0) return 0;
  compact_kernel<<<blocks(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      make_stream(buf, n), static_cast<const int32_t*>(pos), m,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
