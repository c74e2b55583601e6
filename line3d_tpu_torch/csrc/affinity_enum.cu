// The affinity stage's exact-order candidate enumeration, on the card.
//
// Replaces no TPU kernel: line3d_tpu enumerates on the host, in the native
// walk `affinity_enumerate_packed` (native/affinity_enum.cpp, the plain
// twin, which stays the CPU path) and in the numpy stream
// `_build_affinity_graph_vec` (line3d_tpu/cluster/affinity.py).  The walk
// visits every source (a best-match key) in ascending key order: A, its
// correspondents t ascending; B, when the pair {s, t} was fresh and t has a
// best match, t's collinear partners; C, the source's own collinear
// partners.  Every visit marks its unordered pair in one `used` set, and an
// entry whose pair was already marked is dropped (an A entry with its whole
// B expansion).  The stream written here (src row, tgt row, kind 0=A 1=B
// 2=C, collinear weight) is the walk's element for element, in its order.
//
// Why the sequential `used` set can be decided in parallel.  Every pair a
// source x marks contains x, and the correspondence lists are symmetric.
// So before source s's turn, the marked pairs that contain s are {c, s}
// for sources c < s that marked s: s in corr(c) (that is, c in corr(s)),
// s in coll(c), or s in coll(t) for an A target t of c whose expansion ran.
// An A entry (s, t) whose t has a best match is therefore fresh only if
// t >= s (t < s marked it in its own A loop), and then iff no expansion run
// earlier in s's block, of a target of t's view, has t as a partner.  That
// chain is local to (s, view of t): pass 1 decides it, one thread a
// source, and writes `exec` for each packed pair.  "Has t as a partner" is
// asked of a run of a source's A entries (`hit_by`) either by a scan of
// the run or, where fewer, through the transposed collinearity CSR (the
// rows that list t's segment, each looked up in the run): a source with k
// targets in one view then costs pass 1 about k times the rows that list
// a segment, not k^2; the longest source sets the pass's time, and a
// clutter source at 1000 views has up to 194 targets in one view.  Pass 2 then decides
// every other entry against s's own block (the A entries so far, the
// expansions run so far, a repeated partner in the row) and, for a
// partner c < s, against what c marked (`marked_below`), reading c's
// `exec`.  Entries whose partner has no best match are left out: they emit
// nothing, and the pairs they mark contain a key that is never a source, so
// no decision reads them.
//
// Inputs (the walk's): the source keys ascending and their rows, the
// packed pairs a*M + b sorted and symmetric, the key -> row lookup (-1
// exactly for keys that are not sources), and the collinearity CSR over
// keys with each row's partner segments ascending; and that CSR
// transposed (for each key, the segments of its view whose rows list its
// segment, ascending), which the caller builds on the card.
//
// Launches: prep (each key's first packed pair and its count of smaller
// sources), pass 1, and pass 2 counting; the caller's prefix sum over the
// counts, then pass 2 again, writing.  Pass 2 runs one thread per item of
// the stream's order: each packed pair (its A entry and B expansion) and
// each source's C block, the items ordered by slot = position + the
// sources before it, so the prefix sum places every candidate where the
// walk puts it.
//
// What bounds it on the H100: dependent integer lookups (binary searches
// in the packed pairs and the CSR rows, ~20 loads a candidate), so latency
// and not bytes or arithmetic; every thread walks its own entries, and the
// writing pass skips the items with nothing to write.  No floating-point
// value is computed: a weight is copied, so the stream is bit-identical.
#include "l3d_common.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const int64_t* key_sorted;  // [B] source keys, ascending
  const int64_t* order;       // [B] their best-match rows
  int64_t B;
  const int64_t* pk;          // [P] packed pairs a*M + b, sorted, symmetric
  int64_t P;
  const int64_t* row_lookup;  // [M] key -> row, -1 for a key not a source
  const int64_t* ptr;         // [M + 1] collinearity CSR over keys
  const int64_t* coll_j;      // partner segments, ascending in a row
  const double* coll_w;       // their weights
  const int64_t* ptr_t;       // [M + 1] the CSR transposed over keys
  const int64_t* coll_i;      // segments whose rows list the key, ascending
  int64_t S, M;
  int64_t* corr_ptr;          // [M + 1] first packed pair of each key
  int* rank_lt;               // [M + 1] sources with a smaller key
  uint8_t* exec;              // [P] A entry fresh with a matched target
  int* cnt;                   // [P + B] candidates of each slot
  const int64_t* end;         // [P + B] inclusive prefix sum of cnt
  int64_t* out_src;           // [n] each, n the stream's length
  int64_t* out_tgt;
  double* out_cw;
  int8_t* out_kind;
};

__device__ __forceinline__ int64_t lower_bound(const int64_t* x, int64_t lo,
                                               int64_t hi, int64_t v) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (x[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// segment `seg` among key k's collinear partners
__device__ __forceinline__ bool collinear(const Args& a, int64_t k,
                                          int64_t seg) {
  const int64_t hi = a.ptr[k + 1];
  const int64_t i = lower_bound(a.coll_j, a.ptr[k], hi, seg);
  return i < hi && a.coll_j[i] == seg;
}

// packed pair `key` among pk[lo, hi)
__device__ __forceinline__ bool has_pair(const Args& a, int64_t lo,
                                         int64_t hi, int64_t key) {
  const int64_t i = lower_bound(a.pk, lo, hi, key);
  return i < hi && a.pk[i] == key;
}

// an expansion run among the A entries pk[q0, q1) (one source's, `base` =
// its key * M, targets of the view whose first key is `vb`) has segment
// `seg` as a partner: a scan of the entries, or, when the transposed row of
// vb + seg is shorter, a lookup of each segment it lists among them
__device__ bool hit_by(const Args& a, int64_t base, int64_t q0, int64_t q1,
                       int64_t vb, int64_t seg) {
  if (q0 >= q1) return false;
  const int64_t r0 = a.ptr_t[vb + seg], r1 = a.ptr_t[vb + seg + 1];
  if (q1 - q0 <= r1 - r0) {
    for (int64_t q = q0; q < q1; ++q)
      if (a.exec[q] && collinear(a, a.pk[q] - base, seg)) return true;
    return false;
  }
  const int64_t head = base + vb;
  for (int64_t r = r0, q = q0; r < r1 && q < q1; ++r) {
    q = lower_bound(a.pk, q, q1, head + a.coll_i[r]);
    if (q < q1 && a.pk[q] == head + a.coll_i[r] && a.exec[q]) return true;
  }
  return false;
}

// source c < s marked {c, s} in its coll loop or in an expansion it ran (its
// A loop is the caller's has_pair over s's own pairs): s of view sv,
// segment sseg
__device__ bool marked_below(const Args& a, int64_t c, int64_t sv,
                             int64_t sseg) {
  if (c / a.S == sv && collinear(a, c, sseg)) return true;
  const int64_t base = c * a.M, key = base + sv * a.S;
  const int64_t hi = a.corr_ptr[c + 1];
  const int64_t q0 = lower_bound(a.pk, a.corr_ptr[c], hi, key);
  const int64_t q1 = lower_bound(a.pk, q0, hi, key + a.S);
  return hit_by(a, base, q0, q1, sv * a.S, sseg);
}

__global__ void __launch_bounds__(kThreads) prep_kernel(Args a) {
  const int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (k > a.M) return;
  a.corr_ptr[k] = lower_bound(a.pk, 0, a.P, k * a.M);
  a.rank_lt[k] = static_cast<int>(lower_bound(a.key_sorted, 0, a.B, k));
}

// pass 1: each source's A chain, in order (a thread reads its own earlier
// writes)
__global__ void __launch_bounds__(kThreads) exec_kernel(Args a) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (r >= a.B) return;
  const int64_t s = a.key_sorted[r], base = s * a.M;
  const int64_t hi = a.corr_ptr[s + 1];
  int64_t g0 = 0, view = -1;
  for (int64_t q = a.corr_ptr[s]; q < hi; ++q) {
    const int64_t t = a.pk[q] - base, v = t / a.S;
    if (v != view) {
      view = v;
      g0 = q;
    }
    a.exec[q] = t >= s && a.row_lookup[t] >= 0 &&
                !hit_by(a, base, g0, q, v * a.S, t - v * a.S);
  }
}

// pass 2: one slot's candidates, counted (kWrite false) or written
template <bool kWrite>
__global__ void __launch_bounds__(kThreads) stream_kernel(Args a) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= a.P + a.B) return;
  const bool is_c = i >= a.P;
  const int64_t q = i;                       // an A item's packed pair
  const int64_t r = is_c ? i - a.P : 0;      // a C item's source rank
  const int64_t s = is_c ? a.key_sorted[r] : a.pk[q] / a.M;
  const int rank = a.rank_lt[s];
  const int64_t slot = is_c ? a.corr_ptr[s + 1] + r : q + rank;
  int n = 0;
  int64_t at = 0;
  if (kWrite) {
    if (a.cnt[slot] == 0) return;
    at = a.end[slot] - a.cnt[slot];
  }
  auto emit = [&](int64_t tgt, int8_t kind, double cw) {
    if (kWrite) {
      a.out_src[at + n] = a.order[rank];
      a.out_tgt[at + n] = tgt;
      a.out_cw[at + n] = cw;
      a.out_kind[at + n] = kind;
    }
    ++n;
  };
  const int64_t S = a.S, base = s * a.M, lo = a.corr_ptr[s];
  const int64_t sv = s / S, sseg = s - sv * S;
  if (!is_c && a.exec[q]) {
    // A entry, then its target's expansion: a partner is dropped when it
    // repeats in the row, is an A target up to this one, a partner of an
    // expansion run earlier, or was marked by a smaller source
    const int64_t t = a.pk[q] - base, tb = t / S * S;
    emit(a.row_lookup[t], 0, 1.0);
    const int64_t g0 = lower_bound(a.pk, lo, q, base + tb);
    const int64_t c0 = a.ptr[t], c1 = a.ptr[t + 1];
    for (int64_t c = c0; c < c1; ++c) {
      const int64_t j = a.coll_j[c], ck = tb + j;
      const int64_t crow = a.row_lookup[ck];
      if (crow < 0 || (c > c0 && a.coll_j[c - 1] == j) ||
          has_pair(a, lo, q + 1, base + ck) ||
          hit_by(a, base, g0, q, tb, j) ||
          (ck < s && marked_below(a, ck, sv, sseg)))
        continue;
      emit(crow, 1, 1.0);
    }
  } else if (is_c) {
    // C block: against every A entry and every expansion run of the
    // source's own view, a repeat in the row, and the smaller sources
    const int64_t hi = a.corr_ptr[s + 1], sb = sv * S;
    const int64_t g0 = lower_bound(a.pk, lo, hi, base + sb);
    const int64_t g1 = lower_bound(a.pk, g0, hi, base + sb + S);
    const int64_t c0 = a.ptr[s], c1 = a.ptr[s + 1];
    for (int64_t c = c0; c < c1; ++c) {
      const int64_t j = a.coll_j[c], ck = sb + j;
      const int64_t crow = a.row_lookup[ck];
      if (crow < 0 || (c > c0 && a.coll_j[c - 1] == j) ||
          has_pair(a, lo, hi, base + ck) || hit_by(a, base, g0, g1, sb, j) ||
          (ck < s && marked_below(a, ck, sv, sseg)))
        continue;
      emit(crow, 2, a.coll_w[c]);
    }
  }
  if (!kWrite) a.cnt[slot] = n;
}

Args make_args(const void* key_sorted, const void* order, long long B,
               const void* pk, long long P, const void* row_lookup,
               const void* ptr, const void* coll_j, const void* coll_w,
               const void* ptr_t, const void* coll_i, long long S,
               long long M, void* corr_ptr, void* rank_lt, void* exec,
               void* cnt) {
  Args a{};
  a.key_sorted = static_cast<const int64_t*>(key_sorted);
  a.order = static_cast<const int64_t*>(order);
  a.B = B;
  a.pk = static_cast<const int64_t*>(pk);
  a.P = P;
  a.row_lookup = static_cast<const int64_t*>(row_lookup);
  a.ptr = static_cast<const int64_t*>(ptr);
  a.coll_j = static_cast<const int64_t*>(coll_j);
  a.coll_w = static_cast<const double*>(coll_w);
  a.ptr_t = static_cast<const int64_t*>(ptr_t);
  a.coll_i = static_cast<const int64_t*>(coll_i);
  a.S = S;
  a.M = M;
  a.corr_ptr = static_cast<int64_t*>(corr_ptr);
  a.rank_lt = static_cast<int*>(rank_lt);
  a.exec = static_cast<uint8_t*>(exec);
  a.cnt = static_cast<int*>(cnt);
  return a;
}

unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Prep, pass 1 and pass 2 counting on `stream`: the walk's inputs (i64,
// coll_w f64) and the transposed CSR (ptr_t [M+1], coll_i, i64); scratch
// corr_ptr [M+1] i64, rank_lt [M+1] i32, exec [P] u8 (zeroed here); out cnt
// [P+B] i32.
L3D_EXPORT int l3d_affinity_count(const void* key_sorted, const void* order,
                                  long long B, const void* pk, long long P,
                                  const void* row_lookup, const void* ptr,
                                  const void* coll_j, const void* coll_w,
                                  const void* ptr_t, const void* coll_i,
                                  long long S, long long M, void* corr_ptr,
                                  void* rank_lt, void* exec, void* cnt,
                                  void* stream) {
  const Args a = make_args(key_sorted, order, B, pk, P, row_lookup, ptr,
                           coll_j, coll_w, ptr_t, coll_i, S, M, corr_ptr,
                           rank_lt, exec, cnt);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P > 0) {
    const cudaError_t e = cudaMemsetAsync(exec, 0, P, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  prep_kernel<<<blocks(M + 1), kThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || B == 0) return static_cast<int>(e);
  exec_kernel<<<blocks(B), kThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stream_kernel<false><<<blocks(P + B), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 writing on `stream`, after l3d_affinity_count on the same inputs
// and scratch: end [P+B] i64 the inclusive prefix sum of cnt, n its last
// value; out a byte buffer of 25 n: src rows i64 [n], tgt rows i64 [n],
// collinear weights f64 [n], kinds i8 [n], one after the other.
L3D_EXPORT int l3d_affinity_write(const void* key_sorted, const void* order,
                                  long long B, const void* pk, long long P,
                                  const void* row_lookup, const void* ptr,
                                  const void* coll_j, const void* coll_w,
                                  const void* ptr_t, const void* coll_i,
                                  long long S, long long M, void* corr_ptr,
                                  void* rank_lt, void* exec, void* cnt,
                                  const void* end, long long n, void* out,
                                  void* stream) {
  if (n == 0) return 0;
  Args a = make_args(key_sorted, order, B, pk, P, row_lookup, ptr, coll_j,
                     coll_w, ptr_t, coll_i, S, M, corr_ptr, rank_lt, exec,
                     cnt);
  a.end = static_cast<const int64_t*>(end);
  a.out_src = static_cast<int64_t*>(out);
  a.out_tgt = a.out_src + n;
  a.out_cw = reinterpret_cast<double*>(a.out_tgt + n);
  a.out_kind = reinterpret_cast<int8_t*>(a.out_cw + n);
  stream_kernel<true><<<blocks(P + B), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
