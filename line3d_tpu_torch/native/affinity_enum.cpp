// Native affinity-graph enumeration for line3d_tpu.
//
// The reference builds the sparse affinity matrix with a sequential
// host-side triple loop over best-match segments, their potential
// correspondents, and collinear partners, deduplicated through a `used`
// set whose order-dependence is semantically load-bearing
// (clusterSegments2D, reference line3D.cc:984-1221).  This is the same
// traversal in C++ with an open-addressing pair set — ~20x the numpy
// stream formulation at 1000-view production density, bit-identical
// output order (cluster/affinity.py keeps the numpy twin as the semantic
// reference; equivalence is pinned in tests/test_affinity.py).
//
// affinity_similarity: vectorized similarity_coll3D (line3D.cc:1600-1681)
// over candidate row pairs, double precision, OpenMP over pairs.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#if defined(_OPENMP)
#include <parallel/algorithm>
#endif

extern "C" {

// In-place multi-core sort + dedupe of an int64 key array; returns the
// unique count.  Backs _correspondence_pairs (the packed-pair np.unique is
// the hottest single numpy op at 1000-view scale: one 40M-element
// single-threaded sort).
int64_t sort_unique_i64(int64_t* a, int64_t n) {
#if defined(_OPENMP)
    __gnu_parallel::sort(a, a + n);
#else
    std::sort(a, a + n);
#endif
    return std::unique(a, a + n) - a;
}

namespace {

struct PairSet {
    std::vector<uint64_t> slots;
    uint64_t mask;
    explicit PairSet(int64_t expected) {
        size_t sz = 16;
        while (sz < static_cast<size_t>(2 * expected + 16)) sz <<= 1;
        slots.assign(sz, UINT64_MAX);
        mask = sz - 1;
    }
    // returns true when the key was fresh (inserted now)
    bool insert(uint64_t k) {
        uint64_t h = (k * 0x9E3779B97F4A7C15ull) & mask;
        for (;;) {
            uint64_t v = slots[h];
            if (v == k) return false;
            if (v == UINT64_MAX) { slots[h] = k; return true; }
            h = (h + 1) & mask;
        }
    }
};

inline uint64_t pair_key(int64_t a, int64_t b, int64_t M) {
    return a < b ? static_cast<uint64_t>(a) * M + b
                 : static_cast<uint64_t>(b) * M + a;
}

}  // namespace

// Candidate-capacity bound for affinity_enumerate: sum of collinear
// partner counts over the packed pairs' TARGET keys (b = packed % M),
// OpenMP.  Saves the caller a 30M-element divmod + gather at 1000-view
// scale.
int64_t affinity_capacity(const int64_t* allp_packed, int64_t P,
                          const int64_t* coll_ptr, int64_t M) {
    int64_t total = 0;
#pragma omp parallel for schedule(static) reduction(+ : total)
    for (int64_t q = 0; q < P; ++q) {
        const int64_t b = allp_packed[q] % M;
        total += coll_ptr[b + 1] - coll_ptr[b];
    }
    return total;
}

// Exact-order candidate enumeration.  Inputs:
//   key_sorted/srcrow_sorted [B]: best-match node keys ascending + their
//     row index (the reference iterates sources in ascending key order);
//   allp_packed [P]: symmetric verified-correspondence pairs PACKED as
//     a*M + b, sorted ascending — the potential_correspondences_ lists
//     (line3D.cc:861-865).  Taking them packed (the form the sort-unique
//     produces) saves the caller two 30M-element divmod passes + a stack;
//   row_lookup [M]: node key -> best row (-1 none);
//   coll_ptr [M+1] / coll_j / coll_w: per-key CSR of collinear partner
//     segments (ascending) and weights.
// Outputs (capacity `cap` = Na + NB + NC upper bound, caller-computed):
//   out_src/out_tgt rows, out_kind 0=A 1=B 2=C, out_cw collinear weight.
// Returns the number of emitted candidates.
int64_t affinity_enumerate_packed(
    const int64_t* key_sorted, const int64_t* srcrow_sorted, int64_t B,
    const int64_t* allp_packed, int64_t P,
    const int64_t* row_lookup,
    const int64_t* coll_ptr, const int64_t* coll_j, const double* coll_w,
    int64_t S, int64_t M, int64_t expected,
    int64_t* out_src, int64_t* out_tgt, int8_t* out_kind, double* out_cw) {
    PairSet used(expected);
    int64_t cnt = 0;
    int64_t p = 0;
    for (int64_t r = 0; r < B; ++r) {
        const int64_t sk = key_sorted[r];
        const int64_t srow = srcrow_sorted[r];
        const int64_t lo_key = sk * M, hi_key = (sk + 1) * M;
        while (p < P && allp_packed[p] < lo_key) ++p;
        // A: potential correspondents, ascending
        for (int64_t q = p; q < P && allp_packed[q] < hi_key; ++q) {
            const int64_t tk = allp_packed[q] - lo_key;
            if (!used.insert(pair_key(sk, tk, M))) continue;  // skips B too
            const int64_t trow = row_lookup[tk];
            if (trow < 0) continue;       // pair marked, no candidate, no B
            out_src[cnt] = srow; out_tgt[cnt] = trow;
            out_kind[cnt] = 0; out_cw[cnt] = 1.0; ++cnt;
            // B: collinear partners of the matched target
            const int64_t tbase = (tk / S) * S;
            for (int64_t c = coll_ptr[tk]; c < coll_ptr[tk + 1]; ++c) {
                const int64_t ck = tbase + coll_j[c];
                if (!used.insert(pair_key(sk, ck, M))) continue;
                const int64_t crow = row_lookup[ck];
                if (crow < 0) continue;
                out_src[cnt] = srow; out_tgt[cnt] = crow;
                out_kind[cnt] = 1; out_cw[cnt] = 1.0; ++cnt;
            }
        }
        // C: the source's own collinear partners
        const int64_t sbase = (sk / S) * S;
        for (int64_t c = coll_ptr[sk]; c < coll_ptr[sk + 1]; ++c) {
            const int64_t ck = sbase + coll_j[c];
            if (!used.insert(pair_key(sk, ck, M))) continue;
            const int64_t crow = row_lookup[ck];
            if (crow < 0) continue;
            out_src[cnt] = srow; out_tgt[cnt] = crow;
            out_kind[cnt] = 2; out_cw[cnt] = coll_w[c]; ++cnt;
        }
    }
    return cnt;
}

namespace {

// similarity_coll3D for one candidate pair (line3D.cc:1600-1681):
// min-fused endpoint point-to-line Gaussians under the depth-scaled
// uncertainty model (view.cc:353-377) and the angle Gaussian.  Double
// precision, same operation order as the numpy twin (cluster/affinity.py).
inline double similarity_one(
    int64_t a, int64_t b,
    const double* P1, const double* P2, const double* dirv,
    const float* d1, const float* d2, const int32_t* view,
    const double* k_lower, const double* k_upper,
    const double* median_depth, double sa2) {
    const double log001x2 = 2.0 * std::log(0.01);
    const double rad2deg = 180.0 / 3.14159265358979323846;

    // one direction: rows e's endpoints against rows o's line,
    // uncertainties of e
    auto side = [&](int64_t e, int64_t o) -> double {
        const double* p1o = P1 + 3 * o;
        const double* do_ = dirv + 3 * o;
        auto p2l = [&](const double* X) -> double {
            const double dx = X[0] - p1o[0];
            const double dy = X[1] - p1o[1];
            const double dz = X[2] - p1o[2];
            const double t = dx * do_[0] + dy * do_[1] + dz * do_[2];
            const double q = dx * dx + dy * dy + dz * dz - t * t;
            return std::sqrt(q > 0.0 ? q : 0.0);
        };
        const double da = p2l(P1 + 3 * e);
        const double db = p2l(P2 + 3 * e);
        const int32_t v = view[e];
        const double med = median_depth[v];
        const double de1 = static_cast<double>(d1[e]);
        const double de2 = static_cast<double>(d2[e]);
        const double m1 = k_lower[v] * (de1 < med ? de1 : med);
        const double m2 = k_lower[v] * (de2 < med ? de2 : med);
        const double u1 = k_upper[v] * (de1 < med ? de1 : med);
        const double u2 = k_upper[v] * (de2 < med ? de2 : med);
        const double s1sq = -(u1 - m1) * (u1 - m1) / log001x2;
        const double s2sq = -(u2 - m2) * (u2 - m2) / log001x2;
        const double e1 = da < m1 ? 1.0
            : std::exp(-(da - m1) * (da - m1) / (2.0 * s1sq));
        const double e2 = db < m2 ? 1.0
            : std::exp(-(db - m2) * (db - m2) / (2.0 * s2sq));
        return e1 < e2 ? e1 : e2;
    };

    const double w12 = side(a, b);
    const double w34 = side(b, a);
    double wd = w12 < w34 ? w12 : w34;

    const double* da_ = dirv + 3 * a;
    const double* db_ = dirv + 3 * b;
    double dot = da_[0] * db_[0] + da_[1] * db_[1] + da_[2] * db_[2];
    if (dot > 1.0) dot = 1.0;
    if (dot < -1.0) dot = -1.0;
    double ang = std::acos(dot) * rad2deg;
    if (ang > 90.0) ang = 180.0 - ang;
    const double wa = std::exp(-ang * ang / sa2);

    double s = wd < wa ? wd : wa;
    return s <= 0.01 ? 0.0 : s;
}

// Parallel phase of the finalize: per-candidate similarity, weight,
// per-kind threshold -> w or -1 sentinel, for the candidate slice
// [lo, hi).  Split out of affinity_finalize so a multi-host run can
// shard the sweep (each host computes its contiguous slice, the slices
// are allgathered, and every host runs the cheap sequential emission
// identically — cluster/affinity.py:_finalize_candidates_sharded).
void weights_range(
    const int64_t* src_rows, const int64_t* tgt_rows,
    const int8_t* kind, const double* cw, int64_t lo, int64_t hi,
    const float* score,
    const double* P1, const double* P2, const double* dirv,
    const float* d1, const float* d2, const int32_t* view,
    const double* k_lower, const double* k_upper,
    const double* median_depth,
    double sigma_a, double min_affinity, double collinear_affinity,
    double* w_out) {
    const double sa2 = 2.0 * sigma_a * sigma_a;
#pragma omp parallel for schedule(static)
    for (int64_t i = lo; i < hi; ++i) {
        const int64_t a = src_rows[i], b = tgt_rows[i];
        const double sim = similarity_one(a, b, P1, P2, dirv, d1, d2, view,
                                          k_lower, k_upper, median_depth,
                                          sa2);
        const double base = 0.5 * (static_cast<double>(score[a]) +
                                   static_cast<double>(score[b]));
        const double wv = (kind[i] == 2 ? cw[i] : 1.0) * base * sim;
        const double thr = kind[i] == 0 ? min_affinity : collinear_affinity;
        w_out[i - lo] = wv > thr ? wv : -1.0;     // sentinel: dropped
    }
}

// Sequential phase: node ids at first touch (emission order — exactly the
// reference's map behavior, line3D.cc:1019-1050) + interleaved symmetric
// edge emission.  Returns the directed-pair count E (edge arrays hold 2E).
int64_t emit_edges(
    const double* w, const int64_t* src_rows, const int64_t* tgt_rows,
    int64_t n, int64_t B,
    int32_t* edges_i, int32_t* edges_j, float* edges_w,
    int64_t* node_rows, int64_t* n_nodes) {
    std::vector<int64_t> node_of(B, -1);
    int64_t nn = 0, e = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (w[i] < 0.0) continue;
        const int64_t a = src_rows[i], b = tgt_rows[i];
        int64_t na = node_of[a];
        if (na < 0) { na = node_of[a] = nn; node_rows[nn++] = a; }
        int64_t nb = node_of[b];
        if (nb < 0) { nb = node_of[b] = nn; node_rows[nn++] = b; }
        const float wf = static_cast<float>(w[i]);
        edges_i[2 * e] = static_cast<int32_t>(na);
        edges_j[2 * e] = static_cast<int32_t>(nb);
        edges_w[2 * e] = wf;
        edges_i[2 * e + 1] = static_cast<int32_t>(nb);
        edges_j[2 * e + 1] = static_cast<int32_t>(na);
        edges_w[2 * e + 1] = wf;
        ++e;
    }
    *n_nodes = nn;
    return e;
}

}  // namespace

// Host-shardable halves of affinity_finalize (see weights_range): the
// OpenMP weight sweep over a candidate slice, and the sequential
// emission over a full (gathered) weight array.
void affinity_weights_range(
    const int64_t* src_rows, const int64_t* tgt_rows,
    const int8_t* kind, const double* cw, int64_t lo, int64_t hi,
    const float* score,
    const double* P1, const double* P2, const double* dirv,
    const float* d1, const float* d2, const int32_t* view,
    const double* k_lower, const double* k_upper,
    const double* median_depth,
    double sigma_a, double min_affinity, double collinear_affinity,
    double* w_out) {
    weights_range(src_rows, tgt_rows, kind, cw, lo, hi, score, P1, P2, dirv,
                  d1, d2, view, k_lower, k_upper, median_depth, sigma_a,
                  min_affinity, collinear_affinity, w_out);
}

int64_t affinity_emit(
    const double* w, const int64_t* src_rows, const int64_t* tgt_rows,
    int64_t n, int64_t B,
    int32_t* edges_i, int32_t* edges_j, float* edges_w,
    int64_t* node_rows, int64_t* n_nodes) {
    return emit_edges(w, src_rows, tgt_rows, n, B, edges_i, edges_j,
                      edges_w, node_rows, n_nodes);
}

// Vectorized similarity_coll3D over candidate row pairs, OpenMP.
void affinity_similarity(
    const int64_t* src_rows, const int64_t* tgt_rows, int64_t n,
    const double* P1, const double* P2, const double* dirv,  // [B x 3]
    const float* d1, const float* d2, const int32_t* view,   // [B]
    const double* k_lower, const double* k_upper,            // [V]
    const double* median_depth,                              // [V]
    double sigma_a, double* sim_out) {
    const double sa2 = 2.0 * sigma_a * sigma_a;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        sim_out[i] = similarity_one(src_rows[i], tgt_rows[i], P1, P2, dirv,
                                    d1, d2, view, k_lower, k_upper,
                                    median_depth, sa2);
    }
}

// Fused finalize of the candidate stream (_finalize_candidates'
// similarity + weight + threshold + emission-order node assignment +
// symmetric edge emission, line3D.cc:1019-1221, in one native pass — the
// numpy formulation made ~10 full passes over the 30M-candidate stream
// and was the largest single cost of the 1000-view cluster stage).
//   Parallel phase (OpenMP): per-candidate similarity, weight, per-kind
//   threshold -> w or NaN sentinel.
//   Sequential phase: single pass assigning node ids at first touch
//   (emission order, exactly the reference's map behavior) and writing
//   the interleaved symmetric edge list.
// Outputs: edges_* capacity 2n, node_rows capacity B.  Returns E
// (directed-pair count; edges arrays hold 2E), node count via n_nodes.
int64_t affinity_finalize(
    const int64_t* src_rows, const int64_t* tgt_rows,
    const int8_t* kind, const double* cw, int64_t n,
    const float* score, int64_t B,
    const double* P1, const double* P2, const double* dirv,
    const float* d1, const float* d2, const int32_t* view,
    const double* k_lower, const double* k_upper,
    const double* median_depth,
    double sigma_a, double min_affinity, double collinear_affinity,
    int32_t* edges_i, int32_t* edges_j, float* edges_w,
    int64_t* node_rows, int64_t* n_nodes) {
    std::vector<double> w(n);
    weights_range(src_rows, tgt_rows, kind, cw, 0, n, score, P1, P2, dirv,
                  d1, d2, view, k_lower, k_upper, median_depth, sigma_a,
                  min_affinity, collinear_affinity, w.data());
    return emit_edges(w.data(), src_rows, tgt_rows, n, B, edges_i, edges_j,
                      edges_w, node_rows, n_nodes);
}

}  // extern "C"
