// Native runtime kernels for line3d_tpu: the inherently-sequential host-side
// stages that the reference also runs natively (C++), exposed through a plain
// C ABI for ctypes.
//
// fh_cluster: Felzenszwalb-Huttenlocher graph clustering with the exact merge
// semantics of the reference (clustering.cc:6-47, universe.h:60-115).  The
// caller passes edges pre-sorted ascending by weight (stable).
//
// sweep_events: the open/close camera-count sweep of projectToLine
// (line3D.cc:1554-1596) for one cluster; events pre-sorted by distance.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

extern "C" {

struct UF {
    std::vector<int64_t> parent;
    std::vector<int32_t> rank;
    std::vector<int64_t> size;
    explicit UF(int64_t n) : parent(n), rank(n, 0), size(n, 1) {
        for (int64_t i = 0; i < n; ++i) parent[i] = i;
    }
    int64_t find(int64_t x) {
        int64_t root = x;
        while (parent[root] != root) root = parent[root];
        parent[x] = root;  // single-node compression, as the reference does
        return root;
    }
    // returns new root
    int64_t join(int64_t a, int64_t b) {
        if (rank[a] > rank[b]) {
            parent[b] = a;
            size[a] += size[b];
            return a;
        }
        parent[a] = b;
        size[b] += size[a];
        if (rank[a] == rank[b]) rank[b] += 1;
        return b;
    }
};

void fh_cluster(const int64_t* edges_i, const int64_t* edges_j,
                const double* edges_w, int64_t num_edges,
                int64_t num_nodes, double c, int64_t* labels_out) {
    UF uf(num_nodes);
    std::vector<double> threshold(num_nodes, c);
    for (int64_t k = 0; k < num_edges; ++k) {
        int64_t a = uf.find(edges_i[k]);
        int64_t b = uf.find(edges_j[k]);
        if (a == b) continue;
        double w = edges_w[k];
        if (w <= threshold[a] && w <= threshold[b]) {
            int64_t root = uf.join(a, b);
            threshold[root] = w + c / static_cast<double>(uf.size[root]);
        }
    }
    for (int64_t i = 0; i < num_nodes; ++i) labels_out[i] = uf.find(i);
}

// Sweep over 2*n sorted endpoint events.  seg_id[e] identifies the member
// segment of event e, cam_id[e] its camera.  Emits up to n (start,end) event
// index pairs where the number of distinct open cameras is >= min_open.
// Returns the number of emitted sub-segments.
int64_t sweep_events(const int64_t* seg_id, const int64_t* cam_id,
                     int64_t num_events, int64_t min_open,
                     int64_t max_cam, int64_t* out_start, int64_t* out_end) {
    std::vector<int8_t> open_seg(num_events, 0);
    std::vector<int32_t> open_cam(max_cam + 1, 0);
    int64_t open_cams = 0;
    bool opened = false;
    int64_t current_start = -1;
    int64_t count = 0;
    for (int64_t e = 0; e < num_events; ++e) {
        int64_t s = seg_id[e];
        int64_t cam = cam_id[e];
        if (!open_seg[s]) {
            open_seg[s] = 1;
            if (open_cam[cam]++ == 0) ++open_cams;
        } else {
            open_seg[s] = 0;
            if (--open_cam[cam] == 0) --open_cams;
        }
        if (opened && open_cams < min_open) {
            out_start[count] = current_start;
            out_end[count] = e;
            ++count;
            opened = false;
        } else if (!opened && open_cams >= min_open) {
            current_start = e;
            opened = true;
        }
    }
    return count;
}

// Batched sweep: sweep_events over C clusters in one call.  Events of
// cluster c live at [cluster_ptr[c], cluster_ptr[c+1]); seg ids are local
// to the cluster (0..n_c-1).  Emits (start, end) event indices GLOBAL to
// the concatenated array plus the owning cluster id.  Returns the total
// number of sub-segments.
int64_t sweep_events_batched(const int64_t* seg_id, const int64_t* cam_id,
                             const int64_t* cluster_ptr, int64_t num_clusters,
                             int64_t min_open, int64_t max_cam,
                             int64_t* out_start, int64_t* out_end,
                             int64_t* out_cluster) {
    std::vector<int8_t> open_seg;
    std::vector<int32_t> open_cam(max_cam + 1, 0);
    int64_t count = 0;
    for (int64_t c = 0; c < num_clusters; ++c) {
        const int64_t lo = cluster_ptr[c], hi = cluster_ptr[c + 1];
        const int64_t n = hi - lo;
        if (static_cast<int64_t>(open_seg.size()) < n) open_seg.resize(n);
        for (int64_t i = 0; i < n; ++i) open_seg[i] = 0;
        int64_t open_cams = 0;
        bool opened = false;
        int64_t current_start = -1;
        for (int64_t e = lo; e < hi; ++e) {
            const int64_t s = seg_id[e];
            const int64_t cam = cam_id[e];
            if (!open_seg[s]) {
                open_seg[s] = 1;
                if (open_cam[cam]++ == 0) ++open_cams;
            } else {
                open_seg[s] = 0;
                if (--open_cam[cam] == 0) --open_cams;
            }
            if (opened && open_cams < min_open) {
                out_start[count] = current_start;
                out_end[count] = e;
                out_cluster[count] = c;
                ++count;
                opened = false;
            } else if (!opened && open_cams >= min_open) {
                current_start = e;
                opened = true;
            }
        }
        // reset touched cam counters for the next cluster
        for (int64_t e = lo; e < hi; ++e) open_cam[cam_id[e]] = 0;
    }
    return count;
}

// ---------------------------------------------------------------------
// Detection support: connected components over the pixel grid with a
// pairwise gradient-angle gate (the line-support regions of the vectorized
// LSD, detect/vectorized_lsd.py), plus per-component moment statistics and
// axis-extent reductions.  These are host-sequential-friendly (exactly like
// the reference's C++ LSD) and ~10x faster here than gather-based label
// propagation on an accelerator.

static inline double angle_diff(double a, double b) {
    double d = a - b;
    while (d > M_PI) d -= 2.0 * M_PI;
    while (d < -M_PI) d += 2.0 * M_PI;
    return d < 0 ? -d : d;
}

// 8-connected union-find CC where both pixels are defined and their angles
// agree within min(tol_a, tol_b).  Writes compact component ids (or -1) and
// returns the number of components.
//
// Parallelized in row stripes: each thread unions the edges fully interior
// to its stripe (parent writes stay within the stripe's disjoint index
// range), then the edges touching stripe-boundary rows are processed
// serially.  The component partition is order-independent, and the compact
// ids are assigned by a serial first-encounter scan, so the result is
// bit-identical to the sequential version.
int64_t grid_cc_compact(const float* angle, const uint8_t* defined,
                        const float* tol, int64_t H, int64_t W,
                        int32_t* labels_out) {
    const int64_t N = H * W;
    std::vector<int32_t> parent(N);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < N; ++i) parent[i] = static_cast<int32_t>(i);

    struct Find {
        std::vector<int32_t>& p;
        int32_t operator()(int32_t x) {
            int32_t root = x;
            while (p[root] != root) root = p[root];
            while (p[x] != root) { int32_t nxt = p[x]; p[x] = root; x = nxt; }
            return root;
        }
    } find{parent};

    // forward neighbors: W, NW, N, NE (each undirected edge visited once)
    const int64_t dy[4] = {0, -1, -1, -1};
    const int64_t dx[4] = {-1, -1, 0, 1};
    auto do_row = [&](int64_t y) {
        for (int64_t x = 0; x < W; ++x) {
            const int64_t i = y * W + x;
            if (!defined[i]) continue;
            const double ai = angle[i];
            const double ti = tol[i];
            for (int k = 0; k < 4; ++k) {
                const int64_t ny = y + dy[k], nx = x + dx[k];
                if (ny < 0 || nx < 0 || nx >= W) continue;
                const int64_t j = ny * W + nx;
                if (!defined[j]) continue;
                const double t = ti < tol[j] ? ti : tol[j];
                if (angle_diff(ai, angle[j]) <= t) {
                    int32_t ra = find(static_cast<int32_t>(i));
                    int32_t rb = find(static_cast<int32_t>(j));
                    if (ra != rb) parent[rb] = ra;
                }
            }
        }
    };

#ifdef _OPENMP
    const int max_t = omp_get_max_threads();
#else
    const int max_t = 1;
#endif
    const int64_t stripe = (max_t > 1) ? (H + max_t - 1) / max_t : H;
    if (max_t > 1 && stripe >= 4) {
#ifdef _OPENMP
#pragma omp parallel num_threads(max_t)
        {
            const int tid = omp_get_thread_num();
            const int64_t y0 = tid * stripe;
            const int64_t y1 = std::min<int64_t>(y0 + stripe, H);
            // rows whose forward neighbors (row y-1) stay inside the stripe
            for (int64_t y = y0 + 1; y < y1; ++y) do_row(y);
        }
#endif
        // stripe-boundary rows (forward edges reach the previous stripe)
        for (int64_t y0 = 0; y0 < H; y0 += stripe) do_row(y0);
    } else {
        for (int64_t y = 0; y < H; ++y) do_row(y);
    }

    // compact ids (serial: first-encounter order defines the ids)
    std::vector<int32_t> compact(N, -1);
    int32_t next_id = 0;
    for (int64_t i = 0; i < N; ++i) {
        if (!defined[i]) { labels_out[i] = -1; continue; }
        int32_t r = find(static_cast<int32_t>(i));
        if (compact[r] < 0) compact[r] = next_id++;
        labels_out[i] = compact[r];
    }
    return next_id;
}

// per-component moments: count, sw, swx, swy, swxx, swyy, swxy, sca, ssa
// (region2rect/get_theta inputs).  out: [C x 9] doubles, zero-initialized
// by the caller.
void region_moments(const int32_t* labels, const float* w,
                    const float* angle, int64_t H, int64_t W,
                    double* out) {
    // components are spatially contiguous, so a row-stripe split touches
    // each component from at most a few threads; per-thread accumulators
    // merged in thread order keep the result deterministic (each
    // component's contributions are summed stripe-by-stripe in a fixed
    // order — identical to the serial row order only up to fp association
    // at stripe boundaries, which downstream fits are insensitive to; the
    // native-vs-python equivalence test runs single-stripe shapes exactly)
    int64_t C = 0;
    const int64_t N = H * W;
    for (int64_t i = 0; i < N; ++i) if (labels[i] >= C) C = labels[i] + 1;

    auto accum_rows = [&](int64_t y0, int64_t y1, double* o_all) {
        for (int64_t y = y0; y < y1; ++y) {
            for (int64_t x = 0; x < W; ++x) {
                const int64_t i = y * W + x;
                const int32_t c = labels[i];
                if (c < 0) continue;
                double* o = o_all + static_cast<int64_t>(c) * 9;
                const double wi = w[i];
                const double fx = static_cast<double>(x);
                const double fy = static_cast<double>(y);
                o[0] += 1.0;
                o[1] += wi;
                o[2] += wi * fx;
                o[3] += wi * fy;
                o[4] += wi * fx * fx;
                o[5] += wi * fy * fy;
                o[6] += wi * fx * fy;
                o[7] += std::cos(static_cast<double>(angle[i]));
                o[8] += std::sin(static_cast<double>(angle[i]));
            }
        }
    };

#ifdef _OPENMP
    const int max_t = omp_get_max_threads();
    // the per-thread accumulators + merge cost O(threads * C * 9); only
    // worth it when components average enough pixels (tiny-component
    // floods are faster serial)
    if (max_t > 1 && H >= 64 && C * 18 < N) {
        const int64_t stripe = (H + max_t - 1) / max_t;
        std::vector<std::vector<double>> part(max_t);
#pragma omp parallel num_threads(max_t)
        {
            const int tid = omp_get_thread_num();
            const int64_t y0 = tid * stripe;
            const int64_t y1 = std::min<int64_t>(y0 + stripe, H);
            if (y0 < y1) {
                part[tid].assign(static_cast<size_t>(C) * 9, 0.0);
                accum_rows(y0, y1, part[tid].data());
            }
        }
        for (int t = 0; t < max_t; ++t) {
            if (part[t].empty()) continue;
            const double* p = part[t].data();
#pragma omp parallel for schedule(static)
            for (int64_t k = 0; k < C * 9; ++k) out[k] += p[k];
        }
        return;
    }
#endif
    accum_rows(0, H, out);
}

// per-component extents along (dx, dy) through (cx, cy):
// out [C x 4] = l_min, l_max, w_min, w_max; caller initializes to
// +inf/-inf/+inf/-inf.
void region_extents(const int32_t* labels, int64_t H, int64_t W,
                    const double* cx, const double* cy,
                    const double* dx, const double* dy,
                    double* out) {
    auto scan_rows = [&](int64_t y0, int64_t y1, double* o_all) {
        for (int64_t y = y0; y < y1; ++y) {
            for (int64_t x = 0; x < W; ++x) {
                const int64_t i = y * W + x;
                const int32_t c = labels[i];
                if (c < 0) continue;
                const double rx = static_cast<double>(x) - cx[c];
                const double ry = static_cast<double>(y) - cy[c];
                const double l = rx * dx[c] + ry * dy[c];
                const double wd = -rx * dy[c] + ry * dx[c];
                double* o = o_all + static_cast<int64_t>(c) * 4;
                if (l < o[0]) o[0] = l;
                if (l > o[1]) o[1] = l;
                if (wd < o[2]) o[2] = wd;
                if (wd > o[3]) o[3] = wd;
            }
        }
    };

#ifdef _OPENMP
    const int max_t = omp_get_max_threads();
    const int64_t N = H * W;
    int64_t C = 0;
    if (max_t > 1 && H >= 64)
        for (int64_t i = 0; i < N; ++i) if (labels[i] >= C) C = labels[i] + 1;
    if (max_t > 1 && H >= 64 && C * 8 < N) {
        const int64_t stripe = (H + max_t - 1) / max_t;
        std::vector<std::vector<double>> part(max_t);
#pragma omp parallel num_threads(max_t)
        {
            const int tid = omp_get_thread_num();
            const int64_t y0 = tid * stripe;
            const int64_t y1 = std::min<int64_t>(y0 + stripe, H);
            if (y0 < y1) {
                part[tid].resize(static_cast<size_t>(C) * 4);
                for (int64_t c = 0; c < C; ++c) {
                    part[tid][c * 4 + 0] = 1e300;
                    part[tid][c * 4 + 1] = -1e300;
                    part[tid][c * 4 + 2] = 1e300;
                    part[tid][c * 4 + 3] = -1e300;
                }
                scan_rows(y0, y1, part[tid].data());
            }
        }
        for (int t = 0; t < max_t; ++t) {
            if (part[t].empty()) continue;
            const double* p = part[t].data();
#pragma omp parallel for schedule(static)
            for (int64_t c = 0; c < C; ++c) {
                if (p[c * 4 + 0] < out[c * 4 + 0]) out[c * 4] = p[c * 4];
                if (p[c * 4 + 1] > out[c * 4 + 1])
                    out[c * 4 + 1] = p[c * 4 + 1];
                if (p[c * 4 + 2] < out[c * 4 + 2])
                    out[c * 4 + 2] = p[c * 4 + 2];
                if (p[c * 4 + 3] > out[c * 4 + 3])
                    out[c * 4 + 3] = p[c * 4 + 3];
            }
        }
        return;
    }
#endif
    scan_rows(0, H, out);
}

// ---------------------------------------------------------------------
// Seeded carving of low-density components: the reference LSD's main
// seed loop (lsd_opencv.cpp:576-633) restricted to the pixels of the
// failing pass-1 components.  Each component is carved by repeatedly
// seeding at its strongest unused gradient pixel, growing a region
// aligned with the RUNNING MEAN angle (region_grow, lsd_opencv.cpp:
// 735-786), and recovering low-density regions with the tolerance
// re-estimate + regrow of refine (lsd_opencv.cpp:884-930) and the
// radius-shrink loop of reduce_region_radius (lsd_opencv.cpp:932-969).
// Pixels released by refine/radius-reduce become available to later
// seeds, so one noise-glued blob yields several clean segments.
//
// Divergence (documented in PARITY.md): growth never crosses out of the
// owning pass-1 component — carving is per-component data-parallel and
// deterministic, where the reference's global seed ordering could graft
// neighbouring unused pixels onto a region.

namespace {

struct CarveFit {
    double count, sw, cx, cy, dx, dy, l_min, l_max, w_min, w_max;
    double density;
};

// region2rect + get_theta (lsd_opencv.cpp:788-882) over an explicit
// pixel list.  Returns false when the weighted sum degenerates.
static bool fit_region(const std::vector<int64_t>& reg, int64_t n,
                       const float* norm, double reg_angle, double prec,
                       int64_t W, CarveFit* out) {
    double x = 0, y = 0, sum = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t a = reg[i];
        const double wgt = norm[a];
        x += double(a % W) * wgt;
        y += double(a / W) * wgt;
        sum += wgt;
    }
    if (!(sum > 0)) return false;
    x /= sum;
    y /= sum;
    double Ixx = 0, Iyy = 0, Ixy = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t a = reg[i];
        const double wgt = norm[a];
        const double ddx = double(a % W) - x;
        const double ddy = double(a / W) - y;
        Ixx += ddy * ddy * wgt;
        Iyy += ddx * ddx * wgt;
        Ixy -= ddx * ddy * wgt;
    }
    const double lambda =
        0.5 * (Ixx + Iyy - std::sqrt((Ixx - Iyy) * (Ixx - Iyy) +
                                     4.0 * Ixy * Ixy));
    double theta = (std::fabs(Ixx) > std::fabs(Iyy))
                       ? std::atan2(lambda - Ixx, Ixy)
                       : std::atan2(Ixy, lambda - Iyy);
    if (angle_diff(theta, reg_angle) > prec) theta += M_PI;
    const double dx = std::cos(theta), dy = std::sin(theta);
    double l_min = 0, l_max = 0, w_min = 0, w_max = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t a = reg[i];
        const double rx = double(a % W) - x;
        const double ry = double(a / W) - y;
        const double l = rx * dx + ry * dy;
        const double w = -rx * dy + ry * dx;
        if (l > l_max) l_max = l; else if (l < l_min) l_min = l;
        if (w > w_max) w_max = w; else if (w < w_min) w_min = w;
    }
    double width = w_max - w_min;
    if (width < 1.0) width = 1.0;
    out->count = double(n);
    out->sw = sum;
    out->cx = x; out->cy = y;
    out->dx = dx; out->dy = dy;
    out->l_min = l_min; out->l_max = l_max;
    out->w_min = w_min; out->w_max = w_max;
    const double len = l_max - l_min;
    out->density = (len * width > 0) ? double(n) / (len * width) : 0.0;
    return true;
}

// region_grow (lsd_opencv.cpp:735-786): BFS from seed over state==1
// pixels OF THE OWNING PASS-1 COMPONENT (labels gate — growth never
// crosses component boundaries, the documented divergence that makes
// carving per-component data-parallel), gated by alignment with the
// running mean angle; grown pixels flip to state 2.  Returns region size;
// reg_angle returns the mean.
static int64_t grow(int64_t seed, const float* angle, uint8_t* state,
                    const int32_t* labels, int32_t comp,
                    int64_t H, int64_t W, double tol,
                    std::vector<int64_t>& reg, double* reg_angle) {
    reg.clear();
    reg.push_back(seed);
    state[seed] = 2;
    double ang = angle[seed];
    double sumdx = std::cos(ang), sumdy = std::sin(ang);
    for (size_t i = 0; i < reg.size(); ++i) {
        const int64_t a = reg[i];
        const int64_t x = a % W, y = a / W;
        const int64_t xlo = x > 0 ? x - 1 : 0;
        const int64_t xhi = x < W - 1 ? x + 1 : W - 1;
        const int64_t ylo = y > 0 ? y - 1 : 0;
        const int64_t yhi = y < H - 1 ? y + 1 : H - 1;
        for (int64_t yy = ylo; yy <= yhi; ++yy) {
            for (int64_t xx = xlo; xx <= xhi; ++xx) {
                const int64_t b = yy * W + xx;
                if (labels[b] != comp) continue;
                if (state[b] != 1) continue;
                if (angle_diff(double(angle[b]), ang) > tol) continue;
                state[b] = 2;
                reg.push_back(b);
                sumdx += std::cos(double(angle[b]));
                sumdy += std::sin(double(angle[b]));
                ang = std::atan2(sumdy, sumdx);
            }
        }
    }
    *reg_angle = ang;
    return int64_t(reg.size());
}

}  // namespace

// Carve the failing components.  labels: compact pass-1 CC ids [H*W]
// (-1 undefined); comp_fail[c] selects components to carve.  Emits up to
// max_out rows of 10 doubles (count, sw, cx, cy, dx, dy, l_min, l_max,
// w_min, w_max); returns rows written.
namespace {

// Carve ONE failing component: the reference's seed loop
// (lsd_opencv.cpp:576-633) restricted to the component's pixels.
// `cand` must be the component's pixel list sorted by decreasing gradient
// magnitude (index tie-break); `state` is the shared per-pixel state array
// — each component's pixels are disjoint, so concurrent carves never touch
// the same entries.  Appends 10-double fit rows to `fits`.
static void carve_component(const std::vector<int64_t>& cand, int32_t comp,
                            const float* norm, const float* angle,
                            const int32_t* labels, uint8_t* state,
                            int64_t H, int64_t W, double prec,
                            double density_th, int64_t min_reg_size,
                            std::vector<double>& fits) {
    std::vector<int64_t> reg;
    reg.reserve(cand.size());
    for (const int64_t seed : cand) {
        if (state[seed] != 1) continue;
        double reg_angle;
        int64_t n = grow(seed, angle, state, labels, comp, H, W, prec, reg,
                         &reg_angle);
        if (n < min_reg_size) continue;  // pixels stay used (line 586)
        CarveFit fit;
        if (!fit_region(reg, n, norm, reg_angle, prec, W, &fit)) continue;

        if (fit.density < density_th) {
            // refine (lsd_opencv.cpp:884-930): release, re-estimate the
            // tolerance from angles near the seed, regrow
            const double sx = double(seed % W), sy = double(seed / W);
            const double ang_c = angle[seed];
            const double width = std::max(fit.w_max - fit.w_min, 1.0);
            double s = 0, ss = 0;
            int64_t m = 0;
            for (int64_t i = 0; i < n; ++i) {
                const int64_t a = reg[i];
                state[a] = 1;  // release (line 900)
                const double px = double(a % W), py = double(a / W);
                if ((px - sx) * (px - sx) + (py - sy) * (py - sy) <
                    width * width) {
                    double d = double(angle[a]) - ang_c;
                    while (d > M_PI) d -= 2.0 * M_PI;
                    while (d < -M_PI) d += 2.0 * M_PI;
                    s += d;
                    ss += d * d;
                    ++m;
                }
            }
            const double mean = s / double(m);
            const double tau =
                2.0 * std::sqrt((ss - 2.0 * mean * s) / double(m) +
                                mean * mean);
            n = grow(seed, angle, state, labels, comp, H, W, tau, reg,
                     &reg_angle);
            if (n < 2) continue;  // regrown pixels stay used (line 917)
            if (!fit_region(reg, n, norm, reg_angle, prec, W, &fit))
                continue;

            if (fit.density < density_th) {
                // reduce_region_radius (lsd_opencv.cpp:932-969)
                const double ex1 = fit.cx + fit.l_min * fit.dx;
                const double ey1 = fit.cy + fit.l_min * fit.dy;
                const double ex2 = fit.cx + fit.l_max * fit.dx;
                const double ey2 = fit.cy + fit.l_max * fit.dy;
                const double r1 = (sx - ex1) * (sx - ex1) +
                                  (sy - ey1) * (sy - ey1);
                const double r2 = (sx - ex2) * (sx - ex2) +
                                  (sy - ey2) * (sy - ey2);
                double radSq = r1 > r2 ? r1 : r2;
                bool ok = true;
                while (fit.density < density_th) {
                    radSq *= 0.75 * 0.75;
                    int64_t k = 0;
                    for (int64_t i = 0; i < n; ++i) {
                        const int64_t a = reg[i];
                        const double px = double(a % W);
                        const double py = double(a / W);
                        if ((px - sx) * (px - sx) + (py - sy) * (py - sy)
                                > radSq) {
                            state[a] = 1;  // release (line 951)
                        } else {
                            reg[k++] = a;
                        }
                    }
                    n = k;
                    if (n < 2) { ok = false; break; }
                    if (!fit_region(reg, n, norm, reg_angle, prec, W,
                                    &fit)) { ok = false; break; }
                }
                if (!ok) continue;
            }
        }
        if (n < min_reg_size) continue;  // NFA floor needs min_reg_size
        const double o[10] = {fit.count, fit.sw, fit.cx, fit.cy,
                              fit.dx, fit.dy, fit.l_min, fit.l_max,
                              fit.w_min, fit.w_max};
        fits.insert(fits.end(), o, o + 10);
    }
}

}  // namespace

int64_t lsd_carve(const float* norm, const float* angle,
                  const int32_t* labels, const uint8_t* comp_fail,
                  int64_t n_comps, int64_t H, int64_t W,
                  double prec, double density_th, int64_t min_reg_size,
                  double* out, int64_t max_out) {
    const int64_t N = H * W;
    // group the failing components' pixels by component (carving is
    // per-component independent — growth is confined to the owning
    // component — so components carve in parallel)
    std::vector<int64_t> count(n_comps, 0);
    for (int64_t i = 0; i < N; ++i) {
        const int32_t c = labels[i];
        if (c >= 0 && c < n_comps && comp_fail[c]) ++count[c];
    }
    std::vector<int32_t> fail_ids;
    for (int32_t c = 0; c < n_comps; ++c)
        if (comp_fail[c] && count[c] > 0) fail_ids.push_back(c);
    if (fail_ids.empty()) return 0;

    std::vector<int64_t> offset(n_comps + 1, 0);
    for (int64_t c = 0; c < n_comps; ++c)
        offset[c + 1] = offset[c] + count[c];
    std::vector<int64_t> pix(offset[n_comps]);
    {
        std::vector<int64_t> cur(offset.begin(), offset.end() - 1);
        for (int64_t i = 0; i < N; ++i) {
            const int32_t c = labels[i];
            if (c >= 0 && c < n_comps && comp_fail[c]) pix[cur[c]++] = i;
        }
    }

    // state: 0 = not a carve pixel, 1 = available, 2 = used (shared, but
    // per-component disjoint)
    std::vector<uint8_t> state(N, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (size_t k = 0; k < pix.size(); ++k) state[pix[k]] = 1;

    // biggest components first: the parallel loop's tail stays short
    std::sort(fail_ids.begin(), fail_ids.end(), [&](int32_t a, int32_t b) {
        if (count[a] != count[b]) return count[a] > count[b];
        return a < b;
    });

    const int64_t F = static_cast<int64_t>(fail_ids.size());
    std::vector<std::vector<double>> fits(F);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int64_t k = 0; k < F; ++k) {
        const int32_t c = fail_ids[k];
        std::vector<int64_t> cand(pix.begin() + offset[c],
                                  pix.begin() + offset[c] + count[c]);
        // seed order: decreasing gradient magnitude (the reference's
        // 1024-bin pseudo-sort, lsd_opencv.cpp:700-733, made exact)
        std::sort(cand.begin(), cand.end(), [&](int64_t a, int64_t b) {
            if (norm[a] != norm[b]) return norm[a] > norm[b];
            return a < b;  // deterministic tie-break
        });
        carve_component(cand, c, norm, angle, labels, state.data(),
                        H, W, prec, density_th, min_reg_size, fits[k]);
    }

    // merge in component order (deterministic regardless of schedule)
    int64_t rows = 0;
    for (int64_t k = 0; k < F && rows < max_out; ++k) {
        const int64_t nr = static_cast<int64_t>(fits[k].size()) / 10;
        for (int64_t r = 0; r < nr && rows < max_out; ++r, ++rows) {
            std::copy(fits[k].begin() + r * 10,
                      fits[k].begin() + r * 10 + 10, out + rows * 10);
        }
    }
    return rows;
}

// Per-thread OpenMP width (omp_set_num_threads sets the calling thread's
// ICV): the image pool calls this from each worker so one image uses
// cores/workers threads instead of oversubscribing cores x workers.
void native_set_num_threads(int64_t n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads(static_cast<int>(n));
#endif
    (void)n;
}

// ---------------------------------------------------------------------
// Detection front half: separable Gaussian blur (edge replication) +
// antialiased bilinear downscale (sparse taps supplied by the caller,
// detect/vectorized_lsd._resize_taps — identical weights to
// jax.image.resize "linear") + the 2x2 gradient field of ll_angle
// (lsd_opencv.cpp:636-684).  Same math and summation order as the XLA
// formulation in vectorized_lsd._blur_and_scale/_gradient_field; the
// native form exists because the XLA CPU front costs ~90 ms/image and
// contends across the image thread pool, while these loops are plain
// row-parallel f32 FMAs.

int64_t lsd_front(const float* img, int64_t H, int64_t W,
                  const float* kern, int64_t nk,
                  const int32_t* iy, const float* wy, int64_t out_h,
                  int64_t ty,
                  const int32_t* ix, const float* wx, int64_t out_w,
                  int64_t tx,
                  double rho, float notdef,
                  float* norm_out, float* angle_out, uint8_t* def_out) {
    const int64_t r = (nk - 1) / 2;
    std::vector<float> t1(static_cast<size_t>(H) * W);
    std::vector<float> t2(static_cast<size_t>(H) * W);

    // vertical blur with edge replication
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t y = 0; y < H; ++y) {
        float* dst = t1.data() + y * W;
        for (int64_t x = 0; x < W; ++x) dst[x] = 0.0f;
        for (int64_t k = 0; k < nk; ++k) {
            int64_t yy = y + k - r;
            if (yy < 0) yy = 0;
            if (yy >= H) yy = H - 1;
            const float* src = img + yy * W;
            const float kw = kern[k];
            for (int64_t x = 0; x < W; ++x) dst[x] += kw * src[x];
        }
    }
    // horizontal blur
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t y = 0; y < H; ++y) {
        const float* src = t1.data() + y * W;
        float* dst = t2.data() + y * W;
        for (int64_t x = 0; x < W; ++x) {
            float acc = 0.0f;
            for (int64_t k = 0; k < nk; ++k) {
                int64_t xx = x + k - r;
                if (xx < 0) xx = 0;
                if (xx >= W) xx = W - 1;
                acc += kern[k] * src[xx];
            }
            dst[x] = acc;
        }
    }

    // vertical resize: out1[o, :] = sum_k wy[o,k] * t2[iy[o,k], :]
    std::vector<float> rs(static_cast<size_t>(out_h) * W);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t o = 0; o < out_h; ++o) {
        float* dst = rs.data() + o * W;
        for (int64_t x = 0; x < W; ++x) dst[x] = 0.0f;
        for (int64_t k = 0; k < ty; ++k) {
            const float kw = wy[o * ty + k];
            const float* src = t2.data() +
                static_cast<int64_t>(iy[o * ty + k]) * W;
            for (int64_t x = 0; x < W; ++x) dst[x] += kw * src[x];
        }
    }
    // horizontal resize into the scaled image
    std::vector<float> sc(static_cast<size_t>(out_h) * out_w);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t o = 0; o < out_h; ++o) {
        const float* src = rs.data() + o * W;
        float* dst = sc.data() + o * out_w;
        for (int64_t x = 0; x < out_w; ++x) {
            float acc = 0.0f;
            for (int64_t k = 0; k < tx; ++k)
                acc += wx[x * tx + k] * src[ix[x * tx + k]];
            dst[x] = acc;
        }
    }

    // 2x2 gradient field (ll_angle): last row/col undefined
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t y = 0; y < out_h; ++y) {
        float* nrow = norm_out + y * out_w;
        float* arow = angle_out + y * out_w;
        uint8_t* drow = def_out + y * out_w;
        if (y == out_h - 1) {
            for (int64_t x = 0; x < out_w; ++x) {
                nrow[x] = 0.0f;
                arow[x] = notdef;
                drow[x] = 0;
            }
            continue;
        }
        const float* row0 = sc.data() + y * out_w;
        const float* row1 = sc.data() + (y + 1) * out_w;
        for (int64_t x = 0; x < out_w - 1; ++x) {
            const float A = row0[x], B = row0[x + 1];
            const float C = row1[x], D = row1[x + 1];
            const float DA = D - A;
            const float BC = B - C;
            const float gx = DA + BC;
            const float gy = DA - BC;
            const float n = std::sqrt((gx * gx + gy * gy) * 0.25f);
            const bool def = n > static_cast<float>(rho);
            nrow[x] = n;
            arow[x] = def ? std::atan2(gx, -gy) : notdef;
            drow[x] = def ? 1 : 0;
        }
        nrow[out_w - 1] = 0.0f;
        arow[out_w - 1] = notdef;
        drow[out_w - 1] = 0;
    }
    return 0;
}

}  // extern "C"
