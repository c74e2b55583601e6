"""Shared helpers of the tests that hold `line3d_tpu_torch` against
`line3d_tpu`: inputs are made with numpy from a seed and handed to both
packages as numpy arrays."""
import numpy as np
import torch

# tier-1 runs several pytest workers at once; keep each one's intra-op
# thread pool small
torch.set_num_threads(2)

# The one float token of the port's house10 model outside test_golden.py's
# rtol 1e-5 / atol 1e-6, as (line, port, golden), at 1.04 of its tolerance.
# The golden holds XLA:CPU's float32 triangulation, which contracts a*b + c
# into fused multiply-adds and approximates rsqrt; the depths' a*c - b*b
# cancels, so those roundings reach 1.2e-5 of this coordinate.  The port's
# float32 recompute and a float64 one both print -0.57194.
HOUSE10_OUTSIDE = [(0, "-0.57194", "-0.571947")]

# The float tokens of the port's noisy-house model with diffusion
# (tests/golden/house10_diffusion.txt) outside the same tolerance.  Line
# 10's second endpoint: its cluster (segment 12 of all 10 views) has two
# member endpoints (views 6 and 9) at distances 0.90262152 and 0.90262160
# from the line's extremal point in the golden's float32 depths; the port's
# depth of view 6 is 6e-7 larger (XLA:CPU's FMA contraction, as above), so
# the two swap places in the sweep order and the sweep closes the segment
# at the other endpoint, 2.4e-3 away.  Line 11's token is off by 1.03e-6
# against a tolerance of 1.02e-6.  Every integer token matches.
HOUSE10_DIFFUSION_OUTSIDE = [(10, "-0.173167", "-0.170758"),
                             (10, "0.00768377", "0.00892661"),
                             (10, "1.09097", "1.08816"),
                             (11, "0.0023077", "0.00230667")]


def T(x):
    """numpy (or JAX) array -> CPU torch tensor with the same dtype."""
    return torch.as_tensor(np.array(x))


def N(x):
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def facade_pair(v: int = 0, n: int = 1, S: int = 128, St: int = 256):
    """The first S / St segments of two facade views (demo scene of
    line3d_tpu, numpy) with the pair's matching constants, as f32 numpy, in
    `match_pair_dense`'s argument order: (segs_src, segs_tgt, mask_src,
    mask_tgt, F, RtKinv_src, RtKinv_tgt, C_src, C_tgt)."""
    from line3d_tpu.utils.demo import make_facade_scene
    scene, cams = make_facade_scene(num_views=4)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731

    def cut(w, k):
        segs = np.zeros((k, 4), np.float32)
        mask = np.zeros(k, bool)
        m = min(k, int(scene.seg_count[w]))
        segs[:m] = scene.segments[w, :m]
        mask[:m] = True
        return segs, mask
    ss, ms = cut(v, S)
    st, mt = cut(n, St)
    return (ss, st, ms, mt, f32(cams.fundamental(v, n)), f32(cams.RtKinv[v]),
            f32(cams.RtKinv[n]), f32(cams.C[v]), f32(cams.C[n]))


SELECTION_KINDS = ("mixed", "unverified", "no_median")


def selection_tables(kind, S, M=48, N=5, St=40, seed=3):
    """(cam, tgt, depths, valid, conf) numpy [S, M] merged match tables of
    one of SELECTION_KINDS, in merge_neighbor_tables' layout: each row's
    valid slots first, ascending in cam * St + tgt, the rest cam = tgt =
    -1; confidences on a grid of quarter steps (exact ties, one planted at
    each row's maximum), some rows all invalid.  "mixed" has verified
    matches (conf > 1) and a median; "unverified" none above 1 but a
    median; "no_median" no raw maximum above 0.5."""
    rng = np.random.default_rng(seed + SELECTION_KINDS.index(kind))
    cam = np.full((S, M), -1, np.int32)
    tgt = np.full((S, M), -1, np.int32)
    valid = np.zeros((S, M), bool)
    for r in range(S):
        k = 0 if r % 7 == 3 else int(rng.integers(1, M + 1))
        keys = np.sort(rng.choice(N * St, k, replace=False))
        cam[r, :k], tgt[r, :k] = keys // St, keys % St
        valid[r, :k] = True
    conf = (rng.integers(0, 13, (S, M)) * 0.25).astype(np.float32)
    smooth = rng.uniform(0.0, 3.0, (S, M)).astype(np.float32)
    conf = np.where(rng.uniform(size=(S, M)) < 0.3, smooth, conf)
    # plant a tie at each row's maximum, in a later slot
    for r in range(S):
        n = int(valid[r].sum())
        if n >= 2:
            a, b = sorted(rng.choice(n, 2, replace=False))
            conf[r, b] = conf[r, a] = conf[r, :n].max()
    if kind == "unverified":
        conf = np.minimum(conf, np.float32(1.0))
    elif kind == "no_median":
        conf = np.minimum(conf, np.float32(0.5))
    conf = np.where(valid, conf, 0).astype(np.float32)
    depths = rng.uniform(0.5, 20.0, (S, M, 4)).astype(np.float32)
    depths[~valid] = 0
    return cam, tgt, depths, valid, conf


def to_reference(obj):
    """A copy of one of the port's stage objects as line3d_tpu's class of
    the same name, field for field (arrays copied, nothing re-derived), so
    the reference's stages read the port's outputs bit for bit:
    BestMatches, ViewMatches, CollinMaps (its per-view dicts, flat pair
    arrays and drop counters), AffinityGraph, SceneTransform, CameraSet."""
    import dataclasses
    from line3d_tpu.cluster import affinity as ja
    from line3d_tpu.core import cameras as jcam, conditioning as jcond
    from line3d_tpu.match import collinearity as jc, engine as je

    def arr(x):
        return np.array(x) if isinstance(x, np.ndarray) else x
    if hasattr(obj, "flat_view"):
        out = jc.CollinMaps({i: dict(js) for i, js in d.items()}
                            for d in obj)
        for f in ("flat_view", "flat_i", "flat_j", "flat_w",
                  "dropped_per_view"):
            setattr(out, f, arr(getattr(obj, f)))
        out.dropped_total = int(obj.dropped_total)
        return out
    cls = {c.__name__: c for c in (
        je.BestMatches, je.ViewMatches, ja.AffinityGraph,
        jcond.SceneTransform, jcam.CameraSet)}[type(obj).__name__]
    out = cls.__new__(cls)
    for f in dataclasses.fields(cls):
        setattr(out, f.name, arr(getattr(obj, f.name)))
    return out


def relabel(labels):
    """Cluster labels renumbered by first occurrence (0, 1, 2, ...)."""
    _, first, inv = np.unique(np.asarray(labels), return_index=True,
                              return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv.reshape(-1)]


def stereo_views(n_nb, Ss=90, St=150, seed=5, far=False, big_f=False,
                 dev="cpu"):
    """A source view and n_nb neighbors with R = I and one K, displaced
    along x, so every epipolar line is horizontal: F's first row is zero,
    and a horizontal segment's transfer into a horizontal segment fails
    with iz = 0 exactly.  60 segments of a seeded 3D set (8 of them
    horizontal) seen by every view, 40 random distractors in each
    neighbor, zero padding to Ss and St; source segment 0 and target
    segment 1 of every neighbor have zero length, and source segment 2
    (a seen one) is masked.  With `far`, source segments 10-13 and the
    distractors 60-63 lie 1e18 and 1e20 times farther from the origin, so
    that some of their pairs' reciprocals and roots take operands beyond
    2^126 or NaNs; their values overflow to infinities and NaNs, which
    reach every depth as -1.  With `big_f`, the last neighbor's F is
    scaled by 2^136 (the same epipolar lines), so that its transfers'
    |iz| lie at or beyond 2^126, and its target 64 crosses the epipolar
    line of source 14's first endpoint at (2, 1/4): there |iz| lies in
    [2^126, 2^127) and ix stays finite, so the IEEE reciprocal is a
    subnormal and the transfer point (2, 1/4), where the fast path, which
    flushes it to zero, would give (0, 0).  Returns the K1/K5 arguments and the rows of the
    horizontal source segments and columns of the horizontal target
    segments."""
    rng = np.random.default_rng(seed)
    f, cx, cy, W, H = 800.0, 320.0, 240.0, 640.0, 480.0
    n3 = 60
    p = np.stack([rng.uniform(-1.5, 1.5, n3), rng.uniform(-1.0, 1.0, n3),
                  rng.uniform(4.0, 8.0, n3)], 1)
    d = rng.normal(size=(n3, 3)) * 0.6
    d[:8, 1:] = 0.0
    ends = np.stack([p, p + d], 1)                      # [n3, 2, 3]

    def project(b):
        x, y, z = ends[..., 0] - b, ends[..., 1], ends[..., 2]
        return np.stack([f * x / z + cx, f * y / z + cy], -1).reshape(n3, 4)

    base = 0.3 * np.arange(n_nb + 1)
    src = np.zeros((Ss, 4))
    src[:n3] = project(base[0])
    src[0, 2:] = src[0, :2]
    mask_src = np.zeros(Ss, bool)
    mask_src[:n3] = True
    mask_src[2] = False
    segs_nb = np.zeros((n_nb, St, 4))
    mask_nb = np.zeros((n_nb, St), bool)
    order = [rng.permutation(n3) for _ in range(n_nb)]
    for n in range(n_nb):
        segs_nb[n, :n3] = project(base[n + 1])[order[n]]
        segs_nb[n, n3:n3 + 40] = rng.uniform(0, 1, (40, 4)) * [W, H, W, H]
        segs_nb[n, 1, 2:] = segs_nb[n, 1, :2]
        mask_nb[n, :n3 + 40] = True
        if far:
            segs_nb[n, n3:n3 + 4] *= [[1e18], [1e18], [1e20], [1e20]]
    if far:
        src[10:14] *= [[1e18], [1e18], [1e20], [1e20]]
    Kinv = np.linalg.inv(np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]]))
    C_nb = np.stack([base[1:], np.zeros(n_nb), np.zeros(n_nb)], 1)
    F = np.stack([Kinv.T @ np.array([[0, 0, 0], [0, 0, b], [0, -b, 0]])
                  @ Kinv for b in base[1:]])
    assert not F[:, 0].any()
    if big_f:
        # c = b / f 2^k in [2^124, 2^125): the epipolar line of (x, y) is
        # (0, c, -c y), and target 64 (la = -4, lb = 10, lc = 5.5) meets
        # y = 1/4 at (2, 1/4) with iz = -4c, ix = -8c, iy = -c, every
        # product below 2^128
        k = int(np.ceil(124 - np.log2(base[-1] / f)))
        F[-1] = np.ldexp(F[-1].astype(np.float32), k)
        src[14] = [100.0, 0.25, -100.0, -3.0]
        segs_nb[-1, 64] = [-3.0, -1.75, 7.0, 2.25]
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa
    args = (t(src), torch.as_tensor(mask_src, device=dev), t(segs_nb),
            torch.as_tensor(mask_nb, device=dev), t(F), t(Kinv),
            t(np.repeat(Kinv[None], n_nb, 0)), t(np.zeros(3)), t(C_nb))
    flat_s = args[0][:, 1] == args[0][:, 3]
    flat_t = args[2][:, :, 1] == args[2][:, :, 3]
    return args, flat_s, flat_t


def pair_dense_ieee(segs_src, mask_src, segs_nb, mask_nb, F_nb, RtKinv_src,
                    RtKinv_nb, C_src, C_nb, lower=0.10, upper=0.30):
    """K5's function written out again in float32 PyTorch, expression for
    expression and in the order of `csrc/pair_math.cuh` (its `IeeeOps`:
    1 / x and 1 / sqrt(x) as IEEE operations, every product and sum
    rounded on its own, as under -fmad=false), independently of the
    port's plain twin, which divides where the kernel multiplies by a
    reciprocal.  Returns (depths [4, N, Ss, St], valid [N, Ss, St], slow
    [N, Ss, St]): `slow` marks the pairs for which `FastRnOps` meets an
    operand at or beyond 2^126 or a NaN, and so the kernel's IEEE
    evaluation.  The square root is taken in float64 and rounded, the
    correctly rounded float32 root (`core.geometry.sqrt`)."""
    f32 = torch.float32
    one, zero = torch.ones((), dtype=f32), torch.zeros((), dtype=f32)
    eps = torch.tensor(1e-12, dtype=f32)
    eps2 = eps * eps
    big = torch.tensor(2.0 ** 126, dtype=f32)
    N = segs_nb.shape[0]
    # per neighbor parameters, [N, 1, 1]
    col = lambda x: x.to(f32).reshape(N, 1, 1)  # noqa: E731
    F = [col(F_nb.reshape(N, 9)[:, k]) for k in range(9)]
    Ms = [col(RtKinv_src.reshape(1, 9).expand(N, 9)[:, k]) for k in range(9)]
    Mt = [col(RtKinv_nb.reshape(N, 9)[:, k]) for k in range(9)]
    w0 = [col(C_src.reshape(1, 3).expand(N, 3)[:, k] - C_nb[:, k])
          for k in range(3)]
    lo, hi = torch.tensor(lower, dtype=f32), torch.tensor(upper, dtype=f32)
    lo2, hi2 = lo * lo, hi * hi
    slow = [torch.zeros((), dtype=torch.bool)]

    def mat3(M, x, y, t=False):
        i = (0, 3, 6, 1, 4, 7, 2, 5, 8) if t else range(9)
        m = [M[k] for k in i]
        return (m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5],
                m[6] * x + m[7] * y + m[8])

    def ray_n(M, x, y, fast=False):
        rx, ry, rz = mat3(M, x, y)
        q = torch.fmax(rx * rx + ry * ry + rz * rz, eps)
        if fast:
            slow[0] = slow[0] | ~(q < big)
        inv = 1.0 / torch.sqrt(q.double()).to(f32)
        return rx * inv, ry * inv, rz * inv

    def rcp(x):
        slow[0] = slow[0] | ~(x.abs() < big)
        return 1.0 / x

    def stage(seg, mask, M, t):
        x1, y1, x2, y2 = (seg[..., k].to(f32) for k in range(4))
        e1 = mat3(F, x1, y1, t)
        e2 = mat3(F, x2, y2, t)
        return dict(x1=x1, y1=y1, x2=x2, y2=y2, la=y1 - y2, lb=x2 - x1,
                    lc=x1 * y2 - y1 * x2, e1=e1, e2=e2,
                    r1=ray_n(M, x1, y1), r2=ray_n(M, x2, y2),
                    mask=torch.where(mask, one, zero))

    s = stage(segs_src.reshape(1, -1, 1, 4), mask_src.reshape(1, -1, 1), Ms,
              False)
    t = stage(segs_nb.reshape(N, 1, -1, 4), mask_nb.reshape(N, 1, -1), Mt,
              True)

    def intersect(la, lb, lc, m):
        ma, mb, mc = m
        ix = lb * mc - lc * mb
        iy = lc * ma - la * mc
        iz = la * mb - lb * ma
        ok = iz.abs() > eps
        inv = rcp(torch.where(ok, iz, one))
        return torch.where(ok, ix * inv, zero), torch.where(ok, iy * inv,
                                                            zero), ok

    def d2(ux, uy, vx, vy):
        return (ux - vx) * (ux - vx) + (uy - vy) * (uy - vy)

    def on_seg(px, py, qx, qy, rx, ry):
        return (px - rx) * (qx - rx) + (py - ry) * (qy - ry) < eps

    def overlap(ax, ay, bx, by, cx, cy, dx, dy):
        len2_ab, len2_cd = d2(ax, ay, bx, by), d2(cx, cy, dx, dy)
        c_in, d_in = on_seg(ax, ay, bx, by, cx, cy), on_seg(ax, ay, bx, by,
                                                            dx, dy)
        a_in, b_in = on_seg(cx, cy, dx, dy, ax, ay), on_seg(cx, cy, dx, dy,
                                                            bx, by)
        l31, l32 = d2(bx, by, dx, dy), d2(ax, ay, dx, dy)
        b3 = a_in & (l31 > eps2)
        n3 = torch.where(b3, d2(cx, cy, ax, ay),
                         torch.where(l32 > eps2, d2(cx, cy, bx, by), zero))
        e3 = torch.where(b3, torch.fmax(l31, eps),
                         torch.where(l32 > eps2, torch.fmax(l32, eps), one))
        l41, l42 = d2(ax, ay, cx, cy), d2(bx, by, cx, cy)
        b4 = b_in & (l41 > eps2)
        n4 = torch.where(b4, d2(dx, dy, bx, by),
                         torch.where(l42 > eps2, d2(dx, dy, ax, ay), zero))
        e4 = torch.where(b4, torch.fmax(l41, eps),
                         torch.where(l42 > eps2, torch.fmax(l42, eps), one))
        num = torch.where(c_in & d_in, len2_cd, torch.where(
            a_in & b_in, len2_ab, torch.where(
                c_in, n3, torch.where(d_in, n4, zero))))
        den = torch.where(c_in & d_in, torch.fmax(len2_ab, eps), torch.where(
            a_in & b_in, torch.fmax(len2_cd, eps), torch.where(
                c_in, e3, torch.where(d_in, e4, one))))
        return torch.where((len2_ab < 1.0) | (len2_cd < 1.0), zero, num), den

    # cheap gates
    a1x, a1y, ok1 = intersect(t["la"], t["lb"], t["lc"], s["e1"])
    a2x, a2y, ok2 = intersect(t["la"], t["lb"], t["lc"], s["e2"])
    b1x, b1y, ok3 = intersect(s["la"], s["lb"], s["lc"], t["e1"])
    b2x, b2y, ok4 = intersect(s["la"], s["lb"], s["lc"], t["e2"])
    n1, e1 = overlap(s["x1"], s["y1"], s["x2"], s["y2"], b1x, b1y, b2x, b2y)
    n2, e2 = overlap(t["x1"], t["y1"], t["x2"], t["y2"], a1x, a1y, a2x, a2y)
    ov_ok = (n1 > lo2 * e1) & (n2 > lo2 * e2) & ((n1 > hi2 * e1) |
                                                 (n2 > hi2 * e2))
    cheap = ok1 & ok2 & ok3 & ok4 & ov_ok & (s["mask"] > 0.5) & \
        (t["mask"] > 0.5)

    # the four two-ray depths
    def dot(u, v):
        return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

    def two_ray(r1, r2, want_first):
        a, b, c = dot(r1, r1), dot(r1, r2), dot(r2, r2)
        d, e = dot(r1, w0), dot(r2, w0)
        denom = a * c - b * b
        num = b * e - c * d if want_first else a * e - b * d
        return num, denom, denom.abs() > eps

    terms = [two_ray(s["r1"], ray_n(Mt, a1x, a1y, True), True),
             two_ray(s["r2"], ray_n(Mt, a2x, a2y, True), True),
             two_ray(ray_n(Ms, b1x, b1y, True), t["r1"], False),
             two_ray(ray_n(Ms, b2x, b2y, True), t["r2"], False)]
    depths, valid = [], cheap
    for num, den, ok in terms:
        inv = rcp(torch.where(ok, den, one))
        d = torch.where(ok, num * inv, -one)
        depths.append(d)
        valid = valid & (d > 0) & ok
    shape = valid.shape
    return (torch.stack([d.expand(shape) for d in depths]), valid,
            slow[0].expand(shape))


def affinity_enum_inputs(key_of, pairs, coll, V, S):
    """The exact-order enumeration's inputs, the first nine arguments of
    `affinity.enumerate_candidates` (key_sorted, order, pk, row_lookup,
    ptr, coll_j, coll_w, S, M), from the best-match keys in row order, the
    correspondence pairs (a, b) of keys (both directions are taken) and the
    collinear triples (view, i, j), whose weights are made from them (a
    repeated triple stays, as a repeated partner in its row)."""
    from types import SimpleNamespace
    from line3d_tpu_torch.cluster import affinity
    key_of = np.asarray(key_of, np.int64)
    M = V * S
    order = np.argsort(key_of, kind="stable").astype(np.int64)
    row_lookup = np.full(M, -1, np.int64)
    row_lookup[key_of] = np.arange(len(key_of))
    p = np.asarray(pairs, np.int64).reshape(-1, 2)
    pk = np.unique(np.concatenate([p[:, 0] * M + p[:, 1],
                                   p[:, 1] * M + p[:, 0]]))
    c = np.asarray(coll, np.int64).reshape(-1, 3)
    c = c[np.lexsort(c.T[::-1])]
    flat = SimpleNamespace(
        flat_view=c[:, 0].astype(np.int32), flat_i=c[:, 1].astype(np.int32),
        flat_j=c[:, 2].astype(np.int32),
        flat_w=(0.5 + ((c[:, 0] * S + c[:, 1]) * S + c[:, 2]) % 97 / 200.0)
        .astype(np.float32))
    ptr, coll_j, coll_w = affinity._collin_csr(flat, V, S)
    return (key_of[order], order, pk, row_lookup, ptr, coll_j,
            np.asarray(coll_w, np.float64), S, M)


def affinity_random_case(seed, general=False):
    """A small random input of the enumeration: 2-4 views of 3-9
    segments, 40-95% of the keys sources, dense correspondences and
    asymmetric collinearity.  `general` also lets a pair or a collinear
    partner lie in one view or be the key itself, and repeats partners in
    their rows, which the pipeline never gives and the walk takes all the
    same."""
    rng = np.random.default_rng(seed)
    V, S = int(rng.integers(2, 5)), int(rng.integers(3, 10))
    M = V * S
    keys = np.arange(M)
    key_of = rng.permutation(keys[rng.random(M) < rng.uniform(0.4, 0.95)])
    n = int(rng.integers(0, 3 * M))
    a, b = rng.integers(0, M, n), rng.integers(0, M, n)
    if not general:
        a, b = a[a // S != b // S], b[a // S != b // S]
    density = rng.uniform(0.05, 0.5)
    coll = [(k // S, k % S, j) for k in keys for j in range(S)
            if rng.random() < density and (general or j != k % S)]
    if general and coll:
        coll += [coll[i] for i in rng.integers(0, len(coll), len(coll) // 8)]
    return affinity_enum_inputs(key_of, np.stack([a, b], 1), coll, V, S)


def assert_same_stream(got, want):
    """Two candidate streams (src_rows, tgt_rows, kinds, cws) equal
    element for element, dtypes included."""
    for g, w, name in zip(got, want, ("src", "tgt", "kind", "cw")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, name)


def small_facade_affinity():
    """(best, cams, config, stream) of one exact model of a small facade
    on the CPU (5 views of 960 x 720, 5 x 4 cells, ~4 s): the affinity
    stage's inputs as `build_affinity_graph` got them and the walk's
    candidate stream (6,414 candidates of all three kinds, 2,795 of them
    passing)."""
    from line3d_tpu_torch import Line3D, L3DConfig
    from line3d_tpu_torch.cluster import affinity
    from line3d_tpu_torch.utils.demo import make_facade_scene
    scene, cams = make_facade_scene(num_views=5, width=960, height=720,
                                    focal=900.0, n_cols=5, n_rows=4,
                                    distance=6.5, device="cpu")
    seen = {}
    build, enum = affinity.build_affinity_graph, affinity.enumerate_candidates

    def spy_build(*a, **k):
        seen["inputs"] = a
        return build(*a, **k)

    def spy_enum(*a, **k):
        seen["stream"] = enum(*a, **k)
        return seen["stream"]
    affinity.build_affinity_graph = spy_build
    affinity.enumerate_candidates = spy_enum
    try:
        l3d = Line3D(config=L3DConfig(), device="cpu")
        for v in range(scene.num_views):
            l3d.add_view_segments(
                v, scene.segments[v][scene.seg_mask[v]], cams.K[v],
                cams.R[v], cams.t[v], worldpoint_ids=scene.wp_lists[v],
                width=int(cams.width[v]), height=int(cams.height[v]))
        l3d.compute_3d_model()
    finally:
        affinity.build_affinity_graph = build
        affinity.enumerate_candidates = enum
    best, _, _, cams, config, _ = seen["inputs"]
    return best, cams, config, seen["stream"]


def best_rows(best, n, seed):
    """n rows of a BestMatches as one: a run of neighbours in the order of
    their midpoints from a start drawn from `seed`, so that pairs among
    them both pass and fail the affinity thresholds."""
    import dataclasses
    order = np.lexsort(((best.P1 + best.P2) / 2).T[::-1])
    start = np.random.default_rng(seed).integers(0, len(order) - n + 1)
    rows = order[start:start + n]
    return dataclasses.replace(best, **{f.name: getattr(best, f.name)[rows]
                                        for f in dataclasses.fields(best)})


def native_weights(best, stream, cams, config):
    """The host's native sweep's thresholded weights of a whole candidate
    stream (-1 where a candidate fails), at any stream length."""
    from line3d_tpu_torch.cluster import affinity
    n = len(stream[0])
    return affinity._candidate_weights_range(
        best, *stream, cams, config, 0, n,
        n_stream=max(n, affinity.NATIVE_SIM_THRESHOLD + 1))


def assert_same_graph(got, want):
    """Two AffinityGraphs equal field for field, dtypes included, but for
    `num_kept` (how many candidates the host weighed to build them)."""
    for f in ("edges_i", "edges_j", "edges_w", "node_view", "node_seg"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    assert (got.num_nodes, got.num_candidates) == \
        (want.num_nodes, want.num_candidates)


# Hand-built inputs of the enumeration on 3 views of 8 segments (key =
# view * 8 + segment): (best-match keys, correspondence pairs, collinear
# triples (view, i, j)), each with the (source key, target key, kind) the
# walk must emit or must not.
AFFINITY_ORDER_CASES = {
    # 0's expansion of 9 marks {0, 10}: A (0, 10) is dropped with its
    # expansion, which would have given (0, 13)
    "b_mark_kills_a": ([0, 9, 10, 13], [(0, 9), (0, 10)],
                       [(1, 1, 2), (1, 2, 5)],
                       [(0, 10, 1), (9, 10, 2), (10, 13, 2)],
                       [(0, 10, 0), (0, 13, 1)]),
    # 9 kills 10; 10's expansion, which would kill 11, never runs, so 11
    # runs and kills 12, whose expansion (0, 14) never runs
    "chain_of_three": ([0, 9, 10, 11, 12, 14],
                       [(0, 9), (0, 10), (0, 11), (0, 12)],
                       [(1, 1, 2), (1, 2, 3), (1, 3, 4), (1, 4, 6)],
                       [(0, 9, 0), (0, 10, 1), (0, 11, 0), (0, 12, 1)],
                       [(0, 10, 0), (0, 12, 0), (0, 14, 1)]),
    # 9 and 11 have no best match: no A entry and no expansion for them,
    # so {0, 10} stays fresh for A; (0, 11) and 0's partner 1 give nothing
    "targets_without_best_row": ([0, 10, 13], [(0, 9), (0, 10), (0, 11)],
                                 [(1, 1, 2), (1, 1, 5), (1, 2, 3),
                                  (0, 0, 1)],
                                 [(0, 10, 0)],
                                 [(0, 13, 1)]),
    # 0's partners 1 and 2 are no correspondents; 1 lists 0 back (dropped,
    # 0 marked it), 2 does not
    "collinear_partners_outside_correspondents": (
        [0, 1, 2, 9], [(0, 9)], [(0, 0, 1), (0, 0, 2), (0, 1, 0)],
        [(0, 9, 0), (0, 1, 2), (0, 2, 2)], [(1, 0, 2)]),
    # no collinear pair at all: A entries only, each pair once
    "empty_csr_rows": ([0, 9, 17, 20], [(0, 9), (9, 17), (0, 17), (9, 20)],
                       [], [(0, 9, 0), (0, 17, 0), (9, 17, 0), (9, 20, 0)],
                       [(17, 9, 0)]),
    # pairs inside view 0: source 1's expansion of 2 marks {1, 3}, so 3's
    # own partner 1 and its expansion of 5 (partner 1) are dropped; 5's
    # partner 1 was not marked
    "marked_below_through_b": ([1, 2, 3, 5], [(1, 2), (3, 5)],
                               [(0, 2, 3), (0, 3, 1), (0, 5, 1)],
                               [(1, 3, 1), (2, 3, 2), (3, 5, 0), (5, 1, 2)],
                               [(3, 1, 2), (3, 1, 1)]),
}


def diffusion_plan_twin(edges_i, edges_j, edges_w, num_nodes):
    """The device diffusion's plan (`diffusion_device.build_plan`) by numpy
    lexsorts on the host: a dict of its arrays under the plan's names."""
    order_r = np.lexsort((edges_j, edges_i))
    ri, rj = edges_i[order_r], edges_j[order_r]
    order_c = np.lexsort((edges_i, edges_j))
    deg = np.bincount(ri, minlength=num_nodes)
    return dict(
        rw=edges_w[order_r].astype(np.float32),
        wv_col=edges_w[order_c].astype(np.float32),
        ri=ri, rj=rj, deg=deg,
        rowstart=np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int64),
        order_col=np.lexsort((ri, rj)).astype(np.int64),
        ci=edges_i[order_c].astype(np.int64))


def length_classes_twin(n):
    """(terms, [(L, rows)]) of `_PairSums.split` on the host: the sum of n
    and, for each power of two L in ascending order, the rows with n in
    (L/2, L] by np.flatnonzero."""
    n = np.asarray(n)
    classes, top, L = [], int(n.max(initial=0)), 1
    while top and L // 2 < top:
        sel = np.flatnonzero((n > L // 2) & (n <= L))
        if len(sel):
            classes.append((L, sel))
        L *= 2
    return int(n.sum()), classes


def assert_plan_equals_twin(p, twin):
    """Every array of a device `DiffusionPlan` equal to the twin's, dtype
    and value."""
    for name, want in twin.items():
        got = getattr(p, name).cpu().numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_classes_equal_twin(sums, n_host):
    """A `_PairSums`' terms and length classes equal to
    `length_classes_twin` of its lengths."""
    terms, want = length_classes_twin(n_host)
    assert sums.terms == terms
    assert len(sums.classes) == len(want)
    for (rows, c), (L, sel) in zip(sums.classes, want):
        np.testing.assert_array_equal(c.cpu().numpy(), np.arange(L))
        np.testing.assert_array_equal(rows.cpu().numpy(), sel)
