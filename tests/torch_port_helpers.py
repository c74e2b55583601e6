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
