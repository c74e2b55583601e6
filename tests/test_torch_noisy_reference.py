"""The port's noisy-capture stages against the benchmark's plain reference
(`benchmark/reference/noisy.py`: numpy and plain torch in float64, nothing
of either package), on the CPU: the device diffusion (float32 torch) and
the device line refinement (float64 torch), their device forms on CPU
tensors, alone on seeded inputs and inside one whole small facade model.

Tolerances, each between the port's reading and that of a copy of the
port with the diffusion's arithmetic, or the refinement's inputs, rounded
to bfloat16:
  * diffused weights, elementwise relative: 1e-4.  Ten float32 rounds of
    positive product sums read at most 7.8e-6 on the graphs below and
    2.5e-6 on the facade; in bfloat16 0.043-0.26.
  * refined lines, the distance of the port's line from the reference's
    over each cluster's span: median 1e-8, largest 1e-5.  The port reads
    ~5e-10 in the median and at most 2.6e-7 (the reference's numeric
    Jacobian against the port's exact one); a float32 refinement reads
    3-5e-7 and up to 3.8e-4 (the rounding of its residuals decides its
    last steps), bfloat16 inputs 3.8-4.9e-3 and 0.025-0.12.
  * the whole model's refined lines: the port's sub-segment endpoints from
    the reference's refined line, over the capture's extent: 1e-6 (the
    port reads 3.5e-8 on this facade, a float32 refinement 9.8e-6).
"""
import dataclasses

import numpy as np
import pytest

from benchmark import scenes
from benchmark.reference import cameras as rc, cluster as rk, noisy
from line3d_tpu_torch import Line3D, L3DConfig
from line3d_tpu_torch.cluster import diffusion, fh
from line3d_tpu_torch.cluster.diffusion_device import \
    diffuse_reference_device
from line3d_tpu_torch.fit.refine import refine_lines_device

DIFFUSION_RTOL = 1e-4
REFINE_MEDIAN, REFINE_MAX = 1e-8, 1e-5
MODEL_LINE_GAP = 1e-6


def _graph(n, m, alpha, seed):
    """A symmetric graph of up to m undirected edges on n nodes, both
    directions listed; endpoints drawn with weight (k + 1)^-alpha, so a
    larger alpha gives hubs; weights in [0.05, 1)."""
    rng = np.random.default_rng(seed)
    p = (np.arange(n) + 1.0) ** -alpha
    p /= p.sum()
    a, b = rng.choice(n, 3 * m, p=p), rng.choice(n, 3 * m, p=p)
    keep = a != b
    key = np.unique(np.minimum(a, b)[keep] * n + np.maximum(a, b)[keep])[:m]
    lo, hi = key // n, key % n
    w = rng.uniform(0.05, 1.0, len(lo))
    return np.r_[lo, hi], np.r_[hi, lo], np.r_[w, w]


def _same_diffusion(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=DIFFUSION_RTOL, atol=0)


@pytest.mark.parametrize("n,m,alpha,iterations", [
    (40, 120, 0.0, 10),        # small, even degrees
    (200, 1500, 0.0, 10),      # larger, even degrees
    (300, 1200, 1.2, 10),      # hubs up to ~200 neighbours
    (500, 400, 0.0, 10),       # sparse, isolated nodes
    (60, 1700, 0.0, 10),       # nearly complete
    (150, 900, 2.0, 10),       # one dominant hub
    (200, 1500, 0.0, 1),       # one iteration
])
def test_device_diffusion_is_the_reference(n, m, alpha, iterations):
    i, j, w = _graph(n, m, alpha, seed=n + m)
    _same_diffusion(
        diffuse_reference_device(i, j, w, n, iterations, 1e-12,
                                 device="cpu"),
        noisy.diffuse(i, j, w, n, iterations, 1e-12))


def _look_at(C, target):
    z = (target - C) / np.linalg.norm(target - C)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return R, -R @ C


def _clusters(C, V, seed, noise_px=0.5, M=8):
    """C lines in a unit box seen by 3-M of V cameras on a ring (f = 1000,
    1000 x 800 px), their projected endpoints jittered by noise_px, each
    started from its true line moved by ~0.02 and turned by ~0.03 rad.
    Returns refine's (P0, d0, Pm, p1, p2, mask)."""
    rng = np.random.default_rng(seed)
    K = np.array([[1000.0, 0, 500], [0, 1000.0, 400], [0, 0, 1]])
    Ps = []
    for v in range(V):
        ang = 2 * np.pi * v / V
        Cv = np.array([3 * np.cos(ang), 3 * np.sin(ang),
                       rng.uniform(-0.5, 0.5)])
        R, t = _look_at(Cv, rng.normal(0, 0.1, 3))
        Ps.append(K @ np.c_[R, t])
    Pm, mask = np.zeros((C, M, 3, 4)), np.zeros((C, M), bool)
    p1, p2 = np.zeros((C, M, 2)), np.zeros((C, M, 2))
    P0, d0 = np.zeros((C, 3)), np.zeros((C, 3))
    for c in range(C):
        A = rng.uniform(-0.7, 0.7, 3)
        B = A + rng.normal(0, 0.4, 3)
        for k, v in enumerate(rng.choice(V, rng.integers(3, M + 1),
                                         replace=False)):
            ha, hb = Ps[v] @ np.r_[A, 1], Ps[v] @ np.r_[B, 1]
            Pm[c, k] = Ps[v]
            p1[c, k] = ha[:2] / ha[2] + rng.normal(0, noise_px, 2)
            p2[c, k] = hb[:2] / hb[2] + rng.normal(0, noise_px, 2)
            mask[c, k] = True
        P0[c] = (A + B) / 2 + rng.normal(0, 0.02, 3)
        d = (B - A) / np.linalg.norm(B - A) + rng.normal(0, 0.03, 3)
        d0[c] = d / np.linalg.norm(d)
    return P0, d0, Pm, p1, p2, mask


def _line_gap(P, d, Pr, dr, X):
    """Distance from the line (Pr, dr) of the points X [C, k, 3] taken
    onto the line (P, d), per line: the largest over k."""
    Xp = P[:, None] + ((X - P[:, None]) * d[:, None]).sum(-1)[..., None] \
        * d[:, None]
    Y = Xp - Pr[:, None]
    Y = Y - (Y * dr[:, None]).sum(-1)[..., None] * dr[:, None]
    return np.linalg.norm(Y, axis=-1).max(-1)


@pytest.mark.parametrize("C,V,seed", [(40, 8, 0), (300, 12, 1),
                                      (700, 20, 2), (500, 10, 3)])
def test_device_refinement_is_the_reference(C, V, seed):
    args = _clusters(C, V, seed)
    Pr, dr = noisy.refine(*args, iterations=5)
    P, d, rms_before, rms_after = refine_lines_device(*args, iterations=5,
                                                      device="cpu")
    # each cluster's span: its start +-0.3 along its starting direction
    P0, d0 = args[:2]
    span = P0[:, None] + np.array([-0.3, 0.3])[None, :, None] * d0[:, None]
    gap = _line_gap(P, d, Pr, dr, span)
    assert np.median(gap) <= REFINE_MEDIAN, np.median(gap)
    assert gap.max() <= REFINE_MAX, gap.max()
    # and it did refine: the members' pixel rms fell
    assert np.median(rms_after) < 0.2 * np.median(rms_before)


# the benchmark's facade at the size of its CPU tests
SMALL_FACADE = dict(family="facade", num_views=6, width=960, height=720,
                    focal=900.0, focal_y=901.5, principal=[476.0, 355.0],
                    seed=0, n_cols=5, n_rows=4, distance=6.5,
                    min_len_factor=0.005, max_segments=224)


def test_a_noisy_facade_model_is_the_reference(monkeypatch):
    """Both stages inside one model: the diffusion from the graph the model
    diffused, the refined lines from its F-H clusters (the reference's
    cameras and conditioning, the model's best matches)."""
    cap = scenes.make_capture(SMALL_FACADE)
    segs = [s + np.float32(0.17) for s in cap.segments]
    cfg = L3DConfig(perform_diffusion=True, refine_lines=True,
                    diffusion_backend="device", refine_backend="device")
    seen = {}
    run_diffusion, fh_cluster = diffusion.run_diffusion, fh.fh_cluster

    def spy_diffusion(g, *a, **k):
        seen["in"] = (g.edges_i.copy(), g.edges_j.copy(), g.edges_w.copy(),
                      g.num_nodes)
        g = run_diffusion(g, *a, **k)
        seen["out"] = (g.edges_i.copy(), g.edges_j.copy(), g.edges_w.copy(),
                       g.node_view.copy(), g.node_seg.copy())
        return g

    def spy_fh(*a, **k):
        seen["labels"] = fh_cluster(*a, **k)
        return seen["labels"]
    monkeypatch.setattr(diffusion, "run_diffusion", spy_diffusion)
    monkeypatch.setattr(fh, "fh_cluster", spy_fh)
    l3d = Line3D(config=cfg, device="cpu")
    for v in range(cap.num_views):
        l3d.add_view_segments(v, segs[v], cap.K[v], cap.R[v], cap.t[v],
                              worldpoint_ids=cap.wp_lists[v],
                              width=int(cap.width[v]),
                              height=int(cap.height[v]))
    l3d.compute_3d_model()
    assert l3d.stats["diffusion_edges"] == len(seen["in"][0]) > 0

    i, j, w, n = seen["in"]
    oi, oj, ow, nv, ns = seen["out"]
    # the program keeps the diffused weights in float32
    want = noisy.diffuse(i, j, w, n, cfg.diffusion_iterations, cfg.eps)
    _same_diffusion((oi, oj, ow.astype(np.float64)),
                    (want[0], want[1], want[2].astype(np.float32)))

    c = dataclasses.asdict(cfg)
    cams = rc.Cams(cap.K.astype(np.float64), cap.R, cap.t, cap.width,
                   cap.height, c["uncertainty_lower_px"],
                   c["uncertainty_upper_px"])
    tr = rc.conditioning(cams.C)
    cams.condition(tr.Qinv, tr.scale)
    members = rk.clusters(seen["labels"], nv, ns,
                          c["min_cameras_per_cluster"])
    best = {f.name: getattr(l3d.best, f.name)
            for f in dataclasses.fields(l3d.best)}
    P, d = noisy.refined_lines(members, nv, ns, best,
                               l3d.scene.max_segments, segs, cams.P, tr,
                               c["refine_iterations"])
    cluster_of = {(tuple(nv[ks].tolist()), tuple(ns[ks].tolist())): k
                  for k, ks in enumerate(members)}
    extent = float(np.linalg.norm(cams.C.max(0) - cams.C.min(0))) / tr.scale
    assert l3d.stats["refine_clusters"] == len(members)
    assert len(l3d.result) > 0
    for ln in l3d.result:
        k = cluster_of[(tuple(ln.views2d.tolist()),
                        tuple(ln.segs2d.tolist()))]
        X = ln.segments3d.reshape(-1, 3) - P[k]
        gap = np.linalg.norm(X - (X @ d[k])[:, None] * d[k], axis=1).max()
        assert gap / extent <= MODEL_LINE_GAP, (k, gap / extent)
