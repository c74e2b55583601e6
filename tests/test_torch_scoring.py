"""line3d_tpu_torch.match.scoring (the plain twin of kernels K2/K3 and the
plain form of the terms the kernel derives while staging a row) against
line3d_tpu.match.scoring / scoring_pallas.

Inputs are those of tests/test_pallas.py:92-160 (random tables with random
validity, so rows are NOT packed valid-first).  Confidences: rtol 2e-3 /
atol 2e-4 (the Pallas kernel's A&S acos against arccos).  Prep planes:
rtol 1e-6, with an absolute floor of 1e-6 of each plane's magnitude (XLA's
CPU backend fuses multiply-adds, PyTorch does not)."""
import numpy as np
import jax.numpy as jnp
import pytest

from line3d_tpu.match import scoring as js, scoring_pallas as jsp
from line3d_tpu_torch.match import scoring as ts, scoring_cuda
from line3d_tpu_torch.match.pairwise import gather_target_coords
from torch_port_helpers import N, T

# (S, M, N, St, seed): M=128 takes the untiled K3 form, M=512 the tiled K2
SHAPES = {128: (64, 128, 4, 128, 5), 512: (32, 512, 4, 600, 9)}


def _inputs(M):
    S, M, Nc, St, seed = SHAPES[M]
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    cam = rng.integers(-1, Nc, (S, M)).astype(np.int32)
    return dict(
        segs_src=f32(rng.uniform(0, 300, (S, 4))), mask_src=np.ones(S, bool),
        RtKinv=f32(np.eye(3)), C=f32(rng.normal(size=3)), cam=cam,
        tgt=rng.integers(0, St, (S, M)).astype(np.int32),
        depths=f32(rng.uniform(0.5, 3.0, (S, M, 4))),
        valid=(rng.uniform(size=(S, M)) < 0.4) & (cam >= 0),
        P_nb=f32(rng.normal(size=(Nc, 3, 4))),
        segs_nb=f32(rng.uniform(0, 300, (Nc, St, 4))))


SIG = (np.float32(200.0), np.float32(90.0), np.float32(3.0))


def _jax_args(d):
    return ([jnp.asarray(d[k]) for k in ("segs_src", "mask_src", "RtKinv",
                                         "C", "cam", "tgt", "depths",
                                         "valid", "P_nb", "segs_nb")]
            + [jnp.float32(x) for x in SIG])


@pytest.mark.parametrize("M", sorted(SHAPES))
def test_score_plain_matches_xla_and_pallas(M):
    d = _inputs(M)
    ref = N(js.score_matches(*_jax_args(d), row_chunk=32))
    pal = N(jsp.score_matches_pallas(*_jax_args(d), interpret=True))
    got = N(scoring_cuda.score(
        T(d["segs_src"]), T(d["RtKinv"]), T(d["C"]), T(d["cam"]),
        T(d["tgt"]), T(d["depths"]), T(d["valid"]), T(d["P_nb"]),
        T(d["segs_nb"]), *(float(x) for x in SIG)))
    assert (ref > 0).sum() > 50
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got, pal, rtol=2e-3, atol=2e-4)


def _capture_pallas_inputs(monkeypatch, d):
    """Run score_matches_pallas eagerly with pallas_call replaced by a
    recorder; returns the operands the kernel would have received."""
    seen = []

    def fake_pallas_call(kernel, **kw):
        def call(*args):
            seen.append(args)
            return jnp.zeros(kw["out_shape"].shape, jnp.float32)
        return call
    monkeypatch.setattr(jsp.pl, "pallas_call", fake_pallas_call)
    jsp.score_matches_pallas.__wrapped__(*_jax_args(d), interpret=True)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("M", sorted(SHAPES))
def test_kernel_inputs_match_pallas_prep(monkeypatch, M):
    d = _inputs(M)
    ops = _capture_pallas_inputs(monkeypatch, d)
    if M <= 256:
        params, pm, btab, atab = ops
        need = None
    else:
        need, _camlo, _camhi, params, pm, _pm2, btab, atab = ops
    tcoords = gather_target_coords(T(d["segs_nb"]), T(d["cam"]),
                                   T(d["tgt"]))
    g_pm = N(ts.slot_terms(T(d["segs_src"]), T(d["RtKinv"]), T(d["cam"]),
                           T(d["depths"]), T(d["valid"]), tcoords))
    got = ts.kernel_inputs(T(d["segs_src"]), T(d["RtKinv"]), T(d["C"]),
                           T(d["valid"]), T(d["P_nb"]),
                           *(float(x) for x in SIG))
    g_btab, g_atab, g_params, g_need = (N(x) for x in got)
    pm = N(pm)
    assert g_pm.shape == pm.shape
    # the direction planes (12-14) normalize d2 ray2 - d1 ray1, which XLA
    # forms with a fused multiply-add: an ulp of the products, divided by
    # the direction's length
    p1, p2 = np.split(d["segs_src"].reshape(-1, 2, 2), 2, axis=1)
    rays = [np.concatenate([p[:, 0], np.ones((len(p), 1))], 1) for p in
            (p1, p2)]
    rays = [r / np.linalg.norm(r, axis=1, keepdims=True) for r in rays]
    dvec = d["depths"][..., 1:2] * rays[1][:, None] - \
        d["depths"][..., 0:1] * rays[0][:, None]
    dlen = np.maximum(np.linalg.norm(dvec, axis=-1), 1e-12)
    dir_tol = 1e-6 + 4 * 2.0 ** -23 * d["depths"][..., :2].max(-1) / dlen
    for k in range(pm.shape[1]):
        w = pm[:, k]
        atol = dir_tol if k in (12, 13, 14) else \
            1e-6 * max(1.0, np.abs(w).max())
        assert np.all(np.abs(g_pm[:, k] - w) <= atol + 1e-6 * np.abs(w)), \
            f"plane {k}: max err {np.abs(g_pm[:, k] - w).max()}"
    np.testing.assert_allclose(g_btab, N(btab).reshape(g_btab.shape),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g_atab, N(atab).reshape(-1), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(g_params, N(params).reshape(-1), rtol=1e-6)
    if need is not None:
        np.testing.assert_array_equal(g_need, N(need))


def test_row_need_is_one_past_last_valid_slot():
    valid = np.zeros((4, 300), bool)
    valid[1, 5] = True
    valid[2, [0, 129, 257]] = True
    valid[3, 299] = True
    np.testing.assert_array_equal(N(ts.row_need(T(valid))),
                                  [0, 6, 258, 300])


def _noisy_facade_rows(v=0, rows=range(16, 80), seed=2):
    """Rows of facade view v's exact match table (the port's plain K1 twin,
    compaction, merge and depth recompute on the CPU) after every segment
    endpoint of the 25-view facade moved 1-3 px in a random direction
    (seeded), with the view's scoring inputs at the config's sigma_p,
    sigma_a and spatial k: detected segments' supports lie that far off
    their lines, the synthetic facade's lie on them."""
    import torch
    from line3d_tpu_torch import L3DConfig
    from line3d_tpu_torch.core.conditioning import compute_conditioning
    from line3d_tpu_torch.match import engine, pairwise, pairwise_cuda
    from line3d_tpu_torch.scene import Scene, find_visual_neighbors, \
        view_similarities_from_worldpoints
    from line3d_tpu_torch.utils.demo import make_facade_scene
    cfg = L3DConfig()
    scene, cams = make_facade_scene(num_views=25, config=cfg, device="cpu")
    rng = np.random.default_rng(seed)
    lists = []
    for w in range(scene.num_views):
        s = scene.segments[w][scene.seg_mask[w]].astype(np.float64)
        mag = rng.uniform(1, 3, (len(s), 2))
        ang = rng.uniform(0, 2 * np.pi, (len(s), 2))
        s += np.stack([mag * np.cos(ang), mag * np.sin(ang)], 2).reshape(
            -1, 4)
        lists.append(s.astype(np.float32))
    scene = Scene.from_ragged(lists, cams, wp_lists=scene.wp_lists,
                              config=cfg, device="cpu")
    sim, _ = view_similarities_from_worldpoints(scene.wp_lists, 25)
    nbrs = find_visual_neighbors(sim, cams.baselines(), cfg.min_baseline,
                                 cfg.matching_neighbors, cfg.eps)
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    ctx = engine.ViewContext(scene, cams, cfg)
    nb = np.asarray(nbrs[v], np.int64)
    segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb = ctx.neighbor_arrays(v, nb)
    r = torch.as_tensor(list(rows))
    src, msk = scene.segments_t[v][r], scene.seg_mask_t[v][r]
    planes = pairwise_cuda.pair_valid_plain(
        src, msk, segs_nb, mask_nb, F_nb, ctx.RtKinv32[v], RtKinv_nb,
        ctx.C32[v], C_nb, cfg.min_overlap_lower, cfg.min_overlap_upper)
    M = max(128, engine._pow2(int(planes.sum(dim=2).sum(dim=0).max())))
    res = pairwise.match_view_against_neighbors(
        src, msk, ctx.RtKinv32[v], ctx.C32[v], segs_nb, mask_nb, F_nb,
        RtKinv_nb, C_nb, quota=128, min_capacity=M, valid=planes)
    cam, tgt, valid = pairwise.merge_neighbor_tables(res, M,
                                                     scene.max_segments)
    depths = pairwise.depths_for_matches(src, segs_nb, cam, tgt, valid, F_nb,
                                         ctx.RtKinv32[v], RtKinv_nb,
                                         ctx.C32[v], C_nb)
    sig = (np.float32(cfg.sigma_p), np.float32(cfg.sigma_a),
           np.float32(ctx.spatial_ks[v]))
    return dict(segs_src=N(src), mask_src=N(msk), RtKinv=N(ctx.RtKinv32[v]),
                C=N(ctx.C32[v]), cam=N(cam), tgt=N(tgt), depths=N(depths),
                valid=N(valid), P_nb=N(P_nb), segs_nb=N(segs_nb)), sig


# The share of scored slots where line3d_tpu's Pallas scoring kernel (in
# interpret mode) and its own XLA formulation part beyond rtol 2e-3 / atol
# 2e-4 on noisy supports: at most this (the bound chip_smoke.py's phase cli
# holds the CUDA kernel to against its float32 twin, CLI_SCORE_OUTSIDE_MAX).
# Over five samples of 256 rows of this construction (seeds 1-5, views 0,
# 12 and 5) the Pallas kernel parted from XLA on 0, 5, 3, 0 and 0 of
# 16,580, 16,968, 17,015, 6,255 and 10,474 scored slots (8 of 67,292,
# 1.2e-4; up to 2.9e-4 a view), six of them support-threshold flips (0.5
# apart): the reference parts from itself as the port's kernel parts from
# its twin on detected segments (1.7e-4 to 8.9e-4 on an NVIDIA H100), by
# the rounding of the kernel's affine-in-depth, undivided projection.
PALLAS_XLA_OUTSIDE_MAX = 2e-3


def test_pallas_scoring_parts_from_xla_on_noisy_supports():
    """line3d_tpu's Pallas scoring kernel against its XLA formulation on 64
    rows of a noisy facade view: the reference's own kernel leaves the
    scoring tolerance on a share of the slots (pinned: at least one slot,
    a support-threshold flip, and at most PALLAS_XLA_OUTSIDE_MAX), so the
    port's kernel, which keeps its projection, is held to that share."""
    d, sig = _noisy_facade_rows()
    args = ([jnp.asarray(d[k]) for k in ("segs_src", "mask_src", "RtKinv",
                                         "C", "cam", "tgt", "depths",
                                         "valid", "P_nb", "segs_nb")]
            + [jnp.float32(x) for x in sig])
    ref = N(js.score_matches(*args, row_chunk=32))
    pal = N(jsp.score_matches_pallas(*args, interpret=True))
    twin = N(scoring_cuda.score(
        *(T(d[k]) for k in ("segs_src", "RtKinv", "C", "cam", "tgt",
                            "depths", "valid", "P_nb", "segs_nb")),
        *(float(x) for x in sig)))
    n_scored = int((ref > 0).sum())
    err = np.abs(pal - ref)
    outside = err > 2e-4 + 2e-3 * np.abs(ref)
    share = outside.sum() / n_scored
    print(f"Pallas vs XLA: {int(outside.sum())} of {n_scored} scored slots "
          f"outside rtol 2e-3 / atol 2e-4 ({share:.2e}), max abs err "
          f"{err.max():.3e}; the port's twin vs XLA: "
          f"{int((np.abs(twin - ref) > 2e-4 + 2e-3 * np.abs(ref)).sum())}")
    assert n_scored > 3000
    assert 1 <= outside.sum() <= PALLAS_XLA_OUTSIDE_MAX * n_scored
    assert np.abs(err[outside] - 0.5).min() < 1e-3     # a threshold flip
