"""The three matching modes of line3d_tpu_torch (exact one pass, capped pass +
uncapped fallback, capped pass with a warning) and the capacity-probe
counters, held against line3d_tpu on the scenes of tests/test_caps.py.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: identities (verified-match sets, table slots, counters,
capacity decisions, line memberships) are compared exactly; 3D endpoints
of the two packages within 1e-4 (float32 depths; XLA:CPU contracts FMAs,
so the packages agree to tolerances, not bits); within the port, results
of two modes that must be the same run are compared exactly.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest

from line3d_tpu import Line3D as JLine3D, L3DConfig as JConfig
from line3d_tpu.core.conditioning import compute_conditioning
from line3d_tpu.match import engine as je, pairwise as jp
from line3d_tpu.scene import Scene as JScene, find_visual_neighbors, \
    view_similarities_from_worldpoints
from line3d_tpu_torch import Line3D, L3DConfig, convert
from line3d_tpu_torch.match import engine as te, pairwise as tp
from synthetic import make_scene
from torch_port_helpers import N, T

TINY = dict(match_block_quota=1, max_matches_per_segment=8)
BIG = dict(match_block_quota=128, max_matches_per_segment=10**6)


def _dense_syn(num_views=8, copies=6, jitter=1.5, seed=11):
    """tests/test_caps.py's dense scene: every 2D segment duplicated
    `copies` times with pixel jitter, so per-segment gate-passing counts
    saturate small caps."""
    syn = make_scene(num_views=num_views)
    rng = np.random.default_rng(seed)
    seg_lists = []
    for v in range(syn.scene.num_views):
        segs = syn.scene.segments[v][syn.scene.seg_mask[v]]
        reps = [segs]
        for _ in range(copies - 1):
            reps.append(segs + rng.normal(0, jitter, segs.shape)
                        .astype(np.float32))
        seg_lists.append(np.concatenate(reps, axis=0))
    return dataclasses.replace(
        syn, scene=JScene.from_ragged(seg_lists, syn.cameras,
                                      wp_lists=syn.wp_lists))


def _setup(syn, min_baseline=0.25):
    """Condition the cameras, pick 4 visual neighbors (as test_caps.py), and
    carry the scene into the port.  Returns (cams, neighbors, scene_t,
    cams_t)."""
    cams = syn.cameras
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    sim, _ = view_similarities_from_worldpoints(syn.wp_lists,
                                                syn.scene.num_views)
    neighbors = find_visual_neighbors(sim, cams.baselines(), min_baseline, 4)
    scene_t, cams_t = convert.scene_from_reference(syn.scene, cams, "cpu")
    return cams, neighbors, scene_t, cams_t


def _match_key(vm):
    return (vm.view, sorted(zip(vm.src_seg.tolist(), vm.tgt_view.tolist(),
                                vm.tgt_seg.tolist())))


def _best_key(best):
    return {(int(v), int(s)): (int(tv), int(ts), round(float(sc), 6))
            for v, s, tv, ts, sc in zip(best.view, best.seg, best.tgt_view,
                                        best.tgt_seg, best.score)}


_jax_pair = jax.jit(lambda *a: jp.match_pair_dense(*a)[1])


def _jax_planes(segs_src, mask_src, segs_nb, mask_nb, F_nb, RtKinv_src,
                RtKinv_nb, C_src, C_nb, lo, hi):
    """line3d_tpu's valid planes [N, S, S] in `pair_valid`'s signature.  On
    the dense scene K1's twin and the JAX plane part on a borderline pair
    in ~1e-4 of the pairs (tests/test_torch_pairwise.py bounds that), which
    moves a counter by one; the tests that compare counts with line3d_tpu
    exactly therefore give both packages the same planes."""
    return T(np.stack([np.asarray(_jax_pair(
        N(segs_src), N(segs_nb[n]), N(mask_src), N(mask_nb[n]), N(F_nb[n]),
        N(RtKinv_src), N(RtKinv_nb[n]), N(C_src), N(C_nb[n]), lo, hi))
        for n in range(len(segs_nb))]))


@pytest.fixture(scope="module")
def dense():
    syn = _dense_syn()
    cams, neighbors, scene_t, cams_t = _setup(syn)
    cfg = dataclasses.replace(L3DConfig(), **TINY)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(te, "pair_valid", _jax_planes)
        capped = te.run_matching(scene_t, cams_t, neighbors, cfg,
                                 capped=True)
        exact = te.run_matching(scene_t, cams_t, neighbors, cfg)
    return dict(syn=syn, cams=cams, neighbors=neighbors, scene_t=scene_t,
                cams_t=cams_t, cfg=cfg, capped=capped, exact=exact)


def test_overflow_zero_implies_uncapped_identity():
    """Where the default caps never overflow, the capped pass, a pass at
    generous caps and the exact pass give the same result, and the
    verified-match sets equal line3d_tpu's capped pass."""
    syn = make_scene(num_views=8)
    cams, neighbors, scene_t, cams_t = _setup(syn)
    m1, b1, med1 = te.run_matching(scene_t, cams_t, neighbors, L3DConfig(),
                                   capped=True)
    assert all(vm.overflow == 0 for vm in m1)
    assert {vm.m_total for vm in m1} == {256}
    m2, b2, med2 = te.run_matching(scene_t, cams_t, neighbors,
                                   L3DConfig(**BIG), capped=True)
    m3, b3, med3 = te.run_matching(scene_t, cams_t, neighbors, L3DConfig())
    for m, b, med in ((m2, b2, med2), (m3, b3, med3)):
        assert [_match_key(a) for a in m1] == [_match_key(a) for a in m]
        assert _best_key(b1) == _best_key(b)
        np.testing.assert_array_equal(med1, med)
    mj, _, medj = je.run_matching(syn.scene, cams, neighbors, JConfig())
    assert [_match_key(a) for a in m1] == [_match_key(a) for a in mj]
    np.testing.assert_allclose(med1, medj, rtol=1e-6)


def test_dense_scene_saturates_and_fallback_restores_oracle(dense):
    """Tiny caps on the dense scene overflow and change the result; the
    fallback re-matches exactly the overflowing views and gives the exact
    pass's matches, best rows (in view-ascending order) and medians."""
    m_cap, b_cap, med_cap = dense["capped"]
    m_or, b_or, med_or = dense["exact"]
    over = [vm.view for vm in m_cap if vm.overflow > 0]
    assert over, "dense scene did not saturate the tiny caps"
    assert all(vm.overflow == 0 for vm in m_or)
    assert [_match_key(a) for a in m_cap] != [_match_key(a) for a in m_or]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(te, "pair_valid", _jax_planes)
        m_fb, b_fb, med_fb, n = te.apply_uncapped_fallback(
            m_cap, b_cap, med_cap, dense["scene_t"], dense["cams_t"],
            dense["neighbors"], dense["cfg"])
    assert n == len(over)
    assert [_match_key(a) for a in m_fb] == [_match_key(a) for a in m_or]
    for f in dataclasses.fields(b_or):
        np.testing.assert_array_equal(getattr(b_fb, f.name),
                                      getattr(b_or, f.name), err_msg=f.name)
    assert np.all(np.diff(b_fb.view) >= 0)
    np.testing.assert_array_equal(med_fb, med_or)
    np.testing.assert_array_equal(dense["cams_t"].median_depth, med_or)


def test_capped_pass_matches_reference_capped_pass(dense):
    """The capped pass drops what line3d_tpu's capped pass drops: per view
    the same overflow count and the same verified-match set."""
    mj, _, _ = je.run_matching(dense["syn"].scene, dense["cams"],
                               dense["neighbors"],
                               dataclasses.replace(JConfig(), **TINY))
    m_cap = dense["capped"][0]
    assert [vm.overflow for vm in m_cap] == [vm.overflow for vm in mj]
    assert [_match_key(a) for a in m_cap] == [_match_key(a) for a in mj]


def test_probe_counters_match_reference_probe(dense):
    """(need, total, blockmax, nbmax) of every view, from the capped and
    from the exact pass, equal line3d_tpu's device probe on the same
    scene."""
    syn = dense["syn"]
    prep = je.prepare_sharded_matching(syn.scene, dense["cams"],
                                       dense["neighbors"], JConfig())
    want = je.finalize_capacity_probe(je.dispatch_capacity_probe(prep))
    V = syn.scene.num_views
    for run in ("capped", "exact"):
        got = te.probe_counters(dense[run][0], V)
        for g, w, name in zip(got, want, ("need", "total", "blockmax",
                                          "nbmax")):
            np.testing.assert_array_equal(g, w[:V], err_msg=f"{run} {name}")
    assert got[0].max() > 8 and got[2].max() > 1


_GRID = list(itertools.product(
    (3072, 1280, 128, 100),                # S (blocks of 128, 128, 128, 4)
    (100, 256, 1024), (11, 12, 30, 100), (40, 200, 300, 600)))


@pytest.mark.parametrize("caps", [{}, TINY, dict(match_block_quota=32)])
def test_decide_exact_capacities_equals_reference(caps):
    """The scene-wide capacity decision on a grid of probe counters, under
    three cap settings, equals line3d_tpu's (None where the default launch
    is already exact)."""
    cj, ct = JConfig(**caps), L3DConfig(**caps)
    n_none = 0
    for S, need, bmax, nbmax in _GRID:
        for total in (100, 20000):
            a = [np.array([x, 0]) for x in (need, total, bmax, nbmax)]
            want = je.decide_exact_capacities(*a, cj, 10, S)
            got = te.decide_exact_capacities(*a, ct, 10, S)
            assert got == want, (S, need, total, bmax, nbmax)
            n_none += want is None
    if not caps:
        assert 0 < n_none < 2 * len(_GRID)


@pytest.mark.parametrize("per_nb_cap", [None, 4, 16])
def test_per_nb_cap_table_equals_reference(per_nb_cap):
    """match_view_against_neighbors with the second per-neighbor compaction:
    slots, kept flags, counts and overflow equal the JAX table on the same
    valid planes' inputs (dense house view 0 against its neighbors)."""
    syn = _dense_syn(num_views=6)
    cams, neighbors, scene_t, cams_t = _setup(syn)
    ctx = te.ViewContext(scene_t, cams_t, L3DConfig())
    nb = np.asarray(neighbors[0], np.int64)
    a = ctx.neighbor_arrays(0, nb)[:5]
    src = (scene_t.segments_t[0], scene_t.seg_mask_t[0], ctx.RtKinv32[0],
           ctx.C32[0])
    want = jp.match_view_against_neighbors(
        *[N(x) for x in src], *[N(x) for x in a], np.ones(len(nb), bool), 2,
        min_capacity=16, per_nb_cap=per_nb_cap)
    # the compaction is what is compared: both sides get the JAX planes
    # (K1's twin against them is tests/test_torch_pairwise.py's subject)
    planes = np.stack([np.asarray(jp.match_pair_dense(
        N(src[0]), N(a[0][n]), N(src[1]), N(a[1][n]), N(a[2][n]), N(src[2]),
        N(a[3][n]), N(src[3]), N(a[4][n]))[1]) for n in range(len(nb))])
    got = tp.match_view_against_neighbors(*src, *a, quota=2,
                                          min_capacity=16, valid=T(planes),
                                          per_nb_cap=per_nb_cap)
    for k in ("tgt_idx", "valid", "n_valid", "overflow"):
        np.testing.assert_array_equal(N(got[k]), N(want[k]), err_msg=k)
    width = got["tgt_idx"].shape[2]
    assert width == (per_nb_cap or width) and int(got["overflow"].sum()) > 0


@pytest.mark.parametrize("view", [0, 5])
def test_exact_mode_cuts_each_neighbor_losslessly(dense, view):
    """The exact mode hands match_view_against_neighbors the view's own
    per-(segment, neighbor) bound, pow2(nbmax) (or what the N tables need
    to fill m_total slots), narrower than the block-compacted table; the merged table, depths and confidences equal
    those of the same step without the cut, exactly."""
    ctx = te.ViewContext(dense["scene_t"], dense["cams_t"], dense["cfg"])
    nb = np.asarray(dense["neighbors"][view], np.int64)
    seen = []
    orig = tp.match_view_against_neighbors

    def spy(*a, **kw):
        seen.append(kw["per_nb_cap"])
        res = orig(*a, **kw)
        seen.append(res["tgt_idx"].shape[2])
        return res

    def uncut(*a, **kw):
        return orig(*a, **dict(kw, per_nb_cap=None))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tp, "match_view_against_neighbors", spy)
        got = te.match_view(ctx, view, nb)
        mp.setattr(tp, "match_view_against_neighbors", uncut)
        want = te.match_view(ctx, view, nb)
    assert seen == [max(te._pow2(got["nbmax"]),
                        -(-got["m_total"] // len(nb)))] * 2
    assert got["m_total"] == te._pow2(got["need"])
    assert seen[0] < dense["scene_t"].max_segments
    assert got["overflow"] == want["overflow"] == 0
    for k in ("cam", "tgt", "valid", "depths", "conf"):
        np.testing.assert_array_equal(N(got[k]), N(want[k]), err_msg=k)
    for k in ("need", "total", "blockmax", "nbmax", "m_total"):
        assert got[k] == want[k], k


def _run(pkg_line3d, cfg, syn, **kw):
    l3d = pkg_line3d(config=cfg, **kw)
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v], width=640, height=480)
    return l3d.compute_3d_model(perform_diffusion=False), l3d.stats


def _keysets(res):
    return sorted(sorted(zip(r.views2d.tolist(), r.segs2d.tolist()))
                  for r in res)


@pytest.fixture(scope="module")
def pipeline_oracle():
    """The dense scene through both packages at generous caps."""
    syn = _dense_syn()
    res_t, st = _run(Line3D, L3DConfig(use_collinearity=False, **BIG), syn,
                     device="cpu")
    res_j, _ = _run(JLine3D, JConfig(use_collinearity=False, **BIG),
                    _dense_syn(), use_sharded_engine=False)
    assert st["match_overflow"] == 0 and len(res_t) > 10
    return res_t, res_j


def _same_model(res, oracle, atol):
    assert _keysets(res) == _keysets(oracle)
    key = lambda r: sorted(zip(r.views2d.tolist(), r.segs2d.tolist()))  # noqa
    for a, b in zip(sorted(res, key=key), sorted(oracle, key=key)):
        np.testing.assert_allclose(a.segments3d, b.segments3d, rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("probe", [True, False])
def test_pipeline_tiny_caps_match_uncapped(pipeline_oracle, probe):
    """Tiny caps with the exactness guard give the generous-caps model in
    both guard modes: the probe's one pass (nothing overflows, nothing is
    re-matched, the reported capacity is above the cap) and the capped
    pass + fallback (views re-matched).  The port's own oracle exactly;
    line3d_tpu's within 1e-4."""
    cfg = L3DConfig(use_collinearity=False, capacity_probe=probe, **TINY)
    res, st = _run(Line3D, cfg, _dense_syn(), device="cpu")
    assert st["match_overflow"] == (0 if probe else st["match_overflow"])
    if probe:
        assert st["views_rematched_uncapped"] == 0
        assert st["probe_m_total"] > 8 and st["probe_quota"] >= 1
        assert st["probe_k_export"] > 0
    else:
        assert st["views_rematched_uncapped"] > 0 and st["match_overflow"] > 0
        assert st["probe_m_total"] == 0
    _same_model(res, pipeline_oracle[0], atol=0)
    _same_model(res, pipeline_oracle[1], atol=1e-4)


def test_default_caps_exact_reports_no_probe_decision():
    """On the plain house the default caps are already exact: the probe
    decides nothing (probe_m_total 0), as in line3d_tpu."""
    _, st = _run(Line3D, L3DConfig(use_collinearity=False),
                 make_scene(num_views=8), device="cpu")
    _, sj = _run(JLine3D, JConfig(use_collinearity=False),
                 make_scene(num_views=8))
    for k in ("probe_m_total", "probe_quota", "probe_k_export",
              "views_rematched_uncapped", "match_overflow"):
        assert st[k] == sj[k] == 0, k


def test_fallback_off_warns(capsys):
    """With uncapped_fallback off the overflow is warned about, word for
    word as line3d_tpu warns, stays in the stats, and nothing is
    re-matched.  The dropped count itself is within 1e-3 of line3d_tpu's
    (K1's twin and the JAX plane part on borderline pairs)."""
    cfg = dict(use_collinearity=False, uncapped_fallback=False, **TINY)
    _, st = _run(Line3D, L3DConfig(**cfg), _dense_syn(), device="cpu")
    out = capsys.readouterr().out
    _, sj = _run(JLine3D, JConfig(**cfg), _dense_syn(),
                 use_sharded_engine=False)
    warn_j = [ln for ln in capsys.readouterr().out.splitlines()
              if "WARNING" in ln]
    warn_t = [ln for ln in out.splitlines() if "WARNING" in ln]
    assert len(warn_t) == len(warn_j) == 1 and "gate-passing" in warn_t[0]
    assert warn_t[0].replace(str(st["match_overflow"]), "#") == \
        warn_j[0].replace(str(sj["match_overflow"]), "#")
    assert st["match_overflow"] > 0
    assert abs(st["match_overflow"] - sj["match_overflow"]) <= \
        1e-3 * sj["match_overflow"]
    assert st["views_rematched_uncapped"] == 0
