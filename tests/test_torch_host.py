"""line3d_tpu_torch against line3d_tpu stage by stage on the structured
facade (`utils/demo.make_facade_scene`), default configuration
(collinearity on, exact F-H).

The port's whole `Line3D(device="cpu")` runs once; spies on its pipeline's
module attributes capture every stage's inputs and outputs, and each stage
of line3d_tpu gets the same inputs:

(a) similarities, neighbours, conditioning: neighbours equal, similarities
    and transforms within rtol 1e-12 (float64);
(b) collinearity: the drop counters before the exact fallback equal those of
    the reference's Pallas formulation (`collinearity_keep_pallas`,
    interpret mode), the TPU kernel K4 ports, and are a superset of its XLA
    formulation's; the maps after the fallback hold the same pairs except the
    pinned borderline pairs, weights within atol 1e-4;
(c) `build_affinity_graph` (native collinear path): bit for bit;
(d) `fh_cluster` and `fh_cluster_parallel`: labels equal after relabelling;
(e) `process_clusters(refine=False)`: TXT `compare_txt`-ok, worst ratio 0;
(f) matching, every view against the reference's exact per-view engine
    (`_match_one_view` at the port's capacity, quota off, host selection):
    verified-match sets differ on fewer than 1e-3 of a view's matches, and
    every differing best-match pick is a near-tie (the reference scores the
    port's target within 1e-5 relative of its own pick), or its row holds a
    verified match only one package has, or is pinned with its cause.

The attribution: the port's matching outputs through the reference's
affinity, F-H, fit and writer give the port's TXT exactly, so with (c)-(e)
every line in which the two models differ enters at matching, which (f)
bounds.  The two models are compared by member sets and pinned.

Scenes.  tier-1 runs `facade6` (6 views of a 10 x 6-cell facade, 960 x 720,
focal 900, S = 768): the 8-view facade's matching takes ~150 s of the
port's CPU twins at 2 threads, this one ~30 s.  It still drops collinear
pairs in the port (view 5) and has near-tie picks.  Its models: the port
264 lines, the reference 263, 259 member sets shared; only the port has
lines of 17, 16, 12, 10 and 7 members, only the reference 28, 15, 8 and 6.
`facade8` (8 views of the 12 x 10-cell facade, 960 x 720, focal 900,
S = 1,280) runs in the `slow` test with line3d_tpu's whole `Line3D` beside
it: 434 lines against 432, 428 shared.

Pinned in PINS, with their causes (float32 rounding against float64):
- collinearity, facade6 view 5, pair (27, 334): affinity 0.49980 in float64,
  below the 0.5 gate as in the reference (XLA:CPU contracts the cancelling
  a*x + b*y + c into fused multiply-adds); the port rounds each product
  and gets 0.5000318.  facade8 view 5, pair (227, 405): 0.50050 in
  float64, above the gate as in the reference; the port gets 0.49989.
  The shared pairs' weights: the port within 7.7e-4 (facade6) and 4.6e-3
  (facade8) of float64, the reference within 4.4e-4 and 3.0e-3.
- best matches that are float64 ties (`utils/compare.float64_tie`: the
  two picks' float64 confidences closer than either package's float32
  error on them): 9 of facade6's 353 differing picks (344 are near-ties),
  6 of facade8's 942 (935 near-ties, 1 traced).  One is facade8 view 0
  segment 792: the reference picks (view 2, segment 661) at confidence
  1.992096, the port (3, 852) at 1.992520; in float64 the port's pick
  ranks first (1.9955506 against 1.9955169).  The row's triangulations are
  ill-conditioned (near-parallel rays), so both float32 forms miss the
  float64 confidences by 1.5-1.8e-3 and order the two picks by their
  rounding."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from line3d_tpu import L3DConfig as JConfig, Line3D as JLine3D
from line3d_tpu.cluster import affinity as ja, fh as jfh
from line3d_tpu.core.conditioning import compute_conditioning as \
    j_conditioning
from line3d_tpu.fit import lines as jl
from line3d_tpu.io import writers as jw
from line3d_tpu.match import collinearity as jc, \
    collinearity_pallas as jcp, engine as je, pairwise as jpw
from line3d_tpu.scene import find_visual_neighbors as j_neighbors, \
    view_similarities_from_worldpoints as j_similarities
from line3d_tpu.utils.demo import make_facade_scene

from line3d_tpu_torch import L3DConfig, Line3D, convert, pipeline as tp
from line3d_tpu_torch.cluster import fh as tfh
from line3d_tpu_torch.io import writers as tw
from line3d_tpu_torch.utils import compare
from torch_port_helpers import relabel, to_reference

HERE = os.path.dirname(os.path.abspath(__file__))

SCENES = dict(
    facade6=dict(num_views=6, width=960, height=720, focal=900.0,
                 n_cols=10, n_rows=6, distance=13.0 * 10 / 12),
    facade8=dict(num_views=8, width=960, height=720, focal=900.0))

# the differences the docstring explains, per scene: collinear pairs
# (view, i, j) after the fallback only in the port / only in the
# reference; best-match picks (view, seg) neither near-tie nor traced; the
# drop counters before the fallback (port = reference's Pallas form); the
# two models by member sets (a = the port, b = the reference)
PINS = dict(
    facade6=dict(
        collin_only_port={(5, 27, 334), (5, 334, 27)},
        collin_only_ref=set(),
        float64_ties={(0, 432), (1, 369), (2, 136), (3, 10), (3, 13),
                      (3, 106), (3, 165), (3, 278), (3, 435)},
        dropped=[0, 0, 0, 0, 0, 2],
        model=dict(lines_a=264, lines_b=263, shared=259,
                   only_a=[17, 16, 12, 10, 7], only_b=[28, 15, 8, 6])),
    facade8=dict(
        collin_only_port=set(),
        collin_only_ref={(5, 227, 405), (5, 405, 227)},
        float64_ties={(0, 23), (0, 792), (2, 837), (4, 593), (5, 327),
                      (7, 143)},
        dropped=[0, 0, 0, 0, 0, 2, 0, 0],
        model=dict(lines_a=434, lines_b=432, shared=428,
                   only_a=[71, 68, 8, 7, 4, 4], only_b=[74, 68, 11, 4])))


def _spied(mods_names, seen):
    """Wrap each (module, name) so its calls land in seen[name] as
    (args, kwargs, result); returns the originals."""
    origs = []
    for mod, name in mods_names:
        orig = getattr(mod, name)
        origs.append((mod, name, orig))

        def spy(*a, _orig=orig, _name=name, **k):
            r = _orig(*a, **k)
            seen.setdefault(_name, []).append((a, k, r))
            return r
        setattr(mod, name, spy)
    return origs


def port_run(name, tmp):
    """The port's whole Line3D(device="cpu") on scene `name`, fed from the
    reference's scene generator, with its stages' inputs and outputs."""
    scene, cams = make_facade_scene(**SCENES[name])
    V = scene.num_views
    seen = {}
    origs = _spied([(tp, "find_visual_neighbors"),
                    (tp, "compute_conditioning"),
                    (tp.affinity, "build_affinity_graph"),
                    (tp.fh, "fh_cluster"),
                    (tp.fit_lines, "process_clusters")], seen)
    # the fallback patches the maps in place: keep the counters before it
    dropped = []
    orig_collin = tp.collinearity_maps_fast

    def collin_spy(*a, **k):
        out = orig_collin(*a, **k)
        dropped.append(np.array(out.dropped_per_view))
        return out
    tp.collinearity_maps_fast = collin_spy
    try:
        l3d = Line3D(device="cpu")
        for v in range(V):
            l3d.add_view_segments(
                v, scene.segments[v][scene.seg_mask[v]], cams.K[v],
                cams.R[v], cams.t[v], worldpoint_ids=scene.wp_lists[v],
                width=int(cams.width[v]), height=int(cams.height[v]))
        result = l3d.compute_3d_model()
    finally:
        tp.collinearity_maps_fast = orig_collin
        for mod, nm, orig in origs:
            setattr(mod, nm, orig)
    txt = os.path.join(tmp, f"{name}_port.txt")
    l3d.save_3d_lines_as_txt(result, txt)
    one = {k: v[0] for k, v in seen.items() if len(v) == 1}
    return dict(name=name, l3d=l3d, txt=txt, seen=one, dropped=dropped[0],
                segments=scene.segments, mask=scene.seg_mask,
                wp_lists=scene.wp_lists)


def _collinearity_pallas_form(segs, mask, cfg):
    """The reference's collinearity export with its TPU path's keep plane
    (collinearity_keep_pallas in interpret mode), before the fallback."""
    orig_use, orig_keep = jpw.use_pallas, jcp.collinearity_keep_pallas
    jpw.use_pallas = lambda: True
    jcp.collinearity_keep_pallas = functools.partial(orig_keep,
                                                     interpret=True)
    try:
        # a fresh jit, so no executable traced with the XLA form is reused
        fn = jax.jit(lambda s, m: jc.collinearity_compact_all.__wrapped__(
            s, m, np.float32(cfg.collinearity_sigma ** 2),
            quota=cfg.collinearity_block_quota,
            pairs_per_seg=cfg.collinearity_pairs_per_seg,
            aff_threshold=float(cfg.collinearity_aff_threshold)))
        pairs, w, count = fn(jnp.asarray(segs), jnp.asarray(mask))
    finally:
        jpw.use_pallas, jcp.collinearity_keep_pallas = orig_use, orig_keep
    return jc.collinearity_finalize(pairs, w, count,
                                    max_segments=segs.shape[1],
                                    num_views=len(segs))


def reference_collinearity(port):
    """The reference's maps on the port's scene: XLA form (what its CPU
    pipeline runs) and Pallas form, each before and after the fallback;
    computed once per run."""
    if "ref_collinearity" in port:
        return port["ref_collinearity"]
    cfg = JConfig()
    segs = np.asarray(port["segments"], np.float32)
    mask = np.asarray(port["mask"])
    kw = dict(quota=cfg.collinearity_block_quota,
              pairs_per_seg=cfg.collinearity_pairs_per_seg,
              aff_threshold=cfg.collinearity_aff_threshold)
    out = {}
    for form in ("xla", "pallas"):
        pre = jc.collinearity_maps_fast(
            segs, mask, cfg.collinearity_sigma, **kw) if form == "xla" \
            else _collinearity_pallas_form(segs, mask, cfg)
        dropped = np.array(pre.dropped_per_view)
        post, _ = jc.apply_collinearity_exact_fallback(
            pre, segs, mask, cfg.collinearity_sigma,
            aff_threshold=cfg.collinearity_aff_threshold)
        out[form] = (dropped, post)
    port["ref_collinearity"] = out
    return out


def reference_matching(port):
    """line3d_tpu's exact per-view engine on the port's scene: each view at
    the port's capacity with the block quota off (rematch_views_exact's
    caps), host selection, so its ViewMatches carry confidences.  Returns
    dict(matches, best, the conditioned cameras, transform, scene,
    neighbours, each view's raw tables (cam, tgt, depths, valid, conf) and
    the port's scene and cameras converted from the reference's)."""
    scene, cams = make_facade_scene(**SCENES[port["name"]])
    V, cfg = scene.num_views, JConfig()
    sim, _ = j_similarities(scene.wp_lists, V)
    nbrs = j_neighbors(sim, cams.baselines(), cfg.min_baseline,
                       cfg.matching_neighbors, cfg.eps,
                       ext_ids=list(range(V)))
    transform = j_conditioning(cams.C)
    cams.transform(transform.Qinv, transform.scale)
    ctx = je._ViewContext(scene, cams, cfg, max(len(n) for n in nbrs))
    matches, rows, tables = [], [], []
    for v, m_total in enumerate(port["l3d"].stats["m_total"]):
        nb = np.asarray(nbrs[v], np.int64)
        outs = je._match_one_view(ctx, v, nb, quota=128, m_total=m_total)
        assert outs[-1] == 0, f"view {v} overflowed"
        vm, row, cams.median_depth[v] = je._select_view_outputs(
            ctx, v, nb, *outs)
        matches.append(vm)
        rows.append(row)
        tables.append(outs[:5])
    best = je._concat_best([r for r in rows if r is not None])
    return dict(matches=matches, best=best, cams=cams, transform=transform,
                scene=scene, neighbors=nbrs, tables=tables,
                port_scene=convert.scene_from_reference(scene, cams, "cpu"))


def reference_model(best, matches, collin, cams, transform, segments, path):
    """line3d_tpu's affinity, F-H, plain fit and TXT writer."""
    cfg = JConfig()
    S = segments.shape[1]
    graph = ja.build_affinity_graph(best, matches, collin, cams, cfg, S)
    labels = jfh.fh_cluster(graph.edges_i, graph.edges_j, graph.edges_w,
                            graph.num_nodes, cfg.fh_c)
    result = jl.process_clusters(graph, labels, best, transform, cfg, S)
    jw.save_txt(result, path, get_segment_2d=lambda v, s: segments[v, s],
                view_id_map=list(range(segments.shape[0])))
    return path


# ----------------------------------------------------------------------
# the checks, shared by the tier-1 tests (facade6) and the slow test
# (facade8)

def check_conditioning(port):
    seen = port["seen"]
    (sim, baselines, *_), kw, nbrs = seen["find_visual_neighbors"]
    V = len(port["wp_lists"])
    want, _ = j_similarities(port["wp_lists"], V)
    np.testing.assert_allclose(sim, want, rtol=1e-12, atol=0)
    cfg = JConfig()
    ref = j_neighbors(want, baselines, cfg.min_baseline,
                      cfg.matching_neighbors, cfg.eps,
                      ext_ids=kw.get("ext_ids"))
    assert [np.asarray(n).tolist() for n in nbrs] == \
        [np.asarray(n).tolist() for n in ref]
    scene, cams = make_facade_scene(**SCENES[port["name"]])
    np.testing.assert_array_equal(baselines, cams.baselines())
    assert port["l3d"].scene.max_segments == scene.max_segments
    got = seen["compute_conditioning"][2]
    ref = j_conditioning(cams.C)
    for f in ("scale", "R", "t", "Qinv", "scale_inv", "Rinv", "tneg"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-12, atol=0, err_msg=f)


def _pairs(maps):
    return dict(zip(zip(np.asarray(maps.flat_view).tolist(),
                        np.asarray(maps.flat_i).tolist(),
                        np.asarray(maps.flat_j).tolist()),
                    np.asarray(maps.flat_w).tolist()))


def collinear_weights64(segments, keys, sigma=2.0):
    """The collinearity weight exp(-d^2 / 2 sigma^2) of each (view, i, j)
    in float64 from the float32 endpoints: the value both packages'
    float32 forms (`_pair_aff`, `collinearity_matrix`) approximate."""
    v, i, j = (np.array(x) for x in zip(*keys))
    p = segments[v, i].astype(np.float64)
    q = segments[v, j].astype(np.float64)

    def line(s):
        return s[:, 1] - s[:, 3], s[:, 2] - s[:, 0], \
            s[:, 0] * s[:, 3] - s[:, 1] * s[:, 2]

    def dist(ln, x, y):
        return np.abs(ln[0] * x + ln[1] * y + ln[2]) / np.hypot(ln[0], ln[1])
    lp, lq = line(p), line(q)
    d = np.max([dist(lq, p[:, 0], p[:, 1]), dist(lq, p[:, 2], p[:, 3]),
                dist(lp, q[:, 0], q[:, 1]), dist(lp, q[:, 2], q[:, 3])],
               axis=0)
    return np.exp(-d * d / (2.0 * sigma * sigma))


def check_collinearity(port, ref):
    """Returns (port, reference) largest weight error against float64."""
    pins = PINS[port["name"]]
    d_xla, post_xla = ref["xla"]
    d_pallas, post_pallas = ref["pallas"]
    # the port's counters are the reference TPU path's, and never miss a
    # drop of its XLA path
    np.testing.assert_array_equal(port["dropped"], d_pallas)
    assert port["dropped"].tolist() == pins["dropped"]
    assert (port["dropped"] >= d_xla).all()
    got = port["seen"]["build_affinity_graph"][0][2]     # after fallback
    assert got.dropped_total == 0
    pg = _pairs(got)
    for want in (post_xla, post_pallas):
        pw = _pairs(want)
        assert pg.keys() - pw.keys() == pins["collin_only_port"]
        assert pw.keys() - pg.keys() == pins["collin_only_ref"]
        pinned = {(v, i) for v, i, _ in pins["collin_only_port"]
                  | pins["collin_only_ref"]}
        for v, (dg, dw) in enumerate(zip(got, want)):
            rows = {i for vv, i in pinned if vv == v}
            assert {i: set(js) for i, js in dg.items() if i not in rows} \
                == {i: set(js) for i, js in dw.items() if i not in rows}
    # the shared pairs' float32 weights: the port is as close to the
    # float64 value as the reference (which contracts into FMAs) within a
    # factor 2
    shared = sorted(pg.keys() & pw.keys())
    w64 = collinear_weights64(port["segments"], shared)
    err_port = np.abs(np.array([pg[k] for k in shared]) - w64).max()
    err_ref = np.abs(np.array([pw[k] for k in shared]) - w64).max()
    assert err_port <= 2.0 * err_ref, (err_port, err_ref)
    return err_port, err_ref


def check_affinity(port):
    (best, matches, collin, cams, _cfg, S), _kw, got = \
        port["seen"]["build_affinity_graph"]
    want = ja.build_affinity_graph(
        to_reference(best), [to_reference(vm) for vm in matches],
        to_reference(collin), to_reference(cams), JConfig(), S)
    assert got.num_nodes == want.num_nodes > 1000
    for f in ("edges_i", "edges_j", "edges_w", "node_view", "node_seg"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    return got


def check_fh(port, parallel):
    graph = port["seen"]["build_affinity_graph"][2]
    args = (graph.edges_i, graph.edges_j, graph.edges_w, graph.num_nodes,
            JConfig().fh_c)
    if parallel:
        got, want = tfh.fh_cluster_parallel(*args), \
            jfh.fh_cluster_parallel(*args)
    else:
        (*_, c), _kw, got = port["seen"]["fh_cluster"]
        assert c == JConfig().fh_c
        want = jfh.fh_cluster(*args)
    np.testing.assert_array_equal(relabel(got), relabel(want))
    assert len(np.unique(want)) > 100


def check_plain_fit(port, tmp):
    """Returns compare_txt's report of the port's fit, written by the
    port's writer, against the reference's."""
    (graph, labels, best, transform, _cfg, S), kw, got = \
        port["seen"]["process_clusters"]
    assert not kw.get("refine")
    want = jl.process_clusters(to_reference(graph), labels,
                               to_reference(best), to_reference(transform),
                               JConfig(), S)
    segs = port["segments"]
    seg2d = lambda v, s: segs[v, s]                  # noqa: E731
    ids = list(range(segs.shape[0]))
    a = os.path.join(tmp, f"{port['name']}_fit_port.txt")
    b = os.path.join(tmp, f"{port['name']}_fit_ref.txt")
    tw.save_txt(got, a, get_segment_2d=seg2d, view_id_map=ids)
    jw.save_txt(want, b, get_segment_2d=seg2d, view_id_map=ids)
    return tw.compare_txt(a, b)


def check_matching(port, ref, views):
    """(f) on `views`; returns {view: (verified differences, best-pick
    classification, {(view, seg): (gap64, err32)} of the picks that are
    float64 ties)}."""
    pins = PINS[port["name"]]
    (best, matches, *_), _kw, _ = port["seen"]["build_affinity_graph"]
    diffs = compare.verified_differences(ref["matches"], matches)
    out, too_many, not_ties = {}, [], []
    for v in views:
        n, _n, only_ref, only_port = diffs[v]
        if len(only_ref) + len(only_port) >= 1e-3 * n:
            too_many.append((v, n, only_ref, only_port))
        sel = lambda b: type(b)(**{                  # noqa: E731
            f: getattr(b, f)[b.view == v] for f in b.__dataclass_fields__})
        picks = compare.best_pick_differences(
            sel(ref["best"]), sel(best), [ref["matches"][v]], [matches[v]])
        cam, tgt, _d, valid, conf = ref["tables"][v]
        ties = {}
        for _, s, pick_ref, pick_port, _gap in picks["untraced"]:
            gap64, err32 = compare.float64_tie(
                *ref["port_scene"], ref["neighbors"], L3DConfig(), v, s,
                (cam[s], tgt[s], valid[s]), [conf[s]], pick_ref, pick_port)
            if gap64 < err32:
                ties[(v, s)] = (gap64, err32)
            else:
                not_ties.append((v, s, pick_ref, pick_port, gap64, err32))
        out[v] = (diffs[v], picks, ties)
    assert not too_many and not not_ties, (too_many, not_ties)
    got = {k for _, _, t in out.values() for k in t}
    assert got == {k for k in pins["float64_ties"] if k[0] in views}, got
    return out


def check_attribution(port, tmp):
    """The port's matching outputs through the reference's affinity, F-H,
    fit and writer: the port's TXT."""
    (best, matches, collin, cams, _cfg, S), _kw, _ = \
        port["seen"]["build_affinity_graph"]
    transform = port["seen"]["process_clusters"][0][3]
    path = reference_model(
        to_reference(best), [to_reference(vm) for vm in matches],
        to_reference(collin), to_reference(cams), to_reference(transform),
        port["segments"], os.path.join(tmp, f"{port['name']}_attr.txt"))
    rep = tw.compare_txt(port["txt"], path)
    assert rep["ok"] and rep["int_bad"] == 0, rep
    assert rep["worst_ratio"] == 0.0, rep
    return path


def check_models(port, ref, tmp):
    """The reference's model from its own matching against the port's."""
    collin = reference_collinearity(port)["xla"][1]
    path = reference_model(ref["best"], ref["matches"], collin, ref["cams"],
                           ref["transform"], port["segments"],
                           os.path.join(tmp, f"{port['name']}_ref.txt"))
    got = compare.compare_models(port["txt"], path)
    assert got == PINS[port["name"]]["model"], got
    assert tw.compare_txt(port["txt"], path)["int_bad"] == -1
    return path


# ----------------------------------------------------------------------
# tier-1: facade6

@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("host"))


@pytest.fixture(scope="module")
def port(tmp):
    return port_run("facade6", tmp)


@pytest.fixture(scope="module")
def ref_matching(port):
    return reference_matching(port)


def test_conditioning_equal(port):
    check_conditioning(port)


def test_collinearity_maps_after_fallback(port):
    assert port["l3d"].stats["views_recollin_exact"] == 1
    check_collinearity(port, reference_collinearity(port))


def test_affinity_graph_bit_equal(port):
    check_affinity(port)


@pytest.mark.parametrize("parallel", [False, True])
def test_fh_labels_equal(port, parallel):
    check_fh(port, parallel)


def test_plain_fit_txt_equal(port, tmp):
    rep = check_plain_fit(port, tmp)
    assert rep["ok"] and rep["worst_ratio"] == 0.0, rep
    assert rep["n_tokens"] > 10000


@pytest.mark.parametrize("view", range(6))
def test_matching_per_view(port, ref_matching, view):
    (n, n_port, _, _), picks, _ties = check_matching(port, ref_matching,
                                                     [view])[view]
    assert picks["n_a"] == picks["n_b"] > 300
    assert n > 10000 and abs(n - n_port) < 10


def test_matching_has_near_ties(port, ref_matching):
    """The scene exercises the near-tie rule: 353 picks differ, 344 of
    them ties of the reference's own confidences within 1e-5, the other 9
    float64 ties."""
    got = check_matching(port, ref_matching, range(6))
    near = sum(p["near_tie"] for _, p, _ in got.values())
    differ = sum(p["differ"] for _, p, _ in got.values())
    ties = sum(len(t) for _, _, t in got.values())
    assert (differ, near, ties) == (353, 344, 9)


def test_attribution_port_matching_through_reference(port, tmp):
    """264 lines either way: the port's matching outputs give the port's
    TXT through line3d_tpu's downstream stages."""
    check_attribution(port, tmp)


def test_models_differ_only_at_matching(port, ref_matching, tmp):
    """The reference's own model (its matching, then the same downstream):
    263 lines against the port's 264, 259 member sets shared."""
    check_models(port, ref_matching, tmp)


def test_load_txt_both_readers(port):
    paths = [os.path.join(HERE, "golden", f)
             for f in ("house10.txt", "house10_diffusion.txt")]
    for path in paths + [port["txt"]]:
        got, want = tw.load_txt(path), jw.load_txt(path)
        assert len(got) == len(want) > 10
        for (gs, gr), (ws, wr) in zip(got, want):
            assert gs.dtype == ws.dtype == np.float64
            np.testing.assert_array_equal(gs, ws)
            assert gr == wr


# ----------------------------------------------------------------------
# facade8, with line3d_tpu's whole Line3D

@pytest.mark.slow
def test_facade8_both_packages_stage_by_stage(tmp_path):
    """Every check above on the 8-view facade, and line3d_tpu's own Line3D
    (its sharded default path) writing the same model as its per-view
    engine plus downstream stages."""
    tmp = str(tmp_path)
    port = port_run("facade8", tmp)
    ref = reference_matching(port)
    check_conditioning(port)
    check_collinearity(port, reference_collinearity(port))
    check_affinity(port)
    check_fh(port, False)
    check_fh(port, True)
    rep = check_plain_fit(port, tmp)
    assert rep["ok"] and rep["worst_ratio"] == 0.0, rep
    got = check_matching(port, ref, range(8))
    assert [sum(p[k] for _, p, _ in got.values())
            for k in ("differ", "near_tie", "traced")] == [942, 935, 1]
    check_attribution(port, tmp)
    path = check_models(port, ref, tmp)

    scene, cams = make_facade_scene(**SCENES["facade8"])
    l3d = JLine3D()
    for v in range(scene.num_views):
        l3d.add_view_segments(
            v, scene.segments[v][scene.seg_mask[v]], cams.K[v], cams.R[v],
            cams.t[v], worldpoint_ids=scene.wp_lists[v],
            width=int(cams.width[v]), height=int(cams.height[v]))
    whole = os.path.join(tmp, "facade8_jax_line3d.txt")
    l3d.save_3d_lines_as_txt(l3d.compute_3d_model(), whole)
    rep = tw.compare_txt(whole, path)
    assert rep["ok"] and rep["worst_ratio"] == 0.0, rep
