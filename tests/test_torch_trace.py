"""The port's recorder (line3d_tpu_torch/trace.py) on the 10-view synthetic
house, on the CPU: off it records nothing and the stats keep every key;
on, the spans nest as named under one model id each, children lie within
their parents, each stage time is its stage span, and every readback
counts one synchronisation and its bytes under its site.  The model is
the same bit for bit with the recorder on and off."""
import numpy as np
import pytest
import torch

from line3d_tpu_torch import Line3D, L3DConfig, trace
from line3d_tpu_torch.match import collinearity
from line3d_tpu_torch.utils.synthetic import make_scene

# the stats keys of a model before the recorder
STATS_KEYS = {
    "num_views", "num_best", "num_edges", "num_lines", "t_detect", "t_setup",
    "t_graph", "t_collin", "t_match", "t_cluster", "t_total", "t_affinity",
    "t_diffusion", "t_fh", "t_fit", "match_overflow",
    "views_rematched_uncapped", "probe_m_total", "probe_quota",
    "probe_k_export", "m_total", "collinearity_overflow",
    "views_recollin_exact", "num_processes", "views_local",
    "gathered_bytes", "gathered_by_stage"}
# the noisy path's parts and sizes (0 where they do not run)
NOISY_KEYS = {"t_diffusion_plan", "t_diffusion_iterate", "t_refine",
              "diffusion_edges", "diffusion_terms", "refine_clusters",
              "refine_members"}
# what the recorder adds to them, on or off
NEW_KEYS = {"t_affinity_pairs", "t_affinity_enum", "t_affinity_weights",
            "t_match_wait", "readback_syncs", "readback_bytes"} | NOISY_KEYS
# each stage span and the stats key it gives
STAGES = {"scene": "t_setup", "neighbors": "t_graph",
          "collinearity": "t_collin", "matching": "t_match",
          "affinity": "t_affinity", "diffusion": "t_diffusion", "fh": "t_fh",
          "fit": "t_fit", "model": "t_total",
          "affinity.pairs": "t_affinity_pairs",
          "affinity.enumerate": "t_affinity_enum",
          "affinity.weights": "t_affinity_weights"}
# the noisy path's stage spans: their parent and the stats key each gives
NOISY_STAGES = {"diffusion.plan": ("diffusion", "t_diffusion_plan"),
                "diffusion.iterate": ("diffusion", "t_diffusion_iterate"),
                "fit.refine": ("fit.lines", "t_refine")}
# a noisy capture's model with the device forms of both stages (float32
# torch on CPU tensors; "auto" takes the float64 host forms on the CPU)
NOISY = L3DConfig(use_collinearity=True, perform_diffusion=True,
                  refine_lines=True, diffusion_backend="device",
                  refine_backend="device")
# the parent of each span name a model opens
PARENT = {"scene": "model", "neighbors": "model", "collinearity": "model",
          "matching": "model", "affinity": "model", "diffusion": "model",
          "fh": "model", "fit": "model", "wait.collin.export": "collinearity",
          "match.k1": "matching", "wait.match.counters": "match.k1",
          "match.compact": "matching", "match.depths": "matching",
          "match.score": "matching", "match.select": "matching",
          "wait.match.count": "match.select",
          "wait.match.selection": "matching", "match.gather": "matching",
          "match.assemble": "matching", "affinity.pairs": "affinity",
          "affinity.enumerate": "affinity", "affinity.weights": "affinity",
          "fh.sort": "fh", "fh.union": "fh", "fit.lines": "fit"}


def _model(config=L3DConfig(use_collinearity=True), **kw):
    syn = make_scene(num_views=10, device="cpu")
    l3d = Line3D(config=config, device="cpu", **kw)
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v],
            width=int(syn.cameras.width[v]),
            height=int(syn.cameras.height[v]))
    l3d.compute_3d_model()
    return l3d


def _recorded(n=1, **kw):
    with trace.recording():
        models = [_model(**kw) for _ in range(n)]
        got = trace.collect()
    return models, got


@pytest.fixture(scope="module")
def off():
    trace.collect()
    l3d = _model()
    return l3d, trace.collect()


@pytest.fixture(scope="module")
def on():
    return _recorded(2)


def test_off_records_nothing_and_keeps_every_stats_key(off):
    l3d, got = off
    assert not trace.enabled()
    assert got == dict(spans=[], counters={})
    assert trace.span("a") is trace.span("b", torch.device("cpu"))
    trace.count("x", 3)
    assert trace.collect()["counters"] == {}
    assert set(l3d.stats) == STATS_KEYS | NEW_KEYS | {
        "affinity_candidates", "affinity_kept"}
    # on the CPU the host weighs the whole stream
    assert l3d.stats["affinity_kept"] == l3d.stats["affinity_candidates"] > 0
    # neither diffusion nor refinement ran
    assert {k: l3d.stats[k] for k in NOISY_KEYS} == dict.fromkeys(
        NOISY_KEYS, 0)
    # the readbacks count even off, and the stage times are there
    assert l3d.stats["readback_syncs"] > 0
    assert l3d.stats["readback_bytes"] > 0
    assert l3d.stats["t_affinity_enum"] > 0.0


def test_spans_nest_as_named_one_model_id_each(on):
    (a, b), got = on
    spans = got["spans"]
    by_id = {s["id"]: s for s in spans}
    models = sorted({s["model"] for s in spans})
    assert len(models) == 2
    for m in models:
        mine = [s for s in spans if s["model"] == m]
        roots = [s for s in mine if s["parent"] is None]
        assert [s["name"] for s in roots] == ["model"]
        names = {s["name"] for s in mine}
        assert names == set(PARENT) | {"model"}, names ^ set(PARENT)
        for s in mine:
            if s["parent"] is not None:
                p = by_id[s["parent"]]
                assert p["name"] == PARENT[s["name"]], s
                assert p["model"] == m
    nv = a.stats["num_views"]
    for name in ("match.k1", "match.compact", "match.depths", "match.score",
                 "match.select", "wait.match.selection"):
        assert sum(s["name"] == name for s in spans) == 2 * nv


def test_children_lie_within_their_parents(on):
    spans = on[1]["spans"]
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["end_s"] >= s["start_s"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_s"] <= s["start_s"] <= s["end_s"] <= p["end_s"]


def test_each_stage_time_is_its_stage_span(on):
    models, got = on
    for l3d, m in zip(models, sorted({s["model"] for s in got["spans"]})):
        mine = {s["name"]: s for s in got["spans"] if s["model"] == m}
        for name, key in STAGES.items():
            assert l3d.stats[key] == mine[name]["host_s"], name
        st = l3d.stats
        assert st["t_cluster"] == st["t_affinity"] + st["t_diffusion"] + \
            st["t_fh"] + st["t_fit"]
        waits = sum(s["host_s"] for s in got["spans"] if s["model"] == m and
                    s["name"].startswith("wait.match."))
        assert st["t_match_wait"] >= waits > 0.0
        # on the CPU no span has device time
        assert all(s["device_s"] is None for s in got["spans"])


def test_every_readback_counted_under_its_site(on):
    models, got = on
    c = got["counters"]
    l3d = models[0]
    V, S = l3d.scene.num_views, l3d.scene.max_segments
    cfg = l3d.config
    verified = sum(len(vm.src_seg) for vm in l3d.matches)
    C = collinearity.pairs_capacity(S, cfg.collinearity_block_quota,
                                    cfg.collinearity_pairs_per_seg)
    want = {"collin.export": (3, V * C * 8 + V * 8),
            "match.counters": (V, V * 4 * 8),
            "match.count": (V, V * 4),
            "match.selection": (V, 4 * (V * (6 * S + 4) + verified))}
    sites = {k[len("syncs."):] for k in c if k.startswith("syncs.")}
    assert sites == set(want)
    for site, (n, nbytes) in want.items():
        # two models, the same scene
        assert c[f"syncs.{site}"] == 2 * n, site
        assert c[f"dtoh_bytes.{site}"] == 2 * nbytes, site
    for st in (m.stats for m in models):
        assert st["readback_syncs"] == sum(n for n, _ in want.values())
        assert st["readback_bytes"] == sum(b for _, b in want.values())
    # the counters are the readbacks' and nothing else
    assert set(c) == {f"{k}.{site}" for k in ("syncs", "dtoh_bytes")
                      for site in want}


def test_the_exact_collinearity_rerun_reads_back_its_lists(monkeypatch):
    # one exported pair a view in the first pass: the views with more run
    # again at exact capacity, in the collinearity stage, and their lists
    # (pairs, weights, counts) are read back, as long as the largest of
    # their candidate counts
    monkeypatch.setattr(collinearity, "_pairs_cap", lambda S, K, p=4: 1)
    w0 = dict(trace.WAIT_NS)
    (l3d,), got = _recorded()
    waited = {k: v - w0.get(k, 0) for k, v in trace.WAIT_NS.items()}
    views = l3d.scene.collin.views_exact
    n = l3d.stats["views_recollin_exact"]
    assert n == len(views) > 0
    count = collinearity.collinearity_compact_all(
        l3d.scene.segments_t, l3d.scene.seg_mask_t, np.float32(4.0))[2]
    C = int(count[views].max())
    assert got["counters"]["syncs.collin.exact"] == 3
    assert got["counters"]["dtoh_bytes.collin.exact"] == n * C * 8 + n * 8
    by_name = {s["name"]: s for s in got["spans"]}
    exact = [s for s in got["spans"] if s["name"] == "wait.collin.exact"]
    assert len(exact) == 3
    assert {s["parent"] for s in exact} == {by_name["collinearity"]["id"]}
    assert "collin.fallback" not in by_name
    # the match step's wait leaves the re-run's out
    assert waited["collin.exact"] > 0
    assert l3d.stats["t_match_wait"] == sum(
        v for k, v in waited.items() if k.startswith("match.")) / 1e9


def test_a_model_builds_no_per_view_dict():
    """The pipeline reads the collinear pairs' flat arrays only: after a
    model no view's {i: {j: w}} dict exists; indexing a view builds it from
    the flat arrays, once."""
    l3d = _model()
    coll = l3d.scene.collin
    assert len(coll.flat_i) > 0
    assert coll._views == {}
    v = int(coll.flat_view[0])
    d = coll[v]
    assert coll._views == {v: d} and coll[v] is d
    sel = coll.flat_view == v
    assert {(i, j): w for i, js in d.items() for j, w in js.items()} == \
        dict(zip(zip(coll.flat_i[sel].tolist(), coll.flat_j[sel].tolist()),
                 coll.flat_w[sel].tolist()))


def test_the_host_selection_reads_back_the_tables():
    (l3d,), got = _recorded(use_sharded_engine=False)
    V = l3d.scene.num_views
    c = got["counters"]
    assert c["syncs.match.tables"] == 5 * V
    assert c["syncs.match.overflow"] == V
    assert "syncs.match.selection" not in c
    assert l3d.stats["readback_syncs"] == sum(
        v for k, v in c.items() if k.startswith("syncs."))


def test_the_model_is_the_same_on_and_off(off, on):
    a, b = off[0], on[0][0]
    assert len(a.result) == len(b.result) > 0
    for x, y in zip(a.result, b.result):
        np.testing.assert_array_equal(x.views2d, y.views2d)
        np.testing.assert_array_equal(x.segs2d, y.segs2d)
        np.testing.assert_array_equal(x.segments3d, y.segments3d)
    counts = STATS_KEYS - {k for k in STATS_KEYS if k.startswith("t_")}
    assert {k: a.stats[k] for k in counts} == {k: b.stats[k] for k in counts}
    for k in ("readback_syncs", "readback_bytes"):
        assert a.stats[k] == b.stats[k]


def test_readback_is_the_copy_it_replaces():
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    s0, b0 = trace.SYNCS, trace.DTOH_BYTES
    y = trace.readback(x, "unit")
    assert isinstance(y, np.ndarray) and y.dtype == np.int32
    np.testing.assert_array_equal(y, x.numpy())
    assert (trace.SYNCS - s0, trace.DTOH_BYTES - b0) == (1, 48)
    with trace.recording():
        trace.readback(x[0], "unit")
        got = trace.collect()
    assert got["counters"] == {"syncs.unit": 1, "dtoh_bytes.unit": 16}
    assert [s["name"] for s in got["spans"]] == ["wait.unit"]


def test_the_noisy_stages_are_stage_spans_of_their_stats():
    off = _model(NOISY)
    (l3d,), got = _recorded(config=NOISY)
    assert set(l3d.stats) == set(off.stats)
    spans = {s["name"]: s for s in got["spans"]}
    for name, (parent, key) in NOISY_STAGES.items():
        assert spans[name]["parent"] == spans[parent]["id"], name
        assert l3d.stats[key] == spans[name]["host_s"] > 0.0, name
        assert off.stats[key] > 0.0, name
    st, c = l3d.stats, got["counters"]
    assert st["t_diffusion"] >= st["t_diffusion_plan"] + \
        st["t_diffusion_iterate"]
    # the diffusion keeps the graph's pattern: it took every edge
    assert st["diffusion_edges"] == st["num_edges"] == c["diffusion.edges"]
    assert st["diffusion_terms"] == c["diffusion.terms"] > 0
    assert st["refine_clusters"] == c["refine.clusters"] >= st["num_lines"]
    assert st["refine_members"] == c["refine.members"] >= sum(
        len(ln.views2d) for ln in l3d.result) > 0
    # the sizes do not hang on the recorder
    for k in ("diffusion_edges", "diffusion_terms", "refine_clusters",
              "refine_members"):
        assert off.stats[k] == st[k], k


def test_the_host_forms_time_the_refinement_only():
    l3d = _model(L3DConfig(use_collinearity=True, perform_diffusion=True,
                           refine_lines=True))
    st = l3d.stats
    assert st["t_diffusion"] > 0.0 and st["t_refine"] > 0.0
    assert st["refine_clusters"] > 0
    for k in ("t_diffusion_plan", "t_diffusion_iterate", "diffusion_edges",
              "diffusion_terms"):
        assert st[k] == 0, k
