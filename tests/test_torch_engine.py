"""line3d_tpu_torch.match.engine.run_matching against
line3d_tpu.match.engine.run_matching on the 6-view synthetic house.

Verified-match sets per view: identical.  Best matches: the same (view,
seg) keys; the same target, or one that JAX itself scores within 1e-5 of
its own pick (on this noise-free scene most segments have several targets
whose confidences tie to the last bits, and the first maximum then depends
on rounding).  Scores rtol 1e-5; median depths rtol 1e-6.  The port runs
with device selection, its default; its host selection on the same tables
gives the same matches, best matches and medians bit for bit, and both
packages' affinity graphs from the identity-only matches are equal.
`make_demo_scene` equals line3d_tpu's bit for bit; `Line3D` takes
line3d_tpu's positional arguments."""
import dataclasses
import importlib
import inspect
import os
import pkgutil

import numpy as np
import pytest
import torch

from line3d_tpu.config import L3DConfig as JConfig
from line3d_tpu.core.conditioning import compute_conditioning
from line3d_tpu.match import engine as je
from line3d_tpu.scene import view_similarities_from_worldpoints, \
    find_visual_neighbors
import line3d_tpu_torch
from line3d_tpu_torch import Line3D, L3DConfig, convert
from line3d_tpu_torch.match import engine as te
from synthetic import make_scene


@pytest.fixture(scope="module")
def inputs():
    """The 6-view house, conditioned, for both packages: (JAX scene,
    cameras, neighbors, the port's scene and cameras on the CPU)."""
    syn = make_scene(num_views=6)
    cams = syn.cameras
    sim, _ = view_similarities_from_worldpoints(syn.wp_lists, 6)
    nbrs = find_visual_neighbors(sim, cams.baselines(), 0.25, 10)
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    scene_t, cams_t = convert.scene_from_reference(syn.scene, cams, "cpu")
    return syn.scene, cams, nbrs, scene_t, cams_t


@pytest.fixture(scope="module")
def both_runs(inputs):
    """line3d_tpu's per-view engine, and the port's with device selection
    (its default)."""
    scene, cams, nbrs, scene_t, cams_t = inputs
    ref = je.run_matching(scene, cams, nbrs, JConfig())
    got = te.run_matching(scene_t, cams_t, nbrs, L3DConfig())
    return ref, got, cams, cams_t


def test_verified_match_sets_identical(both_runs):
    (m1, _, _), (m2, _, _), _, _ = both_runs
    assert [vm.view for vm in m1] == [vm.view for vm in m2]
    for a, b in zip(m1, m2):
        sa = set(zip(a.src_seg.tolist(), a.tgt_view.tolist(),
                     a.tgt_seg.tolist()))
        sb = set(zip(b.src_seg.tolist(), b.tgt_view.tolist(),
                     b.tgt_seg.tolist()))
        assert sa == sb and len(sa) > 0
        assert b.overflow == 0 and b.m_total >= b.need_capacity > 0


def test_best_matches_agree(both_runs):
    (m1, b1, _), (_, b2, _), _, _ = both_runs
    conf = {}
    for vm in m1:
        for s, tv, ts, c in zip(vm.src_seg, vm.tgt_view, vm.tgt_seg,
                                vm.confidence):
            conf[(vm.view, int(s), int(tv), int(ts))] = float(c)
    k1 = {(int(v), int(s)): (int(tv), int(ts), float(sc))
          for v, s, tv, ts, sc in zip(b1.view, b1.seg, b1.tgt_view,
                                      b1.tgt_seg, b1.score)}
    k2 = {(int(v), int(s)): (int(tv), int(ts), float(sc))
          for v, s, tv, ts, sc in zip(b2.view, b2.seg, b2.tgt_view,
                                      b2.tgt_seg, b2.score)}
    assert k1.keys() == k2.keys() and len(k1) > 20
    for k in k1:
        if k1[k][:2] != k2[k][:2]:
            c_ref = conf[k + k1[k][:2]]
            c_alt = conf[k + k2[k][:2]]
            assert abs(c_ref - c_alt) <= 1e-5 * c_ref, (k, c_ref, c_alt)
        np.testing.assert_allclose(k2[k][2], k1[k][2], rtol=1e-5)


def test_median_depths_agree(both_runs):
    (_, _, med1), (_, _, med2), cams, cams_t = both_runs
    np.testing.assert_allclose(med2, med1, rtol=1e-6)
    np.testing.assert_allclose(cams_t.median_depth, cams.median_depth,
                               rtol=1e-6)


def test_device_selection_equals_host_selection(both_runs, inputs):
    """The port's two selections on the same tables: equal verified
    identities in the same order, BestMatches and medians, bit for bit;
    the device selection's ViewMatches carry identities only."""
    _, (m_dev, b_dev, med_dev), _, _ = both_runs
    _, _, nbrs, scene_t, cams_t = inputs
    m_host, b_host, med_host = te.run_matching(
        scene_t, cams_t, nbrs, L3DConfig(), device_selection=False)
    assert len(m_dev) == len(m_host) == 6
    for a, b in zip(m_dev, m_host):
        assert a.view == b.view and a.overflow == b.overflow == 0
        for f in ("src_seg", "tgt_view", "tgt_seg"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.need_capacity, a.total_candidates, a.block_max, a.nb_max,
                a.m_total) == (b.need_capacity, b.total_candidates,
                               b.block_max, b.nb_max, b.m_total)
        assert a.depths is None and a.confidence is None
        assert len(b.depths) == len(b.confidence) == len(b.src_seg) > 0
    for f in dataclasses.fields(b_dev):
        np.testing.assert_array_equal(getattr(b_dev, f.name),
                                      getattr(b_host, f.name), f.name)
    np.testing.assert_array_equal(med_dev, med_host)


def test_affinity_graphs_agree_on_identity_only_matches(both_runs, inputs):
    """Both packages' affinity graphs (cluster/affinity.py) built from the
    port's device-selected, identity-only matches and its best matches:
    equal nodes and edges, and weights equal bit for bit."""
    from line3d_tpu.cluster import affinity as ja
    from line3d_tpu_torch.cluster import affinity as ta
    _, (m_dev, b_dev, _), cams, cams_t = both_runs
    S = inputs[3].max_segments
    jm = [je.ViewMatches(view=vm.view, src_seg=vm.src_seg,
                         tgt_view=vm.tgt_view, tgt_seg=vm.tgt_seg)
          for vm in m_dev]
    jb = je.BestMatches(**{f.name: getattr(b_dev, f.name)
                           for f in dataclasses.fields(b_dev)})
    got = ta.build_affinity_graph(b_dev, m_dev, None, cams_t, L3DConfig(), S)
    want = ja.build_affinity_graph(jb, jm, None, cams, JConfig(), S)
    assert got.num_nodes == want.num_nodes == len(b_dev.view)
    for f in ("edges_i", "edges_j", "edges_w", "node_view", "node_seg"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert len(got.edges_w) > 100


def test_make_demo_scene_is_bit_identical():
    """utils/demo.make_demo_scene against line3d_tpu's: segments, masks,
    cameras and worldpoints equal bit for bit."""
    from line3d_tpu.utils.demo import make_demo_scene as jdemo
    from line3d_tpu_torch.utils.demo import make_demo_scene, wireframe
    from line3d_tpu.utils.demo import wireframe as jwireframe
    np.testing.assert_array_equal(wireframe(), jwireframe())
    got_s, got_c = make_demo_scene(num_views=6, num_random_segments=50,
                                   device="cpu")
    want_s, want_c = jdemo(num_views=6, num_random_segments=50)
    np.testing.assert_array_equal(got_s.segments, want_s.segments)
    np.testing.assert_array_equal(got_s.seg_mask, want_s.seg_mask)
    np.testing.assert_array_equal(got_s.segments_t.numpy(), want_s.segments)
    assert got_s.seg_count.tolist() == want_s.seg_count.tolist()
    assert [list(w) for w in got_s.wp_lists] == \
        [list(w) for w in want_s.wp_lists]
    for name in ("K", "R", "t", "RtKinv", "C", "P", "k_lower", "k_upper"):
        np.testing.assert_array_equal(getattr(got_c, name),
                                      getattr(want_c, name), name)
    assert got_s.segments.shape[1] >= 50 and got_s.seg_mask.sum() > 6 * 50


def test_line3d_takes_line3d_tpu_positional_arguments(tmp_path):
    """Line3D(folder, cfg) means what it means in line3d_tpu: the folder
    is the data directory, then the config, verbose, use_sharded_engine;
    the device is a keyword."""
    from line3d_tpu.pipeline import Line3D as JLine3D
    folder = str(tmp_path / "L3D_data")
    cfg = L3DConfig(use_collinearity=False)
    l3d = Line3D(folder, cfg, True, False, device="cpu")
    assert l3d.data_directory == folder and os.path.isdir(folder)
    assert l3d.config is cfg and l3d.verbose is True
    assert l3d.use_sharded_engine is False
    assert Line3D(device="cpu").use_sharded_engine is True
    with pytest.raises(TypeError):
        Line3D(folder, cfg, False, True, "cpu")
    jnames = list(inspect.signature(JLine3D).parameters)
    names = list(inspect.signature(Line3D).parameters)
    assert names[:len(jnames)] == jnames and names[len(jnames):] == \
        ["device"]


def test_line3d_host_selection_writes_the_same_model():
    """Line3D(use_sharded_engine=False) selects on the host and writes the
    same model as the default device selection."""
    from synthetic import make_scene as jmake_scene
    syn = jmake_scene(num_views=6)
    out = []
    for on_device in (True, False):
        l3d = Line3D(None, L3DConfig(use_collinearity=True),
                     use_sharded_engine=on_device, device="cpu")
        for v in range(syn.scene.num_views):
            l3d.add_view_segments(
                v, syn.scene.segments[v][syn.scene.seg_mask[v]],
                syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
                worldpoint_ids=syn.wp_lists[v], width=640, height=480)
        res = l3d.compute_3d_model()
        assert all((vm.depths is None) == on_device for vm in l3d.matches)
        out.append([np.asarray(r.segments3d) for r in res])
    assert len(out[0]) == len(out[1]) > 3
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_scene_from_reference_is_bit_identical():
    syn = make_scene(num_views=6)
    scene_t, cams_t = convert.scene_from_reference(syn.scene, syn.cameras,
                                                   "cpu")
    np.testing.assert_array_equal(scene_t.segments, syn.scene.segments)
    np.testing.assert_array_equal(scene_t.seg_mask, syn.scene.seg_mask)
    np.testing.assert_array_equal(scene_t.segments_t.numpy(),
                                  syn.scene.segments)
    for name in ("K", "R", "t", "RtKinv", "C", "P", "k_lower", "k_upper",
                 "median_depth"):
        np.testing.assert_array_equal(getattr(cams_t, name),
                                      getattr(syn.cameras, name))


def test_scene_from_reference_carries_the_config():
    """Every shared field carries over; a field the port lacks carries over
    at its default only, so the reference's lossy
    `collinearity_exact_fallback=False` raises."""
    cfg = JConfig(min_baseline=0.3, collinearity_block_quota=4)
    scene = dataclasses.replace(make_scene(num_views=3).scene, config=cfg)
    got = convert.scene_from_reference(scene, make_scene(3).cameras,
                                       "cpu")[0].config
    want = dataclasses.asdict(cfg)
    del want["collinearity_exact_fallback"]
    assert dataclasses.asdict(got) == want
    with pytest.raises(ValueError, match="collinearity_exact_fallback"):
        convert.scene_from_reference(dataclasses.replace(scene, config=(
            dataclasses.replace(cfg, collinearity_exact_fallback=False))),
            make_scene(3).cameras, "cpu")

    @dataclasses.dataclass(frozen=True)
    class Extra(JConfig):
        unknown_field: int = 1
    assert convert._config_from_reference(Extra()) == L3DConfig()
    with pytest.raises(ValueError, match="unknown_field"):
        convert._config_from_reference(Extra(unknown_field=2))


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Line3D(device="cuda")


def test_line3d_defaults_to_the_card(monkeypatch):
    """No device means "cuda": without CUDA the constructor raises rather
    than run quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Line3D()
    with pytest.raises(RuntimeError, match="cuda"):
        Line3D(None, L3DConfig(use_collinearity=True))


def _port_signatures():
    """(qualified name, signature) of every function, class and method
    defined in line3d_tpu_torch."""
    for info in pkgutil.walk_packages(line3d_tpu_torch.__path__,
                                      "line3d_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                yield f"{mod.__name__}.{name}", inspect.signature(obj)
            elif inspect.isclass(obj):
                yield f"{mod.__name__}.{name}", inspect.signature(obj)
                for mname, m in vars(obj).items():
                    m = getattr(m, "__func__", m)
                    if inspect.isfunction(m):
                        yield (f"{mod.__name__}.{name}.{mname}",
                               inspect.signature(m))


def test_no_device_parameter_defaults_to_the_cpu():
    sigs = dict(_port_signatures())
    with_device = {k: s.parameters["device"].default for k, s in sigs.items()
                   if "device" in s.parameters}
    cpu = {k: d for k, d in with_device.items()
           if d is not inspect.Parameter.empty and str(d) == "cpu"}
    assert not cpu, cpu
    assert len(sigs) > 100 and len(with_device) > 10
    for k in ("pipeline.Line3D", "scene.Scene", "scene.Scene.from_ragged",
              "utils.demo.make_facade_scene", "utils.demo.make_demo_scene",
              "utils.synthetic.make_scene", "convert.scene_from_reference"):
        assert with_device["line3d_tpu_torch." + k] == "cuda", k
    for k in ("cluster.diffusion.run_diffusion",
              "cluster.diffusion_device.diffuse_reference_device",
              "cluster.diffusion_device.diffuse_true_device",
              "fit.lines.process_clusters", "fit.refine.refine_lines_device",
              "fit.bundle.bundle_adjust", "utils.peak.chain_starts"):
        assert with_device["line3d_tpu_torch." + k] is \
            inspect.Parameter.empty, k
