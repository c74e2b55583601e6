"""line3d_tpu_torch.match.engine.run_matching against
line3d_tpu.match.engine.run_matching on the 6-view synthetic house.

Verified-match sets per view: identical.  Best matches: the same (view,
seg) keys; the same target, or one that JAX itself scores within 1e-5 of
its own pick (on this noise-free scene most segments have several targets
whose confidences tie to the last bits, and the first maximum then depends
on rounding).  Scores rtol 1e-5; median depths rtol 1e-6."""
import importlib
import inspect
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
def both_runs():
    syn = make_scene(num_views=6)
    cams = syn.cameras
    sim, _ = view_similarities_from_worldpoints(syn.wp_lists, 6)
    nbrs = find_visual_neighbors(sim, cams.baselines(), 0.25, 10)
    tr = compute_conditioning(cams.C)
    cams.transform(tr.Qinv, tr.scale)
    scene_t, cams_t = convert.scene_from_reference(syn.scene, cams, "cpu")
    ref = je.run_matching(syn.scene, cams, nbrs, JConfig())
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
        Line3D(L3DConfig(use_collinearity=True))


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
              "utils.demo.make_facade_scene", "utils.synthetic.make_scene",
              "convert.scene_from_reference"):
        assert with_device["line3d_tpu_torch." + k] == "cuda", k
    for k in ("cluster.diffusion.run_diffusion",
              "cluster.diffusion_device.diffuse_reference_device",
              "cluster.diffusion_device.diffuse_true_device",
              "fit.lines.process_clusters", "fit.refine.refine_lines_device",
              "fit.bundle.bundle_adjust", "utils.peak.chain_starts"):
        assert with_device["line3d_tpu_torch." + k] is \
            inspect.Parameter.empty, k
