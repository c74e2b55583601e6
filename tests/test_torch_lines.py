"""line3d_tpu_torch.fit.lines.process_clusters against line3d_tpu's, with
refine=True: the same noisy-house affinity graph, F-H labels, best matches,
conditioning transform and conditioned cameras (captured from
line3d_tpu's own pipeline) go through both packages' process_clusters,
once with line refinement (the port's float64 device form against
line3d_tpu's float64 host form) and once with the joint camera + line
bundle adjustment (BA).

Tolerances: every line's member views and segments equal; its 3D segments
within compare_txt's tolerance (rtol 1e-5 / atol 1e-6, the tolerance the
goldens are read with), except the pinned coordinates of OUTSIDE; the BA's
rms within 1e-3 and its conditioned poses within atol 5e-4
(tests/test_bundle.py:131-136)."""
import dataclasses

import numpy as np
import pytest

from line3d_tpu import Line3D as JLine3D, L3DConfig as JConfig
from line3d_tpu import pipeline as jp
from line3d_tpu_torch import L3DConfig, convert
from line3d_tpu_torch.core.conditioning import SceneTransform
from line3d_tpu_torch.fit import lines as tl
from line3d_tpu_torch.match.engine import BestMatches
from synthetic import make_scene

# test_refine.py's noisy house (0.7 px, seed 2); refinement on the device
# form, the BA with test_bundle.py's end-to-end iteration count
SCENE = dict(num_views=10, noise_px=0.7, seed=2)
MODES = dict(
    refine=dict(use_collinearity=True, refine_lines=True,
                refine_backend="device"),
    bundle=dict(use_collinearity=True, refine_backend="device",
                bundle_adjust_cameras=True, bundle_iterations=3))

# line3d_tpu's side of each mode: the port's device refinement computes in
# float64, which line3d_tpu does in its host refinement (its device form is
# float32, whose rounding parted line 0's direction by ~1e-5, 1.12 of the
# tolerance, from the port's former float32 form)
REFERENCE = dict(refine=dict(refine_backend="host"), bundle={})
# The coordinates outside compare_txt's tolerance, as (line, sub-segment,
# endpoint, axis), and the worst ratio of error to tolerance.
OUTSIDE = dict(refine=[], bundle=[])
WORST = dict(refine=1.0, bundle=1.0)


def _port(obj, cls):
    """A copy of the reference's dataclass `obj` as the port's `cls`."""
    return cls(**{f.name: np.array(getattr(obj, f.name))
                  if isinstance(getattr(obj, f.name), np.ndarray)
                  else getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def inputs():
    """process_clusters' inputs in line3d_tpu's pipeline on the scene."""
    seen = []
    orig = jp.fit_lines.process_clusters

    def spy(*a, **k):
        seen.append((a, k))
        return orig(*a, **k)
    syn = make_scene(**SCENE)
    l3d = JLine3D(config=JConfig(use_collinearity=True))
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v],
            width=int(syn.cameras.width[v]),
            height=int(syn.cameras.height[v]))
    jp.fit_lines.process_clusters = spy
    try:
        l3d.compute_3d_model()
    finally:
        jp.fit_lines.process_clusters = orig
    (a, k), = seen
    graph, labels, best, transform, _cfg, max_segments = a
    return dict(graph=graph, labels=np.array(labels), best=best,
                transform=transform, max_segments=max_segments,
                scene_segments=np.array(k["scene_segments"]),
                P_cond=np.array(k["P_cond"]), cameras=k["cameras"])


@pytest.mark.parametrize("mode", ["refine", "bundle"])
def test_process_clusters_refine_matches_reference(inputs, mode):
    x = inputs
    kw = MODES[mode]
    j_info, t_info = {}, {}
    want = jp.fit_lines.process_clusters(
        x["graph"], x["labels"], x["best"], x["transform"],
        JConfig(**{**kw, **REFERENCE[mode]}),
        x["max_segments"], refine=True, scene_segments=x["scene_segments"],
        P_cond=x["P_cond"], cameras=x["cameras"], out_info=j_info)
    got = tl.process_clusters(
        convert.affinity_graph_from_reference(x["graph"]), x["labels"],
        _port(x["best"], BestMatches), _port(x["transform"], SceneTransform),
        L3DConfig(**kw), x["max_segments"], refine=True,
        scene_segments=x["scene_segments"], P_cond=x["P_cond"],
        cameras=convert.cameras_from_reference(x["cameras"]), device="cpu",
        out_info=t_info)
    assert len(got) == len(want) > 10
    outside, worst = [], 0.0
    for li, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.views2d, w.views2d)
        np.testing.assert_array_equal(g.segs2d, w.segs2d)
        assert g.segments3d.shape == w.segments3d.shape
        ratio = np.abs(g.segments3d - w.segments3d) / (
            1e-5 * np.abs(w.segments3d) + 1e-6)
        outside += [(li,) + tuple(int(i) for i in idx)
                    for idx in zip(*np.nonzero(ratio > 1.0))]
        worst = max(worst, float(ratio.max()))
    assert outside == OUTSIDE[mode] and worst < WORST[mode], (outside,
                                                              worst)
    if mode == "bundle":
        assert abs(t_info["ba_rms_after"] - j_info["ba_rms_after"]) < 1e-3
        for k in ("R_cond", "t_cond"):
            np.testing.assert_allclose(t_info[k], j_info[k], rtol=0,
                                       atol=5e-4)
