"""The benchmark's frozen generators give the port's arrays."""
import numpy as np
import pytest

import helpers  # noqa: F401  (puts the checkout on sys.path)
from benchmark import scenes


def _demo(family, kw):
    from line3d_tpu_torch.utils import demo
    kw = dict(kw, device="cpu")
    if family == "facade":
        return demo.make_facade_scene(**kw)
    return demo.make_demo_scene(**kw)


@pytest.mark.parametrize("family,kw", [
    ("facade", dict(num_views=5, width=960, height=720, focal=900.0,
                    seed=0, n_cols=5, n_rows=4, distance=6.5)),
    ("facade", dict(num_views=7, seed=3, n_cols=6, n_rows=3)),
    ("facade", dict(num_views=25, seed=0)),
    ("clutter", dict(num_views=6, num_random_segments=30, seed=0)),
    ("clutter", dict(num_views=4, num_random_segments=7, seed=5,
                     width=800, height=600)),
])
def test_frozen_generators_match_the_port(family, kw):
    cap = scenes.make_capture(dict(kw, family=family))
    scene, cams = _demo(family, kw)
    assert cap.num_views == scene.num_views
    for v in range(cap.num_views):
        np.testing.assert_array_equal(
            cap.segments[v], scene.segments[v][scene.seg_mask[v]])
        assert list(cap.wp_lists[v]) == list(scene.wp_lists[v])
    for k in ("K", "R", "t", "width", "height"):
        np.testing.assert_array_equal(getattr(cap, k), getattr(cams, k))


def test_detectable_keeps_the_longest_above_the_least_length():
    segs = np.array([[0, 0, 5, 0], [0, 0, 30, 0], [0, 0, 0, 12],
                     [0, 0, 40, 0], [0, 0, 20, 0]], np.float32)
    # the least length is 0.1 of the diagonal (100 x 0): 10 px
    assert scenes.detectable(segs, 100, 0, 0.1).tolist() == [1, 2, 3, 4]
    assert scenes.detectable(segs, 100, 0, 0.1, 2).tolist() == [1, 3]
    assert scenes.detectable(segs, 100, 0).tolist() == [0, 1, 2, 3, 4]


def test_the_configured_capture_has_the_camera_and_cap_of_its_source():
    import json
    import os
    from helpers import ROOT
    for name in ("facade_p25", "clutter_p25"):
        cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                          f"{name}.json")))
        cap = scenes.make_capture(cfg["scene"])
        assert cap.num_views == 25
        np.testing.assert_array_equal(cap.K[0], [[2759.48, 0, 1520.69],
                                                 [0, 2764.16, 1006.81],
                                                 [0, 0, 1]])
        assert (cap.width == 3072).all() and (cap.height == 2048).all()
        assert [len(s) for s in cap.segments] == [3000] * 25
