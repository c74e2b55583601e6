"""line3d_tpu_torch.fit.refine against line3d_tpu.fit.refine.

Inputs: the member data of the noisy 8-view house's ground-truth lines,
perturbed with numpy from a seed (tests/test_refine.py's recipe).

Tolerances:
  * host float64 against line3d_tpu's host float64 (a copy of the same
    numpy code): 1e-12 absolute;
  * device float32 (torch, here on CPU tensors) against line3d_tpu's device
    float32 and against the host: tests/test_refine.py:81-91's criteria —
    rms before rtol 1e-4 / atol 1e-4, median rms after within 10% + 1e-3,
    no cluster worse by 0.05 px, directions aligned to 0.9999, base points
    within 5e-3 of the other line."""
import numpy as np
import pytest

from line3d_tpu.fit import refine as jr
from line3d_tpu_torch.fit import refine as tr
from synthetic import make_scene


@pytest.fixture(scope="module")
def members():
    rng = np.random.default_rng(3)
    syn = make_scene(num_views=8, noise_px=0.3, seed=4)
    mviews, msegs, P0s, d0s = [], [], [], []
    for li, (A, B) in enumerate(syn.lines3d):
        mv, ms = [], []
        for v in range(8):
            for s in np.nonzero(syn.seg_line_id[v] == li)[0]:
                mv.append(v)
                ms.append(s)
        if len(mv) < 4:
            continue
        mviews.append(np.array(mv))
        msegs.append(np.array(ms))
        d_true = (B - A) / np.linalg.norm(B - A)
        P0s.append((A + B) / 2 + rng.normal(0, 0.03, 3))
        d0 = d_true + rng.normal(0, 0.03, 3)
        d0s.append(d0 / np.linalg.norm(d0))
    assert len(P0s) >= 8
    return (mviews, msegs, syn.scene.segments, syn.cameras.P,
            np.stack(P0s), np.stack(d0s))


def _criteria(got, want):
    """tests/test_refine.py:81-91 with `got` in the device role."""
    Pd, dd, rb_d, ra_d = got
    Ph, dh, rb_h, ra_h = want
    np.testing.assert_allclose(rb_d, rb_h, rtol=1e-4, atol=1e-4)
    assert np.median(ra_d) <= np.median(ra_h) * 1.1 + 1e-3
    assert (ra_d <= ra_h + 0.05).all(), (ra_d - ra_h).max()
    assert np.abs(np.sum(dd * dh, axis=1)).min() > 0.9999
    assert np.linalg.norm(np.cross(Pd - Ph, dh), axis=1).max() < 5e-3


def test_member_data_identical(members):
    mviews, msegs, segs, P = members[:4]
    for a, b in zip(tr.build_cluster_member_data(mviews, msegs, segs, P),
                    jr.build_cluster_member_data(mviews, msegs, segs, P)):
        np.testing.assert_array_equal(a, b)


def test_host_matches_reference_host(members):
    mviews, msegs, segs, P, P0, d0 = members
    data = jr.build_cluster_member_data(mviews, msegs, segs, P)
    got = tr.refine_lines(P0, d0, *data, iterations=8)
    want = jr.refine_lines(P0, d0, *data, iterations=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("against", ["reference_device", "host"])
def test_device_matches(members, against):
    mviews, msegs, segs, P, P0, d0 = members
    data = jr.build_cluster_member_data(mviews, msegs, segs, P)
    got = tr.refine_lines_device(P0, d0, *data, iterations=8,
                                 device="cpu")
    if against == "host":
        want = tr.refine_lines(P0, d0, *data, iterations=8)
    else:
        want = jr.refine_lines_device(P0, d0, *data, iterations=8)
    assert got[0].dtype == np.float64 and got[0].shape == P0.shape
    _criteria(got, want)


def test_device_recovers_perturbed_line():
    """tests/test_refine.py's convergence check, on the device form."""
    rng = np.random.default_rng(0)
    syn = make_scene(num_views=8)
    A, B = syn.lines3d[0]
    d_true = (B - A) / np.linalg.norm(B - A)
    mv = [v for v in range(8) for _ in np.nonzero(syn.seg_line_id[v] == 0)[0]]
    ms = [s for v in range(8) for s in np.nonzero(syn.seg_line_id[v] == 0)[0]]
    data = tr.build_cluster_member_data([np.array(mv)], [np.array(ms)],
                                        syn.scene.segments, syn.cameras.P)
    P0 = (A + B) / 2 + rng.normal(0, 0.05, 3)
    d0 = d_true + rng.normal(0, 0.05, 3)
    P0r, dr, rms_b, rms_a = tr.refine_lines_device(
        P0[None], (d0 / np.linalg.norm(d0))[None], *data, iterations=10,
        device="cpu")
    assert rms_a[0] < rms_b[0] and rms_a[0] < 0.1
    assert abs(float(dr[0] @ d_true)) > 0.99999
    assert np.linalg.norm(np.cross(P0r[0] - A, d_true)) < 1e-3
