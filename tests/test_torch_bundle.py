"""line3d_tpu_torch.fit.bundle against line3d_tpu.fit.bundle.bundle_adjust
on tests/test_bundle.py's fixture (a synthetic house whose poses are
perturbed with numpy from a seed after projecting).

Tolerances (tests/test_bundle.py:131-136, sharded against unsharded, the
same float32 solve summed in another order): lines and poses atol 5e-4;
rms after within 1e-3."""
import numpy as np
import pytest

from line3d_tpu.fit import bundle as jb
from line3d_tpu_torch.fit import bundle as tb
from test_bundle import _bundle_fixture


def _args(fx, clean=False):
    R, t = (fx["R_true"], fx["t_true"]) if clean else \
        (fx["R_pert"], fx["t_pert"])
    return (fx["P0"], fx["d"], fx["K"], R, t, fx["vidx"], fx["p1"],
            fx["p2"], fx["mask"])


@pytest.mark.parametrize("seed,iterations", [(3, 8), (5, 5)])
def test_bundle_matches_reference(seed, iterations):
    fx = _bundle_fixture(seed=seed)
    got = tb.bundle_adjust(*_args(fx), iterations=iterations,
                           device="cpu")
    want = jb.bundle_adjust(*_args(fx), iterations=iterations)
    for g, w in zip(got[:4], want[:4]):
        assert g.shape == w.shape and g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-4)
    assert abs(got[4] - want[4]) < 1e-3
    assert abs(got[5] - want[5]) < 1e-3
    assert got[5] < got[4]


def test_bundle_gauge_pinned_and_member_data_identical():
    fx = _bundle_fixture()
    for a, b in zip(tb.build_bundle_member_data(fx["mviews"], fx["msegs"],
                                                fx["scene"].segments),
                    (fx["vidx"], fx["p1"], fx["p2"], fx["mask"])):
        np.testing.assert_array_equal(a, b)
    _, _, Rf, tf, _, _ = tb.bundle_adjust(*_args(fx), iterations=4,
                                          device="cpu")
    np.testing.assert_allclose(Rf[0], fx["R_pert"][0], atol=1e-6)
    np.testing.assert_allclose(tf[0], fx["t_pert"][0], atol=1e-6)


def test_bundle_noop_on_clean_scene():
    fx = _bundle_fixture(rot_noise=0.0, t_noise=0.0)
    got = tb.bundle_adjust(*_args(fx, clean=True), iterations=4,
                           device="cpu")
    want = jb.bundle_adjust(*_args(fx, clean=True), iterations=4)
    assert got[5] <= got[4] + 1e-6 and got[5] < 0.35
    assert abs(got[5] - want[5]) < 1e-3
