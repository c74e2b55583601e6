"""line3d_tpu_torch.match.collinearity (and K4's plain twin) against
line3d_tpu.match.collinearity.

The keep plane must be a superset of `collinearity_matrix > 0` (tight:
margin extras only); the compacted pair lists and the finalized CollinMaps
must hold the same pairs and counts.  Weights: atol 1e-4.  The
point-to-line numerator a*x + b*y + c cancels terms of ~1e4 px^2 down to
~1 px^2, and XLA's CPU backend fuses it into multiply-adds while PyTorch
rounds each product, so the distance differs by ulps of the terms (~1e-3
px) and exp(-d^2 / 2 sigma^2) by up to ~1e-4."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from line3d_tpu.match import collinearity as jc
from line3d_tpu_torch.match import collinearity as tc, collinearity_cuda
from synthetic import make_scene
from torch_port_helpers import N, T


def _families(seed=11, S=128):
    """Collinear segment families plus clutter (tests/test_pallas.py:57)."""
    rng = np.random.default_rng(seed)
    segs = np.zeros((S, 4), np.float32)
    mask = np.zeros(S, bool)
    k = 0
    for _ in range(10):
        x0, y0 = rng.uniform(0, 200, 2)
        th = rng.uniform(0, np.pi)
        c, s_ = np.cos(th), np.sin(th)
        t = 0.0
        for _ in range(4):
            L = rng.uniform(15, 40)
            segs[k] = [x0 + t * c + rng.normal(0, 0.3),
                       y0 + t * s_ + rng.normal(0, 0.3),
                       x0 + (t + L) * c, y0 + (t + L) * s_]
            mask[k] = True
            k += 1
            t += L + rng.uniform(3, 10)
    for _ in range(40):
        segs[k] = rng.uniform(0, 300, 4)
        mask[k] = True
        k += 1
    return segs, mask


SIG2 = np.float32(4.0)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_keep_plane_is_tight_superset(seed):
    segs, mask = _families(seed)
    dense = N(jc.collinearity_matrix(jnp.asarray(segs), jnp.asarray(mask),
                                     SIG2)) > 0.0
    thr = collinearity_cuda.keep_threshold_sq(SIG2)
    keep = N(collinearity_cuda.collin_keep_plain(T(segs), T(mask), thr))
    assert dense.sum() > 20
    assert (dense & ~keep).sum() == 0
    assert (keep & ~dense).sum() <= max(2, int(0.001 * dense.sum()))


def test_collinearity_matrix_twin():
    segs, mask = _families()
    want = N(jc.collinearity_matrix(jnp.asarray(segs), jnp.asarray(mask),
                                    SIG2))
    got = N(tc.collinearity_matrix(T(segs), T(mask), float(SIG2)))
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _scene_inputs(kind):
    if kind == "house":
        sc = make_scene(num_views=6).scene
        return sc.segments.astype(np.float32), sc.seg_mask
    segs = np.stack([_families(s)[0] for s in (11, 12, 13)])
    mask = np.stack([_families(s)[1] for s in (11, 12, 13)])
    return segs, mask


def _assert_same_maps(got, want):
    np.testing.assert_array_equal(got.flat_view, want.flat_view)
    np.testing.assert_array_equal(got.flat_i, want.flat_i)
    np.testing.assert_array_equal(got.flat_j, want.flat_j)
    np.testing.assert_allclose(got.flat_w, want.flat_w, rtol=0, atol=1e-4)
    assert len(got) == len(want)
    for dg, dw in zip(got, want):
        assert dg.keys() == dw.keys()
        for i in dg:
            assert dg[i].keys() == dw[i].keys()


@pytest.mark.parametrize("kind", ["house", "families"])
def test_collin_maps_match_reference(kind):
    segs, mask = _scene_inputs(kind)
    want = jc.collinearity_maps_fast(segs, mask, 2.0)
    got = tc.collinearity_maps_fast(T(segs), T(mask), 2.0)
    # the house wireframe has no collinear pairs; the families do
    assert (len(want.flat_i) > 0) == (kind == "families")
    _assert_same_maps(got, want)
    np.testing.assert_array_equal(got.dropped_per_view,
                                  want.dropped_per_view)


def test_exact_rerun_equals_the_reference_fallback():
    """With a one-pair block quota the first pass drops pairs; the port
    runs those views again at exact capacity, to line3d_tpu's capped export
    followed by its dense fallback and to the port's own default-quota
    maps, and keeps line3d_tpu's first-pass counters."""
    segs, mask = _scene_inputs("families")
    want = jc.collinearity_maps_fast(segs, mask, 2.0, quota=1)
    dropped = np.array(want.dropped_per_view)
    want, nw = jc.apply_collinearity_exact_fallback(want, segs, mask, 2.0)
    got = tc.collinearity_maps_fast(T(segs), T(mask), 2.0, quota=1)
    assert got.dropped_total > 0
    np.testing.assert_array_equal(got.dropped_per_view, dropped)
    np.testing.assert_array_equal(got.views_exact, np.flatnonzero(dropped))
    assert len(got.views_exact) == nw > 0
    _assert_same_maps(got, want)
    _assert_same_maps(got, tc.collinearity_maps_fast(T(segs), T(mask), 2.0))


def test_collin_keep_dispatch_cpu_uses_plain_twin():
    """On CPU tensors the dispatcher runs the plain twin and launches
    nothing."""
    segs, mask = _scene_inputs("families")
    before = collinearity_cuda.LAUNCHES
    got = tc.collinearity_compact_all(T(segs), T(mask), SIG2)
    assert collinearity_cuda.LAUNCHES == before
    want = tc.collinearity_compact_all_plain(T(segs), T(mask), SIG2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int64
    assert got[0].shape == (3, 1024) and int((got[0] >= 0).sum()) > 0


def _chain(n=512):
    """One chain of n collinear, non-overlapping segments along the
    diagonal, every other one 1 px higher: every pair is collinear, so each
    row fills its quota in every 128-partner block and the survivors
    (n * 32) exceed the cap max(8192, 4 * n).  Integer endpoints below 2^12
    keep every product of the distance numerators exact, so XLA's fused
    multiply-adds and PyTorch's separate products agree on them."""
    t = np.arange(n) * 6 + 10
    up = np.arange(n) % 2
    segs = np.stack([t, t + up, t + 4, t + 4 + up], axis=1)
    return segs[None].astype(np.float32), np.ones((1, n), bool)


def _compact_case(case):
    if case == "S100_masked":
        # S = 100 (blocks of 4 partners) and one fully masked view
        segs, mask = _scene_inputs("families")
        segs, mask = segs[:, :100].copy(), mask[:, :100].copy()
        mask[1] = False
        return segs, mask
    if case == "chain":
        return _chain()
    return _scene_inputs(case)


@pytest.mark.parametrize("quota", [8, 1])
@pytest.mark.parametrize("case", ["house", "families", "S100_masked",
                                  "chain"])
def test_compact_all_twin_matches_reference(case, quota):
    """The plain twin's pair lists against line3d_tpu's
    collinearity_compact_all (XLA path): equal keys and counts, weights
    within atol 1e-4."""
    segs, mask = _compact_case(case)
    want = [N(x) for x in jc.collinearity_compact_all(
        jnp.asarray(segs), jnp.asarray(mask), SIG2, quota=quota)]
    before = collinearity_cuda.LAUNCHES
    got = [N(x) for x in tc.collinearity_compact_all(T(segs), T(mask), SIG2,
                                                     quota=quota)]
    assert collinearity_cuda.LAUNCHES == before
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    n_pairs = int((got[0] >= 0).sum())
    if case == "house":
        assert n_pairs == 0
    elif case == "S100_masked":
        assert got[2][1] == 0 and (got[0][1] == -1).all()
        assert (got[1][1] == 0).all() and n_pairs > 0
    elif case == "chain":
        C = got[0].shape[1]
        if quota == 8:
            assert C == 8192 and n_pairs == C      # the cap bites
        assert got[2][0] == 512 * 511
        # the first C survivors in (i, j) order
        assert (np.diff(got[0][0][got[0][0] >= 0]) > 0).all()
