"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a); without one they skip.
Run them on the card with
    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest
(`--noconftest`: tests/conftest.py configures JAX, which these tests do not
use).
Tolerances: K1 and K5 at most 4e-4 of the valid pairs may disagree, K5's
depths rtol 1e-3 / atol 1e-4 on the pairs valid in both; K4 a superset of
the dense plane with at most margin extras; scoring rtol 2e-3 / atol 2e-4,
where fewer than 1e-4 of the scored slots may differ by a support whose
confidence sits at the threshold; K6 chain sums within peak.CHAIN_RTOL of
the twin's.  Device diffusion: tests/test_cluster.py's rtol 2e-4 /
atol 1e-7 against the float64 host; device refine: tests/test_refine.py's
criteria against the host."""
import os

import numpy as np
import pytest
import torch

from line3d_tpu_torch import Line3D, L3DConfig
from line3d_tpu_torch.io.writers import compare_txt
from line3d_tpu_torch.cluster import diffusion as td, \
    diffusion_device as tdd
from line3d_tpu_torch.fit import refine as tr
from line3d_tpu_torch.match import collinearity as col, \
    collinearity_cuda as k4, pairwise_cuda as k1, scoring as sc, \
    scoring_cuda as k23
from line3d_tpu_torch.utils import peak as k6
from line3d_tpu_torch.utils.synthetic import make_scene
from torch_port_helpers import HOUSE10_DIFFUSION_OUTSIDE, HOUSE10_OUTSIDE

pytestmark = pytest.mark.cuda
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _house_view(dev, v=1):
    syn = make_scene(num_views=6)
    cams, scn = syn.cameras, syn.scene
    nb = np.array([(v + k) % 6 for k in (1, 2, 4, 5)])
    F = cams.fundamentals_for_pairs(np.stack([np.full(len(nb), v), nb], 1))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa
    return (t(scn.segments[v]), torch.as_tensor(scn.seg_mask[v], device=dev),
            t(scn.segments[nb]), torch.as_tensor(scn.seg_mask[nb],
                                                 device=dev),
            t(F), t(cams.RtKinv[v]), t(cams.RtKinv[nb]), t(cams.C[v]),
            t(cams.C[nb]))


def test_pair_valid_kernel_matches_plain(dev):
    a = _house_view(dev)
    n0 = k1.LAUNCHES
    got = k1.pair_valid(*a)
    assert k1.LAUNCHES == n0 + 1
    want = k1.pair_valid_plain(*a)
    n_valid = int(want.sum())
    assert n_valid > 20
    assert int((got != want).sum()) <= 4e-4 * n_valid


def test_collin_keep_kernel_matches_plain(dev):
    rng = np.random.default_rng(3)
    segs = torch.as_tensor(rng.uniform(0, 300, (384, 4)).astype(np.float32),
                           device=dev)
    segs[:40, 2:] = segs[:40, :2] + 30.0          # some collinear runs
    segs[40:80] = segs[:40] + torch.tensor([35.0, 35.0, 35.0, 35.0],
                                           device=dev)
    mask = torch.ones(384, dtype=torch.bool, device=dev)
    mask[-5:] = False
    thr = k4.keep_threshold_sq(4.0)
    got = k4.collin_keep(segs, mask, thr)
    want = k4.collin_keep_plain(segs, mask, thr)
    dense = col.collinearity_matrix(segs, mask, 4.0) > 0
    assert dense.sum() > 20
    assert not (dense & ~got).any()
    assert int((got != want).sum()) <= max(2, int(1e-3 * int(dense.sum())))


def _score_inputs(dev, S, M, Nc, St, seed, need_rows=None):
    rng = np.random.default_rng(seed)
    cam = rng.integers(-1, Nc, (S, M)).astype(np.int32)
    valid = (rng.uniform(size=(S, M)) < 0.4) & (cam >= 0)
    if need_rows is not None:             # rows ending at chosen slots
        for s, nd in enumerate(need_rows):
            valid[s, nd:] = False
            cam[s, nd - 1] = max(cam[s, nd - 1], 0)
            valid[s, nd - 1] = True
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (t(f32(rng.uniform(0, 300, (S, 4)))), t(f32(np.eye(3))),
            t(f32(rng.normal(size=3))), t(cam),
            t(rng.integers(0, St, (S, M)).astype(np.int32)),
            t(f32(rng.uniform(0.5, 3.0, (S, M, 4)))), t(valid),
            t(f32(rng.normal(size=(Nc, 3, 4)))),
            t(f32(rng.uniform(0, 300, (Nc, St, 4)))), 200.0, 90.0, 3.0)


def _check_scores(got, want):
    err = (got - want).abs()
    outside = int((err > 2e-4 + 2e-3 * want.abs()).sum())
    assert (want > 0).sum() > 50
    assert outside <= 1e-4 * int((want > 0).sum()), outside


@pytest.mark.parametrize("S,M,Nc,St,seed", [(64, 128, 4, 128, 5),
                                             (32, 512, 4, 600, 9),
                                             (16, 1024, 10, 700, 2)])
def test_score_kernel_matches_plain(dev, S, M, Nc, St, seed):
    a = _score_inputs(dev, S, M, Nc, St, seed)
    n0 = k23.LAUNCHES
    got = k23.score(*a)
    assert k23.LAUNCHES == n0 + 1
    _check_scores(got, k23.score_plain(*a))


def test_score_kernel_need_not_multiple_of_tile(dev):
    """Staged m2 tiles end mid-tile: every row's need is off the 128 grid,
    so the last tile of each row is partial (write-after-read check of the
    shared-memory staging)."""
    needs = [1, 2, 127, 129, 200, 255, 257, 300, 383, 385, 511, 600]
    a = _score_inputs(dev, len(needs), 640, 6, 500, 7, need_rows=needs)
    got = k23.score(*a)
    need = sc.row_need(a[6])
    assert sorted(need.tolist()) == sorted(needs)
    _check_scores(got, k23.score_plain(*a))


def test_wrappers_reject_bad_inputs(dev):
    a = list(_house_view(dev))
    with pytest.raises(ValueError):
        k1.pair_valid_cuda(*[x.cpu() for x in a])
    with pytest.raises(TypeError):
        k1.pair_valid_cuda(a[0].double(), *a[1:])
    with pytest.raises(ValueError):
        k1.pair_dense_cuda(*[x.cpu() for x in a])
    with pytest.raises(TypeError):
        k1.pair_dense_cuda(a[0].double(), *a[1:])
    with pytest.raises(ValueError, match="inconsistent"):
        k1.pair_dense_cuda(a[0], a[1], a[2][:2], *a[3:])
    s = _score_inputs(dev, 4, 128, 33, 64, 1)
    with pytest.raises(ValueError, match="compiled limit"):
        k23.score(*s)
    x = k6.chain_starts(64, device=dev)
    with pytest.raises(ValueError):
        k6.fma_chain_cuda(x[:, :3].contiguous(), 1)
    with pytest.raises(TypeError):
        k6.fma_chain_cuda(x.double(), 1)
    with pytest.raises(ValueError):
        k6.fma_chain_cuda(x.cpu(), 1)


def test_house10_on_the_card_matches_golden(dev, tmp_path):
    syn = make_scene(num_views=10)
    l3d = Line3D(config=L3DConfig(use_collinearity=True), device=dev)
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v], width=640, height=480)
    n0 = (k1.LAUNCHES, k4.LAUNCHES, k23.LAUNCHES)
    result = l3d.compute_3d_model()
    assert k1.LAUNCHES > n0[0] and k4.LAUNCHES > n0[1] and \
        k23.LAUNCHES > n0[2]
    out = str(tmp_path / "model.txt")
    l3d.save_3d_lines_as_txt(result, out)
    rep = compare_txt(out, os.path.join(HERE, "golden", "house10.txt"))
    assert rep["int_bad"] == 0, rep
    assert rep["outside"] == HOUSE10_OUTSIDE, rep
    assert rep["worst_ratio"] < 1.05, rep


def _check_dense(got, want):
    (dg, vg), (dw, vw) = got, want
    n_valid = int(vw.sum())
    assert n_valid > 20
    assert int((vg != vw).sum()) <= 4e-4 * n_valid
    both = vg & vw
    for k in range(4):
        torch.testing.assert_close(dg[k][both], dw[k][both], rtol=1e-3,
                                   atol=1e-4)


def _grow(x, n, dim):
    """x padded with zeros (False) to n along dim."""
    shape = list(x.shape)
    shape[dim] = n - shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


@pytest.mark.parametrize("S,St", [(384, 384), (200, 328)])
def test_pair_dense_kernel_matches_plain(dev, S, St):
    """K5 at tpu_validate's S=384 and at a ragged size (no multiple of the
    64 x 4 block), 4 neighbors of house view 1."""
    a = list(_house_view(dev))
    a[0], a[1] = _grow(a[0], S, 0), _grow(a[1], S, 0)
    a[2], a[3] = _grow(a[2], St, 1), _grow(a[3], St, 1)
    n0, v0 = k1.LAUNCHES_DENSE, k1.LAUNCHES
    got = k1.pair_dense(*a)
    assert k1.LAUNCHES_DENSE == n0 + 1 and k1.LAUNCHES == v0
    assert got[0].shape == (4, 4, S, St) and got[1].shape == (4, S, St)
    _check_dense(got, k1.pair_dense_plain(*a))


def test_fma_peak_kernel(dev):
    x = k6.chain_starts(4096, device=dev)
    n0 = k6.LAUNCHES
    got = k6.fma_chain(x, 8)
    assert k6.LAUNCHES == n0 + 1
    torch.testing.assert_close(got, k6.fma_chain_plain(x, 8),
                               rtol=k6.CHAIN_RTOL, atol=0)
    r = k6.measure_fp32_peak(dev)
    assert 0 < r["tflops"] < k6.H100_FP32_PEAK / 1e12


def test_house10_diffusion_on_the_card_matches_golden(dev, tmp_path):
    syn = make_scene(num_views=10, noise_px=0.8, seed=3)
    l3d = Line3D(config=L3DConfig(use_collinearity=True,
                                  diffusion_backend="host"), device=dev)
    for v in range(syn.scene.num_views):
        l3d.add_view_segments(
            v, syn.scene.segments[v][syn.scene.seg_mask[v]],
            syn.cameras.K[v], syn.cameras.R[v], syn.cameras.t[v],
            worldpoint_ids=syn.wp_lists[v], width=640, height=480)
    result = l3d.compute_3d_model(perform_diffusion=True)
    out = str(tmp_path / "model.txt")
    l3d.save_3d_lines_as_txt(result, out)
    rep = compare_txt(out, os.path.join(HERE, "golden",
                                        "house10_diffusion.txt"))
    assert rep["int_bad"] == 0, rep
    assert rep["outside"] == HOUSE10_DIFFUSION_OUTSIDE, rep


@pytest.mark.parametrize("mode", ["reference", "true"])
def test_device_diffusion_on_the_card_matches_host(dev, mode):
    rng = np.random.default_rng(5)
    n = 400
    a, b = rng.integers(0, n, 6000), rng.integers(0, n, 6000)
    pairs = np.unique(np.stack([a[a < b], b[a < b]], 1), axis=0)
    w = rng.uniform(0.05, 1.0, len(pairs))
    i = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int64)
    j = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int64)
    w = np.concatenate([w, w])
    host = (td.diffuse_reference if mode == "reference"
            else td.diffuse_true)(i, j, w, n)
    fn = tdd.diffuse_reference_device if mode == "reference" \
        else tdd.diffuse_true_device
    got = fn(i, j, w, n, device=dev)
    np.testing.assert_array_equal(got[0], host[0])
    np.testing.assert_array_equal(got[1], host[1])
    np.testing.assert_allclose(got[2], host[2], rtol=2e-4, atol=1e-7)
    np.testing.assert_array_equal(fn(i, j, w, n, device=dev)[2], got[2])


def test_device_refine_on_the_card_matches_host(dev):
    rng = np.random.default_rng(3)
    syn = make_scene(num_views=8, noise_px=0.3, seed=4)
    mviews, msegs, P0s, d0s = [], [], [], []
    for li, (A, B) in enumerate(syn.lines3d):
        hits = [(v, s) for v in range(8)
                for s in np.nonzero(syn.seg_line_id[v] == li)[0]]
        if len(hits) < 4:
            continue
        mviews.append(np.array([h[0] for h in hits]))
        msegs.append(np.array([h[1] for h in hits]))
        d_true = (B - A) / np.linalg.norm(B - A)
        P0s.append((A + B) / 2 + rng.normal(0, 0.03, 3))
        d0 = d_true + rng.normal(0, 0.03, 3)
        d0s.append(d0 / np.linalg.norm(d0))
    data = tr.build_cluster_member_data(mviews, msegs, syn.scene.segments,
                                        syn.cameras.P)
    P0, d0 = np.stack(P0s), np.stack(d0s)
    Pd, dd, rb_d, ra_d = tr.refine_lines_device(P0, d0, *data,
                                                iterations=8, device=dev)
    Ph, dh, rb_h, ra_h = tr.refine_lines(P0, d0, *data, iterations=8)
    np.testing.assert_allclose(rb_d, rb_h, rtol=1e-4, atol=1e-4)
    assert np.median(ra_d) <= np.median(ra_h) * 1.1 + 1e-3
    assert (ra_d <= ra_h + 0.05).all()
    assert np.abs(np.sum(dd * dh, axis=1)).min() > 0.9999
    assert np.linalg.norm(np.cross(Pd - Ph, dh), axis=1).max() < 5e-3
