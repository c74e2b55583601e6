"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a); without one they skip.
Run them on the card with
    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest
(`--noconftest`: tests/conftest.py configures JAX, which these tests do not
use).
Tolerances: K1 and K5 at most 4e-4 of the valid pairs may disagree with
the twin, and K1's plane equals K5's valid plane pair for pair; K5's
depths rtol 1e-3 / atol 1e-4 on the pairs valid in both; K4's pair lists
and counts identical to its plain twin's and its weights bit-equal;
scoring rtol 2e-3 / atol 2e-4, where fewer than 1e-4 of the scored slots may differ by a support whose
confidence sits at the threshold, at widths that fit a block's shared
memory and at M = 4096, which does not; K6 chain sums within
peak.CHAIN_RTOL of the twin's.  Device selection (parallel/sharded.py):
the card's buffer equal to the CPU's, and equal matches to the host
selection's, bit for bit.  Device diffusion: tests/test_cluster.py's
rtol 2e-4 / atol 1e-7 against the float64 host; device refine:
tests/test_refine.py's criteria against the host."""
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
from torch_port_helpers import HOUSE10_DIFFUSION_OUTSIDE, HOUSE10_OUTSIDE, \
    SELECTION_KINDS, selection_tables

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


def test_pair_valid_kernel_on_second_card(dev):
    """K1 on cuda:1 while the current device is cuda:0: the wrapper makes
    the tensors' card current for the launch (native.cuda.on_device), so
    the plane is the twin's and lies on cuda:1.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs (torch.cuda.device_count() < 2)")
    second = torch.device("cuda", 1)
    a = _house_view(second)
    with torch.cuda.device(0):
        got = k1.pair_valid(*a)
        torch.cuda.synchronize(second)
    assert got.device == second
    want = k1.pair_valid_plain(*a)
    n_valid = int(want.sum())
    assert n_valid > 20
    assert int((got != want).sum()) <= 4e-4 * n_valid


def _facade_view(dev, n=10):
    """Facade view 0 (S = 1280) against views 1..n, conditioned as the
    pipeline conditions them."""
    from line3d_tpu_torch.core.conditioning import compute_conditioning
    from line3d_tpu_torch.match import engine
    from line3d_tpu_torch.utils.demo import make_facade_scene
    cfg = L3DConfig()
    scene, cams = make_facade_scene(num_views=n + 1, config=cfg, device=dev)
    tr_ = compute_conditioning(cams.C)
    cams.transform(tr_.Qinv, tr_.scale)
    ctx = engine.ViewContext(scene, cams, cfg)
    segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, _ = ctx.neighbor_arrays(
        0, np.arange(1, n + 1))
    return (scene.segments_t[0], scene.seg_mask_t[0], segs_nb, mask_nb,
            F_nb, ctx.RtKinv32[0], RtKinv_nb, ctx.C32[0], C_nb)


@pytest.mark.parametrize("case", ["house", "facade"])
def test_pair_valid_equals_pair_dense_valid(dev, case):
    """K1 triangulates only the pairs that pass the cheap gates and takes a
    depth's sign from num * denom; K5 triangulates every pair and takes it
    from num * (1 / denom).  The two planes agree pair for pair."""
    a = _house_view(dev) if case == "house" else _facade_view(dev)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    got = k1.pair_valid_cuda(*a, stats=stats)
    _, want = k1.pair_dense_cuda(*a)
    differ = (got != want).nonzero().tolist()
    print(f"{case}: {int(want.sum())} valid pairs, cheap-gate survivors "
          f"{int(stats[0])}, warps holding any {int(stats[1])}, differing "
          f"pairs {differ[:20]}")
    assert not differ
    assert int(want.sum()) <= int(stats[0]) <= got.numel()
    assert int(stats[1]) * 32 >= int(stats[0])


def _check_collin_pairs(segments, masks, quota=8, sig2=4.0):
    """K4 against its plain twin on the card: identical keys and counts,
    bit-equal weights; returns the kernel's result."""
    n0 = k4.LAUNCHES
    got = col.collinearity_compact_all(segments, masks, np.float32(sig2),
                                       quota=quota)
    assert k4.LAUNCHES == n0 + 1
    want = col.collinearity_compact_all_plain(segments, masks,
                                              np.float32(sig2), quota=quota)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])
    differ = int((got[1] != want[1]).sum())
    assert differ == 0, (differ, float((got[1] - want[1]).abs().max()))
    return got


def _segments_with_runs(rng, V, S, n_chains, extent=(1920.0, 1440.0)):
    """V views of S random segments, the first n_chains * 8 of them in
    chains of 8 nearly collinear pieces; [V, S, 4] f32, [V, S] bool."""
    segs = np.empty((V, S, 4), np.float32)
    for v in range(V):
        segs[v] = rng.uniform(0, 1, (S, 4)) * np.tile(extent, 2)
        for c in range(n_chains):
            x0, y0 = rng.uniform(0, 1, 2) * extent
            th = rng.uniform(0, np.pi)
            d = np.array([np.cos(th), np.sin(th)])
            t = np.cumsum(rng.uniform(15, 40, 16))
            for k in range(8):
                a = np.array([x0, y0]) + t[2 * k] * d
                b = np.array([x0, y0]) + t[2 * k + 1] * d
                segs[v, c * 8 + k] = np.concatenate([a, b]) + \
                    rng.normal(0, 0.3, 4)
    return segs, np.ones((V, S), bool)


def test_collin_keep_kernel_matches_plain(dev):
    """K4 on one view of S = 384 with collinear runs and masked rows."""
    rng = np.random.default_rng(3)
    segs = torch.as_tensor(rng.uniform(0, 300, (384, 4)).astype(np.float32),
                           device=dev)
    segs[:40, 2:] = segs[:40, :2] + 30.0          # some collinear runs
    segs[40:80] = segs[:40] + torch.tensor([35.0, 35.0, 35.0, 35.0],
                                           device=dev)
    mask = torch.ones(384, dtype=torch.bool, device=dev)
    mask[-5:] = False
    pairs, _, count = _check_collin_pairs(segs[None].contiguous(),
                                          mask[None].contiguous())
    dense = col.collinearity_matrix(segs, mask, 4.0) > 0
    assert int(dense.sum()) > 20 and int(count[0]) >= int(dense.sum())
    assert int((pairs >= 0).sum()) > 20


@pytest.mark.parametrize("quota", [8, 1])
def test_collin_pairs_facade(dev, quota):
    """All 25 facade views; with quota 1 views drop pairs, and the exact
    fallback repairs them from the card's counts as from the twin's."""
    from line3d_tpu_torch.utils.demo import make_facade_scene
    scene, _ = make_facade_scene(num_views=25, device=dev)
    pairs, w, count = _check_collin_pairs(scene.segments_t,
                                          scene.seg_mask_t, quota=quota)
    maps = col.collinearity_finalize(pairs.cpu().numpy(), w.cpu().numpy(),
                                     count.cpu().numpy(), scene.max_segments)
    assert (maps.dropped_total > 0) == (quota == 1)
    if quota == 1:
        fixed, n = col.apply_collinearity_exact_fallback(
            maps, scene.segments_t, scene.seg_mask_t, 2.0)
        assert n > 0 and fixed.dropped_total == 0


def test_collin_pairs_cap_bites(dev):
    """The 512-segment chain of tests/test_torch_collinearity.py: 16,384
    survivors, the first 8,192 kept."""
    t = np.arange(512) * 6 + 10
    up = np.arange(512) % 2
    segs = np.stack([t, t + up, t + 4, t + 4 + up], 1)[None]
    segs = torch.as_tensor(segs.astype(np.float32), device=dev)
    pairs, _, count = _check_collin_pairs(
        segs, torch.ones((1, 512), dtype=torch.bool, device=dev))
    assert pairs.shape == (1, 8192) and bool((pairs >= 0).all())
    assert int(count[0]) == 512 * 511


@pytest.mark.parametrize("S,V,masked", [(100, 3, True), (2990, 2, False)])
def test_collin_pairs_ragged_sizes(dev, S, V, masked):
    """S = 100 (blocks of 4 partners) with a fully masked view, and the P25
    stress scene's S = 2,990 (blocks of 2; three tiles of partners)."""
    rng = np.random.default_rng(S)
    segs, mask = _segments_with_runs(rng, V, S, n_chains=min(S // 16, 40))
    if masked:
        mask[1] = False
        mask[0, ::7] = False
    pairs, w, count = _check_collin_pairs(torch.as_tensor(segs, device=dev),
                                          torch.as_tensor(mask, device=dev))
    assert int((pairs >= 0).sum()) > 0
    if masked:
        assert int(count[1]) == 0 and bool((pairs[1] == -1).all())
        assert bool((w[1] == 0).all())


def _score_inputs(dev, S, M, Nc, St, seed, need_rows=None, spatial_k=3.0,
                  bad_invalid_depths=False):
    """A random match table.  With a small spatial_k, d2 follows d1 within
    3% so that the spatial gate passes runs of the sorted d1 keys; with
    bad_invalid_depths the invalid slots hold NaN, +-inf, 0 and negative
    depths."""
    rng = np.random.default_rng(seed)
    cam = rng.integers(-1, Nc, (S, M)).astype(np.int32)
    valid = (rng.uniform(size=(S, M)) < 0.4) & (cam >= 0)
    if need_rows is not None:             # rows ending at chosen slots
        for s, nd in enumerate(need_rows):
            valid[s, nd:] = False
            cam[s, nd - 1] = max(cam[s, nd - 1], 0)
            valid[s, nd - 1] = True
    depths = rng.uniform(0.5, 3.0, (S, M, 4)).astype(np.float32)
    if spatial_k < 1.0:
        depths[..., 1] = depths[..., 0] * rng.uniform(0.97, 1.03, (S, M))
    if bad_invalid_depths:
        bad = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, -1.0],
                       np.float32)
        depths[~valid] = rng.choice(bad, (int((~valid).sum()), 4))
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (t(f32(rng.uniform(0, 300, (S, 4)))), t(f32(np.eye(3))),
            t(f32(rng.normal(size=3))), t(cam),
            t(rng.integers(0, St, (S, M)).astype(np.int32)),
            t(depths), t(valid),
            t(f32(rng.normal(size=(Nc, 3, 4)))),
            t(f32(rng.uniform(0, 300, (Nc, St, 4)))), 200.0, 90.0, spatial_k)


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


@pytest.mark.parametrize("spatial_k,bad", [(3.0, False), (0.05, True)])
def test_score_kernel_need_not_multiple_of_tile(dev, spatial_k, bad):
    """Every row's need is off the 256-thread grid, so each thread owns a
    different number of slots; with bad=True the invalid slots hold NaN,
    +-inf, 0 and negative depths, which must not enter the sorted keys."""
    needs = [1, 2, 127, 129, 200, 255, 257, 300, 383, 385, 511, 600]
    a = _score_inputs(dev, len(needs), 640, 6, 500, 7, need_rows=needs,
                      spatial_k=spatial_k, bad_invalid_depths=bad)
    got = k23.score(*a)
    need = sc.row_need(a[6])
    assert sorted(need.tolist()) == sorted(needs)
    _check_scores(got, k23.score_plain(*a))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("S,M,Nc,St,seed,k", [(16, 512, 8, 300, 11, 0.05),
                                               (8, 1024, 6, 400, 3, 0.1)])
def test_score_kernel_windowed_gate_matches_plain(dev, S, M, Nc, St, seed,
                                                  k):
    """A spatial_k small enough that each slot's window of sorted d1 keys
    is a short run of its row."""
    a = _score_inputs(dev, S, M, Nc, St, seed, spatial_k=k)
    _check_scores(k23.score(*a), k23.score_plain(*a))


def test_score_kernel_rows_beyond_shared_memory(dev):
    """M = 4096: a row's slots (60 bytes each) exceed a block's shared
    memory, so the kernel keeps them in the wrapper's global scratch."""
    from line3d_tpu_torch.native import cuda
    lib = cuda.lib()
    assert lib.l3d_score_scratch_bytes(1024, 10, 1280, 0) == 0
    assert lib.l3d_score_scratch_bytes(4096, 8, 6, 0) > 0
    a = _score_inputs(dev, 6, 4096, 8, 400, 13, spatial_k=0.05)
    assert int(sc.row_need(a[6]).max()) > 4000
    _check_scores(k23.score(*a), k23.score_plain(*a))


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
    segs = torch.zeros((2, 8, 4), device=dev)
    masks = torch.ones((2, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        k4.collin_pairs_cuda(segs.cpu(), masks.cpu(), 1.0, 4.0, 0.5, 8, 64)
    with pytest.raises(TypeError):
        k4.collin_pairs_cuda(segs.double(), masks, 1.0, 4.0, 0.5, 8, 64)
    with pytest.raises(ValueError, match="inconsistent"):
        k4.collin_pairs_cuda(segs[:1], masks, 1.0, 4.0, 0.5, 8, 64)
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


@pytest.mark.parametrize("kind", SELECTION_KINDS)
def test_device_select_on_the_card_equals_the_cpu(dev, kind):
    """parallel.sharded.device_select on the card against the same ops on
    the CPU, on the seeded tables of tests/test_torch_select.py: the same
    buffer, bit for bit."""
    from line3d_tpu_torch.parallel import sharded
    tabs = selection_tables(kind, 64)
    got = sharded.device_select(
        *(torch.as_tensor(x, device=dev) for x in tabs), 1.0, 5, 3)
    want = sharded.device_select(*map(torch.as_tensor, tabs), 1.0, 5, 3)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_device_selection_on_the_card_equals_host_selection(dev):
    """The 6-view house matched on the card with device and with host
    selection: the same verified identities, best matches and medians, bit
    for bit; an exact view synchronises with the host at most three
    times."""
    import dataclasses
    import warnings
    from line3d_tpu_torch.core.conditioning import compute_conditioning
    from line3d_tpu_torch.match import engine
    from line3d_tpu_torch.scene import find_visual_neighbors, \
        view_similarities_from_worldpoints
    syn = make_scene(num_views=6, device=dev)
    cams = syn.cameras
    sim, _ = view_similarities_from_worldpoints(syn.wp_lists, 6)
    nbrs = find_visual_neighbors(sim, cams.baselines(), 0.25, 10)
    tr_ = compute_conditioning(cams.C)
    cams.transform(tr_.Qinv, tr_.scale)
    cfg = L3DConfig()
    m_d, b_d, med_d = engine.run_matching(syn.scene, cams, nbrs, cfg)
    m_h, b_h, med_h = engine.run_matching(syn.scene, cams, nbrs, cfg,
                                          device_selection=False)
    for a, b in zip(m_d, m_h):
        for f in ("src_seg", "tgt_view", "tgt_seg"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.depths is None and b.depths is not None
    for f in dataclasses.fields(b_d):
        np.testing.assert_array_equal(getattr(b_d, f.name),
                                      getattr(b_h, f.name))
    np.testing.assert_array_equal(med_d, med_h)
    ctx = engine.ViewContext(syn.scene, cams, cfg)
    engine.match_views(ctx, nbrs, [0])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.match_views(ctx, nbrs, [0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert 1 <= len(syncs) <= 3, [str(w.message) for w in syncs]
