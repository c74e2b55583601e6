"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a); without one they skip.
Run them on the card with
    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest
(`--noconftest`: tests/conftest.py configures JAX, which these tests do not
use).
Tolerances: K1 and K5 at most 4e-4 of the valid pairs may disagree with
the twin, and K1's plane equals K5's valid plane pair for pair; K5's
depths rtol 1e-3 / atol 1e-4 on the pairs valid in both, and bit-equal
with and without far segments on the pairs they do not touch, and to
their IEEE evaluation (tests/torch_port_helpers.pair_dense_ieee) where
the fast reciprocals do not apply; K5's fast
reciprocals equal to the IEEE operations on every float of their range; K4's pair lists
and counts identical to its plain twin's and its weights bit-equal;
scoring rtol 2e-3 / atol 2e-4, where fewer than 1e-4 of the scored slots may differ by a support whose
confidence sits at the threshold, at widths that fit a block's shared
memory and at M = 4096, which does not; K6 chain sums within
peak.CHAIN_RTOL of the twin's.  Device selection (parallel/sharded.py):
the card's buffer equal to the CPU's, and equal matches to the host
selection's, bit for bit.  Device diffusion: tests/test_cluster.py's
rtol 2e-4 / atol 1e-7 against the float64 host; its plan, built on the
card, equal to numpy lexsorts array for array at over a million edges,
its class splits reading back under 4 KB; device refine:
tests/test_refine.py's criteria against the host.  The recorder
(trace.py): on one exact model of the 25-view facade and clutter scenes,
its synchronisations and device-to-host bytes equal to the sync debug
mode's count and the profiler's copies, exactly.  The affinity stage's
exact-order enumeration (csrc/affinity_enum.cu): its candidate stream
equal to the native walk's element for element, on hand-built and random
small inputs and on one model of the 25-view facade and clutter scenes,
whose whole graph equals the CPU call's; its weight filter
(csrc/affinity_filter.cu) on the same streams: the candidates it keeps
equal to those its numpy twin keeps, in order, and a superset of those
the host's native sweep passes."""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from line3d_tpu_torch import Line3D, L3DConfig, trace
from line3d_tpu_torch.io.writers import compare_txt
from line3d_tpu_torch.cluster import diffusion as td, \
    diffusion_device as tdd
from line3d_tpu_torch.fit import refine as tr
from line3d_tpu_torch.match import collinearity as col, \
    collinearity_cuda as k4, pairwise_cuda as k1, scoring as sc, \
    scoring_cuda as k23
from line3d_tpu_torch.utils import peak as k6
from line3d_tpu_torch.utils.synthetic import make_scene
from torch_port_helpers import AFFINITY_ORDER_CASES, \
    HOUSE10_DIFFUSION_OUTSIDE, HOUSE10_OUTSIDE, SELECTION_KINDS, \
    affinity_enum_inputs, affinity_random_case, \
    assert_classes_equal_twin, assert_plan_equals_twin, assert_same_stream, \
    best_rows, diffusion_plan_twin, native_weights, pair_dense_ieee, \
    selection_tables, small_facade_affinity, stereo_views

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


def _check_collin_pairs(segments, masks, quota=8, sig2=4.0, capacity=None):
    """K4 against its plain twin on the card: identical keys and counts,
    bit-equal weights; returns the kernel's result."""
    n0 = k4.LAUNCHES
    got = col.collinearity_compact_all(segments, masks, np.float32(sig2),
                                       quota=quota, capacity=capacity)
    assert k4.LAUNCHES == n0 + 1
    want = col.collinearity_compact_all_plain(segments, masks,
                                              np.float32(sig2), quota=quota,
                                              capacity=capacity)
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
    """All 25 facade views; with quota 1 views drop pairs, and
    `collinearity_maps_fast` runs them again through K4 with no quota at a
    capacity of their largest count: the kernel's lists equal the twin's
    there, and the maps equal those of the default quota bit for bit."""
    from line3d_tpu_torch.utils.demo import make_facade_scene
    scene, _ = make_facade_scene(num_views=25, device=dev)
    pairs, w, count = _check_collin_pairs(scene.segments_t,
                                          scene.seg_mask_t, quota=quota)
    maps = col.collinearity_finalize(pairs.cpu().numpy(), w.cpu().numpy(),
                                     count.cpu().numpy(), scene.max_segments)
    assert (maps.dropped_total > 0) == (quota == 1)
    if quota == 1:
        views = np.flatnonzero(maps.dropped_per_view)
        idx = torch.as_tensor(views, device=dev)
        blk = k4.block_quota(scene.max_segments, quota)[0]
        _check_collin_pairs(scene.segments_t[idx], scene.seg_mask_t[idx],
                            quota=blk, capacity=int(count[idx].max()))
        exact = col.collinearity_maps_fast(scene.segments_t,
                                           scene.seg_mask_t, 2.0, quota=1)
        main = col.collinearity_maps_fast(scene.segments_t,
                                          scene.seg_mask_t, 2.0)
        np.testing.assert_array_equal(exact.views_exact, views)
        for f in ("flat_view", "flat_i", "flat_j", "flat_w"):
            np.testing.assert_array_equal(getattr(exact, f),
                                          getattr(main, f))


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
    128-target x 32-source block), 4 neighbors of house view 1."""
    a = list(_house_view(dev))
    a[0], a[1] = _grow(a[0], S, 0), _grow(a[1], S, 0)
    a[2], a[3] = _grow(a[2], St, 1), _grow(a[3], St, 1)
    n0, v0 = k1.LAUNCHES_DENSE, k1.LAUNCHES
    got = k1.pair_dense(*a)
    assert k1.LAUNCHES_DENSE == n0 + 1 and k1.LAUNCHES == v0
    assert got[0].shape == (4, 4, S, St) and got[1].shape == (4, S, St)
    _check_dense(got, k1.pair_dense_plain(*a))


@pytest.mark.parametrize("n_nb,Ss,St", [(1, 90, 150), (3, 90, 150),
                                        (3, 70, 257)])
def test_pair_dense_edge_cases(dev, n_nb, Ss, St):
    """K5 against its twin and K1's plane where the tile's edges and the
    degenerate inputs lie: St no multiple of the 128-target block, Ss no
    multiple of its 32 sources and Ss != St, N = 1 and 3, a masked source
    row, zero-length segments on both sides, and pairs whose epipolar
    transfer fails (|iz| <= eps)."""
    a, flat_s, flat_t = stereo_views(n_nb, Ss, St, dev=dev)
    n0, v0 = k1.LAUNCHES_DENSE, k1.LAUNCHES
    got = k1.pair_dense(*a)
    assert k1.LAUNCHES_DENSE == n0 + 1 and k1.LAUNCHES == v0
    depths, valid = got
    assert depths.shape == (4, n_nb, Ss, St) and valid.shape == (n_nb, Ss, St)
    assert bool(torch.isfinite(depths).all())
    want = k1.pair_dense_plain(*a)
    _check_dense(got, want)
    assert torch.equal(k1.pair_valid_cuda(*a), valid)
    assert not valid[:, 2].any() and not valid[:, 0].any()
    assert not valid[:, :, 1].any()
    flat = flat_s[None, :, None] & flat_t[:, None, :]
    flat[:, 0] = False
    flat[:, :, 1] = False
    assert int(flat[:, :60, :60].sum()) > 8 * n_nb
    assert not valid[flat].any() and not want[1][flat].any()


def _equal_to_ieee(got, a):
    """K5's outputs `got` bit for bit against `pair_dense_ieee`, its
    arithmetic in float32 on the CPU with the IEEE operations (NaNs by
    position); returns the mirror's (depths, valid, slow)."""
    depths, valid, slow = pair_dense_ieee(*[x.cpu() for x in a])
    dg, vg = got[0].cpu(), got[1].cpu()
    assert torch.equal(vg, valid)
    nan = torch.isnan(depths)
    assert torch.equal(torch.isnan(dg), nan)
    assert torch.equal(dg[~nan].view(torch.int32),
                       depths[~nan].view(torch.int32))
    return depths, valid, slow


def test_pair_dense_outside_fast_domain(dev):
    """Pairs whose reciprocals or roots meet operands beyond FastRnOps'
    range (2^126 and more, or NaN) are evaluated again with the IEEE
    operations.  Far segments (their values overflow): the gates agree
    with the twin and with K1, every depth of a pair near the origin is
    the one K5 gives without them, and every depth and valid bit equals
    the IEEE evaluation's.  A fundamental matrix scaled by a power of two
    (the same epipolar lines): every output equals the IEEE evaluation's,
    also on pair (14, 64) of its neighbor, whose transfer's reciprocal is
    a subnormal that the fast path flushes to zero, so that without the
    IEEE evaluation its first depth would come from the transfer point
    (0, 0) in place of (2, 1/4)."""
    a, _, _ = stereo_views(3, far=True, dev=dev)
    depths, valid = k1.pair_dense(*a)
    want = k1.pair_dense_plain(*a)
    _check_dense((depths, valid), want)
    assert torch.equal(k1.pair_valid_cuda(*a), valid)
    assert not valid[:, 10:14].any() and not valid[:, :, 60:64].any()
    _, _, slow = _equal_to_ieee((depths, valid), a)
    assert int(slow.sum()) > 100
    near, _, _ = stereo_views(3, dev=dev)
    d0, v0 = k1.pair_dense(*near)
    keep = torch.ones(valid.shape[1:], dtype=torch.bool, device=dev)
    keep[10:14] = False
    keep[:, 60:64] = False
    assert torch.equal(valid[:, keep], v0[:, keep])
    assert torch.equal(depths[:, :, keep].view(torch.int32),
                       d0[:, :, keep].view(torch.int32))

    a, _, _ = stereo_views(3, big_f=True, dev=dev)
    got = k1.pair_dense(*a)
    assert torch.equal(k1.pair_valid_cuda(*a), got[1])
    d, _, slow = _equal_to_ieee(got, a)
    assert bool(slow[-1, 14, 64]) and 0.0 < float(d[0, -1, 14, 64]) < 1e3


def test_rn_ops_equal_ieee_on_every_float(dev):
    """FastRnOps (csrc/pair_math.cuh) against the IEEE round-to-nearest
    reciprocal and 1 / sqrt on every float of its ranges
    (2^-126 <= |x| < 2^126; 2^-100 <= x < 2^126): bit-equal, and never
    marked slow there."""
    from line3d_tpu_torch.native import cuda
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    with cuda.on_device(counts):
        cuda.check(cuda.lib().l3d_rn_ops_check(counts.data_ptr(),
                                               cuda.stream_of(counts)),
                   "l3d_rn_ops_check")
    n_rcp, bad_rcp, n_isq, bad_isq = counts.tolist()
    assert n_rcp == 2 * 252 * 2 ** 23 and bad_rcp == 0
    assert n_isq == 226 * 2 ** 23 and bad_isq == 0


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


def test_device_diffusion_plan_on_the_card_equals_lexsorts(dev,
                                                         monkeypatch):
    """One reference-mode diffusion of a random symmetric graph of ~1.2 M
    entries, shuffled: the plan built on the card equals the numpy
    lexsort twin array for array, both length-class splits equal the
    flatnonzero twin's, the returned edge order is the twin's, and the
    recorder counts under 4 KB at `diffusion.classes`."""
    rng = np.random.default_rng(19)
    n = 60_000
    a, b = rng.integers(0, n, 1_300_000), rng.integers(0, n, 1_300_000)
    pairs = np.unique(np.stack([a[a < b], b[a < b]], 1), axis=0)
    wu = rng.uniform(0.05, 1.0, len(pairs))
    perm = rng.permutation(2 * len(pairs))
    i = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int64)[perm]
    j = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int64)[perm]
    w = np.concatenate([wu, wu])[perm]
    assert len(w) >= 1_000_000
    plans, sums = [], []
    build, init = tdd.build_plan, tdd._PairSums.__init__

    def spy_build(*a, **k):
        plans.append(build(*a, **k))
        return plans[-1]

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        sums.append(self)
    monkeypatch.setattr(tdd, "build_plan", spy_build)
    monkeypatch.setattr(tdd._PairSums, "__init__", spy_init)
    with trace.recording():
        got = tdd.diffuse_reference_device(i, j, w, n, device=dev)
        torch.cuda.synchronize()
        counters = trace.collect()["counters"]
    twin = diffusion_plan_twin(i, j, w, n)
    (p,) = plans
    assert p.ri.device.type == "cuda"
    assert_plan_equals_twin(p, twin)
    deg = twin["deg"]
    assert len(sums) == 2
    assert_classes_equal_twin(sums[0], deg)
    assert_classes_equal_twin(sums[1], np.minimum(deg[twin["rj"]],
                                                  deg[twin["ri"]]))
    np.testing.assert_array_equal(got[0], twin["ri"])
    np.testing.assert_array_equal(got[1], twin["rj"])
    assert counters["syncs.diffusion.classes"] == 2
    assert counters["dtoh_bytes.diffusion.classes"] < 4096


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


@pytest.mark.parametrize("scene", ["facade", "clutter"])
def test_the_recorder_counts_every_sync_and_copy(dev, scene):
    """One exact model of the 25-view facade or clutter scene
    (`utils/trace_check.py`, in a process of its own: a process's first
    profiler trace keeps every device event): the recorder's
    synchronisations (`trace.readback`) equal those PyTorch's sync debug
    mode sees, and its device-to-host bytes the profiler's device-to-host
    copy bytes, so a synchronisation or copy outside `trace.readback`
    fails here."""
    proc = subprocess.run(
        [sys.executable, "-m", "line3d_tpu_torch.utils.trace_check", scene],
        cwd=os.path.dirname(HERE), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["syncs_recorder"] == got["syncs_debug"] > 0, got
    assert got["dtoh_bytes_recorder"] == got["dtoh_bytes_profiler"] > 0, got


@functools.lru_cache(maxsize=1)
def _small_facade():
    return small_facade_affinity()


@pytest.fixture
def small_facade(dev):
    """(best, cams, config, stream) of a small facade's model on the CPU
    (torch_port_helpers.small_facade_affinity), made once."""
    return _small_facade()


def _hold_filter(kept, want, best, cams, cfg):
    """The card filter's kept candidates `kept` of the walk's stream `want`
    against its numpy twin's, array for array in the stream's order, and a
    superset of the native sweep's passes.  Returns (candidates, kept,
    passed)."""
    from line3d_tpu_torch.cluster import affinity_cuda as ka
    keep = ka.filter_plain(*want, best, cams, cfg)
    assert_same_stream(kept, tuple(x[keep] for x in want))
    passed = native_weights(best, want, cams, cfg) >= 0.0
    assert keep[passed].all()
    return len(keep), int(keep.sum()), int(passed.sum())


def _enum_and_filter(inputs, dev, best, cams, cfg):
    """The card's stream of `inputs` against the walk's, then its filter
    on rows `best` against the twin and the sweep (_hold_filter)."""
    from line3d_tpu_torch.cluster import affinity, affinity_cuda as ka
    stream = affinity.enumerate_candidates(*inputs, device=dev)
    want = affinity.enumerate_candidates(*inputs, device="cpu")
    assert_same_stream(ka.read_stream(stream), want)
    return _hold_filter(ka.kept_candidates(stream, best, cams, cfg), want,
                        best, cams, cfg)


@pytest.mark.parametrize("name", sorted(AFFINITY_ORDER_CASES))
def test_affinity_enum_kernel_on_hand_built_cases(dev, small_facade, name):
    """The card's candidate stream against the native walk's on
    tests/torch_port_helpers.AFFINITY_ORDER_CASES, and its filter on rows
    of a small facade's best matches."""
    best, cams, cfg, _ = small_facade
    keys, pairs, coll, _, _ = AFFINITY_ORDER_CASES[name]
    inputs = affinity_enum_inputs(keys, pairs, coll, 3, 8)
    _enum_and_filter(inputs, dev, best_rows(best, len(keys), 0), cams, cfg)


def test_affinity_enum_kernel_on_random_graphs(dev, small_facade):
    """The card's candidate stream against the native walk's on 200 random
    small inputs (tests/test_torch_affinity_order.py's), half of them with
    pairs inside a view, self pairs and repeated partners, and its filter
    on rows of a small facade's best matches, which both pass and fail."""
    best, cams, cfg, _ = small_facade
    seen = np.zeros(3, np.int64)
    for seed in range(200):
        inputs = affinity_random_case(seed, general=seed % 2 == 1)
        seen += _enum_and_filter(inputs, dev,
                                 best_rows(best, len(inputs[0]), seed),
                                 cams, cfg)
    n, kept, passed = seen
    assert 0 < passed <= kept < n, seen


def test_affinity_filter_kernel_on_a_small_facade(dev, small_facade):
    """The filter on a small facade's own stream (6,414 candidates of all
    three kinds) uploaded to the card."""
    from line3d_tpu_torch.cluster import affinity_cuda as ka
    from line3d_tpu_torch.scene import upload
    best, cams, cfg, want = small_facade
    n = len(want[0])
    buf = np.concatenate([np.asarray(x).view(np.uint8) for x in
                          (want[0], want[1], want[3], want[2])])
    stream = ka.CardStream(upload(buf, dev), n)
    assert_same_stream(ka.read_stream(stream), want)
    n, kept, passed = _hold_filter(
        ka.kept_candidates(stream, best, cams, cfg), want, best, cams, cfg)
    assert 0 < passed <= kept < n


@pytest.mark.parametrize("scene", ["facade", "clutter"])
def test_affinity_enum_kernel_on_25_view_scenes(dev, scene):
    """One model of `scale_exact_profile`'s 25-view scene (the 1920 x 1440
    facade, or the clutter scene at S = 3,072) on the card: its
    enumeration and filter ran on the card (four kernel launches and two,
    `stats["affinity_candidates"]` the stream's length), and its stream,
    read back here, equals the native walk's on the same inputs; the host
    read back only the kept candidates (one readback at `affinity.kept`,
    25 bytes a kept candidate, `stats["affinity_kept"]` of them), which
    are the twin's and include every candidate the native sweep passes;
    the model's graph equals `build_affinity_graph` on the CPU, field for
    field."""
    from line3d_tpu_torch import trace
    from line3d_tpu_torch.cluster import affinity, affinity_cuda as ka
    from line3d_tpu_torch.utils import scale_exact_profile as sep
    cfg = sep.make_config()
    sc, cams = sep.make_scene(25, scene, cfg, dev)
    seen = {"graph": [], "enum": [], "kept": []}
    origs = {(mod, name): getattr(mod, name) for mod, name in (
        (affinity, "build_affinity_graph"),
        (affinity, "enumerate_candidates"), (ka, "kept_candidates"))}

    def spy(mod, name, key):
        def fn(*a, **k):
            out = origs[mod, name](*a, **k)
            seen[key].append((a, k, out))
            return out
        return fn
    affinity.build_affinity_graph = spy(affinity, "build_affinity_graph",
                                        "graph")
    affinity.enumerate_candidates = spy(affinity, "enumerate_candidates",
                                        "enum")
    ka.kept_candidates = spy(ka, "kept_candidates", "kept")
    try:
        with trace.recording():
            _, l3d, launches, _ = sep.run_once(cfg, sc, cams, 0.0, dev)
            counters = trace.collect()["counters"]
    finally:
        for (mod, name), fn in origs.items():
            setattr(mod, name, fn)
    assert launches["affinity_enum"] == 4 + 2
    [(g_args, g_kw, graph)] = seen["graph"]
    [(e_args, _, stream)] = seen["enum"]
    [(_, _, kept)] = seen["kept"]
    assert g_kw["device"].type == e_args[-1].type == "cuda"
    want = affinity.enumerate_candidates(*e_args[:-1], device="cpu")
    assert_same_stream(ka.read_stream(stream), want)
    n, m = len(want[0]), len(kept[0])
    assert l3d.stats["affinity_candidates"] == n > 0
    assert l3d.stats["affinity_kept"] == counters["affinity.kept"] == m > 0
    # the whole stream stays on the card; the host reads the kept part
    assert "syncs.affinity.candidates" not in counters
    assert counters["syncs.affinity.kept_count"] == 1
    assert counters["syncs.affinity.kept"] == 1
    assert counters["dtoh_bytes.affinity.kept"] == 25 * m
    _hold_filter(kept, want, g_args[0], g_args[3], g_args[4])
    host = affinity.build_affinity_graph(*g_args, device="cpu")
    assert graph.num_nodes == host.num_nodes > 0
    for f in ("edges_i", "edges_j", "edges_w", "node_view", "node_seg"):
        a, b = getattr(graph, f), getattr(host, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
