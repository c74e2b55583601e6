"""line3d_tpu_torch.match.pairwise (and K1's plain twin) against
line3d_tpu.match.pairwise / pairwise_pallas.

Valid planes: fewer than 1e-3 of pairs may disagree (borderline gates under
different rounding); expect 0.  Tables: identical.  Depths: rtol 1e-4 /
atol 1e-5."""
import numpy as np
import jax.numpy as jnp
import pytest

from line3d_tpu.match import pairwise as jp, pairwise_pallas as jpp
from line3d_tpu_torch.match import pairwise as tp, pairwise_cuda
from synthetic import make_scene
from torch_port_helpers import N, T, facade_pair, pair_dense_ieee, \
    stereo_views


@pytest.mark.parametrize("S,St", [(128, 256), (384, 384)])
def test_pair_valid_plain_matches_reference(S, St):
    args = facade_pair(0, 1, S, St)
    ja = [jnp.asarray(a) for a in args]
    _, v_ref = jp.match_pair_dense(*ja)
    v_pal = jpp.match_pair_valid_pallas(*ja, block_s=128, block_t=128,
                                        interpret=True)
    ta = [T(a) for a in args]
    got = pairwise_cuda.pair_valid(ta[0], ta[2], ta[1][None], ta[3][None],
                                   ta[4][None], ta[5], ta[6][None], ta[7],
                                   ta[8][None])[0]
    _, v_t = tp.match_pair_dense(*ta)
    v_ref, v_pal, got = N(v_ref), N(v_pal), N(got)
    assert v_ref.sum() > 20
    np.testing.assert_array_equal(got, N(v_t))
    assert (got != v_ref).mean() < 1e-3
    assert (got != v_pal).mean() < 1e-3


@pytest.mark.parametrize("quota,min_capacity", [(8, 0), (2, 0), (8, 40),
                                                (128, 0)])
def test_compact_rows_blockq_identical(quota, min_capacity):
    rng = np.random.default_rng(quota + min_capacity)
    valid = rng.uniform(size=(64, 256)) < 0.08
    want = jp.compact_rows_blockq(jnp.asarray(valid), quota, min_capacity)
    got = tp.compact_rows_blockq(T(valid), quota, min_capacity)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(N(g), N(w))


@pytest.mark.parametrize("m_total", [16, 64, 1024])
def test_merge_neighbor_tables_identical(m_total):
    rng = np.random.default_rng(m_total)
    planes = rng.uniform(size=(3, 64, 128)) < 0.1
    res_j = {"tgt_idx": [], "valid": []}
    res_t = {"tgt_idx": [], "valid": []}
    for p in planes:
        ti, kv, _ = jp.compact_rows_blockq(jnp.asarray(p), 128)
        res_j["tgt_idx"].append(ti)
        res_j["valid"].append(kv)
        ti, kv, _ = tp.compact_rows_blockq(T(p), 128)
        res_t["tgt_idx"].append(ti)
        res_t["valid"].append(kv)
    res_j = {k: jnp.stack(v) for k, v in res_j.items()}
    import torch
    res_t = {k: torch.stack(v) for k, v in res_t.items()}
    want = jp.merge_neighbor_tables(res_j, m_total, 128)
    got = tp.merge_neighbor_tables(res_t, m_total, 128)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(N(g), N(w))


def _view_inputs(v=1):
    syn = make_scene(num_views=6)
    cams, sc = syn.cameras, syn.scene
    nb = np.array([(v + k) % 6 for k in (1, 2, 4, 5)])
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    F = f32(cams.fundamentals_for_pairs(np.stack([np.full(len(nb), v), nb],
                                                 1)))
    return [f32(sc.segments[v]), sc.seg_mask[v], f32(cams.RtKinv[v]),
            f32(cams.C[v]), f32(sc.segments[nb]), sc.seg_mask[nb], F,
            f32(cams.RtKinv[nb]), f32(cams.C[nb])]


def test_match_view_tables_and_depths():
    """The per-view table build (K1 plain twin, block compaction, merge)
    gives JAX's tables; the depth recompute agrees within rtol 1e-4."""
    a = _view_inputs()
    ja = [jnp.asarray(x) for x in a]
    res_j = jp.match_view_against_neighbors(*ja, jnp.ones(4, bool), 8,
                                            min_capacity=64)
    res_t = tp.match_view_against_neighbors(*[T(x) for x in a], 8,
                                            min_capacity=64)
    for k in ("tgt_idx", "valid", "n_valid", "overflow"):
        np.testing.assert_array_equal(N(res_t[k]), N(res_j[k]))
    S = a[0].shape[0]
    cam_j, tgt_j, val_j = jp.merge_neighbor_tables(res_j, 64, S)
    cam_t, tgt_t, val_t = tp.merge_neighbor_tables(res_t, 64, S)
    np.testing.assert_array_equal(N(cam_t), N(cam_j))
    np.testing.assert_array_equal(N(tgt_t), N(tgt_j))
    np.testing.assert_array_equal(N(val_t), N(val_j))
    assert N(val_t).sum() > 20
    d_j = jp.depths_for_matches(ja[0], ja[4], cam_j, tgt_j, val_j, ja[6],
                                ja[2], ja[7], ja[3], ja[8])
    d_t = tp.depths_for_matches(T(a[0]), T(a[4]), cam_t, tgt_t, val_t,
                                T(a[6]), T(a[2]), T(a[7]), T(a[3]), T(a[8]))
    assert N(d_t).dtype == N(d_j).dtype
    np.testing.assert_allclose(N(d_t), N(d_j), rtol=1e-4, atol=1e-5)
    tc_j = jp.gather_target_coords(ja[4], cam_j, tgt_j)
    tc_t = tp.gather_target_coords(T(a[4]), cam_t, tgt_t)
    np.testing.assert_array_equal(N(tc_t), N(tc_j))


def test_pair_valid_dispatch_cpu_uses_plain_twin():
    """CPU tensors take the plain twin and never touch the CUDA library."""
    a = [T(x) for x in facade_pair(0, 1, 128, 128)]
    before = pairwise_cuda.LAUNCHES
    out = pairwise_cuda.pair_valid(a[0], a[2], a[1][None], a[3][None],
                                   a[4][None], a[5], a[6][None], a[7],
                                   a[8][None])
    assert pairwise_cuda.LAUNCHES == before
    assert out.shape == (1, 128, 128) and out.dtype == __import__(
        "torch").bool


def _house_case(v, n, S, St):
    """Views v and n of the 6-view house, padded to S and St segments;
    (1, 3, 384, 384) is scripts/tpu_validate.py's phase-2 case."""
    syn = make_scene(num_views=6)
    cams, sc = syn.cameras, syn.scene
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731

    def cut(w, k):
        segs = np.zeros((k, 4), np.float32)
        mask = np.zeros(k, bool)
        m = min(k, sc.segments.shape[1])
        segs[:m], mask[:m] = sc.segments[w][:m], sc.seg_mask[w][:m]
        return segs, mask
    (ss, ms), (st, mt) = cut(v, S), cut(n, St)
    return (ss, st, ms, mt, f32(cams.fundamental(v, n)), f32(cams.RtKinv[v]),
            f32(cams.RtKinv[n]), f32(cams.C[v]), f32(cams.C[n]))


@pytest.mark.parametrize("case", [(1, 3, 384, 384), (4, 1, 384, 128)])
def test_pair_dense_plain_matches_reference(case):
    """K5's twin against match_pair_dense and match_pair_dense_pallas
    (interpret mode), with tpu_validate's check: gate disagreement < 1e-3,
    depths rtol 1e-3 / atol 1e-4 on the pairs valid in both."""
    args = _house_case(*case)
    ja = [jnp.asarray(a) for a in args]
    ta = [T(a) for a in args]
    depths, valid = pairwise_cuda.pair_dense(
        ta[0], ta[2], ta[1][None], ta[3][None], ta[4][None], ta[5],
        ta[6][None], ta[7], ta[8][None])
    assert depths.shape == (4, 1) + valid.shape[1:] and \
        depths.dtype == __import__("torch").float32
    depths, valid = N(depths)[:, 0], N(valid)[0]
    for ref in (jp.match_pair_dense(*ja),
                jpp.match_pair_dense_pallas(*ja, block_s=128, block_t=128,
                                            interpret=True)):
        d_r, v_r = [N(d) for d in ref[0]], N(ref[1])
        both = valid & v_r
        assert both.sum() > 20
        assert (valid != v_r).mean() < 1e-3
        for k in range(4):
            np.testing.assert_allclose(depths[k][both], d_r[k][both],
                                       rtol=1e-3, atol=1e-4)


def test_pair_dense_dispatch_cpu_uses_plain_twin():
    """CPU tensors take the twin (K1's planes beside the depths), and the
    valid planes equal pair_valid's."""
    a = [T(x) for x in facade_pair(0, 1, 128, 256)]
    nb = (a[1][None], a[3][None], a[4][None])
    before = pairwise_cuda.LAUNCHES_DENSE
    depths, valid = pairwise_cuda.pair_dense(a[0], a[2], *nb, a[5],
                                             a[6][None], a[7], a[8][None])
    assert pairwise_cuda.LAUNCHES_DENSE == before
    want = pairwise_cuda.pair_valid(a[0], a[2], *nb, a[5], a[6][None],
                                    a[7], a[8][None])
    np.testing.assert_array_equal(N(valid), N(want))
    d_t, _ = tp.match_pair_dense(*a)
    for k in range(4):
        np.testing.assert_array_equal(N(depths)[k, 0], N(d_t[k]))


@pytest.mark.parametrize("case", [(1, 3, 384, 384), (4, 1, 384, 128)])
def test_pair_dense_ieee_matches_reference(case):
    """pair_dense_ieee (tests/torch_port_helpers.py: K5's arithmetic in
    float32 with the IEEE operations, which the `cuda` tests hold K5 to
    bit for bit) against match_pair_dense_pallas in interpret mode, which
    also multiplies by reciprocals: gate disagreement < 1e-3, depths rtol
    1e-3 / atol 1e-4 on the pairs valid in both; no operand of the fast
    reciprocals reaches 2^126."""
    args = _house_case(*case)
    ja = [jnp.asarray(a) for a in args]
    ta = [T(a) for a in args]
    depths, valid, slow = pair_dense_ieee(
        ta[0], ta[2], ta[1][None], ta[3][None], ta[4][None], ta[5],
        ta[6][None], ta[7], ta[8][None])
    assert not slow.any()
    depths, valid = N(depths)[:, 0], N(valid)[0]
    ref = jpp.match_pair_dense_pallas(*ja, block_s=128, block_t=128,
                                      interpret=True)
    d_r, v_r = [N(d) for d in ref[0]], N(ref[1])
    both = valid & v_r
    assert both.sum() > 20
    assert (valid != v_r).mean() < 1e-3
    for k in range(4):
        np.testing.assert_allclose(depths[k][both], d_r[k][both],
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n_nb,Ss,St", [(1, 90, 150), (3, 70, 257)])
def test_pair_dense_ieee_matches_twin(n_nb, Ss, St):
    """pair_dense_ieee against K5's twin on the stereo views of the `cuda`
    edge-case tests (a masked source, zero-length segments, transfers with
    iz = 0): valid planes equal, depths rtol 1e-3 / atol 1e-4 on the valid
    pairs."""
    a, _, _ = stereo_views(n_nb, Ss, St)
    depths, valid, slow = pair_dense_ieee(*a)
    d_t, v_t = pairwise_cuda.pair_dense_plain(*a)
    assert not slow.any() and int(v_t.sum()) > 100
    np.testing.assert_array_equal(N(valid), N(v_t))
    for k in range(4):
        np.testing.assert_allclose(N(depths[k])[N(valid)],
                                   N(d_t[k])[N(v_t)], rtol=1e-3, atol=1e-4)
