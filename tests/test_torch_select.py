"""line3d_tpu_torch.parallel.sharded (device selection over one view's
scored match table, and the packed export word) against
line3d_tpu.parallel.sharded and against the port's host selection
(`match.engine._select_view_outputs`).

Inputs are merged match tables made with numpy from a seed, in the layout
`merge_neighbor_tables` gives: each row's valid slots first, ascending in
cam * St + tgt, the rest cam = tgt = -1.  Confidences are drawn from a
grid of quarter steps, so rows hold exact ties, planted also at the row
maximum; some rows are all invalid.  Three kinds: "mixed" (verified
matches and medians), "unverified" (no confidence above the threshold, a
median still defined) and "no_median" (no raw maximum above half the
threshold, so median_has is false).  JAX's k_export is S * M, so nothing
drops.  Tolerance: none: best fields, median, median_has, n_verified and
the exported identities must be equal, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from line3d_tpu.parallel import sharded as js
from line3d_tpu_torch import L3DConfig
from line3d_tpu_torch.match import engine as te
from line3d_tpu_torch.parallel import sharded as ts
from line3d_tpu_torch.utils.synthetic import make_scene
from torch_port_helpers import SELECTION_KINDS as KINDS, T, \
    selection_tables as _tables

CONF_T = 1.0


def _port(tabs, N=5, overflow=0):
    S = tabs[0].shape[0]
    buf = ts.device_select(*map(T, tabs), CONF_T, N, overflow)
    return ts.unpack_selection(buf.numpy(), S)


@pytest.mark.parametrize("kind", KINDS)
def test_device_select_equals_jax(kind):
    S, N = 64, 5
    tabs = _tables(kind, S)
    cam, tgt, depths, valid, conf = tabs
    got = _port(tabs, N, overflow=7)
    want = js.device_select(*map(jnp.asarray, tabs), np.float32(CONF_T),
                            S * tabs[0].shape[1], N)
    want = {k: np.asarray(x) for k, x in want.items()}
    for k in ("best_conf", "best_cam", "best_tgt", "best_has",
              "best_depths"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["median_has"] == bool(want["median_has"])
    assert got["median_depth"].tobytes() == \
        np.float32(want["median_depth"]).tobytes()
    assert got["n_verified"] == int(want["n_verified"]) == \
        int((valid & (conf > CONF_T)).sum())
    assert int(want["export_drop"]) == 0 and got["overflow"] == 7
    exp = want["exp_packed"]
    np.testing.assert_array_equal(got["exp_packed"], exp[exp >= 0])
    for a, b in zip(ts.unpack_export(got["exp_packed"], S, N),
                    js.unpack_export(exp[exp >= 0], S, N)):
        np.testing.assert_array_equal(a, b)
    # the planted ties make the first maximum matter
    keyed = np.where(valid & (conf > CONF_T), conf, -np.inf)
    ties = (keyed == keyed.max(axis=1, keepdims=True)).sum(axis=1) > 1
    if kind == "mixed":
        assert got["n_verified"] > 100 and got["median_has"]
        assert ties.sum() > 10 and (~valid.any(axis=1)).sum() > 5
    elif kind == "unverified":
        assert got["n_verified"] == 0 and got["median_has"]
        assert not got["best_has"].any()
    else:
        assert got["n_verified"] == 0 and not got["median_has"]


@pytest.fixture(scope="module")
def house_ctx():
    syn = make_scene(num_views=6, device="cpu")
    return te.ViewContext(syn.scene, syn.cameras, L3DConfig())


@pytest.mark.parametrize("kind", KINDS)
def test_device_select_equals_host_selection(kind, house_ctx):
    """The same tables through the host twin: equal ViewMatches
    identities (in the same order), best rows and median."""
    S = house_ctx.scene.max_segments
    nb = np.array([2, 3, 4, 5, 1], np.int64)
    tabs = _tables(kind, S, N=len(nb), St=S)
    vm_d, row_d, med_d = te._assemble_view_outputs(
        house_ctx, 0, nb, _port(tabs, len(nb)))
    vm_h, row_h, med_h = te._select_view_outputs(house_ctx, 0, nb, *tabs, 0)
    for f in ("src_seg", "tgt_view", "tgt_seg"):
        np.testing.assert_array_equal(getattr(vm_d, f), getattr(vm_h, f))
        assert getattr(vm_d, f).dtype == getattr(vm_h, f).dtype
    assert vm_d.depths is None and vm_d.confidence is None
    assert vm_d.overflow == vm_h.overflow == 0
    assert (row_d is None) == (row_h is None) == (kind != "mixed")
    if row_h is not None:
        assert row_d.keys() == row_h.keys()
        for k in row_h:
            np.testing.assert_array_equal(row_d[k], row_h[k], err_msg=k)
            assert row_d[k].dtype == row_h[k].dtype
    assert med_d == med_h and (med_h != 1.0) == (kind != "no_median")


@pytest.mark.parametrize("S,n_slots", [(1280, 10), (3072, 10), (4096, 32),
                                       (8192, 32), (8192, 64), (1, 1),
                                       (40000, 2)])
def test_export_bits_equals_jax(S, n_slots):
    """The same layout, and the same ValueError past 31 bits."""
    try:
        want = js.export_bits(S, n_slots)
    except ValueError as e:
        with pytest.raises(ValueError, match="exceeds int32") as got:
            ts.export_bits(S, n_slots)
        assert str(got.value) == str(e)
        return
    assert ts.export_bits(S, n_slots) == want
    rng = np.random.default_rng(S)
    sbits, cbits = want
    packed = ((rng.integers(0, S, 100) << (sbits + cbits))
              | (rng.integers(0, n_slots, 100) << sbits)
              | rng.integers(0, S, 100)).astype(np.int32)
    for a, b in zip(ts.unpack_export(packed, S, n_slots),
                    js.unpack_export(packed, S, n_slots)):
        np.testing.assert_array_equal(a, b)


def test_unpack_selection_rejects_a_short_buffer():
    tabs = _tables("mixed", 16)
    buf = ts.device_select(*map(T, tabs), CONF_T, 5).numpy()
    assert len(buf) > 6 * 16 + 4
    with pytest.raises(ValueError, match="n_verified"):
        ts.unpack_selection(buf[:-1], 16)

