"""line3d_tpu_torch.detect against line3d_tpu.detect on the same images.

The native path (what `detect` always takes) runs the same C++ source in
both packages, so its segments are held to 1e-4 px of line3d_tpu's (they
come out equal).  The PyTorch formulation is held to the JAX formulation
function by function on the same inputs: the front within the tolerance of
tests/test_detect.py's native-vs-XLA check (norm rtol 1e-4 / atol 1e-3,
angles within 1e-3 rad, `defined` flipping on fewer than 1e-3 of the pixels:
XLA:CPU contracts a*b + c into fused multiply-adds, and a gradient norm
within that rounding of rho lands on the other side of the threshold);
connected-component labels exactly; moment sums rtol 1e-5 of the
component's scale (float32 sums in the same order, FMA apart); extents
within 1e-3 px; and the segments of the whole formulation within 0.05 px
(their log NFA within 5% + 5).
"""
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
import torch

from line3d_tpu.detect import detector as jdet, vectorized_lsd as jv
from line3d_tpu.native import load as jload
from line3d_tpu_torch.detect import detector as tdet, vectorized_lsd as tvl
from line3d_tpu_torch.native import load as tload
from torch_port_helpers import N, T

HERE = os.path.dirname(os.path.abspath(__file__))
PREC = math.pi * tvl.ANG_TH / 180.0
RHO = tvl.QUANT / math.sin(PREC)


def draw_scene(width=640, height=480, seed=3, n_lines=12, thickness=2):
    """tests/test_detect.py's drawn scene: dark antialiased lines on
    white, lightly blurred.  Returns (uint8 image, [n, 4] segments)."""
    rng = np.random.default_rng(seed)
    img = np.full((height, width), 255, np.uint8)
    segs = []
    for _ in range(n_lines):
        ang = rng.uniform(0, np.pi)
        length = rng.uniform(100, 300)
        cx = rng.uniform(0.2 * width, 0.8 * width)
        cy = rng.uniform(0.2 * height, 0.8 * height)
        d = np.array([np.cos(ang), np.sin(ang)]) * length / 2
        p1 = np.clip(np.array([cx, cy]) - d, [5, 5], [width - 5, height - 5])
        p2 = np.clip(np.array([cx, cy]) + d, [5, 5], [width - 5, height - 5])
        if np.linalg.norm(p1 - p2) < 60:
            continue
        cv2.line(img, tuple(p1.astype(int)), tuple(p2.astype(int)),
                 int(rng.uniform(0, 120)), thickness, lineType=cv2.LINE_AA)
        segs.append(np.concatenate([p1, p2]))
    return cv2.GaussianBlur(img, (3, 3), 0.7), np.array(segs)


def _noisy(shape=(180, 240), seed=7):
    return np.random.default_rng(seed).uniform(0, 255, shape) \
        .astype(np.float32)


def _fronts(img):
    """(JAX front, torch front, native front) of one gray image, each as
    numpy (norm, angle, defined)."""
    out_h = int(math.ceil(img.shape[0] * tvl.SCALE))
    out_w = int(math.ceil(img.shape[1] * tvl.SCALE))
    ref = [np.asarray(x) for x in jv._grad_jit(
        jv._blur_jit(jnp.asarray(img), out_h, out_w), RHO)]
    got = [N(x) for x in tvl._front_torch(T(img), out_h, out_w, RHO)]
    nat = tvl._front_native(tload.get_lib(), img, out_h, out_w, RHO)
    return ref, got, nat


def _grace_hopper():
    img = cv2.imread(os.path.join(HERE, "data", "grace_hopper.jpg"),
                     cv2.IMREAD_GRAYSCALE)
    return img.astype(np.float32)


@pytest.mark.parametrize("case", ["photo", "drawn", "drawn_resized",
                                  "color", "empty"])
def test_native_detect_equals_reference(case):
    """detect_line_segments through the native library: the segments of
    line3d_tpu's, in the same order (a real photograph, a drawn scene, the
    drawn scene detected at half resolution, a BGR image, a flat image)."""
    if case == "photo":
        img = _grace_hopper()
        h, w = img.shape
        args = (w, h, 0.005 * np.hypot(w, h), 3000)
    elif case == "empty":
        img, args = np.full((200, 300), 128, np.uint8), (300, 200, 10.0, 3000)
    else:
        img, _ = draw_scene(width=1280, height=960, thickness=3) \
            if case == "drawn_resized" else draw_scene()
        args = (640, 480, 40.0 if case == "drawn_resized" else 20.0, 3000)
        if case == "color":
            img = np.stack([img, img // 2, 255 - img], axis=-1)
    got = tdet.detect_line_segments(img, *args)
    want = jdet.detect_line_segments(img, *args)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if case == "photo":
        assert len(got) >= 300
    elif case == "empty":
        assert got.shape == (0, 4)
    else:
        assert len(got) >= 12
        lens = np.hypot(got[:, 0] - got[:, 2], got[:, 1] - got[:, 3])
        assert np.all(np.diff(lens) <= 1e-3)      # longest first


def test_detect_caps_and_min_length():
    img, _ = draw_scene()
    all_ = tdet.detect_line_segments(img, 640, 480, 20.0, 3000)
    top = tdet.detect_line_segments(img, 640, 480, 20.0, 5)
    np.testing.assert_array_equal(top, all_[:5])
    long_ = tdet.detect_line_segments(img, 640, 480, 150.0, 3000)
    lens = np.hypot(all_[:, 0] - all_[:, 2], all_[:, 1] - all_[:, 3])
    np.testing.assert_array_equal(long_, all_[lens > 150.0])


@pytest.mark.parametrize("shape,out", [((90, 120), (72, 96)),
                                       ((64, 64), (52, 52)),
                                       ((33, 47), (27, 38)),
                                       ((1440, 1920), (1152, 1536))])
def test_resize_taps_equal_reference(shape, out):
    """The taps are the JAX module's (which tests/test_detect.py pins to
    jax.image.resize), and the torch resize over them gives
    jax.image.resize(method="linear") within rtol 1e-5 / atol 1e-4."""
    for a, b in zip(shape, out):
        for g, w in zip(tvl._resize_taps(a, b), jv._resize_taps(a, b)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    if shape[0] > 100:
        return
    import jax
    x = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), out, method="linear")
    np.testing.assert_allclose(N(tvl._resize_linear(T(x), *out)),
                               np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("image", ["noise", "drawn"])
def test_torch_front_matches_jax_and_native_front(image):
    """Blur + antialiased resize + gradient field: the torch formulation
    against the JAX one and against the native C++ front."""
    img = _noisy() if image == "noise" else \
        draw_scene(width=320, height=240, n_lines=8)[0].astype(np.float32)
    ref, got, nat = _fronts(img)
    for other, name in ((ref, "jax"), (nat, "native")):
        n_o, a_o, d_o = other
        n_g, a_g, d_g = got
        np.testing.assert_allclose(n_g, n_o, rtol=1e-4, atol=1e-3,
                                   err_msg=name)
        assert (d_g != d_o).mean() < 1e-3, name
        both = d_g & d_o
        assert both.sum() > 100
        da = np.abs(np.mod(a_g[both] - a_o[both] + np.pi, 2 * np.pi) - np.pi)
        assert da.max() < 1e-3, name
        assert np.all(a_g[~d_g] == tvl.NOTDEF)
    assert got[1].dtype == np.float32 and got[2].dtype == bool
    assert not got[2][-1].any() and not got[2][:, -1].any()


@pytest.fixture(scope="module")
def cc_inputs():
    """One gradient field (the JAX front's, so both formulations label
    the same pixels) of a drawn scene."""
    img = draw_scene(width=320, height=240, n_lines=8)[0].astype(np.float32)
    return _fronts(img)[0]


@pytest.mark.parametrize("prec", [PREC, PREC / 4])
def test_cc_and_stats_match_jax(cc_inputs, prec):
    """Hook + pointer-jumping labels: exactly the JAX labels.  Moment sums:
    rtol 1e-5 of each column's largest sum."""
    norm, angle, defined = cc_inputs
    want = jv._cc_and_stats(jnp.asarray(norm), jnp.asarray(angle),
                            jnp.asarray(defined), jnp.float32(prec))
    got = tvl._cc_and_stats(T(norm), T(angle), T(defined), prec)
    np.testing.assert_array_equal(N(got[1]), np.asarray(want[1]))
    assert len(np.unique(N(got[1]))) > 10
    for k, w in want[0].items():
        w = np.asarray(w)
        np.testing.assert_allclose(N(got[0][k]), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(N(g), np.asarray(w))


def test_cc_per_pixel_tolerance_map(cc_inputs):
    """A per-pixel tolerance map (the refinement passes) labels as JAX."""
    norm, angle, defined = cc_inputs
    rng = np.random.default_rng(0)
    tol = rng.choice([PREC, PREC / 2, PREC / 8], angle.shape) \
        .astype(np.float32)
    want = jv._connected_components(jnp.asarray(angle), jnp.asarray(defined),
                                    jnp.asarray(tol))
    got = tvl._connected_components(T(angle), T(defined), T(tol))
    np.testing.assert_array_equal(N(got), np.asarray(want))


def test_fit_components_match_jax(cc_inputs):
    """Extents (scatter amin/amax against segment_min/max) and the fits
    built on them, for components of at least 10 pixels."""
    norm, angle, defined = cc_inputs
    sj, lj, xj, yj, dj = jv._cc_and_stats(
        jnp.asarray(norm), jnp.asarray(angle), jnp.asarray(defined),
        jnp.float32(PREC))
    st, lt, xt, yt, dt = tvl._cc_and_stats(T(norm), T(angle), T(defined),
                                           PREC)
    want = jv._fit_components(sj, xj, yj, lj, dj, PREC)
    got = tvl._fit_components(st, xt, yt, lt, dt, PREC)
    big = want["count"] >= 10
    assert big.sum() > 10
    np.testing.assert_array_equal(got["count"], want["count"])
    for k in ("cx", "cy", "l_min", "l_max", "length", "width"):
        np.testing.assert_allclose(got[k][big], want[k][big], rtol=0,
                                   atol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["density"][big], want["density"][big],
                               rtol=1e-3)


def test_torch_formulation_detects_as_jax_formulation(monkeypatch):
    """`_detect_impl` without a library (front, CC, fits, the
    tolerance-halving ladder, NFA) against the JAX module forced onto its
    own formulation: the same number of segments, endpoints within 0.05 px,
    log NFA within 5% + 5."""
    img = draw_scene(width=320, height=240, n_lines=8)[0].astype(np.float32)
    monkeypatch.setattr(jload, "get_lib", lambda: None)
    want = jv._detect_impl(img)
    got = tvl._detect_impl(img, None, device="cpu")
    assert got.shape == want.shape and len(got) >= 8
    order = lambda a: a[np.lexsort(np.round(a[:, :2]).T)]      # noqa: E731
    got, want = order(got), order(want)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=0.05)
    # a rectangle edge that moves by 1e-3 px takes a lattice pixel in or
    # out of the NFA's counts
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0.05, atol=5.0)
    with pytest.raises(ValueError, match="device"):
        tvl._detect_impl(img, None)


def test_host_statistics_equal_reference():
    """The numpy host code is a copy: `_nfa_log10` and the rect_improve
    ladder give the JAX module's values bit for bit."""
    rng = np.random.default_rng(4)
    n = rng.integers(8, 4096, 200).astype(float)
    k = np.minimum(rng.integers(1, 600, 200), n).astype(float)
    for p in (0.125, 0.015625):
        np.testing.assert_array_equal(tvl._nfa_log10(n, k, p, 7.25),
                                      jv._nfa_log10(n, k, p, 7.25))
    W = 128
    angle = rng.uniform(-0.3, 0.3, (W, W)).astype(np.float32)
    defined = rng.uniform(size=(W, W)) < 0.5
    fit = dict(cx=np.array([60.0, 40.0]), cy=np.array([64.0, 30.0]),
               dx=np.array([1.0, 0.8], np.float32),
               dy=np.array([0.0, 0.6], np.float32),
               l_min=np.array([-40.0, -20.0]), l_max=np.array([40.0, 25.0]),
               width=np.array([5.0, 3.0]))
    log_nt = 5.0 * math.log10(W) + math.log10(11.0)
    for a, b in zip(
            tvl._rect_improve_nfa(fit, np.arange(2), angle, defined,
                                  0.125, log_nt),
            jv._rect_improve_nfa(fit, np.arange(2), angle, defined,
                                 0.125, log_nt)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tvl.gaussian_kernel1d(0.75),
                                  jv.gaussian_kernel1d(0.75))


def test_cc_runs_on_an_explicit_device():
    """The formulation's tensors follow the device of its inputs (here the
    CPU, by name): nothing in it allocates on a default device."""
    angle = torch.zeros((6, 8))
    defined = torch.ones((6, 8), dtype=torch.bool)
    defined[:, 4] = False
    lab = tvl._connected_components(angle, defined, 0.1)
    assert lab.device.type == "cpu"
    assert set(lab.reshape(-1).tolist()) == {0, 5, 48}
