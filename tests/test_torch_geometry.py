"""line3d_tpu_torch.core.geometry against line3d_tpu.core.geometry.

Same numpy inputs through both; rtol 1e-6.  The absolute floor is 1e-6 of
each output's magnitude: XLA's CPU backend contracts a*b + c into fused
multiply-adds and PyTorch does not, so results that cancel (cross
products of pixel coordinates) differ by an ulp of their operands."""
import numpy as np
import jax.numpy as jnp
import pytest

from line3d_tpu.core import geometry as jg
from line3d_tpu_torch.core import geometry as tg
from torch_port_helpers import N, T

rng = np.random.default_rng(0)
f32 = np.float32
PTS2 = rng.uniform(0, 640, (64, 2)).astype(f32)
SEGS = rng.uniform(0, 640, (64, 4)).astype(f32)
P1 = np.concatenate([PTS2, np.ones((64, 1), f32)], 1)
P2 = np.concatenate([rng.uniform(0, 640, (64, 2)).astype(f32),
                     np.ones((64, 1), f32)], 1)
PH = np.concatenate([rng.uniform(-5, 5, (64, 2)),
                     rng.choice([1e-14, 0.5, 2.0], (64, 1))], 1).astype(f32)
LINES = rng.normal(size=(64, 3)).astype(f32) * f32(100)
DIRS = rng.normal(size=(64, 3)).astype(f32)
DIRS2 = rng.normal(size=(64, 3)).astype(f32)
MAT = rng.normal(size=(64, 3, 3)).astype(f32)
# two well-separated cameras looking at the origin region
RK1 = np.linalg.inv(np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1.]])) \
    .astype(f32)
RK2 = (np.array([[0.8, 0, 0.6], [0, 1, 0], [-0.6, 0, 0.8]]) @ RK1).astype(f32)
C1 = np.array([0, 0, -4], f32)
C2 = np.array([3, 0.2, -3], f32)
PMAT = np.concatenate([np.eye(3), np.array([[0.1], [0.2], [4.0]])], 1) \
    .astype(f32)[None].repeat(64, 0)
PTS3 = rng.uniform(-1, 1, (64, 3)).astype(f32)
# collinear overlap inputs: points along one line, some outside
TT = rng.uniform(-1.5, 1.5, (64, 4)).astype(f32)
BASE = np.array([100, 50], f32)
DIR = np.array([3, 1], f32)
COL = [np.concatenate([BASE + t[:, None] * DIR * f32(40),
                       np.ones((64, 1), f32)], 1).astype(f32)
       for t in TT.T]

CASES = {
    "hom": (lambda g, a: g.hom(a[0]), [PTS2]),
    "seg_endpoints": (lambda g, a: g.seg_endpoints(a[0]), [SEGS]),
    "line_through": (lambda g, a: g.line_through(a[0], a[1]), [P1, P2]),
    "normalize_hom": (lambda g, a: g.normalize_hom(a[0]), [PH]),
    "dist_point_line_2d": (lambda g, a: g.dist_point_line_2d(a[0], a[1]),
                           [LINES, P1]),
    "segment_length_2d": (lambda g, a: g.segment_length_2d(a[0], a[1]),
                          [P1, P2]),
    "angle_between_dirs_deg": (
        lambda g, a: g.angle_between_dirs_deg(a[0], a[1]), [DIRS, DIRS2]),
    "point_on_segment_2d": (
        lambda g, a: g.point_on_segment_2d(a[0], a[1], a[2]), COL[:3]),
    "segment_overlap_2d": (
        lambda g, a: g.segment_overlap_2d(a[0], a[1], a[2], a[3]), COL),
    "apply_mat3": (lambda g, a: g.apply_mat3(a[0], a[1]), [MAT, P1]),
    "epipolar_line": (lambda g, a: g.epipolar_line(a[0], a[1]), [MAT, P1]),
    "ray_dir": (lambda g, a: g.ray_dir(a[0], a[1]), [RK1, P1]),
    "triangulation_depths": (
        lambda g, a: g.triangulation_depths(a[0], a[1], C1, C2, RK1, RK2),
        [P1, P2]),
    "unproject": (lambda g, a: g.unproject(a[0], C1, a[1], RK1),
                  [P1, rng.uniform(1, 5, 64).astype(f32)]),
    "project": (lambda g, a: g.project(a[0], a[1]), [PTS3, PMAT]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_twin(name):
    fn, args = CASES[name]
    want = fn(jg, [jnp.asarray(a) for a in args])
    C1t, C2t, RK1t, RK2t = T(C1), T(C2), T(RK1), T(RK2)
    if name in ("triangulation_depths", "unproject"):
        # constants enter through the lambda; rebind them as tensors
        got = {"triangulation_depths": lambda: tg.triangulation_depths(
                   T(args[0]), T(args[1]), C1t, C2t, RK1t, RK2t),
               "unproject": lambda: tg.unproject(T(args[0]), C1t,
                                                 T(args[1]), RK1t)}[name]()
    else:
        got = fn(tg, [T(a) for a in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w, g = N(w), N(g)
        assert w.shape == g.shape and w.dtype == g.dtype, (w.dtype, g.dtype)
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        elif name == "angle_between_dirs_deg":
            # d acos(x)/dx = -1/sin(theta): one ulp of the dot product
            # (6e-8) moves a few-degree angle by up to ~1e-4 degrees
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4)
        else:
            scale = float(np.abs(w).max()) if w.size else 0.0
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * scale)


def test_fundamental_from_rt_is_f64_and_equal():
    K = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1.]])
    R1, R2 = np.eye(3), np.array([[0.8, 0, 0.6], [0, 1, 0], [-0.6, 0, 0.8]])
    t1, t2 = np.zeros(3), np.array([0.5, 0.1, 0.2])
    want = jg.fundamental_from_rt(K, R1, t1, K, R2, t2)
    got = tg.fundamental_from_rt(K, R1, t1, K, R2, t2)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
