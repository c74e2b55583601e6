"""The benchmark's own frozen copies of the port's scene generators.

`facade` is `make_facade_scene` and `clutter` is `make_demo_scene` of
`line3d_tpu_torch/utils/demo.py`, with the pieces they need (`facade_lines`,
`wireframe`, `look_at`, the camera arrays), in numpy alone.  They return a
`Capture` of plain arrays: per-view segments, K, R, t, image sizes and
worldpoint lists, which is all the program is given.  A later change to the
port's generators cannot change the benchmark's data.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Capture:
    """A posed capture as arrays: segments[v] is [S_v, 4] float32 pixels."""
    segments: list
    K: np.ndarray            # [V, 3, 3] float64
    R: np.ndarray            # [V, 3, 3]
    t: np.ndarray            # [V, 3]
    width: np.ndarray        # [V] int
    height: np.ndarray       # [V] int
    wp_lists: list

    @property
    def num_views(self) -> int:
        return len(self.segments)


def wireframe(jitter: float = 0.18, seed: int = 7) -> np.ndarray:
    """[16, 2, 3] edges of a jittered unit cube with a roof apex."""
    c = np.array([
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
        [0.5, 0.5, 1.6],
    ], float) - np.array([0.5, 0.5, 0.5])
    rng = np.random.default_rng(seed)
    c = c + rng.uniform(-jitter, jitter, c.shape)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7), (4, 8), (5, 8), (6, 8), (7, 8)]
    return np.stack([np.stack([c[a], c[b]]) for a, b in edges])


def look_at(C, target, up=(0, 0, 1.0)):
    fwd = target - C
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, float)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-8:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R, -R @ C


def facade_lines(n_cols: int = 30, n_rows: int = 16, cell: float = 1.0,
                 wing_depth: float = 8.0, seed: int = 11) -> np.ndarray:
    """[L, 2, 3] segments of a windowed facade with two perpendicular
    wings: per grid cell one jittered window (frame and two mullions),
    floor lines every fourth row broken into window-scale pieces."""
    rng = np.random.default_rng(seed)
    segs = []

    def window(org, ux, uz, w, h, cx, cz):
        x0, x1 = cx - w / 2, cx + w / 2
        z0, z1 = cz - h / 2, cz + h / 2
        pts = lambda x, z: org + x * ux + z * uz  # noqa: E731
        segs.append([pts(x0, z0), pts(x1, z0)])
        segs.append([pts(x0, z1), pts(x1, z1)])
        segs.append([pts(x0, z0), pts(x0, z1)])
        segs.append([pts(x1, z0), pts(x1, z1)])
        xm = rng.uniform(0.4, 0.6) * (x1 - x0) + x0
        zm = rng.uniform(0.4, 0.6) * (z1 - z0) + z0
        segs.append([pts(x0, zm), pts(x1, zm)])
        segs.append([pts(xm, z0), pts(xm, z1)])

    def wall(org, ux, uz, cols, rows):
        for i in range(cols):
            for j in range(rows):
                w = rng.uniform(0.45, 0.7) * cell
                h = rng.uniform(0.5, 0.75) * cell
                cx = (i + rng.uniform(0.42, 0.58)) * cell
                cz = (j + rng.uniform(0.42, 0.58)) * cell
                window(org, ux, uz, w, h, cx, cz)
        for j in range(0, rows + 1, 4):
            z = j * cell
            for i in range(0, cols, 2):
                a = org + (i + rng.uniform(0.0, 0.2)) * cell * ux + z * uz
                b = org + (i + rng.uniform(1.6, 2.0)) * cell * ux + z * uz
                segs.append([a, b])

    ex = np.array([1.0, 0, 0])
    ey = np.array([0, 1.0, 0])
    ez = np.array([0, 0, 1.0])
    wall(np.zeros(3), ex, ez, n_cols, n_rows)
    wing_cols = max(int(wing_depth / cell), 1)
    wall(np.zeros(3), -ey, ez, wing_cols, n_rows)
    wall(np.array([n_cols * cell, 0, 0]), -ey, ez, wing_cols, n_rows)
    return np.asarray(segs)


def detectable(segs, width, height, min_len_factor=None, max_segments=None):
    """Indices, ascending, of the segments a detector would report: those
    at least `min_len_factor` of the image diagonal long, and of them the
    `max_segments` longest (Line3D++ keeps the longest, commons.h:42-44,
    line3D.cc:1854-1857).  With neither set, every segment."""
    n = len(segs)
    keep = np.arange(n)
    if n == 0 or (min_len_factor is None and max_segments is None):
        return keep
    ln = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
    if min_len_factor is not None:
        keep = keep[ln >= min_len_factor * np.hypot(width, height)]
    if max_segments is not None and len(keep) > max_segments:
        order = np.argsort(-ln[keep], kind="stable")[:max_segments]
        keep = np.sort(keep[order])
    return keep


def _intrinsics(focal, focal_y, principal, width, height):
    px, py = (width / 2.0, height / 2.0) if principal is None else principal
    return np.array([[focal, 0, px],
                     [0, focal if focal_y is None else focal_y, py],
                     [0, 0, 1.0]])


def _project(K, R, t, X):
    x = (K @ (R @ X.T + t[:, None])).T
    return x[:, :2] / x[:, 2:3], x[:, 2]


def _inside(p, width, height):
    return (p[:, 0] >= 0) & (p[:, 0] < width) & \
           (p[:, 1] >= 0) & (p[:, 1] < height)


def facade(num_views: int = 25, width: int = 1920, height: int = 1440,
           focal: float = 1800.0, seed: int = 0, n_cols: int = 12,
           n_rows: int = 10, distance: float = 13.0, focal_y=None,
           principal=None, min_len_factor=None,
           max_segments=None) -> Capture:
    """The structured facade: cameras on a +/-60 degree arc in front of the
    wall (a Herz-Jesu-P25-like capture), exact endpoint projections, one
    worldpoint per visible 3D segment.  `focal_y` and `principal` (x, y)
    default to `focal` and the image centre; `min_len_factor` and
    `max_segments` keep what a detector would (`detectable`)."""
    rng = np.random.default_rng(seed)
    lines = facade_lines(n_cols=n_cols, n_rows=n_rows, seed=seed + 11)
    V = num_views
    cx, cz = n_cols / 2.0, n_rows / 2.0
    target = np.array([cx, 0.0, cz])
    Ks, Rs, ts = [], [], []
    for v in range(V):
        ang = np.deg2rad(-60.0 + 120.0 * v / max(V - 1, 1))
        dist = distance * (1.0 + 0.08 * np.sin(3.1 * v))
        C = target + dist * np.array([np.sin(ang), -np.cos(ang), 0.0])
        C[2] = cz * rng.uniform(0.55, 0.75)
        R, t = look_at(C, target)
        Ks.append(_intrinsics(focal, focal_y, principal, width, height))
        Rs.append(R)
        ts.append(t)
    A, B = lines[:, 0], lines[:, 1]
    seg_lists, vis = [], np.zeros((V, len(lines)), bool)
    for v in range(V):
        pa, za = _project(Ks[v], Rs[v], ts[v], A)
        pb, zb = _project(Ks[v], Rs[v], ts[v], B)
        ok = (za > 0.1) & (zb > 0.1) & \
            _inside(pa, width, height) & _inside(pb, width, height)
        vis[v] = ok
        segs = np.concatenate([pa[ok], pb[ok]], axis=1).astype(np.float32)
        segs = segs[detectable(segs, width, height, min_len_factor,
                               max_segments)]
        seg_lists.append(segs[rng.permutation(len(segs))])
    wp_lists = [np.flatnonzero(vis[v]).tolist() for v in range(V)]
    return Capture(seg_lists, np.stack(Ks), np.stack(Rs), np.stack(ts),
                   np.full(V, width), np.full(V, height), wp_lists)


def clutter(num_views: int = 10, width: int = 1920, height: int = 1440,
            focal: float = 1800.0, radius: float = 4.0,
            num_random_segments: int = 0, seed: int = 0, focal_y=None,
            principal=None, min_len_factor=None,
            max_segments=None) -> Capture:
    """The wireframe house on a ring of cameras plus
    `num_random_segments` uniform clutter segments per view; the camera
    and detector keywords as in `facade`."""
    rng = np.random.default_rng(seed)
    lines = wireframe()
    V = num_views
    Ks, Rs, ts = [], [], []
    for v in range(V):
        ang = 2 * np.pi * v / V
        C = np.array([radius * np.cos(ang), radius * np.sin(ang),
                      radius * 0.35])
        R, t = look_at(C, np.zeros(3))
        Ks.append(_intrinsics(focal, focal_y, principal, width, height))
        Rs.append(R)
        ts.append(t)

    def proj(v, X):
        x = Ks[v] @ (Rs[v] @ X + ts[v])
        return x[:2] / x[2], x[2]

    seg_lists = []
    for v in range(V):
        segs = []
        for A, B in lines:
            pa, za = proj(v, A)
            pb, zb = proj(v, B)
            if za <= 0.1 or zb <= 0.1:
                continue
            if not (0 <= pa[0] < width and 0 <= pa[1] < height and
                    0 <= pb[0] < width and 0 <= pb[1] < height):
                continue
            segs.append(np.concatenate([pa, pb]))
        for _ in range(num_random_segments):
            p = rng.uniform([0, 0], [width, height])
            ang = rng.uniform(0, np.pi)
            ln = rng.uniform(20, 200)
            d = np.array([np.cos(ang), np.sin(ang)]) * ln
            segs.append(np.concatenate([p, p + d]))
        segs = np.asarray(segs, np.float32).reshape(-1, 4)
        seg_lists.append(segs[detectable(segs, width, height,
                                         min_len_factor, max_segments)])
    wp_lists = [[] for _ in range(V)]
    wp = 0
    for A, B in lines:
        for s in np.linspace(0.1, 0.9, 6):
            X = A + s * (B - A)
            for v in range(V):
                x = Ks[v] @ (Rs[v] @ X + ts[v])
                if x[2] > 0.1 and 0 <= x[0] / x[2] < width and \
                        0 <= x[1] / x[2] < height:
                    wp_lists[v].append(wp)
            wp += 1
    return Capture(seg_lists, np.stack(Ks), np.stack(Rs), np.stack(ts),
                   np.full(V, width), np.full(V, height), wp_lists)


FAMILIES = {"facade": facade, "clutter": clutter}


def make_capture(scene: dict) -> Capture:
    """The capture a configuration's "scene" entry describes:
    {"family": name, ...the generator's keyword arguments}."""
    kw = dict(scene)
    return FAMILIES[kw.pop("family")](**kw)
