"""Synthetic line-based MVS scenes with exact ground truth.

Generates a 3D wireframe (house/box of line segments), a ring of cameras, and
the exact 2D projections + worldpoint visibility lists, so the full pipeline
can be validated end-to-end without real imagery.  Copy of the test-suite
generator `tests/synthetic.py`, built for the port's classes so that it runs
where JAX is not installed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.cameras import CameraSet
from ..scene import Scene


def house_wireframe(jitter: float = 0.18, seed: int = 7) -> np.ndarray:
    """[L, 2, 3] endpoints of a 'house' wireframe centered near origin.

    Corners are deterministically jittered: a perfectly symmetric box admits
    multi-view-consistent *wrong* matches (parallel pillars / mirrored roof
    edges score full support under epipolar ambiguity), which no matcher can
    disambiguate — the jitter makes ground truth unique.
    """
    c = np.array([
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],   # floor
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],   # ceiling
        [0.5, 0.5, 1.6],                              # roof apex
    ], float) - np.array([0.5, 0.5, 0.5])
    rng = np.random.default_rng(seed)
    c = c + rng.uniform(-jitter, jitter, c.shape)
    edges = [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
        (4, 8), (5, 8), (6, 8), (7, 8),
    ]
    return np.stack([np.stack([c[a], c[b]]) for a, b in edges])


def look_at(C: np.ndarray, target: np.ndarray, up=(0, 0, 1.0)):
    """World->camera rotation R with +z forward, t = -R C."""
    fwd = target - C
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, float)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-8:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    t = -R @ C
    return R, t


@dataclasses.dataclass
class SyntheticScene:
    scene: Scene
    cameras: CameraSet
    lines3d: np.ndarray           # [L, 2, 3] ground-truth 3D segments
    seg_line_id: list             # per view: [S_v] ground-truth line index
    true_depths: list             # per view: [S_v, 2] endpoint depths
    wp_lists: list


def make_scene(num_views: int = 6, width: int = 640, height: int = 480,
               focal: float = 600.0, radius: float = 4.0,
               noise_px: float = 0.0, seed: int = 0,
               min_len_px: float = 10.0,
               wps_per_line: int = 6,
               elevation: float = 0.35, device="cuda") -> SyntheticScene:
    rng = np.random.default_rng(seed)
    lines = house_wireframe()
    V = num_views

    Ks, Rs, ts = [], [], []
    for v in range(V):
        ang = 2 * np.pi * v / V
        C = np.array([radius * np.cos(ang), radius * np.sin(ang),
                      radius * elevation])
        R, t = look_at(C, np.zeros(3))
        K = np.array([[focal, 0, width / 2.0],
                      [0, focal, height / 2.0],
                      [0, 0, 1.0]])
        Ks.append(K)
        Rs.append(R)
        ts.append(t)

    cams = CameraSet(K=np.stack(Ks), R=np.stack(Rs), t=np.stack(ts),
                     width=np.full(V, width), height=np.full(V, height))

    def project(v, X):
        x = cams.K[v] @ (cams.R[v] @ X + cams.t[v])
        return x[:2] / x[2], x[2]

    seg_lists, line_ids, depth_lists = [], [], []
    for v in range(V):
        segs, ids, deps = [], [], []
        for li, (A, B) in enumerate(lines):
            pa, za = project(v, A)
            pb, zb = project(v, B)
            if za <= 0.1 or zb <= 0.1:
                continue
            inside = lambda p: (0 <= p[0] < width) and (0 <= p[1] < height)
            if not (inside(pa) and inside(pb)):
                continue
            if np.linalg.norm(pa - pb) < min_len_px:
                continue
            if noise_px > 0:
                pa = pa + rng.normal(0, noise_px, 2)
                pb = pb + rng.normal(0, noise_px, 2)
            segs.append(np.concatenate([pa, pb]))
            ids.append(li)
            # depth along the *normalized* ray (= distance from center)
            deps.append([np.linalg.norm(A - cams.C[v]),
                         np.linalg.norm(B - cams.C[v])])
        seg_lists.append(np.array(segs, np.float32).reshape(-1, 4))
        line_ids.append(np.array(ids))
        depth_lists.append(np.array(deps).reshape(-1, 2))

    # worldpoints: samples along each 3D line; visible where projection lands
    # inside the image
    wp_lists = [[] for _ in range(V)]
    wp_id = 0
    for li, (A, B) in enumerate(lines):
        for s in np.linspace(0.1, 0.9, wps_per_line):
            X = A + s * (B - A)
            for v in range(V):
                p, z = project(v, X)
                if z > 0.1 and 0 <= p[0] < width and 0 <= p[1] < height:
                    wp_lists[v].append(wp_id)
            wp_id += 1

    scene = Scene.from_ragged(seg_lists, cams, wp_lists=wp_lists,
                              device=device)
    return SyntheticScene(scene=scene, cameras=cams, lines3d=lines,
                          seg_line_id=line_ids, true_depths=depth_lists,
                          wp_lists=wp_lists)
