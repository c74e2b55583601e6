"""VisualSfM NVM dataset loader (numpy copy of `line3d_tpu/io/nvm.py`).

Mirrors the reference CLI's parsing (main_vsfm.cpp:121-223): per-camera
filename, focal, rotation quaternion (WXYZ order in file, read as
quat3=w, quat0=x, quat1=y, quat2=z), camera center (t = -R C), single radial
distortion coefficient (negated for undistortion, main_vsfm.cpp:259), and
worldpoint measurement lists.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class NVMScene:
    image_names: list
    focal: np.ndarray        # [V]
    distortion: np.ndarray   # [V] (single coefficient, raw from file)
    R: np.ndarray            # [V, 3, 3]
    t: np.ndarray            # [V, 3]
    wp_lists: list


def quat_to_R(w: float, x: float, y: float, z: float) -> np.ndarray:
    """Quaternion to rotation matrix, exactly as main_vsfm.cpp:169-180
    (with its quat0=x, quat1=y, quat2=z, quat3=w naming)."""
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def load_nvm_scene(path: str) -> NVMScene:
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()]
    p = 0
    # header line ("NVM_V3") + blank line skipped (main_vsfm.cpp:126-127)
    p += 2
    while p < len(lines) and not lines[p].strip():
        p += 1
    num_cams = int(lines[p].split()[0]); p += 1

    names, focal, dist = [], [], []
    R = np.zeros((num_cams, 3, 3))
    t = np.zeros((num_cams, 3))
    for i in range(num_cams):
        tok = lines[p].split(); p += 1
        names.append(tok[0])
        f_ = float(tok[1])
        qw, qx, qy, qz = (float(tok[2]), float(tok[3]),
                          float(tok[4]), float(tok[5]))
        C = np.array([float(tok[6]), float(tok[7]), float(tok[8])])
        d = float(tok[9])
        Ri = quat_to_R(qw, qx, qy, qz)
        R[i] = Ri
        t[i] = -Ri @ C
        focal.append(f_)
        dist.append(d)

    # blank line + point count (main_vsfm.cpp:191-197)
    while p < len(lines) and not lines[p].strip():
        p += 1
    num_points = int(lines[p].split()[0]); p += 1

    # the reference reads this section with stream extraction (operator>>,
    # main_vsfm.cpp:199-223), so a point's measurement list may wrap across
    # physical lines — parse the remainder as one token stream
    toks = iter(" ".join(lines[p:]).split())
    wp_lists = [[] for _ in range(num_cams)]
    try:
        for wp in range(num_points):
            for _ in range(6):                    # xyz + rgb
                next(toks)
            num_views = int(next(toks))
            for _ in range(num_views):
                cam = int(next(toks))
                next(toks); next(toks); next(toks)  # featIdx, mx, my
                if 0 <= cam < num_cams:
                    wp_lists[cam].append(wp)
    except StopIteration:
        raise ValueError("truncated NVM point section") from None

    return NVMScene(image_names=names, focal=np.array(focal),
                    distortion=np.array(dist), R=R, t=t, wp_lists=wp_lists)
