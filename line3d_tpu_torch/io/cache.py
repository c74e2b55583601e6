"""Segment cache: load/store detected segments per (image, resolution,
collinearity flag), replacing the reference's boost binary archives
(line3D.cc:144-190, serialization.h:47-67) with npz files.

Numpy copy of `line3d_tpu/io/cache.py` with the same file names and
contents, so a cache written by either package is read by the other.
"""
from __future__ import annotations

import os

import numpy as np


def segment_cache_path(data_directory: str, image_id: int,
                       width: int, height: int, collin: bool,
                       max_segments: int | None = None,
                       min_len_factor: float | None = None) -> str:
    """Same key structure as the reference (line3D.cc:144-150), extended
    with the detector-affecting config values: the reference compiled them
    in as macros (L3D_DEF_*, commons.h), so resolution alone keyed the
    cache; here they are runtime config and must be part of the key or a
    changed cap/min-length silently reuses stale segments."""
    flag = 1 if collin else 0
    extra = ""
    if max_segments is not None:
        extra += f"_cap{int(max_segments)}"
    if min_len_factor is not None:
        extra += f"_ml{min_len_factor:g}"
    return os.path.join(
        data_directory,
        f"segments_{image_id}_{width}x{height}_coll{flag}{extra}.npz")


def save_segments(path: str, segments: np.ndarray):
    np.savez_compressed(path, segments=np.asarray(segments, np.float32))


def load_segments(path: str):
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return z["segments"]
    except Exception:
        return None
