"""Top-level segment detection for the pipeline (copy of
`line3d_tpu/detect/detector.py`).

Mirrors Line3D::detectLineSegments (line3D.cc:1789-1871): resize to working
resolution, grayscale, run the detector, filter by logNFA >= 0 and minimum
length, sort by length descending, cap at max_num_segments, and upscale the
coordinates back to the original resolution.
"""
from __future__ import annotations

import numpy as np

from ..io import images as img_io
from . import vectorized_lsd


def detect_line_segments(image: np.ndarray, new_w: int, new_h: int,
                         min_length: float, max_segments: int) -> np.ndarray:
    """Returns [N, 4] float32 segment endpoints in ORIGINAL pixel coords."""
    h, w = image.shape[:2]
    if (new_w, new_h) != (w, h):
        scaled = img_io.resize(image, new_w, new_h)
        upscale = 1.0 / (0.5 * (new_w / w + new_h / h))
    else:
        scaled = image
        upscale = 1.0
    gray = img_io.to_gray(scaled)

    segs = vectorized_lsd.detect(gray)
    if len(segs) == 0:
        return np.zeros((0, 4), np.float32)

    coords = segs[:, :4] * upscale
    nfa_ok = segs[:, 4] >= 0.0
    lengths = np.hypot(coords[:, 0] - coords[:, 2], coords[:, 1] - coords[:, 3])
    keep = nfa_ok & (lengths > min_length)
    coords = coords[keep]
    lengths = lengths[keep]

    order = np.argsort(-lengths, kind="stable")
    if len(order) > max_segments:
        order = order[:max_segments]
    return coords[order].astype(np.float32)
