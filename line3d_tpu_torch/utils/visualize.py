"""Debug visualization utilities.

Numpy copy of `line3d_tpu/utils/visualize.py`: host helpers mirroring the
reference's debug facilities:

  * ``draw_lines`` — rasterize one view's 2D segments onto a black canvas
    with an optional highlighted subset (L3DView::drawLines,
    view.cc:418-443; the reference draws white 4 px lines on black with
    highlights in red).
  * ``save_ply`` — colored 3D line-set dump for point-cloud viewers; the
    reference ships this only as commented-out debug blocks
    (line3D.cc:650-694: hypotheses colored by confidence; 948-964,
    1360-1364), so the format here is standard ASCII PLY with line
    segments as vertex pairs + edge elements, loadable in Meshlab
    alongside the STL output.

Pure numpy — no OpenCV dependency; the rasterizer is an integer Bresenham
with thickness via a square brush, which is all the reference's debug view
needs.
"""
from __future__ import annotations

import numpy as np


def _draw_segment(img: np.ndarray, x1, y1, x2, y2, color, thickness: int):
    """Bresenham with a square brush of the given thickness (like the
    reference's cv::line(..., 4) for debug purposes).

    Pixels outside the canvas are dropped (geometric clipping, matching
    cv::line) rather than clamped to the border — clamping would smear a
    spurious line along the image edge for segments extending past it.
    """
    h, w = img.shape[:2]
    x1, y1, x2, y2 = int(round(x1)), int(round(y1)), \
        int(round(x2)), int(round(y2))
    n = max(abs(x2 - x1), abs(y2 - y1), 1)
    xs = np.rint(np.linspace(x1, x2, n + 1)).astype(np.int64)
    ys = np.rint(np.linspace(y1, y2, n + 1)).astype(np.int64)
    # brush offsets span exactly `thickness` pixels
    lo = -((max(thickness, 1) - 1) // 2)
    hi = max(thickness, 1) // 2
    for dx in range(lo, hi + 1):
        for dy in range(lo, hi + 1):
            xi = xs + dx
            yi = ys + dy
            keep = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            img[yi[keep], xi[keep]] = color


def draw_lines(segments, width: int, height: int, highlight=(),
               thickness: int = 4) -> np.ndarray:
    """Rasterize 2D segments onto a black [H, W, 3] uint8 canvas.

    Mirrors L3DView::drawLines (view.cc:418-443): every segment white,
    the ``highlight`` ids red, line thickness 4.

    Args:
      segments: [N, 4] (x1, y1, x2, y2) pixel coordinates.
      highlight: iterable of segment indices to overdraw in red.
    """
    segments = np.asarray(segments, np.float64).reshape(-1, 4)
    img = np.zeros((int(height), int(width), 3), np.uint8)
    for x1, y1, x2, y2 in segments:
        _draw_segment(img, x1, y1, x2, y2, (255, 255, 255), thickness)
    for idx in highlight:
        if 0 <= int(idx) < len(segments):
            x1, y1, x2, y2 = segments[int(idx)]
            # reference highlight color is cv::Scalar(0,0,255) = BGR red;
            # this canvas is RGB
            _draw_segment(img, x1, y1, x2, y2, (255, 0, 0), thickness)
    return img


def save_ppm(img: np.ndarray, filename: str):
    """Write an [H, W, 3] uint8 image as binary PPM (no imaging deps)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    with open(filename, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def save_ply(result, filename: str, color_by_confidence: bool = False):
    """Write the final 3D line model as an ASCII PLY line set.

    Each collinear sub-segment contributes two vertices and one edge;
    Meshlab and CloudCompare render the edge elements as lines.  The
    reference's equivalent PLY dumps are debug-only commented code
    (line3D.cc:650-694); colors follow its confidence scheme there when
    ``color_by_confidence`` (green conf>2, yellow 1<conf<=2) and plain
    white otherwise.

    Args:
      result: list of FinalLine3D (as returned by compute_3d_model).
    """
    verts, edges = [], []
    for line in result:
        conf = float(getattr(line, "confidence", 0.0) or 0.0)
        if color_by_confidence:
            if conf > 2.0:
                col = (0, 255, 0)
            elif conf > 1.0:
                col = (255, 255, 0)
            else:
                col = (255, 255, 255)
        else:
            col = (255, 255, 255)
        for P1, P2 in line.segments3d:
            i0 = len(verts)
            verts.append((*np.asarray(P1, float), *col))
            verts.append((*np.asarray(P2, float), *col))
            edges.append((i0, i0 + 1))
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for x, y, z, r, g, b in verts:
            f.write(f"{x:.6f} {y:.6f} {z:.6f} {int(r)} {int(g)} {int(b)}\n")
        for a, b_ in edges:
            f.write(f"{a} {b_}\n")
