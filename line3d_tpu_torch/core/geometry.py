"""Geometry primitives as float32 torch functions.

Twins of `line3d_tpu/core/geometry.py` (the reference's CUDA device library,
cudawrapper.cu:46-427).  Every function broadcasts over leading batch
dimensions and runs on whatever device its tensors live on.

Conventions:
  * 2D points are homogeneous float32 [..., 3] with z == 1 after
    `normalize_hom`.
  * Segments are float32 [..., 4] = (x1, y1, x2, y2) (segments.h:60-71).
  * 2D lines are homogeneous [..., 3] (a, b, c) with a·x + b·y + c = 0.

Small matrix-vector products are written out as sums of products instead
of `matmul`/`einsum`: no TF32 or reduced-precision path can touch them, and
the summation order is fixed.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-12  # L3D_EPS_G (cudawrapper.h:43)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.

    PyTorch's CUDA float32 sqrt is approximate: on an NVIDIA H100 it differs
    from the CPU's correctly rounded one in 0.7% of values, and the
    triangulation's a*c - b*b cancellation turns one ulp of a ray into up
    to half of a depth.  The float64 root rounded to float32 is the
    correctly rounded float32 root, so the port gives the same bits on the
    CPU and on the card."""
    return torch.sqrt(x.double()).to(x.dtype)


def hom(p2: torch.Tensor) -> torch.Tensor:
    """Lift [..., 2] points to homogeneous [..., 3] with z=1."""
    return torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)


def seg_endpoints(seg: torch.Tensor):
    """Split a segment [..., 4] into homogeneous endpoints p1, p2 [..., 3]."""
    return hom(seg[..., 0:2]), hom(seg[..., 2:4])


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (3-vectors), with broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def line_through(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Homogeneous 2D line through two homogeneous points."""
    return cross3(p1, p2)


def normalize_hom(p: torch.Tensor):
    """Normalize homogeneous 2D coords to z=1; invalid points (|z| <= eps)
    are zeroed (D_normalize_hom_coords_2D, cudawrapper.cu:255-267).
    Returns (point, valid)."""
    z = p[..., 2:3]
    valid = z[..., 0].abs() > EPS
    safe = torch.where(z.abs() > EPS, z, torch.ones_like(z))
    out = p / safe
    out = torch.cat([out[..., :2], torch.ones_like(out[..., 2:3])], dim=-1)
    return torch.where(valid[..., None], out, torch.zeros_like(out)), valid


def dist_point_line_2d(line: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Perpendicular distance of homogeneous point (z=1) to a 2D line
    (D_distance_p2l_2D_f3, cudawrapper.cu:58-61)."""
    num = (line[..., 0] * p[..., 0] + line[..., 1] * p[..., 1]
           + line[..., 2]).abs()
    den = sqrt(line[..., 0] ** 2 + line[..., 1] ** 2)
    return num / den.clamp_min(EPS)


def segment_length_2d(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """2D length between homogeneous (z=1) points (cudawrapper.cu:95-99)."""
    d = p1[..., 0:2] - p2[..., 0:2]
    return sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def angle_between_dirs_deg(v1: torch.Tensor, v2: torch.Tensor):
    """Acute angle (degrees) between two (unnormalized) 3D directions
    (D_angle_between_lines_deg_3D_f3, cudawrapper.cu:118-130)."""
    n1 = v1 / _norm3(v1)[..., None].clamp_min(EPS)
    n2 = v2 / _norm3(v2)[..., None].clamp_min(EPS)
    d = (n1[..., 0] * n2[..., 0] + n1[..., 1] * n2[..., 1]
         + n1[..., 2] * n2[..., 2]).clamp(-1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(d))
    return torch.where(ang > 90.0, 180.0 - ang, ang)


def point_on_segment_2d(p1, p2, q):
    """True iff collinear q lies between p1 and p2 (cudawrapper.cu:135-141)."""
    v1 = p1[..., 0:2] - q[..., 0:2]
    v2 = p2[..., 0:2] - q[..., 0:2]
    return v1[..., 0] * v2[..., 0] + v1[..., 1] * v2[..., 1] < EPS


def segment_overlap_2d(src_p1, src_p2, q1, q2) -> torch.Tensor:
    """Relative overlap of segment (q1,q2) with (src_p1,src_p2), all four
    points collinear (branch-free D_segment_overlap_2D,
    cudawrapper.cu:209-252)."""
    len_src = segment_length_2d(src_p1, src_p2)
    len_tgt = segment_length_2d(q1, q2)

    q1_in = point_on_segment_2d(src_p1, src_p2, q1)
    q2_in = point_on_segment_2d(src_p1, src_p2, q2)
    p1_in = point_on_segment_2d(q1, q2, src_p1)
    p2_in = point_on_segment_2d(q1, q2, src_p2)

    def safe(x):
        return x.clamp_min(EPS)

    zero = torch.zeros((), dtype=len_src.dtype, device=len_src.device)
    c1 = len_tgt / safe(len_src)
    c2 = len_src / safe(len_tgt)
    len31 = segment_length_2d(src_p2, q2)
    len32 = segment_length_2d(src_p1, q2)
    c3a = segment_length_2d(q1, src_p1) / safe(len31)
    c3b = segment_length_2d(q1, src_p2) / safe(len32)
    c3 = torch.where(p1_in & (len31 > EPS), c3a,
                     torch.where(len32 > EPS, c3b, zero))
    len41 = segment_length_2d(src_p1, q1)
    len42 = segment_length_2d(src_p2, q1)
    c4a = segment_length_2d(q2, src_p2) / safe(len41)
    c4b = segment_length_2d(q2, src_p1) / safe(len42)
    c4 = torch.where(p2_in & (len41 > EPS), c4a,
                     torch.where(len42 > EPS, c4b, zero))

    overlap = torch.where(
        q1_in & q2_in, c1,
        torch.where(p1_in & p2_in, c2,
                    torch.where(q1_in, c3, torch.where(q2_in, c4, zero))))
    return torch.where((len_src < 1.0) | (len_tgt < 1.0), zero, overlap)


def apply_mat3(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3] -> [..., 3] with broadcasting, in full f32
    (the geometry must not ride a reduced-precision matmul path)."""
    return torch.stack([M[..., i, 0] * p[..., 0] + M[..., i, 1] * p[..., 1]
                        + M[..., i, 2] * p[..., 2] for i in range(3)],
                       dim=-1)


def epipolar_line(F: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Epipolar line l = F p (cudawrapper.cu:144-163, transpose=False)."""
    return apply_mat3(F, p)


def ray_dir(RtKinv: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Normalized viewing-ray direction through homogeneous pixel p
    (D_get_ray_src / D_get_ray_tgt, cudawrapper.cu:270-303)."""
    r = apply_mat3(RtKinv, p)
    return r / _norm3(r)[..., None].clamp_min(EPS)


def triangulation_depths(p1, p2, C1, C2, RtKinv1, RtKinv2):
    """Two-ray closest-point depths for a pixel correspondence
    (D_get_triangulation_depth, cudawrapper.cu:306-335).
    Returns (depth_for_cam1, depth_for_cam2, valid)."""
    ray1 = ray_dir(RtKinv1, p1)
    ray2 = ray_dir(RtKinv2, p2)
    w0 = C1 - C2

    def dot(u, v):
        return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] \
            + u[..., 2] * v[..., 2]

    a = dot(ray1, ray1)
    b = dot(ray1, ray2)
    c = dot(ray2, ray2)
    d = dot(ray1, w0)
    e = dot(ray2, w0)
    denom = a * c - b * b
    valid = denom.abs() > EPS
    safe_denom = torch.where(valid, denom, torch.ones_like(denom))
    minus1 = torch.full_like(denom, -1.0)
    d1 = torch.where(valid, (b * e - c * d) / safe_denom, minus1)
    d2 = torch.where(valid, (a * e - b * d) / safe_denom, minus1)
    return d1, d2, valid


def unproject(p, C, depth, RtKinv):
    """3D point at `depth` along the normalized ray through pixel p
    (D_unproject_point_src, cudawrapper.cu:338-344)."""
    return C + depth[..., None] * ray_dir(RtKinv, p)


def project(P3: torch.Tensor, Pmat: torch.Tensor):
    """Project 3D points with a [..., 3, 4] camera matrix; returns (pix,
    valid) with pix homogeneous z=1 (D_project_point_tgt,
    cudawrapper.cu:355-377)."""
    q = torch.stack([Pmat[..., i, 0] * P3[..., 0] + Pmat[..., i, 1] * P3[..., 1]
                     + Pmat[..., i, 2] * P3[..., 2] + Pmat[..., i, 3]
                     for i in range(3)], dim=-1)
    return normalize_hom(q)


def fundamental_from_rt(K1, R1, t1, K2, R2, t2):
    """Fundamental matrix mapping cam-1 points to cam-2 epipolar lines
    (Line3D::fundamental, line3D.cc:1968-1993): F = K2^-T [t]x R K1^-1 with
    R = R2 R1^T, t = t2 - R t1.  Computed in float64 numpy, as the
    reference does in Eigen doubles; production camera math lives in
    `core.cameras.CameraSet`."""
    K1, R1, t1, K2, R2, t2 = (np.asarray(a, np.float64)
                              for a in (K1, R1, t1, K2, R2, t2))
    R = R2 @ np.swapaxes(R1, -1, -2)
    t = t2 - np.einsum("...ij,...j->...i", R, t1)
    zeros = np.zeros_like(t[..., 0])
    Tx = np.stack([
        np.stack([zeros, -t[..., 2], t[..., 1]], axis=-1),
        np.stack([t[..., 2], zeros, -t[..., 0]], axis=-1),
        np.stack([-t[..., 1], t[..., 0], zeros], axis=-1),
    ], axis=-2)
    E = Tx @ R
    K2invT = np.swapaxes(np.linalg.inv(K2), -1, -2)
    return K2invT @ E @ np.linalg.inv(K1)
