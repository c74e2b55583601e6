"""Kernel K4: the collinearity keep plane of one view.

`collin_keep` launches the CUDA kernel `csrc/collin_keep.cu` (replacing
`line3d_tpu/match/collinearity_pallas.py:_kernel`) for CUDA tensors and runs
`collin_keep_plain`, the plain PyTorch twin, for CPU tensors.  There is no
fallback: a CUDA tensor either goes through the kernel or raises.

Both gate on squared distances with a relative widening of 1e-4, so the
plane is a superset of `collinearity.collinearity_matrix(...) > 0`; the
affinity is recomputed and regated at the compacted pairs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..native import cuda

EPS = 1e-12
# relative widening of the squared-distance gate (collinearity_pallas.py:32)
MARGIN = 1e-4

# launches of the CUDA kernel in this process
LAUNCHES = 0


def keep_threshold_sq(coll_sigma_sq, aff_threshold: float = 0.5) -> float:
    """thr^2 with exp(-d^2 / 2 sigma^2) > T  <=>  d^2 < 2 sigma^2 ln(1/T),
    widened by MARGIN; f32 arithmetic as in collinearity_keep_pallas."""
    f32 = np.float32
    neg_ln_t = f32(-np.log(aff_threshold))
    return float(f32(f32(f32(2.0) * f32(coll_sigma_sq)) * neg_ln_t)
                 * f32(1.0 + MARGIN))


def collin_keep_plain(segs, mask, thr_sq: float):
    """Keep plane [S, S] bool in plain PyTorch (collinearity_pallas.py
    formulation)."""
    p1x = segs[:, 0:1]; p1y = segs[:, 1:2]
    p2x = segs[:, 2:3]; p2y = segs[:, 3:4]
    q1x = segs[None, :, 0]; q1y = segs[None, :, 1]
    q2x = segs[None, :, 2]; q2y = segs[None, :, 3]

    lia = p1y - p2y; lib = p2x - p1x; lic = p1x * p2y - p1y * p2x
    lja = q1y - q2y; ljb = q2x - q1x; ljc = q1x * q2y - q1y * q2x
    den_i = lia * lia + lib * lib
    den_j = lja * lja + ljb * ljb

    # mutual max endpoint-to-line distances (cudawrapper.cu:509-511) on
    # squared numerators
    n1 = lja * p1x + ljb * p1y + ljc
    n2 = lja * p2x + ljb * p2y + ljc
    m1 = lia * q1x + lib * q1y + lic
    m2 = lia * q2x + lib * q2y + lic
    close = (torch.maximum(n1 * n1, n2 * n2) <= thr_sq * den_j) & \
            (torch.maximum(m1 * m1, m2 * m2) <= thr_sq * den_i) & \
            (den_i > EPS) & (den_j > EPS)

    def dot(ux, uy, vx, vy):
        return ux * vx + uy * vy

    pos1 = dot(q1x - p1x, q1y - p1y, q2x - p1x, q2y - p1y)
    pos2 = dot(q1x - p2x, q1y - p2y, q2x - p2x, q2y - p2y)
    pos3 = dot(p1x - q1x, p1y - q1y, p2x - q1x, p2y - q1y)
    pos4 = dot(p1x - q2x, p1y - q2y, p2x - q2x, p2y - q2y)
    no_overlap = (pos1 > -EPS) & (pos2 > -EPS) & (pos3 > -EPS) & \
                 (pos4 > -EPS)

    S = segs.shape[0]
    eye = torch.eye(S, dtype=torch.bool, device=segs.device)
    return close & no_overlap & mask[:, None] & mask[None, :] & ~eye


def collin_keep_cuda(segs, mask, thr_sq: float):
    """Keep plane [S, S] bool from the CUDA kernel (one launch)."""
    global LAUNCHES
    S = segs.shape[0]
    if segs.shape != (S, 4) or mask.shape != (S,):
        raise ValueError("collin_keep: inconsistent shapes")
    cuda.require_cuda("collin_keep", segs, mask,
                      dtypes=[torch.float32, torch.bool])
    out = torch.empty((S, S), dtype=torch.bool, device=segs.device)
    rc = cuda.lib().l3d_collin_keep(segs.data_ptr(), mask.data_ptr(),
                                    float(thr_sq), S, out.data_ptr(),
                                    cuda.stream_of(segs))
    cuda.check(rc, "l3d_collin_keep")
    LAUNCHES += 1
    return out


def collin_keep(segs, mask, thr_sq: float):
    """Keep plane [S, S]: the kernel on CUDA, the plain twin on the CPU."""
    if segs.device.type == "cpu":
        return collin_keep_plain(segs, mask, thr_sq)
    return collin_keep_cuda(segs, mask, thr_sq)
