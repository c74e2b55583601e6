"""Per-view 2D collinearity in plain PyTorch (cudawrapper.cu:476-535,
segments.h:73-101): every segment pair of a view, the mutual largest
endpoint-to-line distance under a Gaussian of sigma, kept above the
threshold when the two segments do not overlap along their direction.
`dtype` float32 is the reference, bfloat16 the control.  It imports
nothing of the program."""
from __future__ import annotations

import numpy as np
import torch

from .match import EPS, sqrt


def pairs(segs, sigma, threshold, device, dtype=torch.float32):
    """(i, j, w) of one view's collinear pairs, (i, j) ascending; segs is
    [S, 4] float32."""
    s = torch.as_tensor(segs, device=device).to(dtype)
    p1x, p1y, p2x, p2y = (s[:, k] for k in range(4))
    a, b = p1y - p2y, p2x - p1x
    c = p1x * p2y - p1y * p2x
    den = sqrt(a * a + b * b).clamp_min(EPS)

    def dist(x, y):            # [i, j]: point i against line j
        return (a[None, :] * x[:, None] + b[None, :] * y[:, None]
                + c[None, :]).abs() / den[None, :]
    d = torch.maximum(dist(p1x, p1y), dist(p2x, p2y))
    d = torch.maximum(d, d.T)
    two_s2 = torch.full((), 2.0 * float(np.float32(sigma * sigma)),
                        dtype=dtype, device=s.device)
    aff = torch.exp(-d * d / two_s2)

    def dot(ux, uy, vx, vy):
        return ux * vx + uy * vy
    ax, ay = p1x[:, None], p1y[:, None]
    bx, by = p2x[:, None], p2y[:, None]
    cx, cy = p1x[None, :], p1y[None, :]
    ex, ey = p2x[None, :], p2y[None, :]
    no_overlap = (dot(cx - ax, cy - ay, ex - ax, ey - ay) > -EPS) & \
        (dot(cx - bx, cy - by, ex - bx, ey - by) > -EPS) & \
        (dot(ax - cx, ay - cy, bx - cx, by - cy) > -EPS) & \
        (dot(ax - ex, ay - ey, bx - ex, by - ey) > -EPS)
    S = s.shape[0]
    keep = (aff > threshold) & no_overlap & \
        ~torch.eye(S, dtype=torch.bool, device=s.device)
    i, j = torch.nonzero(keep, as_tuple=True)
    return i.cpu().numpy(), j.cpu().numpy(), aff[i, j].float().cpu().numpy()
