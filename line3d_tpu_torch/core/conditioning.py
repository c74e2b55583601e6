"""Scene conditioning: similarity transform that normalizes the camera-center
cloud to COG 0 and mean spread sqrt(2) before matching, for numerical
stability (reference: Line3D::transformGeometry line3D.cc:552-617,
findSimilarityTransform 1694-1718, euclideanTransformation 1721-1755,
applyTransformation 1758-1779, inverseTransform 1782-1786).

All in float64 numpy — the reference does this in Eigen doubles, and the
precision here bounds the accuracy of everything downstream.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SceneTransform:
    scale: float
    R: np.ndarray           # [3,3]
    t: np.ndarray           # [3]
    Qinv: np.ndarray        # [4,4]
    scale_inv: float
    Rinv: np.ndarray        # [3,3] (= R^T)
    tneg: np.ndarray        # [3]

    def inverse_transform_points(self, P: np.ndarray) -> np.ndarray:
        """Map conditioned-space points back to original coordinates
        (line3D.cc:1782-1786): R^T (P/s - t)."""
        return (P * self.scale_inv + self.tneg) @ self.Rinv.T


def _kabsch(inp: np.ndarray, cog_in: np.ndarray,
            out: np.ndarray, cog_out: np.ndarray):
    """Euclidean transform minimizing |out - (R inp + t)| (Kabsch SVD),
    following euclideanTransformation (line3D.cc:1721-1755)."""
    X = inp - cog_in
    Y = out - cog_out
    H = Y.T @ X
    U, _, Vt = np.linalg.svd(H)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        Vt = Vt.copy()
        Vt[2, :] *= -1
        R = U @ Vt
    t = cog_out - R @ cog_in
    return R, t


def compute_conditioning(centers: np.ndarray) -> SceneTransform:
    """Compute the conditioning similarity transform from camera centers.

    Mirrors transformGeometry (line3D.cc:552-613): target = centers shifted to
    COG 0 and scaled so the mean distance from COG becomes sqrt(2); the
    similarity (scale, R, t) is then recovered via per-point scale averaging +
    Kabsch, exactly as findSimilarityTransform does.
    """
    centers = np.asarray(centers, np.float64)
    n = len(centers)
    m = centers.mean(axis=0)
    q = np.linalg.norm(centers - m, axis=1).mean()
    q = np.sqrt(2.0) / q

    out_points = (centers - m) * q
    cog_out = out_points.mean(axis=0)

    # findSimilarityTransform (line3D.cc:1694-1718).  The reference
    # divides d2/d1 unguarded and NaNs when a camera center coincides
    # with the centroid (degenerate collinear-symmetric rigs); skipping
    # those points is exact for every non-degenerate scene (each term
    # then equals q) and keeps degenerate ones finite.
    d1 = np.linalg.norm(centers - m, axis=1)
    d2 = np.linalg.norm(out_points - cog_out, axis=1)
    ok = d1 > 1e-15
    scale = float((d2[ok] / d1[ok]).mean()) if ok.any() else 1.0

    cog_in = m * scale
    inp_scaled = centers * scale
    R, t = _kabsch(inp_scaled, cog_in, out_points, cog_out)
    t = t / scale

    # applyTransformation (line3D.cc:1758-1771)
    Q = np.eye(4)
    Q[:3, :3] = R
    Q[:3, 3] = t * scale
    Qinv = np.linalg.inv(Q)

    return SceneTransform(scale=scale, R=R, t=t, Qinv=Qinv,
                          scale_inv=1.0 / scale, Rinv=R.T, tneg=-t)
