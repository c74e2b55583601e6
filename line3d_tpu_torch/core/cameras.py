"""Camera bank: dense, array-first replacement for the reference's per-view
objects (reference: view.h:40-153, view.cc:6-147,227-261,353-377,446-449).

All V cameras live in stacked float64 numpy arrays (the reference uses Eigen
doubles for all camera math); float32 device copies are produced on demand for
the matching kernels.  Views are indexed densely 0..V-1 — callers keep their
own external-id mapping if ids are sparse.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CameraSet:
    K: np.ndarray        # [V, 3, 3] float64
    R: np.ndarray        # [V, 3, 3] float64
    t: np.ndarray        # [V, 3]    float64
    width: np.ndarray    # [V] int32  (original image width)
    height: np.ndarray   # [V] int32

    # derived (filled by `derive`)
    Kinv: np.ndarray = None      # [V, 3, 3]
    Rt: np.ndarray = None        # [V, 3, 3]  R^T
    RtKinv: np.ndarray = None    # [V, 3, 3]
    C: np.ndarray = None         # [V, 3] camera centers
    P: np.ndarray = None         # [V, 3, 4] projection K[R|t]
    k_lower: np.ndarray = None   # [V] uncertainty slope at depth 1 (lower)
    k_upper: np.ndarray = None   # [V] uncertainty slope at depth 1 (upper)
    median_depth: np.ndarray = None  # [V] set after matching (view.cc:44)

    uncertainty_lower_px: float = 1.0
    uncertainty_upper_px: float = 5.0

    def __post_init__(self):
        self.K = np.asarray(self.K, np.float64)
        self.R = np.asarray(self.R, np.float64)
        self.t = np.asarray(self.t, np.float64)
        self.width = np.asarray(self.width, np.int32)
        self.height = np.asarray(self.height, np.int32)
        if self.median_depth is None:
            self.median_depth = np.ones(self.num_views, np.float64)
        self.derive()

    @property
    def num_views(self) -> int:
        return self.K.shape[0]

    # ------------------------------------------------------------------
    def derive(self):
        """Recompute all derived matrices (view.cc:24-34, 243-257)."""
        self.Kinv = np.linalg.inv(self.K)
        self.Rt = np.swapaxes(self.R, -1, -2)
        self.RtKinv = self.Rt @ self.Kinv
        self.C = np.einsum("vij,vj->vi", self.Rt, -self.t)
        Rt34 = np.concatenate([self.R, self.t[:, :, None]], axis=2)
        self.P = self.K @ Rt34
        self._define_spatial_uncertainty()

    def _principal_points(self) -> np.ndarray:
        pp = np.stack([self.width / 2.0, self.height / 2.0,
                       np.ones(self.num_views)], axis=1)
        return pp.astype(np.float64)

    def spatial_uncertainty_k(self, dist_px: np.ndarray | float) -> np.ndarray:
        """Depth-1 3D uncertainty for a pixel offset of `dist_px`.

        Vectorized over views; mirrors specificSpatialUncertaintyK
        (view.cc:124-147): shift the principal point by dist_px in x, cast a
        ray, intersect with the depth-1 plane parallel to the image plane,
        measure the 3D offset.
        """
        pp = self._principal_points()
        n = np.einsum("vij,vj->vi", self.RtKinv, pp)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        Pplane = self.C + n  # point on depth-1 plane

        pp_shift = pp.copy()
        pp_shift[:, 0] = pp[:, 0] + dist_px
        d = np.einsum("vij,vj->vi", self.RtKinv, pp_shift)
        d /= np.linalg.norm(d, axis=1, keepdims=True)

        tt = (np.sum(Pplane * n, axis=1) - np.sum(n * self.C, axis=1)) / \
             np.sum(n * d, axis=1)
        Q = self.C + tt[:, None] * d
        return np.linalg.norm(Pplane - Q, axis=1)

    def _define_spatial_uncertainty(self):
        """k_upper/k_lower slopes (defineSpatialUncertainty, view.cc:90-121)."""
        self.k_upper = self.spatial_uncertainty_k(self.uncertainty_upper_px)
        self.k_lower = self.spatial_uncertainty_k(self.uncertainty_lower_px)

    # ------------------------------------------------------------------
    def baselines(self) -> np.ndarray:
        """[V, V] pairwise camera-center distances (view.cc:446-449)."""
        d = self.C[:, None, :] - self.C[None, :, :]
        return np.linalg.norm(d, axis=2)

    def fundamental(self, i: int, j: int) -> np.ndarray:
        """F mapping view-i points to view-j epipolar lines
        (line3D.cc:1968-1993)."""
        R = self.R[j] @ self.R[i].T
        t = self.t[j] - R @ self.t[i]
        Tx = np.array([[0.0, -t[2], t[1]],
                       [t[2], 0.0, -t[0]],
                       [-t[1], t[0], 0.0]])
        E = Tx @ R
        return np.linalg.inv(self.K[j]).T @ E @ np.linalg.inv(self.K[i])

    def fundamentals_for_pairs(self, pairs: np.ndarray) -> np.ndarray:
        """Batched fundamentals for an [E, 2] array of (src, tgt) pairs."""
        i, j = pairs[:, 0], pairs[:, 1]
        R = self.R[j] @ np.swapaxes(self.R[i], -1, -2)
        t = self.t[j] - np.einsum("eij,ej->ei", R, self.t[i])
        z = np.zeros(len(pairs))
        Tx = np.stack([
            np.stack([z, -t[:, 2], t[:, 1]], axis=1),
            np.stack([t[:, 2], z, -t[:, 0]], axis=1),
            np.stack([-t[:, 1], t[:, 0], z], axis=1),
        ], axis=1)
        E = Tx @ R
        return np.swapaxes(np.linalg.inv(self.K[j]), -1, -2) @ E @ \
            np.linalg.inv(self.K[i])

    # ------------------------------------------------------------------
    def transform(self, Qinv: np.ndarray, scale: float):
        """Apply the scene-conditioning transform to every camera
        (L3DView::transform, view.cc:227-261): t *= scale; [R|t] <- [R|t]Qinv.
        """
        self.t = self.t * scale
        Rt34 = np.concatenate([self.R, self.t[:, :, None]], axis=2)
        Rt34 = Rt34 @ Qinv[None, :, :]
        self.R = Rt34[:, :, :3]
        self.t = Rt34[:, :, 3]
        self.derive()

    # ------------------------------------------------------------------
    def lower_uncertainty(self, view_idx, depth):
        """get_lower_uncertainty (view.cc:353-359): k * min(depth, median)."""
        med = self.median_depth[view_idx]
        return self.k_lower[view_idx] * np.minimum(depth, med)

    def upper_uncertainty(self, view_idx, depth):
        med = self.median_depth[view_idx]
        return self.k_upper[view_idx] * np.minimum(depth, med)

    def uncertainty_sigma_sq(self, view_idx, depth):
        """get_uncertainty_sigma_squared (view.cc:371-377)."""
        d1 = self.lower_uncertainty(view_idx, depth)
        d2 = self.upper_uncertainty(view_idx, depth)
        return -(d2 - d1) ** 2 / (2.0 * np.log(0.01))

    # float32 device views -------------------------------------------------
    def f32(self, name: str) -> np.ndarray:
        return np.asarray(getattr(self, name), np.float32)
