"""Cameras, scene conditioning and visual neighbours, in float64 numpy.

A plain restatement of Line3D++'s camera bookkeeping (view.cc,
line3D.cc:476-617, 1694-1786): the derived matrices, the conditioning
similarity transform, the view similarity from shared worldpoints and the
greedy neighbour choice.  It imports nothing of the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Cams:
    K: np.ndarray
    R: np.ndarray
    t: np.ndarray
    width: np.ndarray
    height: np.ndarray
    lower_px: float = 1.0
    upper_px: float = 5.0

    def __post_init__(self):
        self.derive()

    @property
    def num_views(self):
        return len(self.K)

    def derive(self):
        self.Kinv = np.linalg.inv(self.K)
        Rt = np.swapaxes(self.R, -1, -2)
        self.RtKinv = Rt @ self.Kinv
        self.C = np.einsum("vij,vj->vi", Rt, -self.t)
        self.P = self.K @ np.concatenate([self.R, self.t[:, :, None]], axis=2)
        self.k_upper = self.spatial_k(self.upper_px)
        self.k_lower = self.spatial_k(self.lower_px)

    def spatial_k(self, dist_px):
        """Depth-1 3D offset of a `dist_px` pixel shift at the principal
        point (view.cc:124-147)."""
        V = self.num_views
        pp = np.stack([self.width / 2.0, self.height / 2.0, np.ones(V)],
                      axis=1).astype(np.float64)
        n = np.einsum("vij,vj->vi", self.RtKinv, pp)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        Pplane = self.C + n
        sh = pp.copy()
        sh[:, 0] = pp[:, 0] + dist_px
        d = np.einsum("vij,vj->vi", self.RtKinv, sh)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tt = (np.sum(Pplane * n, axis=1) - np.sum(n * self.C, axis=1)) / \
            np.sum(n * d, axis=1)
        return np.linalg.norm(Pplane - (self.C + tt[:, None] * d), axis=1)

    def fundamentals(self, i, js):
        """F of view i against each view of js ([N, 3, 3])."""
        out = []
        for j in js:
            R = self.R[j] @ self.R[i].T
            t = self.t[j] - R @ self.t[i]
            Tx = np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]],
                           [-t[1], t[0], 0.0]])
            out.append(np.linalg.inv(self.K[j]).T @ (Tx @ R)
                       @ np.linalg.inv(self.K[i]))
        return np.stack(out)

    def condition(self, Qinv, scale):
        """[R|t] <- [R | t scale] Qinv (view.cc:227-261)."""
        t = self.t * scale
        Rt34 = np.concatenate([self.R, t[:, :, None]], axis=2) @ Qinv[None]
        self.R, self.t = Rt34[:, :, :3], Rt34[:, :, 3]
        self.derive()


@dataclasses.dataclass
class Transform:
    scale: float
    R: np.ndarray
    t: np.ndarray
    Qinv: np.ndarray

    def inverse(self, P):
        """Conditioned points back to the original frame: R^T (P/s - t)."""
        return (P / self.scale - self.t) @ self.R


def conditioning(centers) -> Transform:
    """COG 0 and mean spread sqrt(2), as a similarity recovered by scale
    averaging and Kabsch (line3D.cc:552-613, 1694-1771)."""
    centers = np.asarray(centers, np.float64)
    m = centers.mean(axis=0)
    q = np.sqrt(2.0) / np.linalg.norm(centers - m, axis=1).mean()
    out = (centers - m) * q
    cog_out = out.mean(axis=0)
    d1 = np.linalg.norm(centers - m, axis=1)
    d2 = np.linalg.norm(out - cog_out, axis=1)
    ok = d1 > 1e-15
    scale = float((d2[ok] / d1[ok]).mean()) if ok.any() else 1.0
    cog_in = m * scale
    X = centers * scale - cog_in
    Y = out - cog_out
    U, _, Vt = np.linalg.svd(Y.T @ X)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        Vt = Vt.copy()
        Vt[2, :] *= -1
        R = U @ Vt
    t = (cog_out - R @ cog_in) / scale
    Q = np.eye(4)
    Q[:3, :3] = R
    Q[:3, 3] = t * scale
    return Transform(scale, R, t, np.linalg.inv(Q))


def view_similarity(wp_lists, V):
    """sim(v, n) = 2 common / (num(v) + num(n)) over worldpoints that three
    or more views see (line3D.cc:476-501, 1874-1935)."""
    seen = {}
    for v in range(V):
        for w in set(int(x) for x in wp_lists[v] if x >= 0):
            seen.setdefault(w, []).append(v)
    common = np.zeros((V, V), np.int64)
    num = np.zeros(V, np.int64)
    for views in seen.values():
        if len(views) < 3:
            continue
        idx = np.asarray(views)
        num[idx] += 1
        common[np.ix_(idx, idx)] += 1
    np.fill_diagonal(common, 0)
    den = num[:, None] + num[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(den > 0, 2.0 * common / den, 0.0)


def neighbors(sim, C, min_baseline, max_neighbors, eps=1e-12):
    """Greedy neighbours in ascending id order, each far enough from the
    view and from every one accepted before it, then the most similar
    `max_neighbors` (line3D.cc:503-548); sorted ascending."""
    V = len(sim)
    base = np.linalg.norm(C[:, None] - C[None], axis=2)
    out = []
    for v in range(V):
        acc = []
        for n in range(V):
            if n == v or not sim[v, n] > eps or not base[v, n] > min_baseline:
                continue
            if all(base[a, n] > min_baseline for a in acc):
                acc.append(n)
        acc = np.asarray(acc, np.int64)
        if len(acc):
            acc = acc[np.argsort(-sim[v, acc], kind="stable")]
            if max_neighbors > 0:
                acc = acc[:max_neighbors]
        out.append(np.sort(acc))
    return out
