"""The noisy-capture stages in numpy: replicator-dynamics diffusion in the
reference's lockstep form (cudawrapper.cu:717-829, line3D.cc:1255-1303)
and the Gauss-Newton refinement of each cluster's 3D line against its
members' 2D segments, both in float64; the control lowers their
precision.  Patterned on the port's float64 host forms; it imports nothing
of the program."""
from __future__ import annotations

import numpy as np
import torch


def diffuse(ei, ej, ew, n, iterations=10, eps=1e-12, dtype=torch.float64):
    """Lockstep RDD: the t-th entry of P's row j times the t-th entry of
    W's column i, row-normalised between steps, then min-symmetrised.
    The arithmetic runs in torch on the host in `dtype`.  Returns (i, j,
    w) sorted by (i, j), w as float64."""
    ei, ej = ei.astype(np.int64), ej.astype(np.int64)
    if not len(ew):
        return ei, ej, np.asarray(ew, np.float64)
    o = np.lexsort((ej, ei))
    ri, rj = ei[o], ej[o]
    rw = torch.as_tensor(np.asarray(ew, np.float64)[o]).to(dtype)
    cw = torch.as_tensor(np.asarray(ew, np.float64)[np.lexsort((ei, ej))]) \
        .to(dtype)
    deg = np.bincount(ri, minlength=n)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    trans = np.empty(len(ri), np.int64)
    trans[np.lexsort((ri, rj))] = np.arange(len(ri))
    t = np.arange(int(deg.max()))
    tm = t[None, :] < np.minimum(deg[rj], deg[ri])[:, None]
    iP = torch.as_tensor(np.where(tm, start[rj][:, None] + t[None, :], 0))
    iW = torch.as_tensor(np.where(tm, start[ri][:, None] + t[None, :], 0))
    tm = torch.as_tensor(tm).to(dtype)
    rows, trans = torch.as_tensor(ri), torch.as_tensor(trans)
    epsd = torch.tensor(eps, dtype=torch.float64).to(dtype)

    def normalize(pv):
        s = torch.zeros(n, dtype=dtype).index_add_(0, rows, pv)
        return pv / torch.maximum(s, epsd)[rows]
    pv = normalize(rw)
    for it in range(iterations):
        dot = (pv[iP] * cw[iW] * tm).sum(1)
        nv = torch.maximum(pv * dot, epsd)
        pv = torch.empty_like(pv)
        pv[trans] = nv
        if it < iterations - 1:
            pv = normalize(pv)
    w = pv.double().numpy()
    o = np.lexsort((rj, ri))
    i, j, w = ri[o], rj[o], w[o]
    return i, j, np.minimum(w, w[np.lexsort((i, j))])


def _basis(d):
    ref = np.where(np.abs(d[:, 0:1]) < 0.9, np.tile([1.0, 0, 0], (len(d), 1)),
                   np.tile([0, 1.0, 0], (len(d), 1)))
    u1 = np.cross(d, ref)
    u1 /= np.linalg.norm(u1, axis=1, keepdims=True)
    return u1, np.cross(d, u1)


def _residuals(P0, d, Pm, p1, p2, mask):
    ones = np.ones((len(P0), 1))
    xa = np.einsum("cmij,cj->cmi", Pm, np.concatenate([P0, ones], 1))
    xb = np.einsum("cmij,cj->cmi", Pm, np.concatenate([P0 + d, ones], 1))
    ln = np.cross(xa, xb)
    den = np.sqrt(ln[..., 0] ** 2 + ln[..., 1] ** 2)
    ok = (np.abs(xa[..., 2]) > 1e-12) & (np.abs(xb[..., 2]) > 1e-12) & \
        (den > 1e-12) & mask
    den = np.maximum(den, 1e-12)
    r = np.stack([(ln[..., 0] * p[..., 0] + ln[..., 1] * p[..., 1]
                   + ln[..., 2]) / den for p in (p1, p2)], -1)
    return np.where(ok[..., None], r, 0.0), ok


def refine(P0, d, Pm, p1, p2, mask, iterations=5, huber=2.0,
           damping=1e-6):
    """Per-cluster 4-parameter Gauss-Newton with Huber weights and a
    numeric Jacobian, a step kept only where it lowers the rms."""
    P0 = np.asarray(P0, np.float64).copy()
    d = np.asarray(d, np.float64).copy()
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    C = len(P0)
    n_res = np.maximum(mask.sum(1) * 2, 1)

    def rms(P, D):
        r, _ = _residuals(P, D, Pm, p1, p2, mask)
        return np.sqrt((r ** 2).sum((1, 2)) / n_res)
    h = 1e-6
    for _ in range(iterations):
        u1, u2 = _basis(d)
        r0, ok = _residuals(P0, d, Pm, p1, p2, mask)
        J = np.zeros(r0.shape + (4,))
        for k, (dp, dd) in enumerate(((u1, None), (u2, None),
                                      (None, u1), (None, u2))):
            Pp = P0 + h * dp if dp is not None else P0
            dn = d
            if dd is not None:
                dn = d + h * dd
                dn = dn / np.linalg.norm(dn, axis=1, keepdims=True)
            J[..., k] = (_residuals(Pp, dn, Pm, p1, p2, mask)[0] - r0) / h
        a = np.abs(r0)
        w = np.where(a <= huber, 1.0, np.sqrt(huber / np.maximum(a, 1e-12)))
        w = np.where(ok[..., None], w, 0.0)
        Jf = (J * w[..., None]).reshape(C, -1, 4)
        rf = (r0 * w).reshape(C, -1)
        H = np.einsum("cik,cil->ckl", Jf, Jf)
        g = np.einsum("cik,ci->ck", Jf, rf)
        H += damping * np.eye(4)[None] * \
            np.maximum(np.trace(H, axis1=1, axis2=2), 1.0)[:, None, None]
        step = np.linalg.solve(H, -g[..., None])[..., 0]
        Pn = P0 + step[:, 0:1] * u1 + step[:, 1:2] * u2
        dn = d + step[:, 2:3] * u1 + step[:, 3:4] * u2
        dn /= np.linalg.norm(dn, axis=1, keepdims=True)
        better = (rms(Pn, dn) < np.sqrt((r0 ** 2).sum((1, 2)) / n_res))
        P0 = np.where(better[:, None], Pn, P0)
        d = np.where(better[:, None], dn, d)
    return P0, d


def refined_lines(members, node_view, node_seg, best, S, segments, P_cond,
                  transform, iterations, rounding=None):
    """Each cluster's line fitted in conditioned space, refined against its
    members' 2D segments (`segments[v]` [S_v, 4], `P_cond` [V, 3, 4]
    float64) and mapped back to the original frame: (P [C, 3], d [C, 3])."""
    from .cluster import fit_line
    keys = best["view"].astype(np.int64) * S + best["seg"].astype(np.int64)
    row_of = {int(k): r for r, k in enumerate(keys)}
    C = len(members)
    Mx = max(len(ks) for ks in members)
    P0, d0 = np.zeros((C, 3)), np.zeros((C, 3))
    Pm = np.zeros((C, Mx, 3, 4))
    p1, p2 = np.zeros((C, Mx, 2)), np.zeros((C, Mx, 2))
    mask = np.zeros((C, Mx), bool)
    for c, ks in enumerate(members):
        rows = np.asarray([row_of[int(node_view[k]) * S + int(node_seg[k])]
                           for k in ks])
        pts = np.empty((2 * len(rows), 3))
        pts[0::2], pts[1::2] = best["P1"][rows], best["P2"][rows]
        P0[c], d0[c] = fit_line(pts)
        vs = node_view[ks]
        Pm[c, :len(ks)] = P_cond[vs]
        xy = np.stack([segments[v][s] for v, s in zip(vs, node_seg[ks])])
        p1[c, :len(ks)], p2[c, :len(ks)] = xy[:, 0:2], xy[:, 2:4]
        mask[c, :len(ks)] = True
    if rounding is not None:      # the control: inputs in a lower precision
        P0, d0, Pm, p1, p2 = (rounding(x) for x in (P0, d0, Pm, p1, p2))
    P, d = refine(P0, d0, Pm, p1, p2, mask, iterations)
    P = transform.inverse(P)
    d = (d / transform.scale) @ transform.R
    return P, d / np.linalg.norm(d, axis=1, keepdims=True)
