"""The cluster stage in float64 numpy and plain Python loops: the affinity
graph in Line3D++'s traversal order, Felzenszwalb-Huttenlocher clustering
with its serial merge order, and the line fits with their sweep
(line3D.cc:968-1221, 1306-1597, 1600-1691; clustering.cc:6-47).

Patterned on line3d_tpu's loop paths, written as plain loops.  These
stages take the program's own stage inputs (best matches, verified
identities, collinear pairs, median depths, graph, labels), because
Line3D++'s order-dependent choices (borderline gates, near-tie picks)
make two independent runs diverge in structure; the start of the chain,
the match step and the collinearity, is checked on its own.  It imports
nothing of the program.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


def similarity(best, cams_k, median, src, tgt, sigma_a, dtype=np.float64):
    """similarity_coll3D (line3D.cc:1600-1681) of best-match row pairs:
    the smaller of the endpoint-distance and the angle similarities.
    `cams_k` is (k_lower, k_upper) per view, `median` the median depths."""
    k_lo, k_hi = cams_k
    P1, P2, D = (np.asarray(best[k], dtype) for k in ("P1", "P2", "dir"))
    d1 = np.asarray(best["d1"], np.float32).astype(dtype)
    d2 = np.asarray(best["d2"], np.float32).astype(dtype)
    view = best["view"]
    med = np.asarray(median, dtype)

    def p2l(a, b):               # endpoints of rows a against the line of b
        out = []
        for X in (P1[a], P2[a]):
            dx = X - P1[b]
            t = (dx * D[b]).sum(1)
            out.append(np.sqrt(np.maximum((dx * dx).sum(1) - t * t, 0.0)))
        return out

    def endpoint_sims(a, b):
        da, db = p2l(a, b)
        va = view[a]
        sims = []
        for dist, dep in ((da, d1[a]), (db, d2[a])):
            m = np.minimum(dep, med[va])
            lo = k_lo[va].astype(dtype) * m
            hi = k_hi[va].astype(dtype) * m
            s2 = -(hi - lo) ** 2 / (2.0 * np.log(dtype(0.01)))
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                e = np.exp(-(dist - lo) ** 2 / (2.0 * s2))
            sims.append(np.where(dist < lo, 1.0, e))
        return np.minimum(*sims)
    w_d = np.minimum(endpoint_sims(src, tgt), endpoint_sims(tgt, src))
    dots = np.clip((D[src] * D[tgt]).sum(1), -1.0, 1.0)
    ang = np.degrees(np.arccos(dots))
    ang = np.where(ang > 90.0, 180.0 - ang, ang)
    w_a = np.exp(-ang * ang / (2.0 * sigma_a * sigma_a))
    sim = np.minimum(w_d, w_a)
    return np.where(sim <= 0.01, 0.0, sim)


def affinity_graph(best, matches, collin, S, cams_k, median, cfg,
                   dtype=np.float64):
    """(edges_i, edges_j, edges_w float32, node_view, node_seg) in the
    reference's emission order.  `matches` is a list of (view, src_seg,
    tgt_view, tgt_seg) arrays; `collin` a list of {seg: {seg: w}} per
    view."""
    keys = best["view"].astype(np.int64) * S + best["seg"].astype(np.int64)
    row_of = {int(k): r for r, k in enumerate(keys)}
    adj = defaultdict(set)
    for v, s, tv, ts in matches:
        a = v * S + np.asarray(s, np.int64)
        b = np.asarray(tv, np.int64) * S + np.asarray(ts, np.int64)
        for x, y in zip(a.tolist(), b.tolist()):
            adj[x].add(y)
            adj[y].add(x)
    used = set()
    cand = []

    def consider(sk, sr, tk, kind, cw=1.0):
        pair = (sk, tk) if sk < tk else (tk, sk)
        if pair in used:
            return False
        used.add(pair)
        tr = row_of.get(tk)
        if tr is not None:
            cand.append((sr, tr, kind, cw))
        return True

    def partners(view, seg):
        m = collin[view].get(seg) if collin is not None else None
        return sorted(m.items()) if m else ()

    for r in np.argsort(keys, kind="stable").tolist():
        sk = int(keys[r])
        sv, ss = divmod(sk, S)
        for tk in sorted(adj.get(sk, ())):
            if consider(sk, r, tk, 0) and tk in row_of:
                tv, ts = divmod(tk, S)
                for cs, _ in partners(tv, ts):
                    consider(sk, r, tv * S + int(cs), 1)
        for cs, cw in partners(sv, ss):
            consider(sk, r, sv * S + int(cs), 2, float(cw))
    if not cand:
        z = np.zeros(0, np.int32)
        return z, z, np.zeros(0, np.float32), z, z
    src, tgt, kind, cws = (np.asarray(x) for x in zip(*cand))
    sim = similarity(best, cams_k, median, src, tgt, cfg["sigma_a"], dtype)
    score = np.asarray(best["score"], np.float32).astype(dtype)
    w = np.where(kind == 2, cws.astype(dtype), 1.0) * \
        (0.5 * (score[src] + score[tgt])) * sim
    thr = np.where(kind == 0, cfg["min_affinity"], cfg["collinear_affinity"])
    node_of, ei, ej, ew = {}, [], [], []
    for k in np.nonzero(w > thr)[0].tolist():
        a = node_of.setdefault(int(src[k]), len(node_of))
        b = node_of.setdefault(int(tgt[k]), len(node_of))
        ei += [a, b]
        ej += [b, a]
        ew += [w[k], w[k]]
    rows = np.fromiter(node_of.keys(), np.int64, len(node_of))
    return (np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.asarray(ew, np.float32), best["view"][rows].astype(np.int32),
            best["seg"][rows].astype(np.int32))


def fh_labels(ei, ej, ew, n, c=1.0, dtype=np.float64):
    """F-H over edges in ascending weight (stable): join when the weight is
    within both components' thresholds, threshold = w + c / size
    (clustering.cc:6-47, universe.h:60-115)."""
    order = np.argsort(ew, kind="stable")
    parent = list(range(n))
    rank = [0] * n
    size = [1] * n
    thr = [dtype(c)] * n

    def find(x):
        r = x
        while parent[r] != r:
            r = parent[r]
        parent[x] = r
        return r
    for a0, b0, w in zip(ei[order].tolist(), ej[order].tolist(),
                         ew[order].astype(dtype)):
        a, b = find(a0), find(b0)
        if a == b or not (w <= thr[a] and w <= thr[b]):
            continue
        if rank[a] > rank[b]:
            a, b = b, a
        parent[a] = b
        size[b] += size[a]
        if rank[a] == rank[b]:
            rank[b] += 1
        thr[b] = w + dtype(c) / dtype(size[b])
    return np.asarray([find(i) for i in range(n)], np.int64)


def clusters(labels, node_view, node_seg, min_cams):
    """Member (view, seg) lists of the clusters seen by min_cams views or
    more, in label order, members in (view, seg) order."""
    members = defaultdict(list)
    for k in np.lexsort((node_seg, node_view)).tolist():
        members[int(labels[k])].append(k)
    out = []
    for lab in sorted(members):
        ks = np.asarray(members[lab])
        if len(np.unique(node_view[ks])) >= min_cams:
            out.append(ks)
    return out


def fit_line(points):
    """Centroid and principal direction (line3D.cc:1392-1451)."""
    P = points.mean(axis=0)
    X = points - P
    U, Sv, _ = np.linalg.svd(X.T @ X)
    d = U[:, int(np.argmax(Sv))]
    n = np.linalg.norm(d)
    return P, d / n if n > 0 else np.array([1.0, 0.0, 0.0])


def sweep(points, seg_ids, cam_ids, P, d, min_open):
    """Sub-segments along the line where min_open or more cameras have a
    member segment open (line3D.cc:1479-1597)."""
    proj = P + ((points - P) @ d)[:, None] * d
    loc = (P - proj) @ d
    min_point, min_len = np.zeros(3), 0.0
    for e in range(len(points)):
        if loc[e] <= min_len:
            min_len, min_point = loc[e], proj[e]
    order = np.argsort(np.linalg.norm(points - min_point, axis=1),
                       kind="stable")
    out, open_seg, open_cam, opened, start = [], set(), {}, False, -1
    for e, (s, c) in enumerate(zip(seg_ids[order].tolist(),
                                   cam_ids[order].tolist())):
        if s not in open_seg:
            open_seg.add(s)
            open_cam[c] = open_cam.get(c, 0) + 1
        else:
            open_seg.discard(s)
            open_cam[c] -= 1
            if open_cam[c] == 0:
                del open_cam[c]
        if opened and len(open_cam) < min_open:
            out.append((start, e))
            opened = False
        elif not opened and len(open_cam) >= min_open:
            start, opened = e, True
    ps = points[order]
    return np.array([[ps[a], ps[b]] for a, b in out]).reshape(-1, 2, 3)


def fit_lines(members, node_view, node_seg, best, S, inverse, min_open,
              lines=None):
    """For each cluster ([K] node ids): its member (view, seg) ids and the
    sub-segments of its line in the original frame.  `lines`, when given,
    holds a (P, d) per cluster (refined, original frame) that the members'
    endpoints are snapped onto before the sweep."""
    keys = best["view"].astype(np.int64) * S + best["seg"].astype(np.int64)
    row_of = {int(k): r for r, k in enumerate(keys)}
    out = []
    for c, ks in enumerate(members):
        rows = np.asarray([row_of[int(node_view[k]) * S + int(node_seg[k])]
                           for k in ks])
        pts = np.empty((2 * len(rows), 3))
        pts[0::2] = inverse(best["P1"][rows])
        pts[1::2] = inverse(best["P2"][rows])
        if lines is None:
            P, d = fit_line(pts)
        else:
            P, d = lines[0][c], lines[1][c]
            pts = P + ((pts - P) @ d)[:, None] * d
        segs = sweep(pts, np.repeat(np.arange(len(rows)), 2),
                     np.repeat(node_view[ks], 2), P, d, min_open)
        out.append((node_view[ks], node_seg[ks], segs))
    return out
