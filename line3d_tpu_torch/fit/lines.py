"""Per-cluster 3D line estimation and sub-segment extraction.

Replicates processClusteredSegments / getLineEquation3D / projectToLine
(reference: line3D.cc:1306-1368, 1392-1451, 1479-1597):

  * clusters seen by >= 4 distinct cameras are kept,
  * member hypotheses' 3D endpoints are mapped back to the original
    coordinate frame (inverseTransform),
  * the dominant direction of the endpoint scatter matrix (principal axis
    via SVD) plus the centroid define the cluster's 3D line,
  * endpoints are ordered along the line (distance from the extremal
    projected point) and swept: sub-segments are emitted where >= 3 distinct
    cameras have an open segment.

All host-side float64 (the reference uses Eigen doubles); the sweep loop runs
in the native C++ library.  Copy of `line3d_tpu/fit/lines.py`'s batched path,
without refinement.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import L3DConfig
from ..core.conditioning import SceneTransform
from ..cluster.affinity import AffinityGraph
from ..match.engine import BestMatches
from ..native import load as native_load


@dataclasses.dataclass
class FinalLine3D:
    """One clustered 3D line (L3DFinalLine3D, commons.h:215-238)."""
    segments3d: np.ndarray   # [K, 2, 3] float64 sub-segments along the line
    views2d: np.ndarray      # [B] int32 member 2D segment view ids
    segs2d: np.ndarray       # [B] int32 member 2D segment ids


def process_clusters(graph: AffinityGraph, labels: np.ndarray,
                     best: BestMatches, transform: SceneTransform,
                     config: L3DConfig, max_segments: int,
                     verbose: bool = False) -> list:
    """Turn cluster labels into FinalLine3D results.

    The batched formulation of line3d_tpu (grouped numpy, one batched 3x3
    SVD and one native sweep call).  Line refinement and bundle adjustment
    (fit/refine.py, fit/bundle.py of line3d_tpu) are not ported yet.
    """
    if graph.num_nodes == 0:
        return []
    return _process_clusters_batched(native_load.get_lib(), graph, labels,
                                     best, transform, config, max_segments,
                                     verbose)


def _process_clusters_batched(lib, graph, labels, best, transform, config,
                              max_segments, verbose=False) -> list:
    """processClusteredSegments (line3D.cc:1306-1368) over all clusters at
    once: members in ascending (view, seg) order within ascending cluster
    label; the line fit (getLineEquation3D), extremal point and sweep
    (projectToLine) evaluated with grouped numpy reductions, one batched
    3x3 SVD, and a single native sweep call."""
    key_node = graph.node_view.astype(np.int64) * max_segments + \
        graph.node_seg.astype(np.int64)
    key_best = best.view.astype(np.int64) * max_segments + \
        best.seg.astype(np.int64)
    lookup = np.full(int(max(key_node.max(), key_best.max())) + 1, -1,
                     np.int64)
    lookup[key_best] = np.arange(best.view.size)
    node_rows = lookup[key_node]

    # sorted member stream: ascending cluster label, then (view, seg)
    order = np.lexsort((graph.node_seg, graph.node_view, labels))
    lab_s = labels[order]
    n = len(order)
    newc = np.empty(n, bool)
    newc[0] = True
    newc[1:] = lab_s[1:] != lab_s[:-1]
    cstart = np.flatnonzero(newc)
    csize = np.diff(np.append(cstart, n))
    num_clusters_total = len(cstart)

    # distinct cameras per cluster: view-change count within the
    # (label, view)-sorted stream (line3D.cc:1334)
    views_s = graph.node_view[order]
    vchange = np.empty(n, bool)
    vchange[0] = True
    vchange[1:] = (views_s[1:] != views_s[:-1]) | newc[1:]
    ncams = np.add.reduceat(vchange.astype(np.int64), cstart)
    keepc = ncams >= config.min_cameras_per_cluster
    if not keepc.any():
        if verbose:
            print(f"[L3D] #clusters_total: {num_clusters_total}  "
                  f"#clusters_valid: 0")
        return []

    members = order[np.repeat(keepc, csize)]
    sizes = csize[keepc]
    C = len(sizes)
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    cid_m = np.repeat(np.arange(C), sizes)

    rows = node_rows[members]
    P1 = transform.inverse_transform_points(best.P1[rows])
    P2 = transform.inverse_transform_points(best.P2[rows])
    n_tot = len(rows)
    pts = np.empty((2 * n_tot, 3))
    pts[0::2] = P1
    pts[1::2] = P2
    cid_e = np.repeat(cid_m, 2)
    eptr = 2 * ptr
    esizes = 2 * sizes
    local_m = np.arange(n_tot) - np.repeat(ptr[:-1], sizes)
    seg_e = np.repeat(local_m, 2)
    cam_e = np.repeat(graph.node_view[members].astype(np.int64), 2)

    # --- per-cluster line fit (getLineEquation3D, line3D.cc:1392-1451) --
    mean = np.add.reduceat(pts, eptr[:-1], axis=0) / esizes[:, None]
    X = pts - mean[cid_e]
    scat = np.empty((C, 3, 3))
    for i in range(3):
        for j in range(i, 3):
            s = np.add.reduceat(X[:, i] * X[:, j], eptr[:-1])
            scat[:, i, j] = s
            scat[:, j, i] = s
    U, S, _ = np.linalg.svd(scat)
    dirv = np.take_along_axis(
        U, np.argmax(S, axis=1)[:, None, None], axis=2)[:, :, 0]
    nrm = np.linalg.norm(dirv, axis=1, keepdims=True)
    dirv = np.where(nrm > 0, dirv / np.where(nrm > 0, nrm, 1.0),
                    np.array([1.0, 0.0, 0.0]))

    # --- extremal point + event order (projectToLine, line3D.cc:1479+) --
    de = dirv[cid_e]
    t = np.einsum("ij,ij->i", pts - mean[cid_e], de)
    proj = mean[cid_e] + t[:, None] * de
    loc = np.einsum("ij,ij->i", mean[cid_e] - proj, de)

    m = np.minimum.reduceat(loc, eptr[:-1])
    has = m <= 0.0                     # initial min_length is 0
    is_min = loc == m[cid_e]
    winner = np.full(C, -1, np.int64)
    idx = np.flatnonzero(is_min)
    np.maximum.at(winner, cid_e[idx], idx)   # ties -> later event wins
    min_point = np.zeros((C, 3))
    min_point[has] = proj[winner[has]]

    dist = np.linalg.norm(pts - min_point[cid_e], axis=1)
    sort_ord = np.lexsort((dist, cid_e))     # stable within cluster

    so = np.ascontiguousarray(seg_e[sort_ord])
    co = np.ascontiguousarray(cam_e[sort_ord])
    cap = 2 * n_tot
    out_s = np.empty(cap, np.int64)
    out_e = np.empty(cap, np.int64)
    out_c = np.empty(cap, np.int64)
    k = lib.sweep_events_batched(so, co, np.ascontiguousarray(eptr), C,
                                 config.min_cameras_open,
                                 int(co.max(initial=0)), out_s, out_e,
                                 out_c)
    pts_sorted = pts[sort_ord]
    seg3d = np.stack([pts_sorted[out_s[:k]], pts_sorted[out_e[:k]]],
                     axis=1)
    counts = np.bincount(out_c[:k], minlength=C)
    pstart = np.cumsum(counts) - counts

    views_m = graph.node_view[members].astype(np.int32)
    segs_m = graph.node_seg[members].astype(np.int32)
    results = []
    for c in np.flatnonzero(counts):
        results.append(FinalLine3D(
            segments3d=seg3d[pstart[c]:pstart[c] + counts[c]],
            views2d=views_m[ptr[c]:ptr[c + 1]],
            segs2d=segs_m[ptr[c]:ptr[c + 1]]))
    if verbose:
        print(f"[L3D] #clusters_total: {num_clusters_total}  "
              f"#clusters_valid: {len(results)}")
    return results
