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
in the native C++ library.  Copy of `line3d_tpu/fit/lines.py`'s batched
path; its refine path (`_process_clusters_loop` with refine=True: line
refinement, fit/refine.py, or joint camera + line bundle adjustment,
fit/bundle.py) runs through the same batched grouping and sweep, with the
cluster's line taken from the refinement and its member endpoints snapped
onto that line before the sweep.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import L3DConfig
from ..core.conditioning import SceneTransform
from ..cluster.affinity import AffinityGraph
from ..match.engine import BestMatches
from ..native import load as native_load
from .. import trace


@dataclasses.dataclass
class FinalLine3D:
    """One clustered 3D line (L3DFinalLine3D, commons.h:215-238)."""
    segments3d: np.ndarray   # [K, 2, 3] float64 sub-segments along the line
    views2d: np.ndarray      # [B] int32 member 2D segment view ids
    segs2d: np.ndarray       # [B] int32 member 2D segment ids


def process_clusters(graph: AffinityGraph, labels: np.ndarray,
                     best: BestMatches, transform: SceneTransform,
                     config: L3DConfig, max_segments: int,
                     verbose: bool = False, refine: bool = False,
                     scene_segments: np.ndarray | None = None,
                     P_cond: np.ndarray | None = None, cameras=None,
                     *, device, out_info: dict | None = None) -> list:
    """Turn cluster labels into FinalLine3D results.

    The batched formulation of line3d_tpu (grouped numpy, one batched 3x3
    SVD and one native sweep call).  With refine=True (an additive
    capability beyond the reference), each cluster's 3D line is refined
    against its member 2D segments before the sweep and the emitted
    endpoints are snapped onto the refined line: by fit.refine on
    scene_segments [V, S, 4] and the conditioned projection matrices
    P_cond [V, 3, 4] (float64), or, with config.bundle_adjust_cameras, by
    fit.bundle jointly with the conditioned `cameras`' poses, whose result
    lands in out_info (ba_rms_before/after, R_cond, t_cond).  The device
    forms run on `device`, each rank on its own blocks of clusters
    (`parallel/multihost.py`); the host refinement runs on every rank.
    Either refinement gives out_info the clusters and members it refined
    (refine_clusters, refine_members).
    """
    if graph.num_nodes == 0:
        return []
    lib = native_load.get_lib()
    key_node = graph.node_view.astype(np.int64) * max_segments + \
        graph.node_seg.astype(np.int64)
    key_best = best.view.astype(np.int64) * max_segments + \
        best.seg.astype(np.int64)
    lookup = np.full(int(max(key_node.max(), key_best.max())) + 1, -1,
                     np.int64)
    lookup[key_best] = np.arange(best.view.size)
    node_rows = lookup[key_node]

    # sorted member stream: ascending cluster label, then (view, seg) (the
    # reference's maps are ordered by L3DSegment2D, line3D.cc:1311-1321)
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
    n_tot = len(rows)

    def endpoints(P1, P2):
        pts = np.empty((2 * n_tot, 3))
        pts[0::2] = P1
        pts[1::2] = P2
        return pts
    pts = endpoints(transform.inverse_transform_points(best.P1[rows]),
                    transform.inverse_transform_points(best.P2[rows]))
    cid_e = np.repeat(cid_m, 2)
    eptr = 2 * ptr
    local_m = np.arange(n_tot) - np.repeat(ptr[:-1], sizes)
    seg_e = np.repeat(local_m, 2)
    cam_e = np.repeat(graph.node_view[members].astype(np.int64), 2)
    views_m = graph.node_view[members].astype(np.int32)
    segs_m = graph.node_seg[members].astype(np.int32)

    if refine:
        # initial fits in CONDITIONED space (better numerics), then the
        # batched Gauss-Newton against the member 2D segments
        P0, d0 = _fit_lines(endpoints(best.P1[rows], best.P2[rows]), eptr,
                            cid_e)
        mviews = np.split(views_m, ptr[1:-1])
        msegs = np.split(segs_m, ptr[1:-1])
        # stage fit.refine: the member data, the solve, its readback
        with trace.stage("fit.refine"):
            mean, dirv = _refine(P0, d0, mviews, msegs, transform, config,
                                 scene_segments, P_cond, cameras, device,
                                 out_info, verbose)
        trace.count("refine.clusters", C)
        trace.count("refine.members", n_tot)
        if out_info is not None:
            out_info.update(refine_clusters=C, refine_members=n_tot)
        # snap member endpoints onto the refined line before sweeping
        de = dirv[cid_e]
        pts = mean[cid_e] + np.einsum("ij,ij->i", pts - mean[cid_e],
                                      de)[:, None] * de
    else:
        mean, dirv = _fit_lines(pts, eptr, cid_e)

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


def _fit_lines(pts, eptr, cid_e):
    """Per-cluster centroid and principal direction of an endpoint cloud
    (getLineEquation3D, line3D.cc:1392-1451), for all clusters at once:
    grouped reductions and one batched 3x3 SVD."""
    C = len(eptr) - 1
    esizes = np.diff(eptr)
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
    return mean, dirv


def _refine(P0, d0, mviews, msegs, transform, config, scene_segments,
            P_cond, cameras, device, out_info, verbose):
    """Refined (P0, d) per cluster, mapped back to the original frame
    (line3d_tpu/fit/lines.py:189-245)."""
    from ..cluster.diffusion import resolve_backend
    from . import bundle as bundle_mod, refine as refine_mod
    if config.bundle_adjust_cameras and cameras is not None:
        # joint camera + line BA: line blocks Schur-eliminated, the
        # reduced [6V, 6V] camera system solved on the device
        vb, p1b, p2b, mb = bundle_mod.build_bundle_member_data(
            mviews, msegs, scene_segments)
        P0r, dr, Rf, tf, ba_b, ba_a = bundle_mod.bundle_adjust(
            P0, d0, cameras.K, cameras.R, cameras.t, vb, p1b, p2b, mb,
            iterations=config.bundle_iterations, device=device)
        if out_info is not None:
            out_info.update(ba_rms_before=ba_b, ba_rms_after=ba_a,
                            R_cond=Rf, t_cond=tf)
        if verbose:
            print(f"[L3D] bundle adjustment: rms {ba_b:.3f} -> {ba_a:.3f} "
                  f"px over {len(P0)} lines + {len(cameras.K)} cameras")
    else:
        Pm, p1, p2, mask = refine_mod.build_cluster_member_data(
            mviews, msegs, scene_segments, P_cond)
        if resolve_backend(config.refine_backend, device) == "device":
            P0r, dr, rms_b, rms_a = refine_mod.refine_lines_device(
                P0, d0, Pm, p1, p2, mask,
                iterations=config.refine_iterations, device=device)
        else:
            P0r, dr, rms_b, rms_a = refine_mod.refine_lines(
                P0, d0, Pm, p1, p2, mask,
                iterations=config.refine_iterations)
        if verbose:
            print(f"[L3D] refinement: median rms {np.median(rms_b):.3f} -> "
                  f"{np.median(rms_a):.3f} px over {len(P0)} lines")
    # map refined lines back to the original frame:
    # X = R^T (X'/s - t) => points map through inverse_transform, and
    # directions map as R^T d (scale cancels under normalization)
    P0r = transform.inverse_transform_points(P0r)
    dr = (dr * transform.scale_inv) @ transform.Rinv.T
    return P0r, dr / np.linalg.norm(dr, axis=1, keepdims=True)
