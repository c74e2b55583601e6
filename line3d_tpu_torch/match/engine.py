"""Per-view matching engine: pairwise matching + verification + selection.

Torch port of `line3d_tpu/match/engine.py` on one device.  Per view it
reproduces the reference's
  * per-view match table build (performMatching, line3D.cc:698-885),
  * confidence filter conf > 1.0, conf /= 2 (cudawrapper.cu:1089-1110),
  * per-view median depth from best raw matches (cudawrapper.cu:1025-1076),
  * greedy best-match selection per source segment with score = min(conf, 1)
    (greedySelection, line3D.cc:899-965; addMatches only_best,
    view.cc:162-183).

Every view is matched at its EXACT gate-passing capacity, the reference's
unbounded match list (cudawrapper.cu:923-1007): kernel K1 yields the valid
planes against all neighbors, their per-segment counts size the table
(m_total = pow2(max count), no block quota), and the same planes are
compacted, merged, re-triangulated and scored (K2/K3).  This is
`line3d_tpu`'s run_matching + apply_uncapped_fallback without the capped
first pass; a nonzero overflow raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import L3DConfig
from ..core.cameras import CameraSet
from ..scene import Scene
from . import pairwise
from .pairwise_cuda import pair_valid
from .scoring_cuda import score


@dataclasses.dataclass
class ViewMatches:
    """Filtered (verified) matches of one source view."""
    view: int
    src_seg: np.ndarray      # [K] int32
    tgt_view: np.ndarray     # [K] int32 (global view index)
    tgt_seg: np.ndarray      # [K] int32
    depths: np.ndarray | None = None       # [K, 4] float32
    confidence: np.ndarray | None = None   # [K] float32 (already / 2)
    overflow: int = 0
    # exact capacity of the view: max / sum over src segments of raw
    # gate-passing counts, and the match-slot width it was scored at
    need_capacity: int = 0
    total_candidates: int = 0
    m_total: int = 0


@dataclasses.dataclass
class BestMatches:
    """Per-(view, segment) best hypothesis — the clustering input.

    Mirrors best_match_ (line3D.h:133): for every source segment with at
    least one verified match, the highest-confidence one, unprojected to a 3D
    segment in conditioned space.
    """
    view: np.ndarray         # [B] int32
    seg: np.ndarray          # [B] int32
    tgt_view: np.ndarray     # [B] int32
    tgt_seg: np.ndarray      # [B] int32
    score: np.ndarray        # [B] float32 (min(conf, 1))
    P1: np.ndarray           # [B, 3] float64 (conditioned space)
    P2: np.ndarray           # [B, 3] float64
    dir: np.ndarray          # [B, 3] float64 normalized
    d1: np.ndarray           # [B] float32 depth of P1
    d2: np.ndarray           # [B] float32


def _best_rows_f64_batched(scene: Scene, cameras: CameraSet, v_arr, s_arr,
                           d1, d2, bconf, tgt_view, tgt_seg):
    """Unproject best matches in float64 and build the BestMatches row dict
    (unprojectSegment, view.cc:302-342)."""
    n = len(v_arr)
    coords = scene.segments[v_arr, s_arr].astype(np.float64)
    ones = np.ones((n, 1))
    p1 = np.concatenate([coords[:, 0:2], ones], axis=1)
    p2 = np.concatenate([coords[:, 2:4], ones], axis=1)
    M = cameras.RtKinv[v_arr]                       # [n, 3, 3]
    r1 = np.einsum("bij,bj->bi", M, p1)
    r1 /= np.linalg.norm(r1, axis=1, keepdims=True)
    r2 = np.einsum("bij,bj->bi", M, p2)
    r2 /= np.linalg.norm(r2, axis=1, keepdims=True)
    C = cameras.C[v_arr]
    P1 = C + r1 * np.asarray(d1, np.float64)[:, None]
    P2 = C + r2 * np.asarray(d2, np.float64)[:, None]
    dirv = P2 - P1
    nrm = np.linalg.norm(dirv, axis=1, keepdims=True)
    dirv = np.divide(dirv, nrm, out=np.zeros_like(dirv), where=nrm > 0)
    return dict(view=np.asarray(v_arr, np.int32),
                seg=np.asarray(s_arr, np.int32),
                tgt_view=np.asarray(tgt_view, np.int32),
                tgt_seg=np.asarray(tgt_seg, np.int32),
                score=np.asarray(bconf, np.float32),
                P1=P1, P2=P2, dir=dirv,
                d1=np.asarray(d1, np.float32),
                d2=np.asarray(d2, np.float32))


def _best_rows_f64(scene: Scene, cameras: CameraSet, v: int, bs, d1, d2,
                   bconf, tgt_view, tgt_seg):
    """One view's best rows (see _best_rows_f64_batched)."""
    return _best_rows_f64_batched(
        scene, cameras, np.full(len(bs), v, np.int64), np.asarray(bs),
        d1, d2, bconf, tgt_view, tgt_seg)


class ViewContext:
    """f32 camera tensors of a scene on the scene's device, for per-view
    matching calls."""

    def __init__(self, scene: Scene, cameras: CameraSet, config: L3DConfig):
        self.scene, self.cameras, self.config = scene, cameras, config
        self.device = scene.device

        def t(name):
            return torch.as_tensor(cameras.f32(name), device=self.device)

        self.RtKinv32 = t("RtKinv")
        self.C32 = t("C")
        self.P32 = t("P")
        self.spatial_ks = cameras.spatial_uncertainty_k(2.0 * config.sigma_p)

    def neighbor_arrays(self, v: int, nb: np.ndarray):
        """(segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb) of view v's
        neighbors `nb`, on the device."""
        F = self.cameras.fundamentals_for_pairs(
            np.stack([np.full(len(nb), v), nb], axis=1)).astype(np.float32)
        idx = torch.as_tensor(nb, dtype=torch.long, device=self.device)
        return (self.scene.segments_t[idx], self.scene.seg_mask_t[idx],
                torch.as_tensor(F, device=self.device), self.RtKinv32[idx],
                self.C32[idx], self.P32[idx])


def _pow2(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def match_view(ctx: ViewContext, v: int, nb: np.ndarray) -> dict:
    """One view's matching step at its exact capacity, on the scene's
    device.

    Returns a dict of tensors cam, tgt [S, M] int32, depths [S, M, 4] f32,
    valid [S, M] bool, conf [S, M] f32, and ints overflow, need, total and
    m_total."""
    cfg = ctx.config
    segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb = ctx.neighbor_arrays(v, nb)
    segs_src = ctx.scene.segments_t[v]
    mask_src = ctx.scene.seg_mask_t[v]
    RtKinv_src, C_src = ctx.RtKinv32[v], ctx.C32[v]
    N, S = len(nb), ctx.scene.max_segments

    # K1 against all neighbors; the counts are the view's exact capacity
    # (the reference's unbounded list length, cudawrapper.cu:923-944)
    valid_planes = pair_valid(segs_src, mask_src, segs_nb, mask_nb, F_nb,
                              RtKinv_src, RtKinv_nb, C_src, C_nb,
                              cfg.min_overlap_lower, cfg.min_overlap_upper)
    counts = valid_planes.sum(dim=2)                 # [N, S]
    need = int(counts.sum(dim=0).max())
    total = int(counts.sum())
    m_total = min(_pow2(need), N * S)

    # no block quota: compact_rows_blockq clamps the quota to the block
    res = pairwise.match_view_against_neighbors(
        segs_src, mask_src, RtKinv_src, C_src, segs_nb, mask_nb, F_nb,
        RtKinv_nb, C_nb, quota=128, min_capacity=m_total,
        valid=valid_planes)
    cam, tgt, valid = pairwise.merge_neighbor_tables(res, m_total, S)
    tcoords = pairwise.gather_target_coords(segs_nb, cam, tgt)
    depths = pairwise.depths_for_matches(
        segs_src, segs_nb, cam, tgt, valid, F_nb, RtKinv_src, RtKinv_nb,
        C_src, C_nb, tcoords=tcoords)
    conf = score(segs_src, RtKinv_src, C_src, cam, tgt, depths, valid, P_nb,
                 segs_nb, float(np.float32(cfg.sigma_p)),
                 float(np.float32(cfg.sigma_a)),
                 float(np.float32(ctx.spatial_ks[v])),
                 support_threshold=float(cfg.support_threshold),
                 tcoords=tcoords)

    n_kept = res["valid"].sum(dim=(0, 2))            # per src seg, all nbrs
    dropped = (n_kept - cam.shape[1]).clamp_min(0)
    overflow = int(res["overflow"].sum()) + int(dropped.sum())
    return dict(cam=cam, tgt=tgt, depths=depths, valid=valid, conf=conf,
                overflow=overflow, need=need, total=total, m_total=m_total)


def _select_view_outputs(ctx: ViewContext, v: int, nb: np.ndarray,
                         cam, tgt, depths, valid, conf, overflow: int,
                         verbose: bool = False):
    """Host-side selection for one view's match table: median depth,
    confidence filter, best-per-segment (cudawrapper.cu:1025-1110;
    greedySelection, line3D.cc:899-965).  argmax takes the FIRST maximum.

    Returns (ViewMatches, best_row_dict | None, median_depth)."""
    scene, cameras, config = ctx.scene, ctx.cameras, ctx.config

    # --- median depth (cudawrapper.cu:1025-1076) --------------------
    median_depth = 1.0
    conf_m = np.where(valid, conf, -np.inf)
    max_conf = conf_m.max(axis=1)
    arg = conf_m.argmax(axis=1)  # first max (ties)
    has = max_conf > config.confidence_threshold / 2.0
    if has.any():
        rows = np.nonzero(has)[0]
        dsel = depths[rows, arg[rows]][:, :2]   # (d1, d2) per segment
        dall = dsel.reshape(-1)                 # seg-order, d1 then d2
        dall_sorted = np.sort(dall, kind="stable")
        median_depth = float(dall_sorted[len(dall_sorted) // 2])

    # --- confidence filter (cudawrapper.cu:1089-1110) ----------------
    keep = valid & (conf > config.confidence_threshold)
    si, mi = np.nonzero(keep)
    vm = ViewMatches(
        view=v,
        src_seg=si.astype(np.int32),
        tgt_view=nb[cam[si, mi]].astype(np.int32),
        tgt_seg=tgt[si, mi].astype(np.int32),
        depths=depths[si, mi],
        confidence=(conf[si, mi] / config.confidence_norm).astype(np.float32),
        overflow=int(overflow))

    # --- best match per segment (greedySelection) --------------------
    best_row = None
    conf_f = np.where(keep, conf, -np.inf)
    bmax = conf_f.max(axis=1)
    barg = conf_f.argmax(axis=1)
    bs = np.nonzero(bmax > -np.inf)[0]
    if len(bs):
        bm = barg[bs]
        bconf = np.minimum(conf[bs, bm] / config.confidence_norm, 1.0)
        best_row = _best_rows_f64(
            scene, cameras, v, bs,
            depths[bs, bm, 0], depths[bs, bm, 1], bconf,
            nb[cam[bs, bm]], tgt[bs, bm])

    if verbose:
        print(f"[L3D] view {v}: {len(si)} verified matches, "
              f"median_depth={median_depth:.4f}, overflow={int(overflow)}")
    return vm, best_row, median_depth


def match_and_select_view(ctx: ViewContext, v: int, nb: np.ndarray,
                          verbose: bool = False):
    """match_view + host selection for one view.  Raises when the exact
    capacity still overflowed (engine.py:436-439 of line3d_tpu).

    Returns (ViewMatches, best_row | None, median_depth, raw) where raw
    holds the view's host numpy match table (cam, tgt, depths, valid,
    conf)."""
    o = match_view(ctx, v, nb)
    if o["overflow"] != 0:
        raise AssertionError(
            f"exact matching of view {v} overflowed ({o['overflow']}) at "
            f"capacity {o['m_total']} (needed {o['need']})")
    raw = {k: o[k].cpu().numpy()
           for k in ("cam", "tgt", "depths", "valid", "conf")}
    vm, best_row, med = _select_view_outputs(
        ctx, v, nb, raw["cam"], raw["tgt"], raw["depths"], raw["valid"],
        raw["conf"], 0, verbose=verbose)
    vm.need_capacity, vm.total_candidates = o["need"], o["total"]
    vm.m_total = o["m_total"]
    return vm, best_row, med, raw


def run_matching(scene: Scene, cameras: CameraSet, neighbors: list,
                 config: L3DConfig, verbose: bool = False):
    """Match + verify every view against its visual neighbors, on the
    scene's device.

    Returns (list[ViewMatches], BestMatches, median_depths [V] float64).
    Also sets cameras.median_depth (setMedianDepth, line3D.cc:835).
    """
    V = scene.num_views
    if max((len(n) for n in neighbors), default=0) == 0:
        return [], _empty_best(), np.ones(V)
    ctx = ViewContext(scene, cameras, config)
    all_matches, best_rows = [], []
    median_depths = np.ones(V)
    for v in range(V):
        nb = np.asarray(neighbors[v], np.int64)
        if len(nb) == 0:
            continue
        vm, best_row, median_depths[v], _ = match_and_select_view(
            ctx, v, nb, verbose=verbose)
        cameras.median_depth[v] = median_depths[v]
        all_matches.append(vm)
        if best_row is not None:
            best_rows.append(best_row)
    return all_matches, _concat_best(best_rows), median_depths


def _empty_best() -> BestMatches:
    z = np.zeros(0, np.int32)
    zf = np.zeros(0, np.float32)
    z3 = np.zeros((0, 3))
    return BestMatches(view=z, seg=z, tgt_view=z, tgt_seg=z, score=zf,
                       P1=z3, P2=z3, dir=z3, d1=zf, d2=zf)


def _concat_best(rows) -> BestMatches:
    if not rows:
        return _empty_best()
    cat = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    return BestMatches(**cat)
