"""Per-view matching engine: pairwise matching + verification + selection.

Torch port of `line3d_tpu/match/engine.py` on one device.  Per view it
reproduces the reference's
  * per-view match table build (performMatching, line3D.cc:698-885),
  * confidence filter conf > 1.0, conf /= 2 (cudawrapper.cu:1089-1110),
  * per-view median depth from best raw matches (cudawrapper.cu:1025-1076),
  * greedy best-match selection per source segment with score = min(conf, 1)
    (greedySelection, line3D.cc:899-965; addMatches only_best,
    view.cc:162-183).

Kernel K1 yields a view's valid planes against all its neighbors; the same
planes are counted, compacted, merged, re-triangulated and scored (K2/K3).
The three matching modes of `line3d_tpu` (pipeline.py:387-522) are built
from that step:
  * exact (the default): every view at its EXACT gate-passing capacity,
    the reference's unbounded match list (cudawrapper.cu:923-1007) —
    m_total = pow2(max per-segment count), no block quota, each
    neighbor's table cut to the view's own per-(segment, neighbor) bound
    before the merge (lossless); a nonzero overflow raises;
  * the capped pass (`run_matching(..., capped=True)`): every view at
    quota = config.match_block_quota and m_total =
    min(config.max_matches_per_segment, n_max * S); what the caps drop is
    counted in `ViewMatches.overflow`, not raised;
  * `apply_uncapped_fallback`: the overflowing views of a capped pass
    re-matched at exact capacity and spliced in.
Every pass also reduces K1's planes to the capacity-probe counters
(need, total, blockmax, nbmax; parallel/sharded.py:319-378 of
`line3d_tpu`), from which `decide_exact_capacities` picks the scene-wide
launch capacities that `line3d_tpu`'s one-pass mode would use.
Selection runs on the tables' device by default (`parallel.sharded.
device_select`, as on `line3d_tpu`'s default path), so the [S, M] tables
stay there; `_select_view_outputs` is its host twin.  Under N processes
(`parallel.multihost`) `match_views` splits the views across the ranks,
each on its own card, and all-gathers what each view's selection reads
back, so every rank decodes every view (line3d_tpu's global views mesh,
engine.py:655-720 there).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import L3DConfig
from ..core.cameras import CameraSet
from ..scene import Scene, upload
from ..parallel import multihost, sharded
from .. import trace
from . import pairwise
from .pairwise_cuda import pair_valid
from .scoring_cuda import score


@dataclasses.dataclass
class ViewMatches:
    """Filtered (verified) matches of one source view.

    The identities (src_seg, tgt_view, tgt_seg) are what clustering reads
    (cluster/affinity.py).  `depths` and `confidence` are filled only by
    the host selection (`match_views(..., device_selection=False)`,
    `Line3D(use_sharded_engine=False)`); under device selection,
    the default, they are None, as on `line3d_tpu`'s default path."""
    view: int
    src_seg: np.ndarray      # [K] int32
    tgt_view: np.ndarray     # [K] int32 (global view index)
    tgt_seg: np.ndarray      # [K] int32
    depths: np.ndarray | None = None       # [K, 4] float32
    confidence: np.ndarray | None = None   # [K] float32 (already / 2)
    overflow: int = 0
    # the capacity-probe counters of the view (max / sum over src segments
    # of raw gate-passing counts, max per (segment, target block) and per
    # (segment, neighbor)), and the match-slot width it was scored at
    need_capacity: int = 0
    total_candidates: int = 0
    block_max: int = 0
    nb_max: int = 0
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
            return upload(cameras.f32(name), self.device)

        self.RtKinv32 = t("RtKinv")
        self.C32 = t("C")
        self.P32 = t("P")
        self.spatial_ks = cameras.spatial_uncertainty_k(2.0 * config.sigma_p)

    def neighbor_arrays(self, v: int, nb: np.ndarray):
        """(segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb) of view v's
        neighbors `nb`, on the device."""
        F = self.cameras.fundamentals_for_pairs(
            np.stack([np.full(len(nb), v), nb], axis=1)).astype(np.float32)
        idx = upload(np.asarray(nb, np.int64), self.device)
        return (self.scene.segments_t[idx], self.scene.seg_mask_t[idx],
                upload(F, self.device), self.RtKinv32[idx], self.C32[idx],
                self.P32[idx])


def _pow2(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def match_view(ctx: ViewContext, v: int, nb: np.ndarray,
               caps: tuple | None = None) -> dict:
    """One view's matching step on the scene's device: at its exact
    capacity, or, with `caps` = (quota, m_total), at those caps.

    Returns a dict of tensors cam, tgt [S, M] int32, depths [S, M, 4] f32,
    valid [S, M] bool, conf [S, M] f32 and overflow (a scalar on the
    device, so that reading it costs no synchronisation here), and ints
    m_total and the probe counters need, total, blockmax and nbmax."""
    cfg = ctx.config
    dev = ctx.device
    segs_nb, mask_nb, F_nb, RtKinv_nb, C_nb, P_nb = ctx.neighbor_arrays(v, nb)
    segs_src = ctx.scene.segments_t[v]
    mask_src = ctx.scene.seg_mask_t[v]
    RtKinv_src, C_src = ctx.RtKinv32[v], ctx.C32[v]
    N, S = len(nb), ctx.scene.max_segments

    # K1 against all neighbors; the counts are the view's exact capacity
    # (the reference's unbounded list length, cudawrapper.cu:923-944)
    with trace.span("match.k1", dev):
        valid_planes = pair_valid(segs_src, mask_src, segs_nb, mask_nb,
                                  F_nb, RtKinv_src, RtKinv_nb, C_src, C_nb,
                                  cfg.min_overlap_lower,
                                  cfg.min_overlap_upper)
        need, total, blockmax, nbmax = plane_counters(valid_planes)
    quota, m_total, per_nb_cap = capacities(need, nbmax, N, S, caps)

    with trace.span("match.compact", dev):
        res = pairwise.match_view_against_neighbors(
            segs_src, mask_src, RtKinv_src, C_src, segs_nb, mask_nb, F_nb,
            RtKinv_nb, C_nb, quota=quota, min_capacity=m_total,
            valid=valid_planes, per_nb_cap=per_nb_cap)
        cam, tgt, valid = pairwise.merge_neighbor_tables(res, m_total, S)
        overflow = table_overflow(res, cam)
    with trace.span("match.depths", dev):
        tcoords = pairwise.gather_target_coords(segs_nb, cam, tgt)
        depths = pairwise.depths_for_matches(
            segs_src, segs_nb, cam, tgt, valid, F_nb, RtKinv_src, RtKinv_nb,
            C_src, C_nb, tcoords=tcoords)
    with trace.span("match.score", dev):
        conf = score(segs_src, RtKinv_src, C_src, cam, tgt, depths, valid,
                     P_nb, segs_nb, float(np.float32(cfg.sigma_p)),
                     float(np.float32(cfg.sigma_a)),
                     float(np.float32(ctx.spatial_ks[v])),
                     support_threshold=float(cfg.support_threshold),
                     tcoords=tcoords)
    return dict(cam=cam, tgt=tgt, depths=depths, valid=valid, conf=conf,
                overflow=overflow, need=need, total=total,
                blockmax=blockmax, nbmax=nbmax, m_total=cam.shape[1])


def plane_counters(valid_planes) -> list:
    """The capacity-probe counters [need, total, blockmax, nbmax] of a
    view's K1 planes [N, S, S], from one pass over them (the per-block sums
    give the per-neighbor counts) and one readback."""
    N, S, _ = valid_planes.shape
    blk = pairwise.block_size(S)
    block_counts = valid_planes.reshape(N, S, S // blk, blk).sum(dim=3)
    counts = block_counts.sum(dim=2)                 # [N, S]
    return trace.readback(torch.stack([
        counts.sum(dim=0).max(), counts.sum(), block_counts.max(),
        counts.max()]), "match.counters").tolist()


def capacities(need: int, nbmax: int, N: int, S: int,
               caps: tuple | None = None) -> tuple:
    """(quota, m_total, per_nb_cap) of a view's compaction and merge: its
    exact capacity from the probe counters, or, with `caps` = (quota,
    m_total), those caps and no per-neighbor cut.  At exact capacity there
    is no block quota (compact_rows_blockq clamps the quota to the block),
    and each neighbor's table is cut to the view's own per-(segment,
    neighbor) bound before the merge (kept wide enough for the N tables to
    fill m_total slots): both lossless."""
    if caps is not None:
        return caps[0], caps[1], None
    m_total = min(_pow2(need), N * S)
    return 128, m_total, max(_pow2(nbmax), -(-m_total // N))


def table_overflow(res: dict, cam):
    """What a view's compaction (`res`) and merge into `cam` [S, M] dropped,
    as a scalar on the device."""
    n_kept = res["valid"].sum(dim=(0, 2))            # per src seg, all nbrs
    dropped = (n_kept - cam.shape[1]).clamp_min(0)
    return res["overflow"].sum() + dropped.sum()


def _select_view_outputs(ctx: ViewContext, v: int, nb: np.ndarray,
                         cam, tgt, depths, valid, conf, overflow: int,
                         verbose: bool = False):
    """Host-side selection for one view's match table: median depth,
    confidence filter, best-per-segment (cudawrapper.cu:1025-1110;
    greedySelection, line3D.cc:899-965).  argmax takes the FIRST maximum.
    The host twin of `parallel.sharded.device_select`.

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


def _assemble_view_outputs(ctx: ViewContext, v: int, nb: np.ndarray,
                           sel: dict, verbose: bool = False):
    """(ViewMatches, best_row | None, median_depth) from `device_select`'s
    unpacked buffer (line3d_tpu's _assemble_view_outputs, engine.py:449-484
    there): identities only, best rows unprojected in float64 on the host,
    the median from the device."""
    S = ctx.scene.max_segments
    median_depth = float(sel["median_depth"]) if sel["median_has"] else 1.0
    src, camslot, tgt = sharded.unpack_export(sel["exp_packed"], S, len(nb))
    vm = ViewMatches(view=v, src_seg=src,
                     tgt_view=nb[camslot].astype(np.int32), tgt_seg=tgt,
                     overflow=sel["overflow"])
    best_row = None
    bs = np.nonzero(sel["best_has"])[0]
    if len(bs):
        bconf = np.minimum(sel["best_conf"][bs] / ctx.config.confidence_norm,
                           1.0)
        best_d = sel["best_depths"]
        best_row = _best_rows_f64(
            ctx.scene, ctx.cameras, v, bs, best_d[bs, 0], best_d[bs, 1],
            bconf, nb[sel["best_cam"][bs]], sel["best_tgt"][bs])
    if verbose:
        print(f"[L3D] view {v}: {len(src)} verified matches, "
              f"median_depth={median_depth:.4f}, overflow={vm.overflow}")
    return vm, best_row, median_depth


# the per-view counters that cross between ranks beside the selection
# buffer, in this order
_COUNTERS = ("need", "total", "blockmax", "nbmax", "m_total")


def match_views(ctx: ViewContext, neighbors, views,
                caps: tuple | None = None, verbose: bool = False,
                device_selection: bool = True,
                tables: dict | None = None) -> dict:
    """match_view + selection for each of `views` that has neighbours:
    {v: (ViewMatches, best_row | None, median_depth)}, ascending.  Without
    `caps` a view raises when the exact capacity still overflowed
    (engine.py:436-439 of line3d_tpu); with them the overflow is counted
    in the ViewMatches.

    With `device_selection` (the default, line3d_tpu's default path) the
    selection runs where the tables live (`parallel.sharded.
    device_select`) and one int32 buffer of O(S + verified) values crosses
    to the host: an exact view synchronises three times (the probe
    counters, the export's count, the buffer's copy; each a
    `trace.readback`), and the ViewMatches holds identities only.  Each
    process matches the views of its range (`multihost.local_range`; all
    of them in a single process) on its own card, the selection buffers
    and counters are all-gathered, and every rank assembles every view in
    view order, so all ranks hold the single-process result.

    Without it the five tables are copied to the host and
    `_select_view_outputs` selects there.  Under N > 1 that would gather
    every view's [S, M] tables, so it raises (line3d_tpu's multi-process
    path is its sharded engine).

    `tables`, when a dict, receives the match table (cam, tgt, depths,
    valid, conf) of each view this process matched, as tensors on the
    scene's device."""
    views = [int(v) for v in sorted(views) if len(neighbors[v])]
    nb = {v: np.asarray(neighbors[v], np.int64) for v in views}
    nproc = multihost.process_count()
    if not device_selection and nproc > 1:
        raise ValueError(
            f"matching over {nproc} processes needs the device selection "
            "(use_sharded_engine=True): the host selection would gather "
            "every view's [S, M] match tables")
    lo, hi = multihost.local_range(ctx.scene.num_views)
    out, heads, bufs = {}, [], []
    for v in views:
        if not lo <= v < hi:
            continue
        o = match_view(ctx, v, nb[v], caps)
        table = {k: o[k] for k in ("cam", "tgt", "depths", "valid", "conf")}
        if tables is not None:
            tables[v] = table
        if device_selection:
            with trace.span("match.select", ctx.device):
                sel = sharded.device_select(
                    *table.values(), ctx.config.confidence_threshold,
                    len(nb[v]), o["overflow"])
            buf = trace.readback(sel, "match.selection")
            heads.append([v, len(buf)] + [o[k] for k in _COUNTERS])
            bufs.append(buf)
            continue
        raw = {k: trace.readback(x, "match.tables")
               for k, x in table.items()}
        vm, best_row, med = _select_view_outputs(
            ctx, v, nb[v], raw["cam"], raw["tgt"], raw["depths"],
            raw["valid"], raw["conf"],
            int(trace.readback(o["overflow"], "match.overflow")),
            verbose=verbose)
        _check_and_count(vm, v, caps, o)
        out[v] = (vm, best_row, med)
    if not device_selection:
        return out
    with trace.span("match.gather"):
        heads = np.concatenate(multihost.allgather_array(
            np.asarray(heads, np.int64).reshape(-1, 2 + len(_COUNTERS))))
        flat = np.concatenate(multihost.allgather_array(
            np.concatenate(bufs) if bufs else np.zeros(0, np.int32)))
    if [int(v) for v in heads[:, 0]] != views:
        raise RuntimeError(f"gathered views {heads[:, 0].tolist()}, "
                           f"expected {views}")
    with trace.span("match.assemble"):
        for row, end in zip(heads.tolist(),
                            np.cumsum(heads[:, 1]).tolist()):
            v, n = row[0], row[1]
            vm, best_row, med = _assemble_view_outputs(
                ctx, v, nb[v], sharded.unpack_selection(
                    flat[end - n:end], ctx.scene.max_segments),
                verbose=verbose)
            _check_and_count(vm, v, caps, dict(zip(_COUNTERS, row[2:])))
            out[v] = (vm, best_row, med)
    return out


def _check_and_count(vm: ViewMatches, v: int, caps: tuple | None, o):
    """Raise when an exact view overflowed; copy the probe counters and
    the match-slot width into the ViewMatches."""
    if caps is None and vm.overflow != 0:
        raise AssertionError(
            f"exact matching of view {v} overflowed ({vm.overflow}) at "
            f"capacity {o['m_total']} (needed {o['need']})")
    vm.need_capacity, vm.total_candidates = o["need"], o["total"]
    vm.block_max, vm.nb_max = o["blockmax"], o["nbmax"]
    vm.m_total = o["m_total"]


def run_matching(scene: Scene, cameras: CameraSet, neighbors: list,
                 config: L3DConfig, verbose: bool = False,
                 capped: bool = False, device_selection: bool = True):
    """Match + verify every view against its visual neighbors, on the
    scene's device: each view at its exact capacity, or with `capped` every
    view at the config's caps (line3d_tpu's run_matching,
    engine.py:296-333), where dropped matches are counted per view.  Each
    view selects on the device unless `device_selection` is False; under
    N processes each rank matches its own views and all ranks get every
    view's result (match_views).

    Returns (list[ViewMatches], BestMatches, median_depths [V] float64).
    Also sets cameras.median_depth (setMedianDepth, line3D.cc:835).
    """
    V = scene.num_views
    n_max = max((len(n) for n in neighbors), default=0)
    if n_max == 0:
        return [], _empty_best(), np.ones(V)
    ctx = ViewContext(scene, cameras, config)
    # a segment can match up to S targets in each of n_max neighbors, so
    # n_max*S (not S) is the true uncapped per-segment capacity
    caps = (config.match_block_quota,
            min(config.max_matches_per_segment,
                n_max * scene.max_segments)) if capped else None
    per_view = match_views(ctx, neighbors, range(V), caps=caps,
                           verbose=verbose,
                           device_selection=device_selection)
    all_matches, best_rows = [], []
    median_depths = np.ones(V)
    for v, (vm, best_row, med) in per_view.items():
        median_depths[v] = cameras.median_depth[v] = med
        all_matches.append(vm)
        if best_row is not None:
            best_rows.append(best_row)
    return all_matches, _concat_best(best_rows), median_depths


def probe_counters(matches: list, num_views: int):
    """(need, total, blockmax, nbmax), each [V] int64, of a matching pass:
    the capacity probe's per-view counters (zeros for views without
    neighbors), as line3d_tpu's finalize_capacity_probe returns them."""
    out = np.zeros((4, num_views), np.int64)
    for vm in matches:
        out[:, vm.view] = (vm.need_capacity, vm.total_candidates,
                           vm.block_max, vm.nb_max)
    return tuple(out)


def decide_exact_capacities(need, total, blockmax, nbmax,
                            config: L3DConfig, n_max: int, S: int,
                            k_export_per_seg: int = 8):
    """The single-pass launch capacities line3d_tpu picks from the probe
    counters (engine.py:773-835 there).

    Returns None when the DEFAULT capacities are already exact for every
    view, else a dict of capacities bucketed as line3d_tpu buckets them:
    m_total to the next power of two, the block quota to
    {default, 32, 64, 128}, k_export to the next power of two of the
    strict gate-passing bound (verified is a subset of gate-passing, so an
    export of that size can never drop), and the per-neighbor
    second-compaction width to pow2(nbmax) when that is narrower than the
    block-compacted table.
    """
    need_max = int(np.max(need, initial=0))
    total_max = int(np.max(total, initial=0))
    bmax = int(np.max(blockmax, initial=0))
    nbm = int(np.max(nbmax, initial=0))

    # compact_rows_blockq raises the per-block quota to cover min_capacity
    # (= m_total) and caps it at the block width; the lossless test must
    # use that EFFECTIVE quota
    blk = pairwise.block_size(S)
    B = S // blk

    def eff_quota(q, m):
        return min(max(q, -(-m // B)), blk)

    quota0 = config.match_block_quota
    m0 = min(config.max_matches_per_segment, n_max * S)
    k0 = min(S * k_export_per_seg, S * m0)
    if need_max <= m0 and bmax <= eff_quota(quota0, m0) and total_max <= k0:
        return None

    m_total = min(max(_pow2(need_max), m0), n_max * S)
    quota = 128
    for q in (quota0, 32, 64, 128):
        if eff_quota(q, m_total) >= bmax:
            quota = q
            break
    k_export = min(max(_pow2(total_max), k0), S * m_total)
    # block-compaction capacity per neighbor at the LAUNCH capacities; the
    # second compaction only helps if its pow2 width is smaller
    cap1 = B * eff_quota(quota, m_total)
    nb_cap = _pow2(nbm)
    per_nb_cap = nb_cap if nb_cap < cap1 else None
    return dict(quota=quota, m_total=m_total, k_export=k_export,
                per_nb_cap=per_nb_cap,
                need=need_max, total=total_max, blockmax=bmax, nbmax=nbm)


def rematch_views_exact(scene: Scene, cameras: CameraSet, neighbors: list,
                        config: L3DConfig, views, verbose: bool = False,
                        device_selection: bool = True):
    """Re-match `views` at their exact gate-passing capacity — reference
    semantics (every raw match kept, cudawrapper.cu:923-1007).

    Scoring, selection, and the median depth are view-local (support comes
    only from the view's own match table), so re-running just the
    overflowing views at sufficient capacity reproduces a fully uncapped
    run.

    Returns {view: (ViewMatches, best_row | None, median_depth)}.
    """
    out = match_views(ViewContext(scene, cameras, config), neighbors,
                      views, verbose=verbose,
                      device_selection=device_selection)
    if verbose:
        for v, (vm, _, _) in out.items():
            print(f"[L3D] view {v}: re-matched uncapped "
                  f"(capacity {vm.need_capacity} -> m_total {vm.m_total}, "
                  f"{len(vm.src_seg)} verified)")
    return out


def apply_uncapped_fallback(matches, best, median_depths,
                            scene: Scene, cameras: CameraSet,
                            neighbors: list, config: L3DConfig,
                            verbose: bool = False,
                            device_selection: bool = True):
    """Reference-exactness guard over a finished capped pass.

    Views whose overflow counter is zero are provably identical to an
    uncapped run (the caps only drop matches).  The rest are re-matched at
    exact capacity (rematch_views_exact) and their results spliced in.

    Returns (matches, best, median_depths, num_rematched)."""
    over = [vm.view for vm in matches if vm.overflow > 0]
    if not over:
        return matches, best, median_depths, 0
    if verbose:
        print(f"[L3D] uncapped fallback: re-matching {len(over)} "
              f"overflowing view(s) {over}")
    repl = rematch_views_exact(scene, cameras, neighbors, config, over,
                               verbose=verbose,
                               device_selection=device_selection)

    matches = [repl[vm.view][0] if vm.view in repl else vm for vm in matches]
    median_depths = median_depths.copy()
    for v, (_vm, _row, med) in repl.items():
        median_depths[v] = med
        cameras.median_depth[v] = med

    # rebuild BestMatches in view-ascending order (the concatenation order
    # is part of the downstream determinism contract), taking each view's
    # rows from the replacement when one exists
    views_all = sorted({int(x) for x in np.unique(best.view)} | set(repl))
    rows = []
    for v in views_all:
        if v in repl:
            if repl[v][1] is not None:
                rows.append(repl[v][1])
        else:
            m = best.view == v
            rows.append({f.name: getattr(best, f.name)[m]
                         for f in dataclasses.fields(best)})
    return matches, _concat_best(rows), median_depths, len(over)


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
