"""Per-view 2D segment collinearity.

Torch port of `line3d_tpu/match/collinearity.py`, the equivalent of
K_collinearity (reference: cudawrapper.cu:476-535) launched from
L3DSegments (segments.h:73-101): for every segment pair in one view, a
mutual max endpoint-to-line distance Gaussian (sigma = 2.0, commons.h:48),
kept if > 0.5 (L3D_COLLIN_AFF_T_G) AND the segments do not overlap along
their common direction.

`collinearity_compact_all` turns every view's segments into a flat pair
list sorted by (i, j): on the card by kernel K4 (`collinearity_cuda`, one
fused launch sequence for all views), on the CPU by its plain twin
`collinearity_compact_all_plain` (per view: the keep plane, compaction per
128-partner block, the affinity recomputed and regated at the kept pairs by
`_pair_aff`, then one merge sort).  `collinearity_maps_fast` makes every
view's map exact with that one call: a first pass at the block quota and
per-view cap, then the views it dropped pairs of again with no quota and a
list as long as their candidate counts.  `collinearity_matrix`, the dense
form, is the twin tests hold the keep plane against.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from ..core import geometry as g
from .collinearity_cuda import block_quota, collin_keep_plain, \
    collin_pairs_cuda, keep_threshold_sq
from .pairwise import block_size, compact_rows_blockq
from ..parallel import multihost
from .. import trace


def _two_sigma_sq(coll_sigma_sq, like):
    """2 sigma^2 as a float32 tensor on `like`'s device.  Dividing by a
    tensor is a true IEEE divide on every device, as in K4 and the
    reference; dividing by a Python number is, on a CUDA device, a multiply
    by its reciprocal, which rounds differently unless 2 sigma^2 is a power
    of two."""
    return torch.full((), 2.0 * float(coll_sigma_sq), dtype=like.dtype,
                      device=like.device)


def collinearity_matrix(segs, mask, coll_sigma_sq, aff_threshold=0.5):
    """Dense [S, S] collinearity scores for one view (0 where not collinear).

    Args:
      segs: [S, 4] float32; mask: [S] bool; coll_sigma_sq: sigma^2.
      aff_threshold: keep gate (L3D_COLLIN_AFF_T_G = 0.5, cudawrapper.h:44).
    """
    p1, p2 = g.seg_endpoints(segs)
    line = g.line_through(p1, p2)                   # [S, 3]

    # mutual max endpoint-to-line distances (cudawrapper.cu:509-511)
    d_p_on_q = torch.maximum(
        g.dist_point_line_2d(line[None, :, :], p1[:, None, :]),
        g.dist_point_line_2d(line[None, :, :], p2[:, None, :]))
    d = torch.maximum(d_p_on_q, d_p_on_q.T)
    aff = torch.exp(-d * d / _two_sigma_sq(coll_sigma_sq, d))

    # no-overlap check (cudawrapper.cu:518-528)
    a1 = p1[:, None, 0:2]
    a2 = p2[:, None, 0:2]
    b1 = p1[None, :, 0:2]
    b2 = p2[None, :, 0:2]

    def dot(u, v):
        return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]

    eps = g.EPS
    no_overlap = (dot(b1 - a1, b2 - a1) > -eps) & \
        (dot(b1 - a2, b2 - a2) > -eps) & \
        (dot(a1 - b1, a2 - b1) > -eps) & (dot(a1 - b2, a2 - b2) > -eps)

    S = segs.shape[0]
    keep = (aff > aff_threshold) & no_overlap & mask[:, None] & \
        mask[None, :] & ~torch.eye(S, dtype=torch.bool, device=segs.device)
    return torch.where(keep, aff, torch.zeros_like(aff))


def _pair_aff(si, sj, mask_i, mask_j, not_self, coll_sigma_sq,
              aff_threshold: float = 0.5):
    """Collinearity affinity for explicit segment pairs: si [S, 4] row
    segments, sj [S, K, 4] partners.  Same math as collinearity_matrix at
    the given pairs; returns [S, K] weights (0 where gated out)."""
    p1x, p1y = si[:, 0:1], si[:, 1:2]
    p2x, p2y = si[:, 2:3], si[:, 3:4]
    q1x, q1y = sj[..., 0], sj[..., 1]
    q2x, q2y = sj[..., 2], sj[..., 3]

    lia = p1y - p2y; lib = p2x - p1x; lic = p1x * p2y - p1y * p2x  # [S, 1]
    lja = q1y - q2y; ljb = q2x - q1x; ljc = q1x * q2y - q1y * q2x  # [S, K]

    def dist(a, b, c, x, y):
        den = g.sqrt((a * a + b * b).clamp_min(g.EPS))
        return (a * x + b * y + c).abs() / den

    d = torch.maximum(
        torch.maximum(dist(lja, ljb, ljc, p1x, p1y),
                      dist(lja, ljb, ljc, p2x, p2y)),
        torch.maximum(dist(lia, lib, lic, q1x, q1y),
                      dist(lia, lib, lic, q2x, q2y)))
    aff = torch.exp(-d * d / _two_sigma_sq(coll_sigma_sq, d))

    def dot(ux, uy, vx, vy):
        return ux * vx + uy * vy

    pos1 = dot(q1x - p1x, q1y - p1y, q2x - p1x, q2y - p1y)
    pos2 = dot(q1x - p2x, q1y - p2y, q2x - p2x, q2y - p2y)
    pos3 = dot(p1x - q1x, p1y - q1y, p2x - q1x, p2y - q1y)
    pos4 = dot(p1x - q2x, p1y - q2y, p2x - q2x, p2y - q2y)
    eps = g.EPS
    no_overlap = (pos1 > -eps) & (pos2 > -eps) & (pos3 > -eps) & \
        (pos4 > -eps)

    keep = (aff > aff_threshold) & no_overlap & mask_i & mask_j & not_self
    return torch.where(keep, aff, torch.zeros_like(aff))


def _pairs_cap(S: int, K: int, pairs_per_seg: int = 4) -> int:
    """Per-view cap on exported collinear pairs (shape-derived)."""
    return min(S * K, max(8192, pairs_per_seg * S))


def pairs_capacity(S: int, quota: int = 8, pairs_per_seg: int = 4) -> int:
    """C, the width of `collinearity_compact_all`'s per-view lists: the
    cap over S rows of S // blk blocks of the quota's candidates."""
    blk, q = block_quota(S, quota)
    return _pairs_cap(S, S // blk * q, pairs_per_seg)


def collinearity_compact_all(segments, masks, coll_sigma_sq, quota=8,
                             pairs_per_seg: int = 4,
                             aff_threshold: float = 0.5,
                             capacity: int | None = None):
    """All views' collinearity maps compacted to flat pair lists.

    segments [V, S, 4] f32 and masks [V, S] bool tensors (on one device):
    kernel K4 for CUDA tensors, the plain twin for CPU tensors.  Each view
    keeps, per row and block of `block_quota(S, quota)[0]` partners, the
    first `quota` keep-plane candidates whose recomputed affinity passes
    `aff_threshold`, as i*S+j keys in (i, j) order, cut to the first C
    (`capacity`, else `pairs_capacity`).

    Returns (pairs [V, C] int32 packed i*S+j (-1 pads),
             w [V, C] f32 (0 pads),
             count [V] int64 true pre-quota keep-plane count).
    """
    if segments.device.type == "cpu":
        return collinearity_compact_all_plain(
            segments, masks, coll_sigma_sq, quota=quota,
            pairs_per_seg=pairs_per_seg, aff_threshold=aff_threshold,
            capacity=capacity)
    if capacity is None:
        capacity = pairs_capacity(segments.shape[1], quota, pairs_per_seg)
    return collin_pairs_cuda(
        segments, masks, keep_threshold_sq(coll_sigma_sq, aff_threshold),
        float(np.float32(coll_sigma_sq)), aff_threshold, quota, capacity)


def collinearity_compact_all_plain(segments, masks, coll_sigma_sq, quota=8,
                                   pairs_per_seg: int = 4,
                                   aff_threshold: float = 0.5,
                                   capacity: int | None = None):
    """`collinearity_compact_all` in plain PyTorch, K4's twin: per view the
    keep plane, block compaction (compact_rows_blockq), the affinity
    recomputed at the kept pairs, and the pairs packed as i*S+j keys merged
    by one sort into a flat [C] list."""
    V, S, _ = segments.shape
    dev = segments.device
    thr_sq = keep_threshold_sq(coll_sigma_sq, aff_threshold)
    sig2 = float(np.float32(coll_sigma_sq))
    tgts, ws, counts = [], [], []
    for v in range(V):
        segs, mask = segments[v], masks[v]
        keep = collin_keep_plain(segs, mask, thr_sq)
        tgt, kept, n_valid = compact_rows_blockq(keep, quota)
        sj = segs[tgt.clamp_min(0).long()]          # [S, K, 4]
        row = torch.arange(S, dtype=torch.int32, device=dev)[:, None]
        # kept slots come from the keep plane, which already gated on
        # mask_i & mask_j
        w = _pair_aff(segs, sj, mask[:, None], kept, tgt != row, sig2,
                      aff_threshold=aff_threshold)
        tgts.append(tgt)
        ws.append(w)
        counts.append(n_valid.sum())
    tgt = torch.stack(tgts)
    w = torch.stack(ws)
    K = tgt.shape[2]
    C = _pairs_cap(S, K, pairs_per_seg) if capacity is None else capacity
    row = torch.arange(S, dtype=torch.int32, device=dev)[None, :, None]
    key = torch.where(w > 0.0, row * S + tgt,
                      torch.full_like(tgt, S * S)).reshape(V, S * K)
    skey, order = torch.sort(key, dim=1, stable=True)
    sw = torch.gather(w.reshape(V, S * K), 1, order)
    skey, sw = skey[:, :C], sw[:, :C]
    valid = skey < S * S
    return (torch.where(valid, skey, torch.full_like(skey, -1)),
            torch.where(valid, sw, torch.zeros_like(sw)),
            torch.stack(counts))


class CollinMaps(Sequence):
    """Per-view sparse collinearity maps as flat pair arrays sorted by
    (view, i, j): flat_view, flat_i, flat_j [P] int32, flat_w [P] f32.
    Indexing view v gives its {seg_i: {seg_j: w}} dict (the
    L3DSegments::collinearities shape, segments.h:115-117), built from
    them the first time and cached; the pipeline reads the arrays only.

    dropped_per_view [V] int64: the pairs the first pass's quota and cap
    dropped in each view (up to: its candidates are counted before the
    regate), line3d_tpu's counters; views_exact: the views
    `collinearity_maps_fast` re-ran at exact capacity.
    """

    def __init__(self, num_views: int, flat_view, flat_i, flat_j, flat_w,
                 dropped_per_view=None, views_exact=()):
        self.num_views = num_views
        self.flat_view, self.flat_i, self.flat_j, self.flat_w = \
            flat_view, flat_i, flat_j, flat_w
        self.dropped_per_view = np.zeros(num_views, np.int64) \
            if dropped_per_view is None else dropped_per_view
        self.views_exact = np.asarray(views_exact, np.int64)
        self._views: dict = {}

    @property
    def dropped_total(self) -> int:
        return int(self.dropped_per_view.sum())

    def __len__(self):
        return self.num_views

    def __getitem__(self, v):
        v = range(self.num_views)[v]
        if v not in self._views:
            lo, hi = np.searchsorted(self.flat_view, [v, v + 1])
            d = self._views[v] = {}
            for i, j, w in zip(self.flat_i[lo:hi].tolist(),
                               self.flat_j[lo:hi].tolist(),
                               self.flat_w[lo:hi].tolist()):
                d.setdefault(i, {})[j] = w
        return self._views[v]


def _decode(pairs, w, views, S: int):
    """(view, i, j, w) of the kept slots of lists `pairs` / `w` [n, C] of
    views `views` [n] int32, in (view, i, j) order."""
    r, c = np.nonzero(pairs >= 0)
    return views[r], pairs[r, c] // S, pairs[r, c] % S, w[r, c]


def collinearity_finalize(pairs, w, count, max_segments: int,
                          num_views: int | None = None):
    """The CollinMaps of a collinearity_compact_all result, with each
    view's pairs dropped by the quota and cap counted from `count`."""
    pairs, w, count = np.asarray(pairs), np.asarray(w), np.asarray(count)
    V = pairs.shape[0] if num_views is None else num_views
    pairs, w = pairs[:V], w[:V]
    dropped = np.maximum(count[:V].astype(np.int64)
                         - (pairs >= 0).sum(axis=1), 0)
    return CollinMaps(V, *_decode(pairs, w, np.arange(V, dtype=np.int32),
                                  max_segments), dropped_per_view=dropped)


def _rerun_exact(maps: CollinMaps, count, segments, masks, sig2,
                 aff_threshold: float) -> CollinMaps:
    """`maps` with the views that dropped pairs computed again with no
    quota and a list as long as their largest candidate count, so that
    nothing drops (collinearity is view-local, cudawrapper.cu:833-855);
    raises if a view's candidates outnumber the list."""
    views = np.flatnonzero(maps.dropped_per_view).astype(np.int32)
    S = masks.shape[1]
    cap = int(count[views].max())
    idx = torch.as_tensor(views, dtype=torch.int64, device=segments.device)
    pairs, w, n = [trace.readback(x, "collin.exact")
                   for x in collinearity_compact_all(
                       segments[idx], masks[idx], sig2,
                       quota=block_size(S), aff_threshold=aff_threshold,
                       capacity=cap)]
    if (n > cap).any():
        raise AssertionError(
            f"exact collinearity of view {views[np.argmax(n)]} overflowed: "
            f"{n.max()} candidates at capacity {cap}")
    old = ~np.isin(maps.flat_view, views)
    fv, fi, fj, fw = (np.concatenate([a[old], b]) for a, b in zip(
        (maps.flat_view, maps.flat_i, maps.flat_j, maps.flat_w),
        _decode(pairs, w, views, S)))
    order = np.argsort(fv, kind="stable")
    return CollinMaps(maps.num_views, fv[order], fi[order], fj[order],
                      fw[order], maps.dropped_per_view, views)


def collinearity_maps_fast(segments, masks, coll_sigma: float,
                           quota: int = 8, pairs_per_seg: int = 4,
                           aff_threshold: float = 0.5):
    """Per-view CollinMaps for [V, S, 4] / [V, S] segment tensors, exact:
    a first pass at the block quota and per-view cap, then the views it
    dropped pairs of at exact capacity (`_rerun_exact`).

    Under N processes (`parallel.multihost`) each rank's first pass
    compacts only the views of its range `multihost.local_range(V)` (one
    K4 launch on its card); the per-view lists are all-gathered, so every
    rank finalizes every view (line3d_tpu's collinearity over the views
    mesh, pipeline.py:405-418 there).  A view's list does not depend on the
    other views of its launch, and the lists carry no view index, so the
    gathered rows are the single-launch rows.  Every rank then re-runs the
    same views on its own card, from the segments of every view it holds."""
    V, S = masks.shape
    sig2 = np.float32(coll_sigma * coll_sigma)
    lo, hi = multihost.local_range(V)
    if hi > lo:
        parts = [trace.readback(x, "collin.export")
                 for x in collinearity_compact_all(
                     segments[lo:hi], masks[lo:hi], sig2, quota=quota,
                     pairs_per_seg=pairs_per_seg,
                     aff_threshold=aff_threshold)]
    else:
        C = pairs_capacity(S, quota, pairs_per_seg)
        parts = [np.zeros((0, C), np.int32), np.zeros((0, C), np.float32),
                 np.zeros(0, np.int64)]
    pairs, w, count = (np.concatenate(multihost.allgather_array(x))
                       for x in parts)
    maps = collinearity_finalize(pairs, w, count, max_segments=S,
                                 num_views=V)
    if maps.dropped_total:
        maps = _rerun_exact(maps, count, segments, masks, sig2,
                            aff_threshold)
    return maps
