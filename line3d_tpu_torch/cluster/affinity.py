"""Affinity-graph construction over best-match 2D segments.

Replicates clusterSegments2D's edge enumeration (reference:
line3D.cc:968-1221) including its order-dependent `used` deduplication:

For each source segment src with a best match (ascending (view, seg) order):
  A) every potential correspondent tgt (ascending order): if the unordered
     pair was already seen, skip it ENTIRELY (including step B); else mark
     it seen; if tgt also has a best match, the edge weight is
     w = 0.5 (score_src + score_tgt) * sim3D, kept if w > 0.25
     (L3D_MIN_AFFINITY).
  B) only when the A pair was fresh and tgt has a best match: tgt's
     collinear partners tgtc (same view as tgt): unseen-pair gate, weight
     as in A (no collinearity factor), kept if w > 0.01.
  C) src's own collinear partners (same view): unseen-pair gate, weight
     multiplied by the collinearity score, kept if w > 0.01.

The pair is marked seen *before* the threshold test, and a seen A pair
suppresses the target's whole collinear expansion (the `continue`,
line3D.cc:1001-1004) — so a failed A-edge is never reconsidered as a
C-edge, and B blocks of re-encountered targets never run.  Both behaviors
are order-dependent and preserved here.

The per-pair 3D similarity (similarity_coll3D, line3D.cc:1600-1681) is
evaluated vectorized over all candidate pairs after enumeration.

Host numpy + native C++ copy of `line3d_tpu/cluster/affinity.py`.  With
collinearity the exact-order enumeration runs on the card when the Line3D's
device is CUDA (`affinity_cuda`, `csrc/affinity_enum.cu`), in the native
walk otherwise; both give one stream.  On the card the stream stays there,
and a filter (`csrc/affinity_filter.cu`) sends the host only the candidates
it cannot prove failing; the host's sweep weighs those, so the graph is the
whole stream's.  Under N processes (`parallel.multihost`) the finalize's
weight sweep is split by candidate range across the ranks and gathered as
float64 bits (`_finalize_candidates`); the enumeration and the filter (each
rank on its own card) and the emission run replicated, so every rank
builds the single-process graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import L3DConfig
from ..core.cameras import CameraSet
from ..match.collinearity import CollinMaps
from ..match.engine import BestMatches
from ..native.load import get_lib
from ..parallel import multihost
from .. import trace
from . import affinity_cuda


@dataclasses.dataclass
class AffinityGraph:
    edges_i: np.ndarray       # [E] int32 local node ids (both directions)
    edges_j: np.ndarray       # [E] int32
    edges_w: np.ndarray       # [E] float32
    node_view: np.ndarray     # [B] int32: local id -> view
    node_seg: np.ndarray      # [B] int32: local id -> segment
    num_nodes: int
    num_candidates: int = 0   # length of the candidate stream it was built from
    num_kept: int = 0         # the candidates the host weighed: the card's
                              # kept ones on CUDA, the whole stream otherwise


# batch size above which similarity_coll3d and the candidate finalize run
# in the native OpenMP library (the reference's dispatch; below it, numpy)
NATIVE_SIM_THRESHOLD = 20000


def similarity_coll3d(cams: CameraSet, best: BestMatches,
                      src_rows: np.ndarray, tgt_rows: np.ndarray,
                      sigma_a: float) -> np.ndarray:
    """Vectorized similarity_coll3D (line3D.cc:1600-1681) over row pairs.

    Large batches run in the native OpenMP kernel (same double-precision
    math, native/affinity_enum.cpp), small ones in numpy below."""
    if len(src_rows) > NATIVE_SIM_THRESHOLD:
        n = len(src_rows)
        sim = np.empty(n, np.float64)
        get_lib().affinity_similarity(
            np.ascontiguousarray(src_rows, np.int64),
            np.ascontiguousarray(tgt_rows, np.int64), n,
            np.ascontiguousarray(best.P1, np.float64),
            np.ascontiguousarray(best.P2, np.float64),
            np.ascontiguousarray(best.dir, np.float64),
            np.ascontiguousarray(best.d1, np.float32),
            np.ascontiguousarray(best.d2, np.float32),
            np.ascontiguousarray(best.view, np.int32),
            np.ascontiguousarray(cams.k_lower, np.float64),
            np.ascontiguousarray(cams.k_upper, np.float64),
            np.ascontiguousarray(cams.median_depth, np.float64),
            float(sigma_a), sim)
        return sim

    def p2l(P1, dirv, X):
        # distance_point2line_3D (line3D.cc:1684-1691).  dist^2 =
        # |X - P1|^2 - (dir . (X - P1))^2 (dir is unit) — two reductions
        # instead of materializing the projection (~3x cheaper at the
        # multi-million-pair scale the affinity stage runs at)
        dx = X[:, 0] - P1[:, 0]
        dy = X[:, 1] - P1[:, 1]
        dz = X[:, 2] - P1[:, 2]
        t = dx * dirv[:, 0] + dy * dirv[:, 1] + dz * dirv[:, 2]
        d2 = dx * dx + dy * dy + dz * dz - t * t
        return np.sqrt(np.maximum(d2, 0.0))

    def endpoint_sims(a_rows, b_rows):
        """Gaussian sims of a's endpoints against b's 3D line."""
        P1b = best.P1[b_rows]; dirb = best.dir[b_rows]
        d1 = p2l(P1b, dirb, best.P1[a_rows])
        d2 = p2l(P1b, dirb, best.P2[a_rows])
        va = best.view[a_rows]
        min1 = cams.lower_uncertainty(va, best.d1[a_rows])
        min2 = cams.lower_uncertainty(va, best.d2[a_rows])
        s1sq = cams.uncertainty_sigma_sq(va, best.d1[a_rows])
        s2sq = cams.uncertainty_sigma_sq(va, best.d2[a_rows])
        with np.errstate(divide="ignore", invalid="ignore"):
            e1 = np.exp(-(d1 - min1) ** 2 / (2.0 * s1sq))
            e2 = np.exp(-(d2 - min2) ** 2 / (2.0 * s2sq))
        sim1 = np.where(d1 < min1, 1.0, e1)
        sim2 = np.where(d2 < min2, 1.0, e2)
        return np.minimum(sim1, sim2)

    w12 = endpoint_sims(src_rows, tgt_rows)
    w34 = endpoint_sims(tgt_rows, src_rows)
    w_d = np.minimum(w12, w34)

    dots = np.clip(np.sum(best.dir[src_rows] * best.dir[tgt_rows], axis=1),
                   -1.0, 1.0)
    ang = np.degrees(np.arccos(dots))
    ang = np.where(ang > 90.0, 180.0 - ang, ang)
    w_a = np.exp(-ang * ang / (2.0 * sigma_a * sigma_a))

    sim = np.minimum(w_d, w_a)
    return np.where(sim <= 0.01, 0.0, sim)


def potential_correspondence_lists(matches: list, num_views: int,
                                   max_segments: int):
    """Symmetric adjacency dict: node key -> sorted partner keys.

    Node key = view * max_segments + seg.  Mirrors
    potential_correspondences_ (line3D.cc:861-865) which is filled from the
    *verified* match lists.
    """
    allp = _correspondence_pairs(matches, num_views, max_segments)
    if not len(allp):
        return {}
    adj = {}
    keys, starts = np.unique(allp[:, 0], return_index=True)
    starts = np.append(starts, len(allp))
    for k, s, e in zip(keys, starts[:-1], starts[1:]):
        adj[int(k)] = allp[s:e, 1]
    return adj


def _build_affinity_graph_fast(best, adj, row_of, key_of, cams, config,
                               verbose):
    """Fully-vectorized A-candidate path (no collinearity).

    Without collinear candidates the traversal is src ascending x partner
    ascending, so the first visit of an unordered pair (a, b), a < b, is at
    src = a if a has a best match (all sources do), else at src = b.  Hence
    the `used` dedup reduces to: keep (src, tgt) iff src < tgt or tgt has no
    best match (and pairs without a best-match tgt produce no edge anyway).
    Candidate order, weights, thresholds, and node-id assignment match the
    loop path exactly (covered by tests/test_affinity.py).
    """
    # flatten adjacency into arrays in (src_rank, tgt) order
    order = np.argsort(key_of, kind="stable")
    srcs, tgts = [], []
    for r in order:
        partners = adj.get(int(key_of[r]))
        if partners is None:
            continue
        srcs.append(np.full(len(partners), r, np.int64))
        tgts.append(partners)
    if not srcs:
        return AffinityGraph(np.zeros(0, np.int32), np.zeros(0, np.int32),
                             np.zeros(0, np.float32),
                             np.zeros(0, np.int32), np.zeros(0, np.int32), 0)
    src_rows = np.concatenate(srcs)
    tgt_keys = np.concatenate(tgts)

    # partner -> best row.  Edges require BOTH ends to have best matches;
    # such pairs are first visited at the smaller key, so dedup = src < tgt.
    # (Pairs whose smaller end lacks a best match are first visited at the
    # larger end, but they produce no edge regardless.)
    tgt_rows = np.array([row_of.get(int(k), -1) for k in tgt_keys], np.int64)
    src_keys = key_of[src_rows]
    keep = (tgt_rows >= 0) & (src_keys < tgt_keys)
    src_rows = src_rows[keep]
    tgt_rows = tgt_rows[keep]
    n_cand = len(src_rows)

    sim = similarity_coll3d(cams, best, src_rows, tgt_rows, config.sigma_a)
    w = 0.5 * (best.score[src_rows].astype(np.float64) +
               best.score[tgt_rows].astype(np.float64)) * sim
    passed = w > config.min_affinity
    src_rows, tgt_rows, w = src_rows[passed], tgt_rows[passed], w[passed]

    # node ids in emission order: first occurrence over the interleaved
    # (src, tgt) sequence
    seq = np.empty(2 * len(src_rows), np.int64)
    seq[0::2] = src_rows
    seq[1::2] = tgt_rows
    uniq, first = np.unique(seq, return_index=True)
    id_order = np.argsort(first, kind="stable")
    node_rows = uniq[id_order]
    node_of = np.full(best.view.size, -1, np.int64)
    node_of[node_rows] = np.arange(len(node_rows))

    a = node_of[src_rows]
    b = node_of[tgt_rows]
    E = len(a)
    ei = np.empty(2 * E, np.int32)
    ej = np.empty(2 * E, np.int32)
    ew = np.empty(2 * E, np.float32)
    ei[0::2] = a; ej[0::2] = b
    ei[1::2] = b; ej[1::2] = a
    ew[0::2] = w; ew[1::2] = w

    if verbose:
        print(f"[L3D] A: #num_entries = {len(ei)}")
        print(f"[L3D] A: #num_rows    = {len(node_rows)}")
    return AffinityGraph(
        edges_i=ei, edges_j=ej, edges_w=ew,
        node_view=best.view[node_rows].astype(np.int32),
        node_seg=best.seg[node_rows].astype(np.int32),
        num_nodes=len(node_rows), num_candidates=n_cand, num_kept=n_cand)


def _collin_csr(collin, num_views: int, S: int):
    """Global CSR over node key = view*S + seg -> (sorted partner segs,
    weights), from the flat arrays a CollinMaps carries."""
    n_keys = num_views * S
    ikey = collin.flat_view.astype(np.int64) * S + \
        collin.flat_i.astype(np.int64)          # sorted ascending by export
    fj = collin.flat_j.astype(np.int64)
    fw = collin.flat_w
    # out-of-range segment ids cannot collide with any real node key, so
    # dropping them preserves the loop path's semantics exactly
    ok = (ikey >= 0) & (ikey < n_keys) & (fj >= 0) & (fj < S)
    if not ok.all():
        ikey, fj, fw = ikey[ok], fj[ok], fw[ok]
    ptr = np.zeros(n_keys + 1, np.int64)
    np.add.at(ptr, ikey + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, fj, fw


def _finalize_candidates(best, src_rows, tgt_rows, kinds, cws,
                         cams, config, verbose, n_stream=None):
    """Shared tail of every enumerator: similarity, weights, per-kind
    thresholds, node-id assignment in emission order (line3D.cc:1019-1050),
    symmetric edge list.  The weight sweep, the parallel part, covers this
    rank's candidate range (`multihost.local_range`: the whole stream in a
    single process) and the slices are all-gathered as float64 bits; the
    sequential emission then runs over the whole stream on every rank, so
    every rank builds the single-process graph (line3d_tpu's
    _finalize_candidates_sharded, affinity.py:489-524 there).  The
    enumeration is replicated, so only the weight slices cross.
    `n_stream`: the length of the stream these candidates were kept from
    (by default theirs), which chooses the native or the numpy sweep and
    emission, as it would for the whole stream, and is the graph's
    `num_candidates`."""
    n = len(src_rows)
    n_stream = n if n_stream is None else n_stream
    if not n:
        return AffinityGraph(np.zeros(0, np.int32), np.zeros(0, np.int32),
                             np.zeros(0, np.float32),
                             np.zeros(0, np.int32), np.zeros(0, np.int32), 0,
                             num_candidates=n_stream)
    lo, hi = multihost.local_range(n)
    w = np.concatenate(multihost.allgather_array(_candidate_weights_range(
        best, src_rows, tgt_rows, kinds, cws, cams, config, lo, hi,
        n_stream)))
    if len(w) != n:
        raise RuntimeError(f"gathered {len(w)} weights for {n} candidates")
    return _emit_graph(best, src_rows, tgt_rows, w, verbose, n_stream)


def _candidate_weights_range(best, src_rows, tgt_rows, kinds, cws,
                             cams, config, lo: int, hi: int,
                             n_stream=None) -> np.ndarray:
    """Thresholded edge weights of the candidate slice [lo, hi): w when it
    passes its kind's threshold, -1.0 sentinel otherwise.  The native
    OpenMP sweep (affinity_weights_range) or numpy, chosen on the WHOLE
    stream's length (`n_stream`, by default the candidates'), not the
    slice's or the kept candidates', so a rank, or the host after the
    card's filter, takes the native sweep exactly when one process would
    over the whole stream: otherwise the numpy and libm roundings would
    let the process count or the filter decide marginal threshold
    passes."""
    n_stream = len(src_rows) if n_stream is None else n_stream
    if n_stream > NATIVE_SIM_THRESHOLD:
        w = np.empty(hi - lo, np.float64)
        get_lib().affinity_weights_range(
            np.ascontiguousarray(src_rows, np.int64),
            np.ascontiguousarray(tgt_rows, np.int64),
            np.ascontiguousarray(kinds, np.int8),
            np.ascontiguousarray(cws, np.float64), lo, hi,
            np.ascontiguousarray(best.score, np.float32),
            np.ascontiguousarray(best.P1, np.float64),
            np.ascontiguousarray(best.P2, np.float64),
            np.ascontiguousarray(best.dir, np.float64),
            np.ascontiguousarray(best.d1, np.float32),
            np.ascontiguousarray(best.d2, np.float32),
            np.ascontiguousarray(best.view, np.int32),
            np.ascontiguousarray(cams.k_lower, np.float64),
            np.ascontiguousarray(cams.k_upper, np.float64),
            np.ascontiguousarray(cams.median_depth, np.float64),
            float(config.sigma_a), float(config.min_affinity),
            float(config.collinear_affinity), w)
        return w
    sl = slice(lo, hi)
    sim = similarity_coll3d(cams, best, src_rows[sl], tgt_rows[sl],
                            config.sigma_a)
    base = 0.5 * (best.score[src_rows[sl]].astype(np.float64) +
                  best.score[tgt_rows[sl]].astype(np.float64))
    w = np.where(kinds[sl] == 2, cws[sl], 1.0) * base * sim
    thr = np.where(kinds[sl] == 0, config.min_affinity,
                   config.collinear_affinity)
    return np.where(w > thr, w, -1.0)


def _emit_graph(best, src_rows, tgt_rows, w, verbose, n_stream=None):
    """Emission-order graph assembly from sentinel weights (-1 = dropped):
    node ids at first touch + interleaved symmetric edges
    (line3D.cc:1019-1050).  The native sequential pass (affinity_emit) for
    streams above NATIVE_SIM_THRESHOLD, numpy below, judged by the whole
    stream's length `n_stream` (by default the candidates')."""
    n = len(src_rows)
    n_stream = n if n_stream is None else n_stream
    if n_stream > NATIVE_SIM_THRESHOLD:
        B = best.view.size
        edges_i = np.empty(2 * n, np.int32)
        edges_j = np.empty(2 * n, np.int32)
        edges_w = np.empty(2 * n, np.float32)
        node_rows = np.empty(B, np.int64)
        n_nodes = np.zeros(1, np.int64)
        E = get_lib().affinity_emit(
            np.ascontiguousarray(w, np.float64),
            np.ascontiguousarray(src_rows, np.int64),
            np.ascontiguousarray(tgt_rows, np.int64), n, B,
            edges_i, edges_j, edges_w, node_rows, n_nodes)
        ei, ej, ew = (x[:2 * E].copy() for x in (edges_i, edges_j, edges_w))
        node_rows = node_rows[:int(n_nodes[0])]
    else:
        passed = w >= 0.0
        src_rows, tgt_rows, w = src_rows[passed], tgt_rows[passed], w[passed]

        # --- node ids in emission order -----------------------------------
        # first-occurrence position per row via a reverse-order scatter (the
        # last store wins, so storing positions in reverse leaves the FIRST),
        # then sort only the ~#nodes first-positions — replaces an
        # np.unique(return_index) sort over the 2E-element stream (~5x at
        # 1000-view scale)
        seq = np.empty(2 * len(src_rows), np.int64)
        seq[0::2] = src_rows
        seq[1::2] = tgt_rows
        first_pos = np.full(best.view.size, -1, np.int64)
        first_pos[seq[::-1]] = np.arange(len(seq) - 1, -1, -1)
        rows_used = np.flatnonzero(first_pos >= 0)
        node_rows = rows_used[np.argsort(first_pos[rows_used],
                                         kind="stable")]
        node_of = np.full(best.view.size, -1, np.int64)
        node_of[node_rows] = np.arange(len(node_rows))

        a = node_of[src_rows]
        b = node_of[tgt_rows]
        E = len(a)
        ei = np.empty(2 * E, np.int32)
        ej = np.empty(2 * E, np.int32)
        ew = np.empty(2 * E, np.float32)
        ei[0::2] = a; ej[0::2] = b
        ei[1::2] = b; ej[1::2] = a
        ew[0::2] = w; ew[1::2] = w

    if verbose:
        print(f"[L3D] A: #num_entries = {len(ei)}")
        print(f"[L3D] A: #num_rows    = {len(node_rows)}")
    return AffinityGraph(
        edges_i=ei, edges_j=ej, edges_w=ew,
        node_view=best.view[node_rows].astype(np.int32),
        node_seg=best.seg[node_rows].astype(np.int32),
        num_nodes=len(node_rows), num_candidates=n_stream, num_kept=n)


def _build_affinity_graph_native(best, matches, key_of, collin, cams,
                                 config, max_segments, verbose, device):
    """Exact-order enumeration (`enumerate_candidates`): the reference's
    sequential traversal, on the card for a CUDA `device`, else in C++
    with an open-addressing pair set (native/affinity_enum.cpp, ~20x the
    numpy stream formulation at 1000-view density).  Output is
    candidate-for-candidate identical to the reference's loop and
    vectorized enumerators (tests/test_affinity.py).  Correspondence pairs
    stay in their packed a*M + b form end to end.  Its three parts are
    stage spans (`trace.stage`): affinity.pairs (the correspondence pairs,
    the row lookup and the collinearity CSR), affinity.enumerate and
    affinity.weights (on the card the filter, `affinity_cuda.
    kept_candidates`, then `_finalize_candidates`)."""
    S = max_segments
    V = cams.num_views
    with trace.stage("affinity.pairs"):
        pk, M = _correspondence_pairs_packed(matches, V, S)
        row_lookup = np.full(V * S, -1, np.int64)
        row_lookup[key_of] = np.arange(best.view.size)
        ptr, coll_j, coll_w = _collin_csr(collin, V, S)

    with trace.stage("affinity.enumerate"):
        order = np.ascontiguousarray(np.argsort(key_of, kind="stable"),
                                     np.int64)
        key_sorted = np.ascontiguousarray(key_of[order])
        cand = enumerate_candidates(key_sorted, order, pk, row_lookup, ptr,
                                    coll_j, coll_w, S, M, device)
    with trace.stage("affinity.weights"):
        n_stream = None
        if isinstance(cand, affinity_cuda.CardStream):
            n_stream = cand.n
            cand = affinity_cuda.kept_candidates(cand, best, cams, config)
        return _finalize_candidates(best, *cand, cams, config, verbose,
                                    n_stream)


def enumerate_candidates(key_sorted, order, pk, row_lookup, ptr, coll_j,
                         coll_w, S: int, M: int, device=None):
    """The exact-order candidate stream (src_rows, tgt_rows, kinds 0=A
    1=B 2=C, collinear weights) of the sources `key_sorted` (their rows
    `order`), the sorted symmetric packed correspondence pairs `pk`, the
    key -> row lookup (-1 exactly for keys not in `key_sorted`) and the
    collinearity CSR (partners ascending in each row).  On a CUDA
    `device` the card decides it and it stays there (an
    `affinity_cuda.CardStream`; `affinity_cuda.read_stream` gives its
    arrays); otherwise the native walk `affinity_enumerate_packed`, its
    plain twin, gives the four host arrays."""
    coll_w = np.ascontiguousarray(coll_w, np.float64)
    if device is not None and torch.device(device).type == "cuda":
        return affinity_cuda.enumerate_candidates_cuda(
            key_sorted, order, pk, row_lookup, ptr, coll_j, coll_w, S, M,
            torch.device(device))
    return _enumerate_native(key_sorted, order, pk, row_lookup, ptr, coll_j,
                             coll_w, S, M)


def _enumerate_native(key_sorted, order, pk, row_lookup, ptr, coll_j, coll_w,
                      S, M):
    """The native walk over a capacity bound: every correspondence pair,
    its target's collinear partners, and every source's collinear
    partners."""
    lib = get_lib()
    ptr64 = np.ascontiguousarray(ptr, np.int64)
    pk = np.ascontiguousarray(pk, np.int64)
    coll_b = int(lib.affinity_capacity(pk, len(pk), ptr64, M))
    expected = int(len(pk) + coll_b + np.diff(ptr64)[key_sorted].sum())
    out_src = np.empty(expected, np.int64)
    out_tgt = np.empty(expected, np.int64)
    out_kind = np.empty(expected, np.int8)
    out_cw = np.empty(expected, np.float64)
    cnt = lib.affinity_enumerate_packed(
        np.ascontiguousarray(key_sorted, np.int64),
        np.ascontiguousarray(order, np.int64), len(order), pk, len(pk),
        np.ascontiguousarray(row_lookup, np.int64), ptr64,
        np.ascontiguousarray(coll_j, np.int64), coll_w,
        S, M, expected, out_src, out_tgt, out_kind, out_cw)
    return out_src[:cnt], out_tgt[:cnt], out_kind[:cnt], out_cw[:cnt]


def _correspondence_pairs_packed(matches: list, num_views: int,
                                 max_segments: int):
    """Sorted unique symmetric correspondence pairs PACKED as a*M + b over
    verified matches.  Packing makes the unique a single 1-D sort —
    np.unique(axis=0) on the 2-column form is ~15x slower at 1000-view
    scale — and the native enumerator consumes the packed form directly
    (unpacking to two columns costs two 30M-element divmod passes)."""
    S = max_segments
    M = np.int64(num_views) * S
    keys = []
    for vm in matches:
        a = vm.view * S + vm.src_seg.astype(np.int64)
        b = vm.tgt_view.astype(np.int64) * S + vm.tgt_seg.astype(np.int64)
        keys.append(a * M + b)
        keys.append(b * M + a)
    if not keys:
        return np.zeros(0, np.int64), M
    pk = np.ascontiguousarray(np.concatenate(keys))
    m = get_lib().sort_unique_i64(pk, len(pk))    # multi-core in-place
    return pk[:m], M


def _correspondence_pairs(matches: list, num_views: int, max_segments: int):
    """Sorted unique symmetric (key_a, key_b) array (2-column form)."""
    pk, M = _correspondence_pairs_packed(matches, num_views, max_segments)
    if not len(pk):
        return np.zeros((0, 2), np.int64)
    return np.stack([pk // M, pk % M], axis=1)


def build_affinity_graph(best: BestMatches, matches: list,
                         collin: CollinMaps | None, cams: CameraSet,
                         config: L3DConfig, max_segments: int,
                         verbose: bool = False,
                         device=None) -> AffinityGraph:
    """The affinity graph (line3D.cc:968-1221).  With collinear pairs the
    exact-order enumeration runs on the card when `device` is CUDA (the
    Line3D's device), in the native walk otherwise; without them the
    vectorized A-candidate path runs on the host."""
    S = max_segments
    key_of = best.view.astype(np.int64) * S + best.seg.astype(np.int64)

    if collin is not None and len(collin.flat_i):
        return _build_affinity_graph_native(
            best, matches, key_of, collin, cams, config, S, verbose, device)

    adj = potential_correspondence_lists(matches, cams.num_views, S)
    row_of = {int(k): r for r, k in enumerate(key_of)}
    return _build_affinity_graph_fast(best, adj, row_of, key_of, cams,
                                      config, verbose)
