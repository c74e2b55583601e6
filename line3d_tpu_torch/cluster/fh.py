"""Felzenszwalb–Huttenlocher graph clustering with the reference's exact
merge semantics (reference: clustering.cc:6-47, universe.h:60-115).

Edges are sorted ASCENDING by weight (the reference applies the
image-segmentation formulation directly to its affinity weights,
clustering.cc:12) with a stable sort, so equal-weight edges keep emission
order.  Two components join iff the edge weight w satisfies
w <= threshold[a] and w <= threshold[b]; the merged component's threshold
becomes w + c / size.

Union-find is inherently sequential (SURVEY.md §7 hard part #2) and runs in
the native C++ library.  Copy of `line3d_tpu/cluster/fh.py`: the exact
native path (`fh_cluster`) and the round-parallel approximation
(`fh_cluster_parallel`, config fh_backend="parallel", its rounds in torch
on a device).
"""
from __future__ import annotations

import numpy as np
import torch

from ..native import load as native_load
from .. import trace


def fh_cluster_parallel(edges_i: np.ndarray, edges_j: np.ndarray,
                        edges_w: np.ndarray, num_nodes: int,
                        c: float = 1.0, max_rounds: int = 10000, *,
                        device) -> np.ndarray:
    """Round-parallel APPROXIMATION of F-H clustering — SURVEY.md
    §7.6's "hard part #2" prototype (config: fh_backend="parallel"),
    measured for cluster agreement against the exact serial merge order
    in tests/test_cluster.py (numbers recorded in PARITY.md).

    Boruvka-style MUTUAL-MINIMAL rounds instead of the sequential edge
    scan: every component picks its minimum-weight edge that passes the
    F-H gate (w <= threshold of BOTH endpoint components,
    clustering.cc:30-36), and exactly the edges chosen by BOTH endpoints
    merge (larger root id adopts the smaller); labels compress by
    pointer jumping and each merged pair's threshold becomes
    w + c / new_size — the reference's own per-merge update
    (clustering.cc:37-39), exact per pair because a component merges at
    most once per round.  Each round is pure vectorized data-parallel
    work (gather, segment-min via reverse scatter, pointer jumping,
    bincount), i.e. the formulation shards over devices or hosts.

    A first prototype hooked whole CHAINS of chosen edges per round
    (classic hook-and-compress): catastrophic over-merging (ARI 0.008 on
    dense random graphs, 0.95 at production density) because the
    sequential scan tightens thresholds between each merge of a chain.
    Mutual-minimal merges remove almost all of that: a pair's decision
    sees the same endpoint thresholds the ascending scan would, and a
    component whose candidate edge is rejected under its current
    threshold is frozen in BOTH schedules (later edges are heavier, and
    thresholds only change by merging).  The residual divergence is a
    threshold-RAISING race (thr = w + c/size can exceed the previous
    threshold, so a pending smaller merge elsewhere can admit an edge
    the parallel schedule has already routed past) — measured in
    tests/test_cluster.py and recorded in PARITY.md; fh_cluster below
    remains the exact default and this is the documented scale mode.

    The rounds run as torch operations on `device` (line3d_tpu runs them
    in numpy): the largest cluster takes in about one member a round at
    the end, so the rounds number about its size (~10·V on a dense arc
    of V views, up to max_rounds), each over all E edges, which on the
    host is minutes at the 256-view facade's 9.1 M edges.  Each step is
    line3d_tpu's: the per-root minimum edge is a scatter
    "amin" of edge positions (order-free, so the same on any device), the
    comparisons and the threshold update are float64, so the labels are
    line3d_tpu's on any device.
    """
    dev = torch.device(device)
    if len(edges_w) == 0 or num_nodes == 0:
        return np.arange(num_nodes, dtype=np.int64)
    order = np.argsort(edges_w, kind="stable")
    ei, ej, ew = (torch.as_tensor(np.asarray(x, dt)[order], device=dev)
                  for x, dt in ((edges_i, np.int64), (edges_j, np.int64),
                                (edges_w, np.float64)))
    E, n = len(order), num_nodes
    labels = torch.arange(n, device=dev)
    thr = torch.full((n,), c, dtype=torch.float64, device=dev)
    c_t = torch.tensor(c, dtype=torch.float64, device=dev)
    alive = ei != ej
    position = torch.arange(E, device=dev)
    for _ in range(max_rounds):
        ra = labels[ei]
        rb = labels[ej]
        alive &= ra != rb
        adm = alive & (ew <= thr[ra]) & (ew <= thr[rb])
        if not bool(adm.any()):
            break
        # per-root minimum admissible edge: edges are weight-sorted, so the
        # least position is the LOWEST-weight (and earliest, matching the
        # stable tie order) edge; E where a root has none
        e_adm = torch.where(adm, position, E)
        none = torch.full((n,), E, dtype=torch.int64, device=dev)
        choose = torch.minimum(
            none.scatter_reduce(0, ra, e_adm, "amin"),   # root is i
            none.scatter_reduce(0, rb, e_adm, "amin"))   # root is j
        roots = torch.nonzero(choose < E)[:, 0]
        e_r = choose[roots]
        pa = ra[e_r]
        pb = rb[e_r]
        partner = torch.where(pa == roots, pb, pa)
        # merge ONLY mutual choices (both endpoints picked the same
        # edge), larger root id adopting the smaller — one merge per
        # component per round, so the F-H threshold update is exact per
        # pair.  The globally smallest admissible edge is always mutual,
        # so every round makes progress.
        mutual = (choose[partner] == e_r) & (partner < roots)
        parent = torch.arange(n, device=dev)
        parent[roots[mutual]] = partner[mutual]
        labels = parent[labels]
        size = torch.bincount(labels, minlength=n)
        dst = partner[mutual]
        # a tensor divided by a tensor: `c / tensor` multiplies by the
        # reciprocal, which is not the correctly rounded quotient
        thr[dst] = ew[e_r[mutual]] + \
            c_t / size[dst].clamp_min(1).to(torch.float64)
    return trace.readback(labels, "fh.labels")
    order = np.argsort(edges_w, kind="stable")
    ei = np.asarray(edges_i, np.int64)[order]
    ej = np.asarray(edges_j, np.int64)[order]
    ew = np.asarray(edges_w, np.float64)[order]
    thr = np.full(num_nodes, c, np.float64)
    alive = ei != ej
    for _ in range(max_rounds):
        ra = labels[ei]
        rb = labels[ej]
        alive &= ra != rb
        adm = alive & (ew <= thr[ra]) & (ew <= thr[rb])
        if not adm.any():
            break
        idx = np.nonzero(adm)[0]
        # per-root minimum admissible edge: edges are weight-sorted, so a
        # reverse-order scatter leaves the LOWEST-weight (and earliest,
        # matching the stable tie order) edge per root
        rev = idx[::-1]
        ca = np.full(num_nodes, -1, np.int64)
        cb = np.full(num_nodes, -1, np.int64)
        ca[ra[rev]] = rev          # min over edges where the root is i
        cb[rb[rev]] = rev          # min over edges where the root is j
        choose = np.where(ca < 0, cb,
                          np.where(cb < 0, ca, np.minimum(ca, cb)))
        roots = np.nonzero(choose >= 0)[0]
        e_r = choose[roots]
        pa = ra[e_r]
        pb = rb[e_r]
        partner = np.where(pa == roots, pb, pa)
        # merge ONLY mutual choices (both endpoints picked the same
        # edge), larger root id adopting the smaller — one merge per
        # component per round, so the F-H threshold update is exact per
        # pair.  The globally smallest admissible edge is always mutual,
        # so every round makes progress.
        mutual = (choose[partner] == e_r) & (partner < roots)
        parent = np.arange(num_nodes, dtype=np.int64)
        parent[roots[mutual]] = partner[mutual]
        labels = parent[labels]
        size = np.bincount(labels, minlength=num_nodes)
        dst = partner[mutual]
        thr[dst] = ew[e_r[mutual]] + c / np.maximum(size[dst], 1)
    return labels


def _drop_reverse_duplicates(edges_i, edges_j, edges_w):
    """Drop an edge whose IMMEDIATE PREDECESSOR in the stream is its
    exact reverse with the same weight.

    The affinity builder emits every undirected edge in both directions
    consecutively (_emit_graph: positions 2k / 2k+1), and the STABLE
    ascending weight sort keeps equal-weight edges in emission order —
    so the two directions stay adjacent in the sorted scan.  The second
    evaluation then sees exactly the state the first left behind: if the
    first merged, find(a) == find(b) and the duplicate is skipped; if it
    failed the threshold gate, the unchanged thresholds fail it again
    (clustering.cc:24-36).  Dropping it is therefore EXACT — and halves
    both the sort and the scan (t_fh was 14-21 s at the 1000-view scale,
    ~60M directed edges).  Streams without the consecutive-reverse
    structure (unit tests, external callers) are left untouched.
    """
    n = len(edges_w)
    if n < 2:
        return edges_i, edges_j, edges_w
    dup = np.zeros(n, bool)
    dup[1:] = ((edges_i[1:] == edges_j[:-1])
               & (edges_j[1:] == edges_i[:-1])
               & (edges_w[1:] == edges_w[:-1]))
    # only a SECOND member of a pair may drop: a dropped edge must not
    # itself justify dropping its successor unless that successor is a
    # further exact duplicate (A_fwd, A_rev, A_fwd2, ... chains are
    # no-ops throughout, so transitive drops are safe and kept)
    if not dup.any():
        return edges_i, edges_j, edges_w
    keep = ~dup
    return edges_i[keep], edges_j[keep], edges_w[keep]


def fh_cluster(edges_i: np.ndarray, edges_j: np.ndarray,
               edges_w: np.ndarray, num_nodes: int,
               c: float = 1.0) -> np.ndarray:
    """[num_nodes] cluster labels (representative ids, not compacted),
    from the native union-find."""
    lib = native_load.get_lib()
    with trace.span("fh.sort"):
        edges_i, edges_j, edges_w = _drop_reverse_duplicates(
            edges_i, edges_j, edges_w)
        order = np.argsort(edges_w, kind="stable").astype(np.int64)
        ei = np.ascontiguousarray(edges_i[order], np.int64)
        ej = np.ascontiguousarray(edges_j[order], np.int64)
        ew = np.ascontiguousarray(edges_w[order], np.float64)
    labels = np.zeros(num_nodes, np.int64)
    with trace.span("fh.union"):
        lib.fh_cluster(ei, ej, ew, len(order), num_nodes, float(c), labels)
    return labels
