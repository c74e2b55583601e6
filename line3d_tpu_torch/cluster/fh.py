"""Felzenszwalb–Huttenlocher graph clustering with the reference's exact
merge semantics (reference: clustering.cc:6-47, universe.h:60-115).

Edges are sorted ASCENDING by weight (the reference applies the
image-segmentation formulation directly to its affinity weights,
clustering.cc:12) with a stable sort, so equal-weight edges keep emission
order.  Two components join iff the edge weight w satisfies
w <= threshold[a] and w <= threshold[b]; the merged component's threshold
becomes w + c / size.

Union-find is inherently sequential (SURVEY.md §7 hard part #2) and runs in
the native C++ library.  Copy of `line3d_tpu/cluster/fh.py`'s exact native
path (the round-parallel mode is not ported).
"""
from __future__ import annotations

import numpy as np

from ..native import load as native_load


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
    edges_i, edges_j, edges_w = _drop_reverse_duplicates(
        edges_i, edges_j, edges_w)
    order = np.argsort(edges_w, kind="stable").astype(np.int64)
    labels = np.zeros(num_nodes, np.int64)
    lib.fh_cluster(
        np.ascontiguousarray(edges_i[order], np.int64),
        np.ascontiguousarray(edges_j[order], np.int64),
        np.ascontiguousarray(edges_w[order], np.float64),
        len(order), num_nodes, float(c), labels)
    return labels
