"""Replicator-dynamics diffusion (RDD) on the segment affinity graph
[M. Donoser, BMVC'13].

Copy of `line3d_tpu/cluster/diffusion.py` (host float64 numpy and scipy);
the device formulation is `diffusion_device.py`.  Two modes
(config.diffusion_mode):

* "reference" — bit-faithful re-implementation of the reference GPU kernels
  (K_sparseMat_row_normalization / K_sparseMat_diffusion_step,
  cudawrapper.cu:717-829, driver 1131-1191).  Note the reference's sparse
  product walks a P-row and a W-column in index-locked steps
  (cudawrapper.cu:786-800): the t-th entry of P's row j is multiplied with
  the t-th entry of W's column i regardless of whether their inner indices
  agree.  This is not a mathematical sparse dot product, but it is what the
  reference computes, so it is reproduced exactly for output parity.

* "true" — the published update P' = P^T ∘ (P·W) restricted to the sparsity
  pattern, with row normalization: a proper sparse SpMM via scipy (float64,
  the semantic reference).

After the iterations the matrix is min-symmetrized (performDiffusion,
line3D.cc:1264-1299) and the edge list is returned in ascending (i, j) order,
which is the tie-break order the subsequent F-H clustering sees.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import L3DConfig


def _sorted_entries(edges_i, edges_j, edges_w, by_row: bool):
    if by_row:
        order = np.lexsort((edges_j, edges_i))
    else:
        order = np.lexsort((edges_i, edges_j))
    return edges_i[order], edges_j[order], edges_w[order]


def diffuse_reference(edges_i, edges_j, edges_w, num_nodes,
                      iterations: int = 10, eps: float = 1e-12):
    """Reference-mode RDD.  Inputs: COO edge list (both directions present).

    Returns (sym_i, sym_j, sym_w): min-symmetrized edge list sorted by (i, j).
    """
    E = len(edges_w)
    if E == 0:
        return edges_i, edges_j, edges_w

    # P, P' row-sorted; W col-sorted (sparsematrix.cc:6-117, 120-191)
    ri, rj, rw = _sorted_entries(edges_i, edges_j, edges_w, by_row=True)
    ci, cj, cw = _sorted_entries(edges_i, edges_j, edges_w, by_row=False)

    # row starts/degrees in the row-sorted layout
    deg = np.bincount(ri, minlength=num_nodes)
    rowstart = np.concatenate([[0], np.cumsum(deg)[:-1]])
    # column starts in the col-sorted layout (pattern symmetric -> same deg)
    colstart = rowstart

    # transposed position of each row-sorted entry: the rank of entry e under
    # the (j, i) key equals the row-sorted position of its transpose (the
    # pattern is symmetric, so the (j, i)-sorted keys coincide with the
    # (i, j)-sorted keys)
    order_col = np.lexsort((ri, rj))
    trans = np.empty(E, np.int64)
    trans[order_col] = np.arange(E)

    K = int(deg.max())
    t_idx = np.arange(K)
    # idx_P[e, t] = row-sorted index of the t-th entry of P's row j_e
    idx_P = rowstart[rj][:, None] + t_idx[None, :]
    # idx_W[e, t] = col-sorted index of the t-th entry of W's column i_e
    idx_W = colstart[ri][:, None] + t_idx[None, :]
    tmask = t_idx[None, :] < np.minimum(deg[rj], deg[ri])[:, None]
    idx_P = np.where(tmask, idx_P, 0)
    idx_W = np.where(tmask, idx_W, 0)

    wv_col = cw.copy()                    # W's values, fixed

    def row_normalize(pv):
        sums = np.zeros(num_nodes)
        np.add.at(sums, ri, pv)
        sums = np.maximum(sums, eps)      # cudawrapper.cu:745-746
        return pv / sums[ri]

    pv = row_normalize(rw.copy())
    for it in range(iterations):
        dot = np.sum(pv[idx_P] * wv_col[idx_W] * tmask, axis=1)
        newv = np.maximum(pv * dot, eps)  # cudawrapper.cu:805-806
        pv2 = np.empty_like(pv)
        pv2[trans] = newv                 # write to transposed position
        pv = pv2
        if it < iterations - 1:
            pv = row_normalize(pv)

    return _min_symmetrize(ri, rj, pv, eps)


def diffuse_true(edges_i, edges_j, edges_w, num_nodes,
                 iterations: int = 10, eps: float = 1e-12):
    """Published RDD update on the sparsity pattern (scipy SpMM)."""
    import scipy.sparse as sp
    E = len(edges_w)
    if E == 0:
        return edges_i, edges_j, edges_w
    ri, rj, rw = _sorted_entries(edges_i, edges_j, edges_w, by_row=True)
    W = sp.csr_matrix((rw, (ri, rj)), shape=(num_nodes, num_nodes))

    def row_normalize(M):
        s = np.maximum(np.asarray(M.sum(axis=1)).ravel(), eps)
        return sp.diags(1.0 / s) @ M

    P = row_normalize(W.copy())
    for it in range(iterations):
        PW = (P @ W).tocsr()
        # restrict to pattern & multiply elementwise with P^T
        vals = np.asarray(PW[ri, rj]).ravel()
        newv = np.maximum(np.asarray(P[rj, ri]).ravel() * vals, eps)
        P = sp.csr_matrix((newv, (rj, ri)), shape=(num_nodes, num_nodes))
        if it < iterations - 1:
            P = row_normalize(P)
    Pc = P.tocoo()
    return _min_symmetrize(Pc.row.astype(np.int64), Pc.col.astype(np.int64),
                           Pc.data, eps)


def _min_symmetrize(i, j, w, eps):
    """min(w_ij, w_ji) symmetrization, output sorted by (i, j)
    (performDiffusion, line3D.cc:1264-1299)."""
    order = np.lexsort((j, i))
    i, j, w = i[order], j[order], w[order]
    # transposed positions: with both directions present, sorting by (j, i)
    # enumerates the transposes in (i, j) order
    trans = np.lexsort((i, j))
    w_sym = np.minimum(w, w[trans])
    return i, j, w_sym


def resolve_backend(value: str, device) -> str:
    """Resolve a diffusion_backend / refine_backend value: "auto" becomes
    "device" for a Line3D on a CUDA device and "host" on the CPU, which
    keeps the float64 reference path for the tests and the golden runs
    (line3d_tpu keys the same rule on a TPU backend, utils/backend.py).
    Explicit values pass through."""
    if value == "auto":
        return "device" if torch.device(device).type == "cuda" else "host"
    if value not in ("host", "device"):
        raise ValueError(f"unknown backend {value!r}")
    return value


def run_diffusion(graph, config: L3DConfig, verbose: bool = False,
                  device="cpu"):
    """Diffuse a cluster.AffinityGraph in place; returns it with the new
    edge list.  The device backend runs on `device` (float32 torch)."""
    if resolve_backend(config.diffusion_backend, device) == "device":
        from . import diffusion_device as dd
        fn = dd.diffuse_reference_device \
            if config.diffusion_mode == "reference" \
            else dd.diffuse_true_device
        kw = dict(device=device)
    else:
        fn = diffuse_reference if config.diffusion_mode == "reference" \
            else diffuse_true
        kw = {}
    i, j, w = fn(graph.edges_i.astype(np.int64),
                 graph.edges_j.astype(np.int64),
                 graph.edges_w.astype(np.float64),
                 graph.num_nodes, config.diffusion_iterations, config.eps,
                 **kw)
    graph.edges_i = i.astype(np.int32)
    graph.edges_j = j.astype(np.int32)
    graph.edges_w = w.astype(np.float32)
    if verbose:
        print(f"[L3D] diffusion done: {len(w)} entries")
    return graph
