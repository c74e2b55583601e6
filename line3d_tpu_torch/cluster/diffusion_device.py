"""Device-side replicator-dynamics diffusion in float32 torch.

Torch port of `line3d_tpu/cluster/diffusion_device.py`, the device
equivalent of the reference RDD GPU kernels (K_sparseMat_row_normalization
cudawrapper.cu:717-762, K_sparseMat_diffusion_step cudawrapper.cu:765-829,
host driver replicator_dynamics_diffusion cudawrapper.cu:1131-1191): the
host builds a static index plan once (sorted COO layout, lockstep bases,
transpose permutation, `build_plan`), then the iterations run on `device`.
Both modes of `diffusion.py` have a device form here: "reference" (the
lockstep walk, `diffuse_reference_device`) and "true" (the sparse dot over
common inner indices, `diffuse_true_device`).

Every per-iteration sum is a product sum over a static list of index
pairs: out[k] = sum over c < n_k of a[A[k, c]] * b[B[k, c]].  The row sums
of the normalization (b = 1, A = the row's entries), the lockstep dot
(A[e, c] = rowstart[j_e] + c, B[e, c] = colstart[i_e] + c, n_e = min of the
two degrees) and the true dot (the (P, W) positions where the merge walk
of P's row i_e and W's column j_e meets, found once per call) all take
this form.  `_PairSums` evaluates it as one padded gather and one sum over
the padded axis per power-of-two length class: no atomics, so two runs on
the card give the same bits (a float `index_add_` or `scatter_add_` on
CUDA sums in an order that changes from run to run).  Values are float32,
as in the reference kernels (the host path in diffusion.py is float64).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class DiffusionPlan:
    """Static index plan of the (i, j)-sorted edge list."""
    rw: np.ndarray          # [E] f32 row-sorted values (P's initial W)
    wv_col: np.ndarray      # [E] f32 col-sorted values (W, fixed)
    ri: np.ndarray          # [E] i64 row ids, (i, j)-sorted
    rj: np.ndarray          # [E] i64 col ids
    deg: np.ndarray         # [num_nodes] i64 row (= column) degrees
    rowstart: np.ndarray    # [num_nodes] i64 row-sorted (= col-sorted) starts
    order_col: np.ndarray   # [E] i64 transpose gather permutation
    ci: np.ndarray          # [E] i64 row id per col-sorted entry
    num_nodes: int
    num_edges: int


def build_plan(edges_i, edges_j, edges_w, num_nodes) -> DiffusionPlan:
    """Precompute the plan on the host (one-time, O(E log E))."""
    order_r = np.lexsort((edges_j, edges_i))
    ri, rj = edges_i[order_r], edges_j[order_r]
    order_c = np.lexsort((edges_i, edges_j))
    deg = np.bincount(ri, minlength=num_nodes)
    # the pattern is symmetric (both edge directions present), so the
    # col-sorted layout has the same per-column starts; the rank of each
    # row-sorted entry under the (col, row) key is the row-sorted position
    # of its transpose (sparsematrix.cc:120-191 re-sort semantics)
    return DiffusionPlan(
        rw=edges_w[order_r].astype(np.float32),
        wv_col=edges_w[order_c].astype(np.float32),
        ri=ri, rj=rj, deg=deg,
        rowstart=np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int64),
        order_col=np.lexsort((ri, rj)).astype(np.int64),
        ci=edges_i[order_c].astype(np.int64),
        num_nodes=num_nodes, num_edges=len(edges_w))


class _PairSums:
    """out[k] = sum over c < n[k] of a[A[k, c]] * b[B[k, c]] (b optional).

    Built from n [K], and `index(rows, c)` giving the A (and B) indices of
    rows `rows` at positions c [L] as [len(rows), L] tensors.  Rows are
    grouped by length class (n in (L/2, L], L a power of two) and padded to
    L with a sentinel index that reads an appended zero."""

    def __init__(self, n: torch.Tensor, index, sentinel: int):
        self.K = n.numel()
        self.classes = []
        n_host = n.cpu().numpy()
        top = int(n_host.max(initial=0))
        L = 1
        while top and L // 2 < top:
            sel = np.flatnonzero((n_host > L // 2) & (n_host <= L))
            if len(sel):
                rows = torch.as_tensor(sel, device=n.device)
                c = torch.arange(L, device=n.device)
                pad = c[None, :] >= n[rows][:, None]
                idx = [torch.where(pad, sentinel, x) for x in index(rows, c)]
                self.classes.append((rows, idx))
            L *= 2

    def __call__(self, a_ext, b_ext=None) -> torch.Tensor:
        out = torch.zeros(self.K, dtype=a_ext.dtype, device=a_ext.device)
        for rows, idx in self.classes:
            v = a_ext[idx[0]]
            if b_ext is not None:
                v = v * b_ext[idx[1]]
            out[rows] = v.sum(dim=1)
        return out


def _ext(x):
    """x with one trailing zero (the sentinel slot of _PairSums)."""
    return torch.cat([x, x.new_zeros(1)])


def _merge_walk_hits(p: DiffusionPlan, dev):
    """The "true"-mode merge walk (line3d_tpu's _diffuse_true_kernel
    :190-210), run once: for every row-sorted entry e = (i, j), walk P's
    row i (keys: column ids) and W's column j (keys: row ids) by key
    comparison.  Where the keys meet, P[i, k] * W[k, j] enters the dot.
    The walk depends on the pattern alone, so its meeting points are the
    same in every iteration.  Returns (n [E], index fn) for _PairSums."""
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    rowstart, deg = t(p.rowstart), t(p.deg)
    rj_keys, ci_keys = t(p.rj), t(p.ci)
    base_a = rowstart[t(p.ri)]          # P's row i_e, row-sorted layout
    base_b = rowstart[t(p.rj)]          # W's column j_e, col-sorted layout
    len_a, len_b = deg[t(p.ri)], deg[t(p.rj)]
    e = torch.arange(p.num_edges, device=dev)
    a = torch.zeros_like(e)
    b = torch.zeros_like(e)
    he, ha, hb = [], [], []
    while e.numel():
        pa, pb = base_a[e] + a, base_b[e] + b
        ka, kb = rj_keys[pa], ci_keys[pb]
        hit = ka == kb
        he.append(e[hit])
        ha.append(pa[hit])
        hb.append(pb[hit])
        a = a + (ka <= kb)
        b = b + (kb <= ka)
        live = (a < len_a[e]) & (b < len_b[e])
        e, a, b = e[live], a[live], b[live]
    he, ha, hb = torch.cat(he), torch.cat(ha), torch.cat(hb)
    order = torch.sort(he, stable=True).indices   # by edge, walk order
    ha, hb = ha[order], hb[order]
    n = torch.bincount(he, minlength=p.num_edges)
    off = torch.cumsum(n, 0) - n

    def index(rows, c):
        k = (off[rows][:, None] + c[None, :]).clamp_max(max(len(ha) - 1, 0))
        return ha[k], hb[k]
    return n, index


def _diffuse(edges_i, edges_j, edges_w, num_nodes, iterations, eps, device,
             true_mode: bool):
    E = len(edges_w)
    if E == 0:
        return edges_i, edges_j, edges_w
    dev = torch.device(device)
    p = build_plan(edges_i, edges_j, edges_w, num_nodes)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    rowstart, deg, ri = t(p.rowstart), t(p.deg), t(p.ri)
    order_col = t(p.order_col)
    rw, wv_ext = t(p.rw), _ext(t(p.wv_col))

    # row normalization (cudawrapper.cu:736-760, eps clamp 745-746)
    row_sums = _PairSums(deg, lambda rows, c: (rowstart[rows][:, None]
                                               + c[None, :],), E)

    def row_normalize(pv):
        return pv / row_sums(_ext(pv)).clamp_min(eps)[ri]

    if true_mode:
        n, index = _merge_walk_hits(p, dev)
    else:
        # lockstep: the t-th entry of P's row j_e times the t-th entry of
        # W's column i_e, t < min(deg j_e, deg i_e) (cudawrapper.cu:786-800)
        base_p, base_w = rowstart[t(p.rj)], rowstart[ri]
        n = torch.minimum(deg[t(p.rj)], deg[ri])

        def index(rows, c):
            return (base_p[rows][:, None] + c[None, :],
                    base_w[rows][:, None] + c[None, :])
    dot = _PairSums(n, index, E)

    pv = row_normalize(rw)
    for it in range(iterations):
        if it:
            pv = row_normalize(pv)
        if true_mode:
            # P^T ∘ (P·W) written to transposed positions, as a gather
            pv = (pv * dot(_ext(pv), wv_ext)[order_col]).clamp_min(eps)
        else:
            # write-to-transpose (cudawrapper.cu:805-818) as a gather
            pv = (pv * dot(_ext(pv), wv_ext)).clamp_min(eps)[order_col]
    # min-symmetrize (performDiffusion, line3D.cc:1264-1299)
    w_sym = torch.minimum(pv, pv[order_col])
    return p.ri, p.rj, w_sym.cpu().numpy().astype(np.float64)


def diffuse_reference_device(edges_i, edges_j, edges_w, num_nodes,
                             iterations: int = 10, eps: float = 1e-12,
                             *, device):
    """Reference-mode RDD in float32 on `device`; returns the (i, j)-sorted
    edge list with min-symmetrized weights (float64 numpy)."""
    return _diffuse(edges_i, edges_j, edges_w, num_nodes, iterations, eps,
                    device, true_mode=False)


def diffuse_true_device(edges_i, edges_j, edges_w, num_nodes,
                        iterations: int = 10, eps: float = 1e-12,
                        *, device):
    """"True"-mode RDD in float32 on `device` (the device twin of
    diffusion.diffuse_true); same contract as diffuse_reference_device."""
    return _diffuse(edges_i, edges_j, edges_w, num_nodes, iterations, eps,
                    device, true_mode=True)
