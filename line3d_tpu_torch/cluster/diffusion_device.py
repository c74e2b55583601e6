"""Device-side replicator-dynamics diffusion in float32 torch.

Torch port of `line3d_tpu/cluster/diffusion_device.py`, the device
equivalent of the reference RDD GPU kernels (K_sparseMat_row_normalization
cudawrapper.cu:717-762, K_sparseMat_diffusion_step cudawrapper.cu:765-829,
host driver replicator_dynamics_diffusion cudawrapper.cu:1131-1191): a
static index plan is built once on `device` (sorted COO layout by stable
sorts of composite keys, lockstep bases, transpose permutation,
`build_plan`), then the iterations run there too.
Both modes of `diffusion.py` have a device form here: "reference" (the
lockstep walk, `diffuse_reference_device`) and "true" (the sparse dot over
common inner indices, `diffuse_true_device`).

Every per-iteration sum is a product sum over a static list of index
pairs: out[k] = sum over c < n_k of a[A[k, c]] * b[B[k, c]].  The row sums
of the normalization (b = 1, A = the row's entries), the lockstep dot
(A[e, c] = rowstart[j_e] + c, B[e, c] = colstart[i_e] + c, n_e = min of the
two degrees) and the true dot (the (P, W) positions where the merge walk
of P's row i_e and W's column j_e meets, found once per call) all take
this form.  `_PairSums` evaluates it as one padded gather per power-of-two
length class and a sum over the padded axis by pairwise halving: no
atomics, so two runs on the card give the same bits (a float `index_add_`
or `scatter_add_` on CUDA sums in an order that changes from run to run),
and the additions of a row do not depend on how many rows are summed with
it (a library reduction may choose its order by the row count).  Values
are float32, as in the reference kernels (the host path in diffusion.py is
float64).

Across N processes (`parallel/multihost.py`) the O(E·K) work splits by
edge, as line3d_tpu shards the [E] arrays over its mesh: each rank builds
and evaluates the dot (and the true-mode merge walk) for its contiguous
range of the row-sorted edges only, and all-gathers its slice of the new
values once per iteration; the O(E) row normalisation, transpose gather and
min-symmetrisation run on every rank.  A row's sum is its own, so every
rank gets the single process's bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel import multihost
from .. import trace


@dataclass
class DiffusionPlan:
    """Static index plan of the (i, j)-sorted edge list, on the device."""
    rw: torch.Tensor          # [E] f32 row-sorted values (P's initial W)
    wv_col: torch.Tensor      # [E] f32 col-sorted values (W, fixed)
    ri: torch.Tensor          # [E] i64 row ids, (i, j)-sorted
    rj: torch.Tensor          # [E] i64 col ids
    deg: torch.Tensor         # [num_nodes] i64 row (= column) degrees
    rowstart: torch.Tensor    # [num_nodes] i64 row-sorted (= col-sorted) starts
    order_col: torch.Tensor   # [E] i64 transpose gather permutation
    ci: torch.Tensor          # [E] i64 row id per col-sorted entry
    num_nodes: int
    num_edges: int


def build_plan(edges_i, edges_j, edges_w, num_nodes, device) -> DiffusionPlan:
    """The plan on `device` (one-time, three sorts of E int64 keys).

    The edges go up once (ids as int32, widened there; values as float32,
    which gives the bits of casting after the permutation).  A stable sort
    of the composite key i * N + j is np.lexsort((j, i)), ties in input
    order included, so every array is the one np.lexsort over the two
    columns would give, element for element.  The degrees and starts come
    from searching the sorted row ids, with nothing read back."""
    dev = torch.device(device)
    N = int(num_nodes)

    def up(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)
    i, j = up(edges_i, np.int32).long(), up(edges_j, np.int32).long()
    w = up(edges_w, np.float32)
    order_r = torch.sort(i * N + j, stable=True).indices
    order_c = torch.sort(j * N + i, stable=True).indices
    ri, rj = i[order_r], j[order_r]
    bounds = torch.searchsorted(ri, torch.arange(N + 1, device=dev))
    # the pattern is symmetric (both edge directions present), so the
    # col-sorted layout has the same per-column starts; the rank of each
    # row-sorted entry under the (col, row) key is the row-sorted position
    # of its transpose (sparsematrix.cc:120-191 re-sort semantics)
    return DiffusionPlan(
        rw=w[order_r], wv_col=w[order_c], ri=ri, rj=rj,
        deg=bounds[1:] - bounds[:-1], rowstart=bounds[:-1],
        order_col=torch.sort(rj * N + ri, stable=True).indices,
        ci=i[order_c], num_nodes=N, num_edges=len(edges_w))


# the class of rows that sum nothing (n = 0): after every length class
NO_CLASS = 64


class _PairSums:
    """out[k] = sum over c < n[k] of a[A[k, c]] * b[B[k, c]] (b optional).

    Built from n [K], and `index(rows, c)` giving the A (and B) indices of
    rows `rows` at positions c [L] as [len(rows), L] tensors.  Rows are
    grouped by length class (n in (L/2, L], L a power of two) and padded to
    L with a sentinel index that reads an appended zero.  The padded index
    planes are formed at each call, CHUNK elements at a time: for all rows
    at once they are O(E x degree) (60 GB for the 1000-view facade's 41 M
    edges).  Each row's sum is its own, so the chunking changes no bit."""

    # index elements formed at once (two int64 planes and a float plane)
    CHUNK = 1 << 25

    def __init__(self, n: torch.Tensor, index, sentinel: int):
        self.K = n.numel()
        self.n, self.index, self.sentinel = n, index, sentinel
        # terms: the products of one evaluation (padding left out)
        self.terms, self.classes = self.split(n)

    @staticmethod
    def split(n: torch.Tensor):
        """(terms, classes): the sum of n, and for each length class L in
        ascending order the rows of that class, ascending, beside
        arange(L); on n's device.  Each row's class, ceil(log2 n), is the
        bit length of n - 1, the exponent frexp gives exactly; one stable
        sort orders the rows by class, and only the class bounds and the
        sum are read back (66 integers).  Each row's sum is its own and its
        halving order depends on L alone, so no bit depends on how the
        rows of a class are ordered."""
        cls = torch.where(n > 0, torch.frexp((n - 1).double()).exponent,
                          NO_CLASS)
        key, rows = torch.sort(cls, stable=True)
        bounds = torch.searchsorted(
            key, torch.arange(NO_CLASS + 1, dtype=key.dtype, device=n.device))
        host = trace.readback(torch.cat([bounds, n.sum().view(1)]),
                              "diffusion.classes")
        classes = [(rows[int(b0):int(b1)],
                    torch.arange(1 << c, device=n.device))
                   for c, (b0, b1) in enumerate(zip(host[:NO_CLASS],
                                                    host[1:NO_CLASS + 1]))
                   if b1 > b0]
        return int(host[-1]), classes

    def __call__(self, a_ext, b_ext=None) -> torch.Tensor:
        out = torch.zeros(self.K, dtype=a_ext.dtype, device=a_ext.device)
        for rows_all, c in self.classes:
            step = max(1, self.CHUNK // len(c))
            for r0 in range(0, len(rows_all), step):
                rows = rows_all[r0:r0 + step]
                pad = c[None, :] >= self.n[rows][:, None]
                idx = [torch.where(pad, self.sentinel, x)
                       for x in self.index(rows, c)]
                v = a_ext[idx[0]]
                if b_ext is not None:
                    v = v * b_ext[idx[1]]
                # pairwise halving over the padded axis: elementwise adds
                # in an order fixed by L alone
                while v.shape[1] > 1:
                    h = v.shape[1] // 2
                    v = v[:, :h] + v[:, h:]
                out[rows] = v[:, 0]
        return out


def _ext(x):
    """x with one trailing zero (the sentinel slot of _PairSums)."""
    return torch.cat([x, x.new_zeros(1)])


# the merge walk runs on chunks of edges whose walks can meet at most this
# many times in all (the lesser degree bounds an edge's meetings)
WALK_CHUNK = 1 << 28


def _walk_cuts(p: DiffusionPlan, lo: int, hi: int) -> np.ndarray:
    """Where the edges [lo, hi) split into chunks of at most WALK_CHUNK
    possible meetings (the lesser degree bounds an edge's meetings):
    np.searchsorted of the running bound at each multiple of WALK_CHUNK
    below its total, counted from lo.  Computed on the device; the total
    and the cut points are read back."""
    deg = p.deg
    bound = torch.cumsum(torch.minimum(deg[p.ri[lo:hi]], deg[p.rj[lo:hi]]),
                         0)
    if not len(bound):
        return np.zeros(0, np.int64)
    total = int(trace.readback(bound[-1:], "diffusion.cuts")[0])
    marks = torch.arange(WALK_CHUNK, max(total, WALK_CHUNK), WALK_CHUNK,
                         device=deg.device)
    return trace.readback(torch.searchsorted(bound, marks), "diffusion.cuts")


def _merge_walk_hits(p: DiffusionPlan, lo: int, hi: int):
    """The "true"-mode merge walk (line3d_tpu's _diffuse_true_kernel
    :190-210), run once: for every row-sorted entry e = (i, j) in [lo, hi),
    walk P's row i (keys: column ids) and W's column j (keys: row ids) by
    key comparison.  Where the keys meet, P[i, k] * W[k, j] enters the dot.
    The walk depends on the pattern alone, so its meeting points are the
    same in every iteration.  It runs on chunks of edges of at most
    WALK_CHUNK possible meetings (`_walk_cuts`) and keeps each meeting's
    two positions as int32: for all edges at once in int64, with their
    sort, they outgrow an 80 GB card at the 1000-view facade's 41 M edges.
    Each edge's meetings keep their walk order, so the chunks change no
    bit.  Returns (n [hi - lo], index fn) for _PairSums, rows counted from
    lo."""
    dev = p.ri.device
    rowstart, deg = p.rowstart, p.deg
    rj_keys, ci_keys = p.rj, p.ci
    base_a = rowstart[p.ri]             # P's row i_e, row-sorted layout
    base_b = rowstart[p.rj]             # W's column j_e, col-sorted layout
    len_a, len_b = deg[p.ri], deg[p.rj]
    cuts = _walk_cuts(p, lo, hi)
    ns = [torch.zeros(0, dtype=torch.int64, device=dev)]
    has = [torch.zeros(0, dtype=torch.int32, device=dev)]
    hbs = list(has)
    for c0, c1 in zip(np.r_[0, cuts], np.r_[cuts, hi - lo]):
        if c1 == c0:
            continue
        e = torch.arange(lo + c0, lo + c1, device=dev)
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
        he = torch.cat(he)
        order = torch.sort(he, stable=True).indices   # by edge, walk order
        has.append(torch.cat(ha)[order].to(torch.int32))
        hbs.append(torch.cat(hb)[order].to(torch.int32))
        ns.append(torch.bincount(he - lo - int(c0),
                                 minlength=int(c1 - c0)))
    ha, hb = torch.cat(has), torch.cat(hbs)
    n = torch.cat(ns)
    off = torch.cumsum(n, 0) - n

    def index(rows, c):
        k = (off[rows][:, None] + c[None, :]).clamp_max(max(len(ha) - 1, 0))
        return ha[k].long(), hb[k].long()
    return n, index


def _row_sums(p: DiffusionPlan) -> _PairSums:
    """The row normalization's sums (cudawrapper.cu:736-760) as a
    _PairSums over the num_nodes rows."""
    return _PairSums(p.deg, lambda rows, c: (p.rowstart[rows][:, None]
                                             + c[None, :],), p.num_edges)


def _edge_dot(p: DiffusionPlan, lo: int, hi: int,
              true_mode: bool) -> _PairSums:
    """The diffusion dot of the row-sorted edges [lo, hi) (this rank's
    share) as a _PairSums over those hi - lo rows."""
    if true_mode:
        n, index = _merge_walk_hits(p, lo, hi)
    else:
        # lockstep: the t-th entry of P's row j_e times the t-th entry of
        # W's column i_e, t < min(deg j_e, deg i_e) (cudawrapper.cu:786-800)
        rowstart, deg = p.rowstart, p.deg
        rj, ri = p.rj[lo:hi], p.ri[lo:hi]
        base_p, base_w = rowstart[rj], rowstart[ri]
        n = torch.minimum(deg[rj], deg[ri])

        def index(rows, c):
            return (base_p[rows][:, None] + c[None, :],
                    base_w[rows][:, None] + c[None, :])
    return _PairSums(n, index, p.num_edges)


def _diffuse(edges_i, edges_j, edges_w, num_nodes, iterations, eps, device,
             true_mode: bool, out_info):
    E = len(edges_w)
    if E == 0:
        return edges_i, edges_j, edges_w
    # stage diffusion.plan: the uploads, the device plan and the length
    # classes of both product sums (each reads its class bounds back)
    with trace.stage("diffusion.plan"):
        p = build_plan(edges_i, edges_j, edges_w, num_nodes, device)
        ri, order_col = p.ri, p.order_col
        rw, wv_ext = p.rw, _ext(p.wv_col)
        # row normalization (cudawrapper.cu:736-760, eps clamp 745-746)
        row_sums = _row_sums(p)
        lo, hi = multihost.local_range(E)
        dot = _edge_dot(p, lo, hi, true_mode)
    trace.count("diffusion.edges", E)
    trace.count("diffusion.terms", dot.terms)
    if out_info is not None:
        out_info.update(edges=E, terms=dot.terms)

    def row_normalize(pv):
        return pv / row_sums(_ext(pv)).clamp_min(eps)[ri]

    # stage diffusion.iterate: the iterations, the min-symmetrisation and
    # the readback of the weights and of the sorted edge ids
    with trace.stage("diffusion.iterate"):
        pv = row_normalize(rw)
        for it in range(iterations):
            if it:
                pv = row_normalize(pv)
            d = dot(_ext(pv), wv_ext)                 # edges [lo, hi)
            if true_mode:
                # P^T ∘ (P·W) written to transposed positions, as a gather
                pv = (pv * multihost.allgather_tensor(d)[order_col]) \
                    .clamp_min(eps)
            else:
                # write-to-transpose (cudawrapper.cu:805-818) as a gather
                pv = multihost.allgather_tensor(
                    (pv[lo:hi] * d).clamp_min(eps))[order_col]
        # min-symmetrize (performDiffusion, line3D.cc:1264-1299)
        w_sym = torch.minimum(pv, pv[order_col])
        w = trace.readback(w_sym, "diffusion.weights").astype(np.float64)
        ij = trace.readback(torch.stack([ri.to(torch.int32),
                                         p.rj.to(torch.int32)]),
                            "diffusion.edges")
    return (ij[0].astype(np.asarray(edges_i).dtype),
            ij[1].astype(np.asarray(edges_j).dtype), w)


def diffuse_reference_device(edges_i, edges_j, edges_w, num_nodes,
                             iterations: int = 10, eps: float = 1e-12,
                             *, device, out_info: dict | None = None):
    """Reference-mode RDD in float32 on `device`; returns the (i, j)-sorted
    edge list with min-symmetrized weights (float64 numpy).  `out_info`
    receives the stage's size: `edges` (E) and `terms`, the products of
    one evaluation of this rank's dot (the sum over its edges of
    min(deg i, deg j))."""
    return _diffuse(edges_i, edges_j, edges_w, num_nodes, iterations, eps,
                    device, False, out_info)


def diffuse_true_device(edges_i, edges_j, edges_w, num_nodes,
                        iterations: int = 10, eps: float = 1e-12,
                        *, device, out_info: dict | None = None):
    """"True"-mode RDD in float32 on `device` (the device twin of
    diffusion.diffuse_true); same contract as diffuse_reference_device,
    `terms` counting the merge walk's meetings."""
    return _diffuse(edges_i, edges_j, edges_w, num_nodes, iterations, eps,
                    device, True, out_info)
