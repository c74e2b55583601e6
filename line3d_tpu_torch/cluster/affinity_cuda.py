"""The affinity stage's exact-order candidate enumeration and its weight
filter on the card.

`enumerate_candidates_cuda` launches `csrc/affinity_enum.cu` on the walk's
own inputs; its stream is the native walk's (`affinity_enumerate_packed`,
the plain twin and the CPU path) element for element, in the same order,
and stays on the card (`CardStream`).  `affinity.enumerate_candidates`
picks one of the two by the Line3D's device; there is no fallback.

The inputs go up once a model from pinned memory without a
synchronisation (`scene.upload`), and the collinearity CSR is transposed
on the card (`transposed_csr`), for the kernel's lookups of who lists a
segment.  The host reads the stream's length (readback site
`affinity.count`).

`kept_candidates` then runs `csrc/affinity_filter.cu` over the stream: it
drops the candidates whose weight it proves below their kind's threshold
(by more than `FILTER_MARGIN` of it), compacts the rest in the stream's
order, and reads them back (sites `affinity.kept_count` and
`affinity.kept`) into pinned memory, in the arrays `_finalize_candidates`
takes.  The host's own sweep decides those, so the graph is the whole
stream's.  `filter_plain` is the filter's rule in numpy, for the tests.
`read_stream` reads a whole stream back, for the checks against the walk.
The card's buffers are released when the last reference goes.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..native import cuda
from ..scene import upload

# kernel launches of the enumeration and the filter in this process: three
# a call of `l3d_affinity_count` (prep, pass 1, pass 2 counting), one a call
# of `l3d_affinity_write` (pass 2 writing), one of `l3d_affinity_filter` and
# one of `l3d_affinity_compact` (none when nothing is kept)
LAUNCHES = 0

# bytes of one candidate on the card and in a readback: src and tgt rows
# (int64), its collinear weight (float64) and its kind (int8)
CANDIDATE_BYTES = 25

# the card drops a candidate only when its weight lies below its kind's
# threshold by more than this share of it: the card's float64 exp and acos
# and the host library's FMA contractions move a weight by ulps, far
# inside it, so every candidate the host's sweep passes is kept
FILTER_MARGIN = 1e-3

# similarity_one's constants (native/affinity_enum.cpp:158-159)
LOG001X2 = 2.0 * math.log(0.01)
RAD2DEG = 180.0 / math.pi


class CardStream(NamedTuple):
    """A candidate stream on the card: `n` candidates in `buf`, 25 n bytes,
    src rows int64 [n], tgt rows int64 [n], collinear weights float64
    [n] and kinds int8 [n], one after the other."""
    buf: torch.Tensor
    n: int


def transposed_csr(ptr: torch.Tensor, coll_j: torch.Tensor, nnz: int,
                   S: int, M: int):
    """The collinearity CSR over keys (`ptr` [M + 1], `coll_j`, partner
    segments ascending in a row) transposed, on the CSR's device without a
    synchronisation: (ptr_t [M + 1], coll_i), the segments of key k's view
    whose rows list k's segment in ptr_t[k]:ptr_t[k + 1], ascending."""
    keys = torch.arange(M + 1, dtype=torch.int64, device=ptr.device)
    row = torch.repeat_interleave(keys[:M], ptr.diff(), output_size=nnz)
    seg = row % S
    listed, at = torch.sort(row - seg + coll_j, stable=True)
    return torch.searchsorted(listed, keys), seg[at]


def enumerate_candidates_cuda(key_sorted, order, pk, row_lookup, ptr,
                              coll_j, coll_w, S: int, M: int,
                              device: torch.device) -> CardStream:
    """The stream of the sources `key_sorted` (rows `order`), the packed
    symmetric pairs `pk`, the key -> row lookup and the collinearity CSR
    (`ptr`, `coll_j`, `coll_w` float64), decided on the CUDA `device` and
    left there."""
    global LAUNCHES
    B, P = len(key_sorted), len(pk)
    if B == 0:
        return CardStream(torch.empty(0, dtype=torch.uint8, device=device), 0)
    if B >= 2 ** 31:
        raise ValueError(f"affinity_enum: {B} sources (ranks are int32)")
    ins = [upload(np.asarray(x, dt), device) for x, dt in (
        (key_sorted, np.int64), (order, np.int64), (pk, np.int64),
        (row_lookup, np.int64), (ptr, np.int64), (coll_j, np.int64),
        (coll_w, np.float64))]
    ptr_t, coll_i = transposed_csr(ins[4], ins[5], len(coll_j), S, M)
    corr_ptr = torch.empty(M + 1, dtype=torch.int64, device=device)
    rank_lt = torch.empty(M + 1, dtype=torch.int32, device=device)
    executed = torch.empty(P, dtype=torch.uint8, device=device)
    cnt = torch.empty(P + B, dtype=torch.int32, device=device)
    ks, od, pkd, rl, pt, cj, cw = (t.data_ptr() for t in ins)
    head = (ks, od, B, pkd, P, rl, pt, cj, cw, ptr_t.data_ptr(),
            coll_i.data_ptr(), S, M, corr_ptr.data_ptr(),
            rank_lt.data_ptr(), executed.data_ptr(), cnt.data_ptr())
    lib = cuda.lib()
    with cuda.on_device(cnt):
        cuda.check(lib.l3d_affinity_count(*head, cuda.stream_of(cnt)),
                   "l3d_affinity_count")
        LAUNCHES += 3
        end = torch.cumsum(cnt, 0, dtype=torch.int64)
        n = int(trace.readback(end[-1:], "affinity.count")[0])
        out = torch.empty(CANDIDATE_BYTES * n, dtype=torch.uint8,
                          device=device)
        if n == 0:
            return CardStream(out, 0)
        cuda.check(lib.l3d_affinity_write(*head, end.data_ptr(), n,
                                          out.data_ptr(),
                                          cuda.stream_of(out)),
                   "l3d_affinity_write")
        LAUNCHES += 1
    return CardStream(out, n)


def _host_arrays(host: np.ndarray, n: int):
    """(src_rows, tgt_rows, kinds, cws) views of a 25 n-byte host buffer."""
    return (host[:8 * n].view(np.int64), host[8 * n:16 * n].view(np.int64),
            host[24 * n:].view(np.int8), host[16 * n:24 * n].view(np.float64))


def _pinned_readback(buf: torch.Tensor, site: str) -> np.ndarray:
    return trace.readback(buf, site, out=torch.empty(
        buf.shape, dtype=torch.uint8, pin_memory=True))


def read_stream(stream: CardStream):
    """The whole stream on the host (site `affinity.candidates`), as the
    walk returns it: (src_rows, tgt_rows, kinds, cws)."""
    return _host_arrays(_pinned_readback(stream.buf, "affinity.candidates"),
                        stream.n)


def filter_constants(config):
    """(log001x2, sa2, cut of kind 0, cut of kinds 1-2): a candidate whose
    finite weight lies below its kind's cut is dropped."""
    cuts = [t - abs(t) * FILTER_MARGIN
            for t in (float(config.min_affinity),
                      float(config.collinear_affinity))]
    sigma_a = float(config.sigma_a)
    return LOG001X2, 2.0 * sigma_a * sigma_a, cuts[0], cuts[1]


def upload_rows(best, cams, device: torch.device) -> list:
    """The filter's row inputs on `device`, in `l3d_affinity_filter`'s
    order, without a synchronisation."""
    return [upload(np.asarray(x, dt), device) for x, dt in (
        (best.P1, np.float64), (best.P2, np.float64), (best.dir, np.float64),
        (best.d1, np.float32), (best.d2, np.float32), (best.view, np.int32),
        (best.score, np.float32), (cams.k_lower, np.float64),
        (cams.k_upper, np.float64), (cams.median_depth, np.float64))]


def filter_flags(stream: CardStream, rows: list, config) -> torch.Tensor:
    """The filter's keep flags (uint8 [n], 1 = kept) of a stream with at
    least one candidate, on the stream's card, without a synchronisation."""
    global LAUNCHES
    cuda.require_cuda("l3d_affinity_filter", stream.buf, *rows)
    keep = torch.empty(stream.n, dtype=torch.uint8, device=stream.buf.device)
    with cuda.on_device(keep):
        cuda.check(cuda.lib().l3d_affinity_filter(
            stream.buf.data_ptr(), stream.n, *(t.data_ptr() for t in rows),
            *filter_constants(config), keep.data_ptr(),
            cuda.stream_of(keep)), "l3d_affinity_filter")
    LAUNCHES += 1
    return keep


def kept_candidates(stream: CardStream, best, cams, config):
    """The candidates of `stream` that the card cannot prove failing, in
    the stream's order, on the host: (src_rows, tgt_rows, kinds, cws)."""
    global LAUNCHES
    n = stream.n
    if n == 0:
        return _host_arrays(np.zeros(0, np.uint8), 0)
    if n >= 2 ** 31:
        raise ValueError(f"affinity_filter: {n} candidates (positions are "
                         "int32)")
    keep = filter_flags(stream, upload_rows(best, cams, stream.buf.device),
                        config)
    pos = torch.cumsum(keep, 0, dtype=torch.int32)
    del keep
    m = int(trace.readback(pos[-1:], "affinity.kept_count")[0])
    trace.count("affinity.kept", m)
    if m == 0:
        return _host_arrays(np.zeros(0, np.uint8), 0)
    out = torch.empty(CANDIDATE_BYTES * m, dtype=torch.uint8,
                      device=stream.buf.device)
    with cuda.on_device(out):
        cuda.check(cuda.lib().l3d_affinity_compact(
            stream.buf.data_ptr(), n, pos.data_ptr(), m, out.data_ptr(),
            cuda.stream_of(out)), "l3d_affinity_compact")
    LAUNCHES += 1
    return _host_arrays(_pinned_readback(out, "affinity.kept"), m)


def filter_plain(src_rows, tgt_rows, kinds, cws, best, cams, config):
    """The filter's rule in numpy, float64, the kernel's operations in its
    order: True where `l3d_affinity_filter` keeps the candidate.  For the
    tests, which hold it to the host's sweep."""
    a = np.asarray(src_rows, np.int64)
    b = np.asarray(tgt_rows, np.int64)
    kinds = np.asarray(kinds)
    log001x2, sa2, cut_a, cut_c = filter_constants(config)

    def p2l(X, p1o, dov):
        dx = X[:, 0] - p1o[:, 0]
        dy = X[:, 1] - p1o[:, 1]
        dz = X[:, 2] - p1o[:, 2]
        t = dx * dov[:, 0] + dy * dov[:, 1] + dz * dov[:, 2]
        q = dx * dx + dy * dy + dz * dz - t * t
        return np.sqrt(np.where(q > 0.0, q, 0.0))

    def side(e, o):
        p1o, dov = best.P1[o], best.dir[o]
        da, db = p2l(best.P1[e], p1o, dov), p2l(best.P2[e], p1o, dov)
        v = best.view[e]
        med = cams.median_depth[v]
        de1 = best.d1[e].astype(np.float64)
        de2 = best.d2[e].astype(np.float64)
        m1 = cams.k_lower[v] * np.where(de1 < med, de1, med)
        m2 = cams.k_lower[v] * np.where(de2 < med, de2, med)
        u1 = cams.k_upper[v] * np.where(de1 < med, de1, med)
        u2 = cams.k_upper[v] * np.where(de2 < med, de2, med)
        s1sq = -(u1 - m1) * (u1 - m1) / log001x2
        s2sq = -(u2 - m2) * (u2 - m2) / log001x2
        e1 = np.where(da < m1, 1.0,
                      np.exp(-(da - m1) * (da - m1) / (2.0 * s1sq)))
        e2 = np.where(db < m2, 1.0,
                      np.exp(-(db - m2) * (db - m2) / (2.0 * s2sq)))
        return np.where(e1 < e2, e1, e2)

    with np.errstate(all="ignore"):
        w12, w34 = side(a, b), side(b, a)
        wd = np.where(w12 < w34, w12, w34)
        da, db = best.dir[a], best.dir[b]
        dot = da[:, 0] * db[:, 0] + da[:, 1] * db[:, 1] + da[:, 2] * db[:, 2]
        dot = np.where(dot > 1.0, 1.0, np.where(dot < -1.0, -1.0, dot))
        ang = np.arccos(dot) * RAD2DEG
        ang = np.where(ang > 90.0, 180.0 - ang, ang)
        wa = np.exp(-ang * ang / sa2)
        sim = np.where(wd < wa, wd, wa)
        base = 0.5 * (best.score[a].astype(np.float64) +
                      best.score[b].astype(np.float64))
        w = np.where(kinds == 2, cws, 1.0) * base * sim
    return ~(np.isfinite(w) & (w < np.where(kinds == 0, cut_a, cut_c)))
