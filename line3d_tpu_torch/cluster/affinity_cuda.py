"""The affinity stage's exact-order candidate enumeration on the card.

`enumerate_candidates_cuda` launches `csrc/affinity_enum.cu` on the walk's
own inputs and returns its stream, which is the native walk's
(`affinity_enumerate_packed`, the plain twin and the CPU path) element for
element, in the same order.  `affinity.enumerate_candidates` picks one of
the two by the Line3D's device; there is no fallback.

The inputs go up once a model from pinned memory without a
synchronisation (`scene.upload`), and the collinearity CSR is transposed
on the card (`transposed_csr`), for the kernel's lookups of who lists a
segment.  The host then reads the stream's length
(readback site `affinity.count`) and the stream itself (site
`affinity.candidates`) into pinned memory, in the arrays
`_finalize_candidates` takes.  The card's buffers are released when the
call returns.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..native import cuda
from ..scene import upload

# kernel launches of the enumeration in this process: three a call of
# `l3d_affinity_count` (prep, pass 1, pass 2 counting), one a call of
# `l3d_affinity_write` (pass 2 writing)
LAUNCHES = 0

# bytes of one candidate in the readback: src and tgt rows (int64), its
# collinear weight (float64) and its kind (int8)
CANDIDATE_BYTES = 25


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
                              device: torch.device):
    """(src_rows int64, tgt_rows int64, kinds int8, cws float64) of the
    sources `key_sorted` (rows `order`), the packed symmetric pairs `pk`,
    the key -> row lookup and the collinearity CSR (`ptr`, `coll_j`,
    `coll_w` float64), decided on the CUDA `device`."""
    global LAUNCHES
    B, P = len(key_sorted), len(pk)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64),
             np.zeros(0, np.int8), np.zeros(0, np.float64))
    if B == 0:
        return empty
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
        if n == 0:
            return empty
        out = torch.empty(CANDIDATE_BYTES * n, dtype=torch.uint8,
                          device=device)
        cuda.check(lib.l3d_affinity_write(*head, end.data_ptr(), n,
                                          out.data_ptr(),
                                          cuda.stream_of(out)),
                   "l3d_affinity_write")
        LAUNCHES += 1
    host = trace.readback(out, "affinity.candidates", out=torch.empty(
        out.shape, dtype=torch.uint8, pin_memory=True))
    return (host[:8 * n].view(np.int64), host[8 * n:16 * n].view(np.int64),
            host[24 * n:].view(np.int8), host[16 * n:24 * n].view(np.float64))
