"""Kernel K4: every view's collinear pairs in one fused launch sequence.

`collin_pairs_cuda` launches `csrc/collin_pairs.cu` (replacing
`line3d_tpu/match/collinearity_pallas.py:_kernel` and the device work of
`collinearity_compact_all` around it) for CUDA tensors; it raises on
anything else.  Its plain PyTorch twin is
`collinearity.collinearity_compact_all_plain`, built on `collin_keep_plain`
below, and `collinearity.collinearity_compact_all` picks one of the two by
the tensors' device.  There is no fallback.

Both gate on squared distances with a relative widening of 1e-4, so the
keep plane is a superset of `collinearity.collinearity_matrix(...) > 0`; the
affinity is recomputed and regated at each block's first `quota`
candidates.
"""
from __future__ import annotations

import numpy as np
import torch

from ..native import cuda
from .pairwise import block_size

EPS = 1e-12
# relative widening of the squared-distance gate (collinearity_pallas.py:32)
MARGIN = 1e-4

# calls of the fused kernel sequence in this process
LAUNCHES = 0


def keep_threshold_sq(coll_sigma_sq, aff_threshold: float = 0.5) -> float:
    """thr^2 with exp(-d^2 / 2 sigma^2) > T  <=>  d^2 < 2 sigma^2 ln(1/T),
    widened by MARGIN; f32 arithmetic as in collinearity_keep_pallas."""
    f32 = np.float32
    neg_ln_t = f32(-np.log(aff_threshold))
    return float(f32(f32(f32(2.0) * f32(coll_sigma_sq)) * neg_ln_t)
                 * f32(1.0 + MARGIN))


def block_quota(S: int, quota: int):
    """(blk, q): `pairwise.compact_rows_blockq`'s partner block and
    per-block quota min(quota, blk)."""
    blk = block_size(S)
    return blk, min(max(quota, 0), blk)


def collin_keep_plain(segs, mask, thr_sq: float):
    """Keep plane [S, S] bool in plain PyTorch (collinearity_pallas.py
    formulation)."""
    p1x = segs[:, 0:1]; p1y = segs[:, 1:2]
    p2x = segs[:, 2:3]; p2y = segs[:, 3:4]
    q1x = segs[None, :, 0]; q1y = segs[None, :, 1]
    q2x = segs[None, :, 2]; q2y = segs[None, :, 3]

    lia = p1y - p2y; lib = p2x - p1x; lic = p1x * p2y - p1y * p2x
    lja = q1y - q2y; ljb = q2x - q1x; ljc = q1x * q2y - q1y * q2x
    den_i = lia * lia + lib * lib
    den_j = lja * lja + ljb * ljb

    # mutual max endpoint-to-line distances (cudawrapper.cu:509-511) on
    # squared numerators
    n1 = lja * p1x + ljb * p1y + ljc
    n2 = lja * p2x + ljb * p2y + ljc
    m1 = lia * q1x + lib * q1y + lic
    m2 = lia * q2x + lib * q2y + lic
    close = (torch.maximum(n1 * n1, n2 * n2) <= thr_sq * den_j) & \
            (torch.maximum(m1 * m1, m2 * m2) <= thr_sq * den_i) & \
            (den_i > EPS) & (den_j > EPS)

    def dot(ux, uy, vx, vy):
        return ux * vx + uy * vy

    pos1 = dot(q1x - p1x, q1y - p1y, q2x - p1x, q2y - p1y)
    pos2 = dot(q1x - p2x, q1y - p2y, q2x - p2x, q2y - p2y)
    pos3 = dot(p1x - q1x, p1y - q1y, p2x - q1x, p2y - q1y)
    pos4 = dot(p1x - q2x, p1y - q2y, p2x - q2x, p2y - q2y)
    no_overlap = (pos1 > -EPS) & (pos2 > -EPS) & (pos3 > -EPS) & \
                 (pos4 > -EPS)

    S = segs.shape[0]
    eye = torch.eye(S, dtype=torch.bool, device=segs.device)
    return close & no_overlap & mask[:, None] & mask[None, :] & ~eye


def collin_pairs_cuda(segments, masks, thr_sq: float, coll_sigma_sq: float,
                      aff_threshold: float, quota: int, cap: int):
    """All views' pair lists from the fused kernel (pass 1 and pass 2 on
    the current stream; no host synchronisation).

    segments [V, S, 4] f32, masks [V, S] bool on one CUDA device; `quota`
    per block of `block_quota(S, .)[0]` partners, `cap` slots per view.
    Returns (pairs [V, cap] int32 keys i*S+j (-1 pads), w [V, cap] f32 (0
    pads), count [V] int64 candidates before the quota)."""
    global LAUNCHES
    V, S = masks.shape
    if segments.shape != (V, S, 4):
        raise ValueError("collin_pairs: inconsistent shapes")
    if S == 0 or S * S >= 2 ** 31:
        raise ValueError(f"collin_pairs: S = {S} outside 1..46340 (keys "
                         "i*S+j are int32)")
    blk, q = block_quota(S, quota)
    cuda.require_cuda("collin_pairs", segments, masks,
                      dtypes=[torch.float32, torch.bool])
    dev = segments.device
    scratch = torch.empty((4, V, S), dtype=torch.int32, device=dev)
    pairs = torch.empty((V, cap), dtype=torch.int32, device=dev)
    w = torch.empty((V, cap), dtype=torch.float32, device=dev)
    count = torch.empty(V, dtype=torch.int64, device=dev)
    with cuda.on_device(segments):
        rc = cuda.lib().l3d_collin_pairs(
            segments.data_ptr(), masks.data_ptr(), V, S, blk, q,
            float(thr_sq), float(np.float32(2.0 * coll_sigma_sq)),
            float(aff_threshold), cap, scratch.data_ptr(), pairs.data_ptr(),
            w.data_ptr(), count.data_ptr(), cuda.stream_of(segments))
    cuda.check(rc, "l3d_collin_pairs")
    LAUNCHES += 1
    return pairs, w, count
