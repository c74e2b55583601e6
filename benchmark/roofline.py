"""The yardstick of the kernels' roofline shares: the card's published
peaks and the work each kernel needs for the inputs it was given.

The operation counts are those of `chip_smoke.pair_ops` and of the scoring
kernel's byte count there, frozen here.  Where the work depends on the
data, what these inputs need is counted: K1 triangulates at least the
pairs its gates pass (its cheap-gate survivors are a superset the trace
does not carry, so the count is a floor), and the scoring kernel's pair
tests depend on its spatial gate, so only its per-slot work and its bytes
are counted.  A floor on the work keeps the share at or under the truth.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W: float32 outside
# the tensor cores, and HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# K1: operations per pair (the cheap gates), per pair that passes them
# (two-ray triangulation and its sign tests), per segment, per segment and
# neighbour, per neighbour
PAIR_CHEAP_OPS, PAIR_TRI_OPS, K1_SIGN_OPS = 162, 180, 8
SEG_OPS, SEG_NB_OPS, NB_OPS = 59, 24, 5
# the scoring kernel's operations per valid slot
SCORE_SLOT_OPS = 48


def least_seconds(ops: float, nbytes: float) -> float:
    """The larger of the operations over the float32 peak and the bytes
    over the memory peak."""
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)


def k1_work(src: int, tgts: list, valid: int):
    """(operations, bytes) of one view's K1 launch: `src` source segments
    against neighbours of `tgts` segments, `valid` pairs passing."""
    N = len(tgts)
    pairs = sum(src * t for t in tgts)
    ops = (pairs * PAIR_CHEAP_OPS + (src + sum(tgts)) * SEG_OPS
           + sum(src + t for t in tgts) * SEG_NB_OPS + N * NB_OPS
           + valid * (PAIR_TRI_OPS + K1_SIGN_OPS))
    # segments and masks read, per-pair camera data, the plane written
    nbytes = (src + sum(tgts)) * 17 + N * (36 + 36 + 12) + 48 + pairs
    return ops, nbytes


def score_work(S: int, M: int, valid: int):
    """(operations, bytes) of one view's scoring launch over an [S, M]
    table with `valid` slots: the table read (cam, valid, depths, target
    coordinates of the valid slots) and the confidences written."""
    return valid * SCORE_SLOT_OPS, S * M * (1 + 4) + valid * (4 + 8 + 16)
