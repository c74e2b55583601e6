"""Kernels K2/K3: multi-view support scoring of one view's match table.

`score` launches the CUDA kernel `csrc/scoring.cu` (replacing
`line3d_tpu/match/scoring_pallas.py:_kernel_tiled` for M > 256 and
`_kernel` for M <= 256; one kernel serves both) for CUDA tensors, and runs
`score_plain`, the plain PyTorch twin, for CPU tensors.  There is no
fallback: a CUDA tensor either goes through the kernel or raises.

The kernel takes the match table as `engine.match_view` holds it and
derives the per-row and per-slot terms itself; the only host work is four
float32 scalars and the output (and, for rows too wide for a block's shared
memory, a scratch buffer).
"""
from __future__ import annotations

import torch

from ..native import cuda
from . import scoring
from .pairwise import gather_target_coords

# launches of the CUDA kernel in this process, and those at M > 256 (the
# match-slot widths the TPU package gave to its tiled kernel K2)
LAUNCHES = 0
LAUNCHES_WIDE = 0

# neighbor cameras the kernel keeps per-camera maxima for (compiled in)
MAX_CAMS = 32


def score_plain(segs_src, RtKinv_src, C_src, cam, tgt, depths, valid,
                P_nb, segs_nb, sigma_p, sigma_a, spatial_k,
                support_threshold=0.5, tcoords=None):
    """Confidence [S, M] f32 in plain PyTorch (`scoring.score_matches`)."""
    return scoring.score_matches(
        segs_src, None, RtKinv_src, C_src, cam, tgt, depths, valid, P_nb,
        segs_nb, sigma_p, sigma_a, spatial_k,
        support_threshold=support_threshold, tcoords=tcoords)


def score_cuda(segs_src, RtKinv_src, C_src, cam, tgt, depths, valid,
               P_nb, segs_nb, sigma_p, sigma_a, spatial_k,
               support_threshold=0.5, tcoords=None):
    """Confidence [S, M] f32 from the CUDA kernel (one launch)."""
    global LAUNCHES, LAUNCHES_WIDE
    if tcoords is None:
        tcoords = gather_target_coords(segs_nb, cam, tgt)
    S, M = cam.shape
    N = P_nb.shape[0]
    f32 = torch.float32
    if depths.shape != (S, M, 4) or valid.shape != (S, M) or \
            tcoords.shape != (S, M, 4) or segs_src.shape != (S, 4) or \
            RtKinv_src.shape != (3, 3) or C_src.shape != (3,) or \
            P_nb.shape != (N, 3, 4):
        raise ValueError("score: inconsistent shapes")
    if N > MAX_CAMS:
        raise ValueError(f"score: {N} neighbor cameras exceed the "
                         f"kernel's compiled limit of {MAX_CAMS}")
    cuda.require_cuda("score", cam, depths, valid, tcoords, segs_src,
                      RtKinv_src, C_src, P_nb,
                      dtypes=[torch.int32, f32, torch.bool] + [f32] * 5)
    dev = cam.device
    lib = cuda.lib()
    nbytes = lib.l3d_score_scratch_bytes(M, N, S, dev.index or 0)
    if nbytes < 0:
        cuda.check(-nbytes, "l3d_score_scratch_bytes")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) \
        if nbytes else None
    out = torch.empty((S, M), dtype=f32, device=dev)
    params = scoring.kernel_params(sigma_p, sigma_a, spatial_k,
                                   support_threshold)
    rc = lib.l3d_score(
        cam.data_ptr(), depths.data_ptr(), valid.data_ptr(),
        tcoords.data_ptr(), segs_src.data_ptr(), RtKinv_src.data_ptr(),
        C_src.data_ptr(), P_nb.data_ptr(), *(float(p) for p in params),
        N, S, M, None if scratch is None else scratch.data_ptr(),
        out.data_ptr(), dev.index or 0, cuda.stream_of(cam))
    cuda.check(rc, "l3d_score")
    LAUNCHES += 1
    if M > 256:
        LAUNCHES_WIDE += 1
    return out


def score(segs_src, RtKinv_src, C_src, cam, tgt, depths, valid,
          P_nb, segs_nb, sigma_p, sigma_a, spatial_k,
          support_threshold=0.5, tcoords=None):
    """Confidence [S, M]: the kernel on CUDA, the plain twin on the CPU."""
    args = (segs_src, RtKinv_src, C_src, cam, tgt, depths, valid, P_nb,
            segs_nb, sigma_p, sigma_a, spatial_k, support_threshold)
    if cam.device.type == "cpu":
        return score_plain(*args, tcoords=tcoords)
    return score_cuda(*args, tcoords=tcoords)
