"""Kernels K2/K3: multi-view support scoring of one view's match table.

`score` launches the CUDA kernel `csrc/scoring.cu` (replacing
`line3d_tpu/match/scoring_pallas.py:_kernel_tiled` for M > 256 and
`_kernel` for M <= 256; one kernel serves both) for CUDA tensors, and runs
`score_plain`, the plain PyTorch twin, for CPU tensors.  There is no
fallback: a CUDA tensor either goes through the kernel or raises.
"""
from __future__ import annotations

import torch

from ..native import cuda
from . import scoring

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
    pm, btab, atab, params, need = scoring.kernel_inputs(
        segs_src, RtKinv_src, C_src, cam, tgt, depths, valid, P_nb, segs_nb,
        sigma_p, sigma_a, spatial_k, support_threshold, tcoords=tcoords)
    return score_prepared(pm, btab, atab, params, need)


def score_prepared(pm, btab, atab, params, need):
    """Launch the scoring kernel on prepared inputs (`kernel_inputs`)."""
    global LAUNCHES, LAUNCHES_WIDE
    S, n_pm, M = pm.shape
    N = atab.shape[0] // 3
    f32 = torch.float32
    if n_pm != scoring._PM or btab.shape != (S, 6 * N) or \
            atab.shape != (3 * N,) or params.shape != (4,) or \
            need.shape != (S,):
        raise ValueError("score: inconsistent shapes")
    if N > MAX_CAMS:
        raise ValueError(f"score: {N} neighbor cameras exceed the "
                         f"kernel's compiled limit of {MAX_CAMS}")
    if S > 65535:
        raise ValueError(f"score: {S} rows exceed the grid limit 65535")
    cuda.require_cuda("score", pm, btab, atab, params, need,
                      dtypes=[f32, f32, f32, f32, torch.int32])
    out = torch.empty((S, M), dtype=f32, device=pm.device)
    rc = cuda.lib().l3d_score(
        pm.data_ptr(), btab.data_ptr(), atab.data_ptr(), params.data_ptr(),
        need.data_ptr(), N, S, M, out.data_ptr(), cuda.stream_of(pm))
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
