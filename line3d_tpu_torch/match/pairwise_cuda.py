"""Kernels K1 and K5: the pair planes of one view against N neighbors.

`pair_valid` launches the CUDA kernel `csrc/pair_valid.cu` (replacing
`line3d_tpu/match/pairwise_pallas.py:_kernel_valid`) for CUDA tensors and
runs `pair_valid_plain`, the plain PyTorch twin, for CPU tensors.
`pair_dense` does the same for K5, `csrc/pair_dense.cu` (replacing
`pairwise_pallas.py:_kernel`, `match_pair_dense_pallas`): the four depth
planes beside the valid plane.  The two kernels evaluate each pair with the
same expressions (`csrc/pair_math.cuh`), so K1's plane equals K5's valid
plane.  There is no fallback: a CUDA tensor either goes through the kernel
or raises.

The match engine takes K1; K5 is the dense form the validation path holds
against the plain formulation (`scripts/tpu_validate.py`'s phase 2 in the
reference).
"""
from __future__ import annotations

import torch

from ..native import cuda
from . import pairwise

# launches of the CUDA kernels in this process (K1, K5)
LAUNCHES = 0
LAUNCHES_DENSE = 0


def pair_valid_plain(segs_src, mask_src, segs_nb, mask_nb, F_nb,
                     RtKinv_src, RtKinv_nb, C_src, C_nb,
                     min_overlap_lower=pairwise.MIN_OVERLAP_LOWER,
                     min_overlap_upper=pairwise.MIN_OVERLAP_UPPER):
    """[N, Ss, St] bool valid planes; plain PyTorch (`match_pair_dense`)."""
    return torch.stack([
        pairwise.match_pair_dense(
            segs_src, segs_nb[n], mask_src, mask_nb[n], F_nb[n],
            RtKinv_src, RtKinv_nb[n], C_src, C_nb[n],
            min_overlap_lower, min_overlap_upper)[1]
        for n in range(segs_nb.shape[0])])


def pair_valid_cuda(segs_src, mask_src, segs_nb, mask_nb, F_nb,
                    RtKinv_src, RtKinv_nb, C_src, C_nb,
                    min_overlap_lower=pairwise.MIN_OVERLAP_LOWER,
                    min_overlap_upper=pairwise.MIN_OVERLAP_UPPER,
                    stats=None):
    """[N, Ss, St] bool valid planes from the CUDA kernel (one launch).

    `stats`, an int64 [2] tensor on the same device, if given, gains the
    launch's pairs that pass the cheap gates (the ones the kernel
    triangulates) and its warps of 32 pairs that hold any of them."""
    global LAUNCHES
    args, params = _launch_args("pair_valid", segs_src, mask_src, segs_nb,
                                mask_nb, F_nb, RtKinv_src, RtKinv_nb, C_src,
                                C_nb, min_overlap_lower, min_overlap_upper)
    if stats is not None:
        cuda.require_cuda("pair_valid", segs_src, stats,
                          dtypes=[torch.float32, torch.int64])
        if stats.shape != (2,):
            raise ValueError("pair_valid: stats must have shape [2]")
    N, St = mask_nb.shape
    out = torch.empty((N, segs_src.shape[0], St), dtype=torch.bool,
                      device=segs_src.device)
    with cuda.on_device(segs_src):
        rc = cuda.lib().l3d_pair_valid(*args, out.data_ptr(),
                                       None if stats is None
                                       else stats.data_ptr(),
                                       cuda.stream_of(segs_src))
    cuda.check(rc, "l3d_pair_valid")
    LAUNCHES += 1
    return out


def _launch_args(name, segs_src, mask_src, segs_nb, mask_nb, F_nb,
                 RtKinv_src, RtKinv_nb, C_src, C_nb, min_overlap_lower,
                 min_overlap_upper):
    """Checks shared by K1 and K5; returns the kernel's leading C arguments
    and the [N, 35] parameter rows they point into."""
    N, St, _ = segs_nb.shape
    Ss = segs_src.shape[0]
    f32 = torch.float32
    if segs_src.shape != (Ss, 4) or mask_src.shape != (Ss,) or \
            mask_nb.shape != (N, St) or F_nb.shape != (N, 3, 3) or \
            RtKinv_src.shape != (3, 3) or RtKinv_nb.shape != (N, 3, 3) or \
            C_src.shape != (3,) or C_nb.shape != (N, 3):
        raise ValueError(f"{name}: inconsistent shapes")
    cuda.require_cuda(name, segs_src, mask_src, segs_nb, mask_nb,
                      F_nb, RtKinv_src, RtKinv_nb, C_src, C_nb,
                      dtypes=[f32, torch.bool, f32, torch.bool] + [f32] * 5)
    dev = segs_src.device
    # per-neighbor parameter rows (pairwise_pallas.py:303-307 layout); the
    # thresholds are filled on the device, so no host copy waits on the
    # stream
    params = torch.cat([F_nb.reshape(N, 9),
                        RtKinv_src.reshape(1, 9).expand(N, 9),
                        RtKinv_nb.reshape(N, 9),
                        C_src.reshape(1, 3).expand(N, 3), C_nb,
                        torch.full((N, 1), min_overlap_lower, dtype=f32,
                                   device=dev),
                        torch.full((N, 1), min_overlap_upper, dtype=f32,
                                   device=dev)], dim=1).contiguous()
    args = (segs_src.data_ptr(), mask_src.data_ptr(), segs_nb.data_ptr(),
            mask_nb.data_ptr(), params.data_ptr(), N, Ss, St)
    return args, params


def pair_valid(segs_src, mask_src, segs_nb, mask_nb, F_nb,
               RtKinv_src, RtKinv_nb, C_src, C_nb,
               min_overlap_lower=pairwise.MIN_OVERLAP_LOWER,
               min_overlap_upper=pairwise.MIN_OVERLAP_UPPER):
    """Valid planes [N, Ss, St]: the kernel on CUDA, the plain twin on the
    CPU."""
    args = (segs_src, mask_src, segs_nb, mask_nb, F_nb, RtKinv_src,
            RtKinv_nb, C_src, C_nb, min_overlap_lower, min_overlap_upper)
    if segs_src.device.type == "cpu":
        return pair_valid_plain(*args)
    return pair_valid_cuda(*args)


def pair_dense_plain(segs_src, mask_src, segs_nb, mask_nb, F_nb,
                     RtKinv_src, RtKinv_nb, C_src, C_nb,
                     min_overlap_lower=pairwise.MIN_OVERLAP_LOWER,
                     min_overlap_upper=pairwise.MIN_OVERLAP_UPPER):
    """(depths [4, N, Ss, St] f32, valid [N, Ss, St] bool); plain PyTorch
    (`match_pair_dense` stacked over the neighbors)."""
    outs = [pairwise.match_pair_dense(
        segs_src, segs_nb[n], mask_src, mask_nb[n], F_nb[n], RtKinv_src,
        RtKinv_nb[n], C_src, C_nb[n], min_overlap_lower, min_overlap_upper)
        for n in range(segs_nb.shape[0])]
    depths = torch.stack([torch.stack(list(d)) for d, _ in outs], dim=1)
    return depths, torch.stack([v for _, v in outs])


def pair_dense_cuda(segs_src, mask_src, segs_nb, mask_nb, F_nb,
                    RtKinv_src, RtKinv_nb, C_src, C_nb,
                    min_overlap_lower=pairwise.MIN_OVERLAP_LOWER,
                    min_overlap_upper=pairwise.MIN_OVERLAP_UPPER):
    """(depths [4, N, Ss, St] f32, valid [N, Ss, St] bool) from the CUDA
    kernel K5 (one launch)."""
    global LAUNCHES_DENSE
    args, params = _launch_args("pair_dense", segs_src, mask_src, segs_nb,
                                mask_nb, F_nb, RtKinv_src, RtKinv_nb, C_src,
                                C_nb, min_overlap_lower, min_overlap_upper)
    N, St = mask_nb.shape
    Ss = segs_src.shape[0]
    dev = segs_src.device
    valid = torch.empty((N, Ss, St), dtype=torch.bool, device=dev)
    depths = torch.empty((4, N, Ss, St), dtype=torch.float32, device=dev)
    with cuda.on_device(segs_src):
        rc = cuda.lib().l3d_pair_dense(*args, valid.data_ptr(),
                                       depths.data_ptr(),
                                       cuda.stream_of(segs_src))
    cuda.check(rc, "l3d_pair_dense")
    LAUNCHES_DENSE += 1
    return depths, valid


def pair_dense(segs_src, mask_src, segs_nb, mask_nb, F_nb,
               RtKinv_src, RtKinv_nb, C_src, C_nb,
               min_overlap_lower=pairwise.MIN_OVERLAP_LOWER,
               min_overlap_upper=pairwise.MIN_OVERLAP_UPPER):
    """Depth planes [4, N, Ss, St] and valid planes [N, Ss, St]: kernel K5
    on CUDA, the plain twin on the CPU."""
    args = (segs_src, mask_src, segs_nb, mask_nb, F_nb, RtKinv_src,
            RtKinv_nb, C_src, C_nb, min_overlap_lower, min_overlap_upper)
    if segs_src.device.type == "cpu":
        return pair_dense_plain(*args)
    return pair_dense_cuda(*args)
