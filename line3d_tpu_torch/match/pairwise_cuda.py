"""Kernel K1: the pair valid plane of one view against N neighbors.

`pair_valid` launches the CUDA kernel `csrc/pair_valid.cu` (replacing
`line3d_tpu/match/pairwise_pallas.py:_kernel_valid`) for CUDA tensors and
runs `pair_valid_plain`, the plain PyTorch twin, for CPU tensors.  There is
no fallback: a CUDA tensor either goes through the kernel or raises.
"""
from __future__ import annotations

import torch

from ..native import cuda
from . import pairwise

# launches of the CUDA kernel in this process
LAUNCHES = 0


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
                    min_overlap_upper=pairwise.MIN_OVERLAP_UPPER):
    """[N, Ss, St] bool valid planes from the CUDA kernel (one launch)."""
    global LAUNCHES
    N, St, _ = segs_nb.shape
    Ss = segs_src.shape[0]
    f32 = torch.float32
    if segs_src.shape != (Ss, 4) or mask_src.shape != (Ss,) or \
            mask_nb.shape != (N, St) or F_nb.shape != (N, 3, 3) or \
            RtKinv_src.shape != (3, 3) or RtKinv_nb.shape != (N, 3, 3) or \
            C_src.shape != (3,) or C_nb.shape != (N, 3):
        raise ValueError("pair_valid: inconsistent shapes")
    cuda.require_cuda("pair_valid", segs_src, mask_src, segs_nb, mask_nb,
                      F_nb, RtKinv_src, RtKinv_nb, C_src, C_nb,
                      dtypes=[f32, torch.bool, f32, torch.bool] + [f32] * 5)
    dev = segs_src.device
    # per-neighbor parameter rows (pairwise_pallas.py:303-307 layout)
    thr = torch.tensor([min_overlap_lower, min_overlap_upper], dtype=f32,
                       device=dev)
    params = torch.cat([F_nb.reshape(N, 9),
                        RtKinv_src.reshape(1, 9).expand(N, 9),
                        RtKinv_nb.reshape(N, 9),
                        C_src.reshape(1, 3).expand(N, 3), C_nb,
                        thr.expand(N, 2)], dim=1).contiguous()
    out = torch.empty((N, Ss, St), dtype=torch.bool, device=dev)
    rc = cuda.lib().l3d_pair_valid(
        segs_src.data_ptr(), mask_src.data_ptr(), segs_nb.data_ptr(),
        mask_nb.data_ptr(), params.data_ptr(), N, Ss, St, out.data_ptr(),
        cuda.stream_of(segs_src))
    cuda.check(rc, "l3d_pair_valid")
    LAUNCHES += 1
    return out


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
