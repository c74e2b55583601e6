"""Multi-process orchestration: one reconstruction over N ranks, one GPU each.

Torch port of `line3d_tpu/parallel/multihost.py`.  In PyTorch a device mesh
is one process per GPU, so the JAX recipe becomes:

  1. every rank calls `initialize()` (a `torch.distributed` process group
     over gloo, from explicit arguments or torchrun's environment),
  2. every rank holds the full scene (segments, cameras, neighbour lists:
     small host arrays) and owns the contiguous view range
     `my_view_range(V, rank, N)` (`local_range`),
  3. each rank runs the device stages of its own views on its own card
     (`Line3D(device="cuda")` resolves to `cuda:{local rank % cards}`,
     `resolve_device`): collinearity (K4 on its views only) and the
     per-view match step (K1, the scoring kernel, the device selection);
     what those stages read back to the host anyway (each view's selection
     buffer and probe counters, each view's collinear pair list) is
     all-gathered, and every rank decodes every view in view order, as
     every JAX host decodes the replicated buffer,
  4. the cluster stage runs on identical inputs on every rank, with its
     device work split: the affinity weight sweep by candidate range
     (`cluster/affinity.py:_finalize_candidates`, gathered as float64
     bits), the device diffusion's per-edge dot by edge range (one gather
     of the new values per iteration, `cluster/diffusion_device.py`), the
     device refinement and the bundle adjustment (BA) by whole blocks of
     clusters (`local_block_range`; `fit/refine.py`, `fit/bundle.py`,
     whose reduced camera system is the `ordered_sum` of the ranks' block
     partials); the host forms (float64 diffusion, numpy refinement),
     F-H and the line fits run replicated.  Every rank ends with the same
     model, bit for bit the single-process one.

All exchanges are host arrays over gloo (`allgather_array`): the data lies
on the host after the readbacks the single-process path does anyway, gloo
runs on the CPU, and it serves two ranks that share one card, which NCCL
refuses.  `globalize` and `replicate` of the JAX module have no
counterpart: they place and replicate arrays over a device mesh, and here
no array spans processes; a rank's tensors live on its own card.

Without an initialised process group every function here is the
single-process identity: `process_count()` is 1 and nothing is exchanged.
A single process runs the same split code as a gather of one, so the
results cannot depend on the process count: no sum crosses ranks in an
order the backend picks (`ordered_sum` adds the gathered partials in
global block order on every rank).
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import trace

# payload bytes this process received from the other ranks through
# `allgather_array` (its own share and the padding not counted)
GATHERED_BYTES = 0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: float = 600.0) -> bool:
    """Join the process group (gloo) of an N-rank run.

    `coordinator_address` is "host:port" of rank 0; with no arguments the
    address, world size and rank are torchrun's MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK.  Returns False for a single process (nothing is
    created), True once the group is up (also when it already was).  A
    collective that waits longer than `timeout_s` for a rank raises."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes in (None, 1):
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if process_id is None:
        process_id = int(env["RANK"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's index on its host: LOCAL_RANK, or else the rank."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; under N > 1 ranks a bare "cuda" becomes
    this rank's card, cuda:{local rank % card count}.  "cpu" and an
    explicit "cuda:k" are kept, and so is "cuda" without CUDA (the caller
    raises)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and process_count() > 1 \
            and torch.cuda.is_available():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def my_view_range(num_views: int, process_id: int, num_processes: int):
    """Contiguous view shard [start, end) for this host (detection split)."""
    per = (num_views + num_processes - 1) // num_processes
    start = min(process_id * per, num_views)
    return start, min(start + per, num_views)


def local_range(n: int):
    """[lo, hi) of this rank's share of n items (views, candidates):
    `my_view_range` at this process's index and count, all of [0, n) in a
    single process.  The one place a stage learns what this rank owns."""
    return my_view_range(n, process_index(), process_count())


def local_block_range(n: int, block: int):
    """[lo, hi) of this rank's share of n items in whole blocks of `block`
    (the last block may be short): the blocks `local_range` gives this
    rank out of all ceil(n / block), so a rank's blocks are the single
    process's blocks, with the same shapes."""
    b0, b1 = local_range(-(-n // block))
    return min(b0 * block, n), min(b1 * block, n)


def allgather_array(x: np.ndarray) -> list:
    """Every rank's `x`, in rank order, exactly: the bytes of each array
    cross as they are (int32, int64, float64, bool alike), padded to the
    largest.  All ranks pass the same dtype and trailing shape; the leading
    axis may differ (and be 0).  A single process gets [x]."""
    global GATHERED_BYTES
    x = np.ascontiguousarray(x)
    n = process_count()
    if n == 1:
        return [x]
    raw = x.reshape(-1).view(np.uint8)
    with trace.span("gather"):
        size = torch.tensor([raw.size], dtype=torch.int64)
        sizes = [torch.empty_like(size) for _ in range(n)]
        dist.all_gather(sizes, size)
        sizes = [int(s) for s in sizes]
        buf = torch.zeros(max(max(sizes), 1), dtype=torch.uint8)
        buf[:raw.size] = torch.from_numpy(raw)
        outs = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(outs, buf)
    me = process_index()
    GATHERED_BYTES += sum(s for r, s in enumerate(sizes) if r != me)
    return [o.numpy()[:s].view(x.dtype).reshape((-1,) + x.shape[1:])
            for o, s in zip(outs, sizes)]


def allgather_segments(local_segments: np.ndarray, local_mask: np.ndarray,
                       start: int, num_views: int):
    """All-gather per-rank segment shards into the replicated [V, S, 4]
    float32 segments and [V, S] bool mask.

    local_segments: [V_local, S, 4] detected by this rank for views
    [start, start + V_local).  Ranks detect independently, so their padded
    segment axes can differ: every shard is padded to the global maximum
    S, then placed at its start (the JAX version sums disjoint slices;
    the assembly here is exact and gives the same array)."""
    V_local, S, _ = local_segments.shape
    S_global = max(int(s[0]) for s in
                   allgather_array(np.array([S], np.int64)))
    pad = S_global - S
    segs_l = np.pad(np.asarray(local_segments, np.float32),
                    [(0, 0), (0, pad), (0, 0)])
    mask_l = np.pad(np.asarray(local_mask, bool), [(0, 0), (0, pad)])
    starts = allgather_array(np.array([start], np.int64))
    segs = np.zeros((num_views, S_global, 4), np.float32)
    mask = np.zeros((num_views, S_global), bool)
    for s0, sg, mk in zip(starts, allgather_array(segs_l),
                          allgather_array(mask_l)):
        segs[int(s0[0]):int(s0[0]) + len(sg)] = sg
        mask[int(s0[0]):int(s0[0]) + len(mk)] = mk
    return segs, mask


def allgather_tensor(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `x` concatenated in rank order, on x's device;
    the values cross exactly (`allgather_array`).  A single process gets
    `x` itself: no copy, no trip through the host."""
    if process_count() == 1:
        return x
    parts = allgather_array(trace.readback(x.detach(), "gather"))
    return torch.from_numpy(np.concatenate(parts)).to(x.device)


def ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's block partials `parts` [n_local, ...] in
    global block order, starting from zero: ((0 + p_0) + p_1) + ..., the
    loop one process runs over all its blocks.  Ranks own contiguous block
    ranges in rank order, so every rank gets the single process's bits."""
    acc = parts.new_zeros(parts.shape[1:])
    for p in allgather_tensor(parts):
        acc = acc + p
    return acc
